"""repro_torch.serve — Gemini as a long-running online controller service,
the counterpart of ``repro.serve``, on the device.

The offline engines replay a trace in batch; this package is the *online*
mode of the paper's §4.6 control loop: a long-lived controller that

1. ingests traffic-matrix intervals as a stream (:class:`TMStream` — replay
   over recorded/synthetic fleet traces, or any iterable of TM rows),
2. maintains the rolling prediction window *incrementally*
   (:class:`RollingWindow`: O(C) ring-buffer push per interval, no per-epoch
   window recopy),
3. re-plans routing with **warm-started PDHG** on the device — each epoch's
   primal/dual iterates seed the next
   (:meth:`repro_torch.core.pdhg.TorchRoutingSolver.solve_routing_warm`)
   instead of the batch engine's cold middle-epoch anchor,
4. scores each finished epoch with the single-block linkload and queueloss
   CUDA kernels, off the decision path, and
5. measures per-epoch *time-to-new-weights* (TM arrival → installed weight
   matrix), exported through :mod:`repro_torch.obs` (``serve.*`` spans +
   histograms).

Replay parity is the correctness contract: streaming over a recorded trace
reproduces the offline engines' decisions and metrics within solver
tolerance (``tests/test_torch_serve.py`` holds it against the reference).
Every entry point takes ``device`` (``None`` = CUDA, raising without a card).
"""

from .controller import ServeConfig, ServeResult, StreamingController
from .stream import TMStream, stream_fleet_fabric
from .window import RollingWindow

__all__ = [
    "TMStream", "stream_fleet_fabric", "RollingWindow",
    "ServeConfig", "ServeResult", "StreamingController",
]
