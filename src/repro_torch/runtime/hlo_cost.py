"""Cost of one step: flops, bytes and collectives — the counterpart of
``repro/runtime/hlo_cost.py``, measured on the port's own step.

The reference re-derives the three roofline inputs from a compiled step's
HLO text, with its loops expanded by their trip counts.  The port compiles
no HLO, so it keeps the reference's result type (:class:`CostResult`) and
not its text reader: :func:`measure_step` fills it from one eager call of a
port step — the matrix products' flops as they execute, an unfused bound on
the bytes its operators touch, and the collectives it issues.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.runtime.hlo_traffic import collective_summary, record_collectives

__all__ = ["CostResult", "measure_step"]


@dataclasses.dataclass
class CostResult:
    flops: float
    hbm_bytes: float
    collective_ops: list  # CollectiveOp list
    unknown_trip_loops: int

    def summary(self) -> dict:
        s = collective_summary(self.collective_ops)
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collectives": s, "unknown_trip_loops": self.unknown_trip_loops}


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(_tensor_bytes(t) for t in tree.values())
    return 0


class _BytesMode(torch.utils._python_dispatch.TorchDispatchMode):
    """Adds up the operand and result bytes of every aten operator that
    moves data (views and other aliasing operators excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += _tensor_bytes(list(args)) + _tensor_bytes(kwargs) \
                + _tensor_bytes(out)
        return out


def measure_step(fn, *args) -> CostResult:
    """The :class:`CostResult` of one call ``fn(*args)``.

    * ``flops``: per device (the call runs this rank's shares), every
      matrix product as it executes, forward, recomputation and backward,
      from ``torch.utils.flop_counter.FlopCounterMode``.  Eager execution
      has no loops to expand, so ``unknown_trip_loops`` is 0.
    * ``hbm_bytes``: operand plus result bytes of every aten operator at
      dispatch, views excluded — an unfused upper bound: a fused kernel
      (the hand-written ones among them, whose plain versions run on
      ``meta`` and the CPU) keeps its intermediates out of memory.
    * ``collective_ops``: the collectives the call issues
      (:func:`~repro_torch.runtime.hlo_traffic.record_collectives`).

    On ``meta`` tensors (a virtual mesh) the whole step runs as shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    with record_collectives() as ops, FlopCounterMode(display=False) as fc, \
            _BytesMode() as bm:
        fn(*args)
    return CostResult(flops=float(fc.get_total_flops()), hbm_bytes=float(bm.bytes),
                      collective_ops=list(ops), unknown_trip_loops=0)
