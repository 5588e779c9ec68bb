"""Burst-level packet-loss subsystem (paper §3, §5), the counterpart of
``repro.burst``.

* :mod:`repro_torch.burst.expander` — a copy of the reference's burst
  expander: the same numpy ``default_rng(seed)`` draws, so bursts stay paired
  by seed with the reference;
* :mod:`repro_torch.burst.queue` — the per-link finite-buffer fluid-queue
  model, with its scan on the CUDA kernel (:mod:`repro_torch.kernels.queueloss`)
  or the float64 numpy oracle.
"""

from repro_torch.burst.expander import BurstParams, expand, from_fleet_spec
from repro_torch.burst.queue import (LossConfig, interval_loss,
                                     interval_loss_batched,
                                     interval_loss_fleet, link_buffer_gb)

__all__ = [
    "BurstParams", "expand", "from_fleet_spec",
    "LossConfig", "interval_loss", "interval_loss_batched",
    "interval_loss_fleet", "link_buffer_gb",
]
