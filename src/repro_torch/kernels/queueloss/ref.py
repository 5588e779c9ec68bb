"""Plain-PyTorch version of the fused queue-loss kernel.

The counterpart of ``repro/kernels/queueloss/ref.py``.  Per directed link
``e`` (fluid queue with a finite buffer, see :mod:`repro_torch.burst.queue`):

    x[k]     = q[k] + (load[k, e] - cap[e]) * dt        # pre-clip level (Gb)
    drop[k]  = max(0, x[k] - buf[e])                    # overflow (Gb)
    q[k+1]   = clip(x[k], 0, buf[e])

The functions materialize the load tensor ((TS, E), (B, TS, E) batched, or
(F, B, TS, E) for a fleet bucket) and walk the sub-steps in a Python loop; the wrappers in :mod:`.ops` run them
for CPU tensors, and ``chip_smoke.py`` holds the CUDA kernel
(``csrc/queueloss.cu``) against them.
"""

from __future__ import annotations

import torch

__all__ = ["queueloss_ref", "queueloss_batched_ref", "queueloss_fleet_ref"]


def queueloss_ref(demand: torch.Tensor, w: torch.Tensor, cap: torch.Tensor,
                  buf: torch.Tensor, dt: float):
    """demand (TS, C), w (C, E), cap/buf (E,); the queue starts empty at the
    call and carries across all TS sub-steps.  Returns (drop_sum, load_sum),
    each (TS,)."""
    drop, tot = queueloss_batched_ref(demand[None], w[None], cap[None],
                                      buf[None], dt)
    return drop[0], tot[0]


def queueloss_batched_ref(demand: torch.Tensor, w: torch.Tensor,
                          cap: torch.Tensor, buf: torch.Tensor, dt: float):
    """demand (B, TS, C), w (B, C, E), cap/buf (B, E); the queue starts empty
    in every epoch.  Returns (drop_sum, load_sum), each (B, TS)."""
    load = demand @ w  # (B, TS, E)
    q = torch.zeros_like(cap)
    drops = []
    for k in range(load.shape[1]):
        x = q + (load[:, k] - cap) * dt
        drops.append(torch.clamp(x - buf, min=0.0).sum(dim=1))
        q = torch.minimum(torch.clamp(x, min=0.0), buf)
    drop = (torch.stack(drops, dim=1) if drops
            else load.new_zeros(load.shape[:2]))
    return drop, load.sum(dim=2)


def queueloss_fleet_ref(demand: torch.Tensor, w: torch.Tensor,
                        cap: torch.Tensor, buf: torch.Tensor, dt: float):
    """demand (F, B, TS, C), w (F, B, C, E), cap/buf (F, B, E); the queue
    starts empty in every (fabric, block) pair.  Returns (drop_sum,
    load_sum), each (F, B, TS)."""
    f, b, ts = demand.shape[:3]
    e = w.shape[3]
    drop, tot = queueloss_batched_ref(
        demand.reshape((f * b,) + demand.shape[2:]),
        w.reshape((f * b,) + w.shape[2:]), cap.reshape(f * b, e),
        buf.reshape(f * b, e), dt)
    return drop.reshape(f, b, ts), tot.reshape(f, b, ts)
