"""Plain-PyTorch version of the RG-LRU scan kernel.

The counterpart of ``repro/kernels/rglru_scan/ref.py`` (an associative scan):
a log-step (Hillis–Steele) scan of the pairs (a, b) under
``(a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2)`` along the sequence axis,
ceil(log2 S) full-size steps instead of S small ones.  The wrappers in
:mod:`.ops` run it for CPU tensors, and ``chip_smoke.py`` holds the kernel
(``csrc/rglru_scan.cu``, one sequential walk per channel) against it on the
card.
"""

from __future__ import annotations

import torch

__all__ = ["rglru_scan_ref"]


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 (h_{-1} = 0). a, b: (B, S, D)."""
    a_c, h = a, b
    s = a.shape[1]
    shift = 1
    while shift < s:
        h = torch.cat([h[:, :shift], a_c[:, shift:] * h[:, :-shift] + h[:, shift:]], 1)
        a_c = torch.cat([a_c[:, :shift], a_c[:, shift:] * a_c[:, :-shift]], 1)
        shift *= 2
    return h
