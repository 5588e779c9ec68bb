"""Plain version of the SSD chunk kernel: the model's
:func:`repro_torch.models.ssd.ssd_chunked` in the kernel's (B, H, S, P)
layout — the counterpart of ``repro/kernels/ssd_chunk/ref.py``.  The wrapper
in :mod:`.ops` runs it for CPU tensors, and ``chip_smoke.py`` holds the kernel
(``csrc/ssd_chunk.cu``) against it on the card.  :func:`ssd_chunk_ref_bwd`,
autograd through it, is the plain version of the backward entry (#9b).
"""

from __future__ import annotations

import torch

from repro_torch.models import ssd as model_ssd

__all__ = ["ssd_chunk_ref", "ssd_chunk_ref_bwd"]


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor, chunk: int = 128):
    """Same layout as the kernel: x (B,H,S,P), dt (B,H,S,1), a (H,1,1,1),
    b/c (B,1,S,N) -> y (B,H,S,P)."""
    xs = x.transpose(1, 2)                  # (B,S,H,P)
    dts = dt[..., 0].transpose(1, 2)        # (B,S,H)
    y = model_ssd.ssd_chunked(xs, dts, a[:, 0, 0, 0], b[:, 0], c[:, 0], chunk)
    return y.transpose(1, 2)


def ssd_chunk_ref_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                      chunk: int = 128):
    """(dx, ddt, da, db, dc) of :func:`ssd_chunk_ref` for the output gradient
    ``dy`` (B, H, S, P), each in its input's layout, by
    ``torch.autograd.grad`` through the plain version (which it recomputes)."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, a, b, c)]
        y = ssd_chunk_ref(*ins, chunk)
        return torch.autograd.grad(y, ins, dy)
