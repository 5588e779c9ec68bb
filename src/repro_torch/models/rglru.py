"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU
(arXiv:2402.19427) — the counterpart of ``repro/models/rglru.py``.

RG-LRU recurrence (per channel):
    r_t = sigmoid(x_t W_a)                (recurrence gate)
    i_t = sigmoid(x_t W_x)                (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)     (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The gates are computed in float32.  The full-sequence recurrence goes through
the RG-LRU scan wrapper (the CUDA kernel on the card, its plain version on the
CPU); decode takes one step at a time.
The block: x → [linear → gelu] ⊙ [linear → conv1d → RG-LRU] → linear out.
"""

from __future__ import annotations


import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rl
from repro_torch.models.layers import dtype_of, init_dense

__all__ = ["init_rglru_params", "rglru_scan", "rglru_step", "recurrent_block",
           "recurrent_block_step"]

_C = 8.0


def init_rglru_params(gen, cfg, device) -> dict:
    d = dr = cfg.d_model  # recurrent width = d_model
    dt = dtype_of(cfg)
    lam = 0.9 + 0.099 * torch.rand(dr, generator=gen, dtype=torch.float32,
                                   device=device)
    # Λ such that a ≈ lam at r = 0.5: softplus(Λ) = -2 ln(lam) / c
    lam_raw = torch.log(torch.expm1(-2.0 * torch.log(lam) / _C))
    return {
        "w_in_gate": init_dense(gen, (d, dr), dtype=dt, device=device),
        "w_in_rec": init_dense(gen, (d, dr), dtype=dt, device=device),
        "conv_w": init_dense(gen, (cfg.conv_width, dr), dtype=dt, device=device),
        "w_a": init_dense(gen, (dr, dr), dtype=dt, device=device),
        "w_x": init_dense(gen, (dr, dr), dtype=dt, device=device),
        "lambda_raw": lam_raw,
        "w_out": init_dense(gen, (dr, d), dtype=dt, device=device),
    }


def _gates(p, x):
    """x (..., dr) -> (a, gated_input), both float32."""
    xf = x.float()
    r = torch.sigmoid(xf @ p.w_a.float())
    i = torch.sigmoid(xf @ p.w_x.float())
    a = torch.exp(-_C * F.softplus(p.lambda_raw) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def rglru_scan(p, x):
    """Full-sequence RG-LRU through the scan kernel. x: (B, S, dr)."""
    a, b = _gates(p, x)
    return rl.rglru_scan(a.contiguous(), b.contiguous()).to(x.dtype)


def rglru_step(p, x_t, h_prev):
    """One decode step. x_t (B, dr), h_prev (B, dr) float32 state."""
    a, b = _gates(p, x_t)
    h = a * h_prev + b
    return h.to(x_t.dtype), h


def _causal_conv(w, x, state=None):
    """Depthwise causal conv1d in float32. x (B, S, dr), w (K, dr).  With
    ``state`` ((B, K-1, dr)) one decode step, returning the new state."""
    k = w.shape[0]
    wf = w.float()
    if state is not None:  # decode: x is (B, 1, dr)
        window = torch.cat([state, x], dim=1)  # (B, K, dr)
        out = torch.einsum("bkd,kd->bd", window.float(), wf)[:, None, :]
        return out.to(x.dtype), window[:, 1:, :]
    s = x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s].float() * wf[i] for i in range(k))
    return out.to(x.dtype), None


def _gelu(x):
    """tanh-approximated GELU, as ``jax.nn.gelu``'s default."""
    return F.gelu(x, approximate="tanh")


def recurrent_block(p, x):
    """Full Griffin recurrent block, full sequence. x: (B, S, d)."""
    gate = _gelu(x @ p.w_in_gate)
    rec, _ = _causal_conv(p.conv_w, x @ p.w_in_rec)
    rec = rglru_scan(p, rec)
    return (gate * rec) @ p.w_out


def recurrent_block_step(p, x_t, state):
    """One-token decode. x_t (B, 1, d); state {"h": (B, dr) float32,
    "conv": (B, K-1, dr)}; returns (out, new state)."""
    gate = _gelu(x_t @ p.w_in_gate)
    rec, conv_state = _causal_conv(p.conv_w, x_t @ p.w_in_rec, state["conv"])
    h_out, h_new = rglru_step(p, rec[:, 0, :], state["h"])
    out = (gate * h_out[:, None, :]) @ p.w_out
    return out, {"h": h_new, "conv": conv_state}


