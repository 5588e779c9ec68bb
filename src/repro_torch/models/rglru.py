"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU
(arXiv:2402.19427) — the counterpart of ``repro/models/rglru.py``.

RG-LRU recurrence (per channel):
    r_t = sigmoid(x_t W_a)                (recurrence gate)
    i_t = sigmoid(x_t W_x)                (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)     (c = 8)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

The gates are computed in float32.  The full-sequence recurrence goes through
the RG-LRU scan wrapper (the CUDA kernel on the card, its plain version on the
CPU); decode takes one step at a time, on the whole state or on this
rank's channels of it (:func:`recurrent_block_step`).
The block: x → [linear → gelu] ⊙ [linear → conv1d → RG-LRU] → linear out.

Tensor parallelism over the model axis (the recurrence's channels): handed
this rank's columns of ``w_in_gate``, ``w_in_rec``, ``conv_w``, ``w_a``,
``w_x`` and rows of ``w_out`` (dr/m channels), a block runs its channels
alone: the input projections and the depthwise convolution on them, the
convolution's output gathered over the model axis (the gates are dense over
it: :func:`~repro_torch.parallel.sharding.tp_gather`, whose backward
reduce-scatters), the gates and the scan (#8) on the rank's channels, and
``w_out`` row-parallel, its partial products summed over the model axis.
Λ, whole on every rank, is read at the rank's channels (its gradient summed
over the model axis by the step's plan).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rl
from repro_torch.models.layers import dtype_of, init_dense
from repro_torch.parallel import sharding as sh

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


def _gates(p, x, cols: slice | None = None):
    """x (..., dr) -> (a, gated_input), both float32; with ``cols``, of
    those channels alone (``p.w_a``/``p.w_x`` this rank's columns)."""
    xf = x.float()
    w_a, w_x, lam, xs = p.w_a.float(), p.w_x.float(), p.lambda_raw, xf
    if cols is not None:
        lam, xs = lam[cols], xf[..., cols]
    r = torch.sigmoid(xf @ w_a)
    i = torch.sigmoid(xf @ w_x)
    a = torch.exp(-_C * F.softplus(lam) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xs)
    return a, gated


def rglru_scan(p, x, cols: slice | None = None):
    """Full-sequence RG-LRU through the scan kernel. x: (B, S, dr); with
    ``cols``, the recurrence of those channels alone."""
    a, b = _gates(p, x, cols)
    return rl.rglru_scan(a.contiguous(), b.contiguous()).to(x.dtype)


def rglru_step(p, x_t, h_prev, cols: slice | None = None):
    """One decode step. x_t (B, dr), h_prev (B, dr) float32 state (with
    ``cols``, of those channels alone: ``h_prev`` (B, |cols|))."""
    a, b = _gates(p, x_t, cols)
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


def _channel_share(p):
    """This rank's channels of the recurrence (``None``: all of them, the
    weights whole)."""
    dr, dr_loc = p.w_a.shape
    if dr_loc == dr:
        return None
    if dr % dr_loc or dr // dr_loc != sh.tp_size():
        raise ValueError(f"{dr_loc} of {dr} RG-LRU channels is not a model rank's "
                         f"share on a model axis of {sh.tp_size()}")
    return slice(sh.tp_rank() * dr_loc, (sh.tp_rank() + 1) * dr_loc)


def recurrent_block(p, x):
    """Full Griffin recurrent block, full sequence. x: (B, S, d); on this
    rank's channels when ``p`` holds a tensor-parallel share of them."""
    cols = _channel_share(p)
    if cols is not None:
        x = sh.tp_copy(x)
    gate = _gelu(x @ p.w_in_gate)
    rec, _ = _causal_conv(p.conv_w, x @ p.w_in_rec)
    if cols is not None:  # the gates read every channel
        rec = sh.tp_gather(rec, -1)
    out = (gate * rglru_scan(p, rec, cols)) @ p.w_out
    return out if cols is None else sh.tp_reduce(out)


def recurrent_block_step(p, x_t, state, sharding=None):
    """One-token decode. x_t (B, 1, d); state {"h": (B, dr) float32,
    "conv": (B, K-1, dr)}; returns (out, new state).

    ``sharding`` ({"h", "conv"}: their
    :class:`~repro_torch.parallel.sharding.NamedSharding`) may name the
    state as this rank's channels, which are then the channels of the
    weights' tensor-parallel share (:func:`recurrent_block`): the rank
    computes its channels of the input projections and of the (depthwise)
    convolution, gathers the convolution's output (the gates are dense
    over it), forms its channels' gates and state, and sums its partial
    product with ``w_out`` over the model axis."""
    cols = _channel_share(p)
    axes = sh.dim_axes(sharding and sharding["h"], 1)
    if (cols is None) != (not axes) or (cols is not None and
                                         state["h"].shape[-1] != cols.stop - cols.start):
        raise ValueError(f"the RG-LRU state's channels {tuple(state['h'].shape)} are not "
                         f"the weights' {tuple(p.w_a.shape)}")
    gate = _gelu(x_t @ p.w_in_gate)
    rec, conv_state = _causal_conv(p.conv_w, x_t @ p.w_in_rec, state["conv"])
    if cols is not None:
        rec = sh.all_gather(rec, 2, sharding["h"].mesh, axes)
    h_out, h_new = rglru_step(p, rec[:, 0, :], state["h"], cols)
    out = (gate * h_out[:, None, :]) @ p.w_out
    return out if cols is None else sh.tp_reduce(out), {"h": h_new, "conv": conv_state}
