"""Mamba2 SSD (state-space duality, arXiv:2405.21060) block — the
counterpart of ``repro/models/ssd.py``.

Selective SSM with scalar-per-head decay.  The full-sequence block
(:func:`ssd_block`) goes through the SSD chunk wrapper in its (B, H, S, P)
layout (the CUDA kernel on the card, the plain version on the CPU; training
differentiates through its ``SSDScan``, the backward kernel on the card);
:func:`ssd_chunked` is that plain version in the model's (B, S, H, P) layout:
within a chunk the token mixing is a masked quadratic form, across chunks a
compact state ``S (B, H, N, P)`` is carried.  :func:`ssd_block_step` is the
one-token decode, on the whole state or on this rank's tile of it (its
heads, or its share of N, and its channels of the convolution's state).

Tensor parallelism over the model axis (the SSD heads): handed this rank's
rows of ``w_out`` (fewer than d_inner), a block runs its heads alone —
H/m of them, or an unequal share where the axis does not divide H
(:func:`~repro_torch.parallel.sharding.head_range`: mamba2-130m's 24 on 16
ranks, 1 or 2 a rank).
``w_in`` and ``conv_w`` come whole (their tiles cut plain column blocks
that do not align with [z | x | B | C | dt]); the block reads its z, x and
dt columns and B, C whole, convolves its x channels and B, C, runs the
scan on its heads, adds ``d_skip``, and applies the gated RMSNorm over all
of d_inner (the global width, whatever the rank's share) with the sum of
squares summed over the model axis
(:func:`~repro_torch.parallel.sharding.tp_sum`: each rank's gradient of it
differs, so the backward sums too); ``w_out`` is row-parallel, its
partial products summed (:func:`~repro_torch.parallel.sharding.tp_reduce`).
The step's plan sums the gradients of the leaves read in part over the
model axis (``LeafPlan.model_sum``).

Shapes: d_inner = 2·d_model, heads H = d_inner / 64 (head dim P = 64),
one B/C group (G = 1), state size N = cfg.ssm_state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ops as sd
from repro_torch.models.layers import dtype_of, init_dense
from repro_torch.parallel import sharding as sh

__all__ = ["HEAD_P", "dims", "init_ssd_params", "ssd_chunked", "ssd_block",
           "ssd_block_step"]

HEAD_P = 64


def dims(cfg):
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // HEAD_P, cfg.ssm_state


def init_ssd_params(gen, cfg, device) -> dict:
    d = cfg.d_model
    d_inner, h, n = dims(cfg)
    dt = dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    a = 1.0 + 15.0 * torch.rand(h, generator=gen, **f32)  # uniform(1, 16)
    return {
        "w_in": init_dense(gen, (d, 2 * d_inner + 2 * n + h), dtype=dt, device=device),
        "conv_w": init_dense(gen, (cfg.conv_width, d_inner + 2 * n), dtype=dt,
                             device=device),
        "a_log": torch.log(a),
        "d_skip": torch.ones(h, **f32),
        "dt_bias": torch.zeros(h, **f32),
        "w_out": init_dense(gen, (d_inner, d), dtype=dt, device=device),
        "norm_z": torch.zeros(d_inner, dtype=dt, device=device),
    }


def _split_proj(p, x, cfg):
    d_inner, _, n = dims(cfg)
    proj = x @ p.w_in
    return torch.split(proj, [d_inner, d_inner, n, n, proj.shape[-1] - 2 * d_inner - 2 * n],
                       dim=-1)  # z, xc, b, c, dt_raw


def _conv(w, u, state=None):
    """Depthwise causal conv1d + SiLU in float32; with ``state`` one decode
    step, returning the new state."""
    k = w.shape[0]
    wf = w.float()
    if state is not None:
        window = torch.cat([state, u], dim=1)
        out = torch.einsum("bkd,kd->bd", window.float(), wf)[:, None, :]
        return F.silu(out).to(u.dtype), window[:, 1:, :]
    s = u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s].float() * wf[i] for i in range(k))
    return F.silu(out).to(u.dtype), None


def ssd_chunked(x, dt, a, b, c, chunk: int):
    """Chunked SSD, the plain version. x (B,S,H,P) f32, dt (B,S,H) f32,
    a (H,) f32 (negative), b/c (B,S,N) f32 (G=1).  Returns y (B,S,H,P) f32.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} must be divisible by chunk {chunk}")
    nc = s // chunk
    xr = x.reshape(bsz, nc, chunk, h, p)
    dtr = dt.reshape(bsz, nc, chunk, h)
    br = b.reshape(bsz, nc, chunk, n)
    cr = c.reshape(bsz, nc, chunk, n)

    lcum = torch.cumsum(dtr * a, dim=2)  # L_s, (B, nc, Q, H)

    # intra-chunk quadratic term: y[s] += Σ_{t≤s} C_s·B_t exp(L_s − L_t) dt_t x_t
    seg = lcum[:, :, :, None, :] - lcum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    # clamp the masked (t > s) entries before exp: exp of a large positive
    # masked-out value is inf
    seg = torch.where(mask[None, None, :, :, None], seg, -1e30)
    cb = torch.einsum("bcsn,bctn->bcst", cr, br)  # (B,nc,Q,Q)
    att = cb[..., None] * torch.exp(seg) * dtr[:, :, None, :, :]  # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcsth,bcthp->bcshp", att, xr)

    # chunk-end states and the inter-chunk carry
    tail = torch.exp(lcum[:, :, -1:, :] - lcum) * dtr  # exp(L_Q − L_t) dt_t
    state_in = torch.einsum("bctn,bcthp->bchnp", br, xr * tail[..., None])
    chunk_decay = torch.exp(lcum[:, :, -1, :])  # (B, nc, H)
    starts = []
    state = torch.zeros((bsz, h, n, p), dtype=x.dtype, device=x.device)
    for ci in range(nc):
        starts.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + state_in[:, ci]
    s_starts = torch.stack(starts, dim=1)  # (B, nc, H, N, P)

    y_inter = (torch.einsum("bcsn,bchnp->bcshp", cr, s_starts)
               * torch.exp(lcum)[..., None])
    return (y_intra + y_inter).reshape(bsz, s, h, p)


def _gated_norm(y, z, norm_z, dtype, d_inner=None):
    """Gated RMSNorm (Mamba2's norm before the out-projection), float32.
    With ``d_inner`` (tensor parallel) ``y`` and ``z`` are this rank's
    channels of it and the mean of squares runs over all of them: the
    ranks' sums of squares summed over the model axis."""
    zf = F.silu(z.float())
    yz = y.float() * zf
    if d_inner is None:
        var = yz.square().mean(dim=-1, keepdim=True)
    else:
        var = sh.tp_sum(yz.square().sum(dim=-1, keepdim=True)) / d_inner
    return (yz * torch.rsqrt(var + 1e-6) * (1.0 + norm_z.float())).to(dtype)


def _head_share(p, cfg):
    """(first head, head count) of this rank's share of the SSD heads
    (:func:`~repro_torch.parallel.sharding.tp_heads`): all of them unless
    ``p`` holds a share of ``w_out``'s rows."""
    d_inner, h, _ = dims(cfg)
    rows = p.w_out.shape[0]
    if rows == d_inner:
        return 0, h
    h0, h1 = sh.tp_heads(h)
    if rows != (h1 - h0) * HEAD_P:
        raise ValueError(f"{rows} of {d_inner} rows of w_out is not model rank "
                         f"{sh.tp_rank()}'s share on a model axis of {sh.tp_size()}")
    return h0, h1 - h0


def _columns(cfg, h0: int, h_loc: int):
    """The in-projection's columns of heads [h0, h0 + h_loc): their z, x,
    B and C whole, their dt — as one index."""
    d_inner, _, n = dims(cfg)
    c0, c1 = h0 * HEAD_P, (h0 + h_loc) * HEAD_P
    return torch.cat([torch.arange(c0, c1), torch.arange(d_inner + c0, d_inner + c1),
                      torch.arange(2 * d_inner, 2 * d_inner + 2 * n),
                      torch.arange(2 * d_inner + 2 * n + h0, 2 * d_inner + 2 * n + h0 + h_loc)])


def ssd_block(p, x, cfg, chunk: int = 64):
    """Full-sequence Mamba2 block through the SSD chunk kernel.
    x (B, S, d) -> (B, S, d); on this rank's heads alone when ``p`` holds a
    tensor-parallel share of them."""
    d_inner, h, n = dims(cfg)
    h0, h_loc = _head_share(p, cfg)
    split = h_loc != h
    bsz, s, _ = x.shape
    di = h_loc * HEAD_P
    w_in, conv_w = p.w_in, p.conv_w
    if split:  # the rank's z, x, dt columns and B, C whole
        x = sh.tp_copy(x)
        cols = _columns(cfg, h0, h_loc).to(x.device)
        w_in, conv_w = w_in[:, cols], conv_w[:, cols[di:2 * di + 2 * n] - d_inner]
    z, xc, b, c, dt_raw = torch.split(x @ w_in, [di, di, n, n, h_loc], dim=-1)
    conv_out, _ = _conv(conv_w, torch.cat([xc, b, c], dim=-1))
    xc, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    heads = slice(h0, h0 + h_loc)
    dt = F.softplus(dt_raw.float() + p.dt_bias[heads])  # (B, S, H)
    a = -torch.exp(p.a_log[heads])
    xh = xc.float().reshape(bsz, s, h_loc, HEAD_P)
    y = sd.ssd_scan(xh.transpose(1, 2).contiguous(),
                    dt.transpose(1, 2)[..., None].contiguous(),
                    a.reshape(h_loc, 1, 1, 1).contiguous(),
                    b.float()[:, None].contiguous(), c.float()[:, None].contiguous(),
                    chunk).transpose(1, 2)  # (B, S, H, P)
    y = y + p.d_skip[heads][:, None] * xh
    y = y.reshape(bsz, s, di).to(x.dtype)
    norm = p.norm_z[h0 * HEAD_P:h0 * HEAD_P + di]
    out = _gated_norm(y, z, norm, x.dtype, d_inner if split else None) @ p.w_out
    return sh.tp_reduce(out) if split else out


def ssd_block_step(p, x_t, state, cfg, sharding=None):
    """One-token decode. state: {"s": (B,H,N,P) f32, "conv": (B,K-1,convdim)};
    returns (out, new state).

    ``sharding`` ({"s", "conv"}: their
    :class:`~repro_torch.parallel.sharding.NamedSharding`) may name the
    state as this rank's tile.  The rank convolves its share of the
    channels, and the convolution's output is gathered (every head reads b
    and c).  With the heads split the weights are this rank's
    tensor-parallel share of them (:func:`ssd_block`): the rank updates its
    heads' state, applies the gated norm to its heads' y and sums its
    partial product with ``w_out`` over the model axis.  With N split (a
    head count the model axis does not divide) the weights are whole: the
    rank updates its share of N, and ``y = c·s`` is summed over N's axes."""
    d_inner, h, n = dims(cfg)
    h0, h_loc = _head_share(p, cfg)
    s_sh = sharding and sharding["s"]
    h_axes, n_axes = sh.dim_axes(s_sh, 1), sh.dim_axes(s_sh, 2)
    if (h_loc != h) != bool(h_axes) or (h_axes and state["s"].shape[1] != h_loc):
        raise ValueError(f"the SSD state's heads {tuple(state['s'].shape)} are not the "
                         f"weights' {h_loc} of {h} heads")
    conv_axes = sh.dim_axes(sharding and sharding["conv"], 2)
    conv_cols = (sh.tile_slice(state["conv"].shape[-1], sharding["conv"].mesh, conv_axes)
                 if conv_axes else slice(None))
    if h_loc != h:  # this rank's z and dt columns, the conv tile's columns
        heads = slice(h0, h0 + h_loc)
        chans = slice(h0 * HEAD_P, (h0 + h_loc) * HEAD_P)
        z = x_t @ p.w_in[:, chans]
        dt_raw = x_t @ p.w_in[:, 2 * d_inner + 2 * n + h0:2 * d_inner + 2 * n + h0 + h_loc]
        u = x_t @ p.w_in[:, d_inner:2 * d_inner + 2 * n][:, conv_cols]
    else:
        heads = chans = slice(None)
        z, xc, b, c, dt_raw = _split_proj(p, x_t, cfg)
        u = torch.cat([xc, b, c], dim=-1)[..., conv_cols]
    conv_out, conv_state = _conv(p.conv_w[:, conv_cols], u, state["conv"])
    if conv_axes:
        conv_out = sh.all_gather(conv_out, 2, sharding["conv"].mesh, conv_axes)
    xc, b, c = torch.split(conv_out, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias[heads])[:, 0]  # (B, H)
    a = -torch.exp(p.a_log[heads])
    bsz = x_t.shape[0]
    xh = xc[..., chans].float().reshape(bsz, h_loc, HEAD_P)
    bn, cn, d_skip = b[:, 0].float(), c[:, 0].float(), p.d_skip[heads]
    if n_axes:  # this rank's share of the state size
        part = sh.tile_slice(state["s"].shape[2], s_sh.mesh, n_axes)
        bn, cn = bn[:, part], cn[:, part]
    decay = torch.exp(dt * a)  # (B, H)
    s_new = (state["s"] * decay[:, :, None, None]
             + torch.einsum("bh,bn,bhp->bhnp", dt, bn, xh))
    y = torch.einsum("bn,bhnp->bhp", cn, s_new)
    if n_axes:
        y = sh.all_reduce(y, s_sh.mesh, n_axes)
    y = y + d_skip[:, None] * xh
    y = y.reshape(bsz, 1, h_loc * HEAD_P)
    split = h_loc != h
    out = _gated_norm(y, z, p.norm_z[chans], x_t.dtype, d_inner if split else None) @ p.w_out
    return sh.tp_reduce(out) if split else out, {"s": s_new, "conv": conv_state}
