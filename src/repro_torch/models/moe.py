"""GShard-style mixture-of-experts FFN (dbrx 16 experts top-4, mixtral 8
top-2) — the counterpart of ``repro/models/moe.py``.

The router runs in float32: softmax over the experts, top-k, the k gates
renormalized to sum to one.  Each expert takes at most
``capacity_factor·T·k/E`` tokens (every token when T ≤ 256: dispatch is
lossless at decode and small batches); tokens past an expert's capacity are
dropped in the order of a cumulative sum over (token, k).  The experts are
SwiGLU FFNs (``silu(x·w_gate)·(x·w_up)·w_down``), and the Switch
load-balancing loss comes back beside the output.

Dispatch, the expert products and combine are einsums in the reference,
outside any Pallas kernel, so they stay ``torch.einsum`` products here.
:func:`moe_ffn_onehot` is the GShard one-hot path, :func:`moe_ffn_sorted`
the sort-based one; ``cfg.moe_impl`` picks between them.

Expert parallelism (the reference's ``moe/(w_gate|w_up|w_down)`` rule
splits the expert axis over "tp"): handed this rank's E/m experts (the
expert weights' leading dim shorter than ``cfg.n_experts``), a layer routes
every token over all E experts exactly as one card does — the tokens are
the same on every model rank, so no all-to-all is needed —, dispatches to
its own experts only, and sums the combined partial outputs over the model
axis (:func:`~repro_torch.parallel.sharding.tp_reduce`).  Its input to the
experts passes :func:`~repro_torch.parallel.sharding.tp_copy`, and so do
the gate values before the combine: each rank's gradient of them covers its
experts alone.  The router reads the input as it is (its gradient is whole
on every rank), and the load-balancing loss is the same on every rank, so
it is not summed.

Ties in the top-k: ``jax.lax.top_k`` takes the lower expert index first,
``torch.topk`` gives no such promise.  An exact tie between two routing
probabilities never happens on random normal inputs; on a real tie the two
packages may route a token to different experts.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of, init_dense
from repro_torch.parallel import sharding as sh

__all__ = ["init_moe_params", "moe_ffn", "moe_ffn_onehot", "moe_ffn_sorted"]


def init_moe_params(gen: torch.Generator, cfg, device) -> dict:
    """The router (d, E) in float32 and the stacked expert weights
    (E, d, ff), (E, d, ff), (E, ff, d) in the model's dtype, from ``gen``."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    return {"router": init_dense(gen, (d, e), dtype=torch.float32, device=device),
            "w_gate": init_dense(gen, (e, d, ff), dtype=dt, device=device),
            "w_up": init_dense(gen, (e, d, ff), dtype=dt, device=device),
            "w_down": init_dense(gen, (e, ff, d), dtype=dt, device=device)}


def moe_ffn(p, x: torch.Tensor, cfg):
    """Dispatch selector: the one-hot path (default) or the sorted one."""
    if getattr(cfg, "moe_impl", "onehot") == "sorted":
        return moe_ffn_sorted(p, x, cfg)
    return moe_ffn_onehot(p, x, cfg)


def _route(p, xt: torch.Tensor, k: int):
    """float32 router: (probs (.., E), gates (.., k) renormalized, experts
    (.., k))."""
    probs = torch.softmax(xt.float() @ p.router, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_idx


def _aux_loss(probs: torch.Tensor, top1: torch.Tensor, e: int) -> torch.Tensor:
    """Switch-style load balance: E · Σ_e mean prob · mean top-1 share.
    In a training step on a mesh the means are the global batch's, as the
    reference's are under its sharded step: each dp rank's means averaged
    over the dp ranks (equal slices), one all-reduce
    (:func:`~repro_torch.parallel.sharding.batch_mean`)."""
    me = probs.reshape(-1, e).mean(0)
    ce = F.one_hot(top1.reshape(-1), e).float().mean(0)
    me, ce = sh.batch_mean(torch.stack([me, ce]))
    return (me * ce).sum() * e


def _expert_share(p, e: int):
    """(first expert, expert count) of the rank's share: every expert unless
    ``p`` holds a share of the expert axis."""
    e_loc = p.w_gate.shape[0]
    if e_loc == e:
        return 0, e
    if e % e_loc or e // e_loc != sh.tp_size():
        raise ValueError(f"{e_loc} of {e} experts is not a model rank's share "
                         f"on a model axis of {sh.tp_size()}")
    return sh.tp_rank() * e_loc, e_loc


def _experts(p, expert_in: torch.Tensor, lead: str) -> torch.Tensor:
    """SwiGLU of every expert on its capacity buffer (..., E, C, d)."""
    g = torch.einsum(f"{lead}ecd,edf->{lead}ecf", expert_in, p.w_gate)
    u = torch.einsum(f"{lead}ecd,edf->{lead}ecf", expert_in, p.w_up)
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", F.silu(g) * u, p.w_down)


def _dp_ranks():
    """(mesh, dp axes, rank count, this rank's index over them) of the active
    mesh's dp axes that hold more than one rank, or ``None``: the ranks
    whose slices of the batch one card would dispatch together."""
    mesh = sh.active_mesh()
    axes = () if mesh is None else tuple(a for a in sh.batch_axes(mesh)
                                         if mesh.shape[a] > 1)
    if not axes:
        return None
    return mesh, axes, math.prod(mesh.shape[a] for a in axes), sh.axis_index(mesh, axes)


def _capacity(cfg, n_tok: int, n_all: int) -> int:
    """An expert's capacity in a dispatch of ``n_all`` tokens, ``n_tok`` of
    them on this rank: all of this rank's when n_all ≤ 256 (lossless at
    decode and small batches)."""
    if n_all <= 256:
        return n_tok
    return max(1, int(cfg.capacity_factor * n_all * cfg.top_k / cfg.n_experts))


def _offsets(counts: torch.Tensor, dp, span: int) -> torch.Tensor:
    """Each expert's count of (token, k) assignments on the dp ranks before
    this one within its block of ``span`` consecutive ranks (one dispatch
    group spread over them): where this rank's positions in the experts'
    cumulative sums start.  ``counts`` (E,) this rank's; one all-gather
    over the dp axes."""
    mesh, axes, _, i = dp
    every = sh.all_gather(counts.float()[None], 0, mesh, axes)  # (n, E)
    return every[i - i % span:i].sum(0).long()


def moe_ffn_onehot(p, x: torch.Tensor, cfg):
    """x (B, S, d) -> ((B, S, d), aux loss), through GShard's one-hot
    dispatch and combine tensors (T, E, C) in x's dtype, as the reference
    builds them.  On a mesh whose dp ranks hold slices of the batch the
    capacity and the cumulative-sum positions are the whole batch's, as one
    card computes them: each rank's positions start after the earlier
    ranks' counts (:func:`_offsets`)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    dp = _dp_ranks()
    n_all = n_tok * (dp[2] if dp else 1)
    capacity = _capacity(cfg, n_tok, n_all)
    xt = x.reshape(n_tok, d)
    probs, gate_vals, expert_idx = _route(p, xt, k)

    # position of each (token, k) within its expert's capacity buffer
    onehot = F.one_hot(expert_idx, e)  # (T, k, E)
    flat = onehot.reshape(n_tok * k, e)
    pos = ((torch.cumsum(flat, 0) - flat).reshape(n_tok, k, e) * onehot).sum(-1)
    if dp and n_all > 256:  # the earlier dp ranks' tokens come first
        pos = pos + _offsets(flat.sum(0), dp, dp[2])[expert_idx]
    keep = pos < capacity  # overflow dropped in cumulative-sum order
    e0, e_loc = _expert_share(p, e)
    split = e_loc != e
    if split:  # this rank's experts: their slices of dispatch and combine
        gate_vals, xt = sh.tp_copy(gate_vals), sh.tp_copy(xt)
    disp = (onehot[..., e0:e0 + e_loc].to(xt.dtype)[..., None]
            * F.one_hot(torch.where(keep, pos, 0), capacity).to(xt.dtype)[:, :, None, :]
            * keep[..., None, None].to(xt.dtype))  # (T, k, E, C)
    combine = (disp * gate_vals[..., None, None].to(xt.dtype)).sum(1)  # (T, E, C)
    disp = disp.sum(1)

    expert_in = torch.einsum("tec,td->ecd", disp, xt)  # (E, C, d)
    expert_out = _experts(p, expert_in, "")
    out = torch.einsum("tec,ecd->td", combine, expert_out)
    if split:
        out = sh.tp_reduce(out)
    return out.reshape(b, s, d), _aux_loss(probs, expert_idx[:, 0], e)


def moe_ffn_sorted(p, x: torch.Tensor, cfg):
    """Linear-cost dispatch: token assignments sorted by expert (stable),
    placed into per-group (G, E, C, d) capacity buffers, gathered back after
    the experts and combined in float32.  ``cfg.moe_groups`` splits the
    tokens into groups, each with its own capacity.  On a mesh whose dp
    ranks hold slices of the batch the groups are the whole batch's: a
    rank holds whole groups, or its slice of one group whose positions
    start after the earlier ranks' counts (:func:`_offsets`)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    dp = _dp_ranks()
    n = dp[2] if dp else 1
    groups = max(1, getattr(cfg, "moe_groups", 1))
    while (n_tok * n) % groups:
        groups //= 2
    if groups % n == 0:  # whole groups on each dp rank
        groups, span = groups // n, 1
    elif n % groups == 0:  # one group over ``span`` consecutive dp ranks
        groups, span = 1, n // groups
    else:
        raise ValueError(f"{groups} dispatch groups do not align with {n} dp ranks")
    tl = n_tok // groups  # tokens per group on this rank
    capacity = _capacity(cfg, tl, tl * span)
    xg = x.reshape(groups, tl, d)
    probs, gate_vals, expert_idx = _route(p, xg, k)  # (G, Tl, k)

    dev = x.device
    flat_e = expert_idx.reshape(groups, tl * k)
    flat_t = (torch.arange(tl * k, device=dev) // k).expand(groups, -1)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_t = torch.gather(flat_t, 1, order)
    counts = F.one_hot(sorted_e, e).sum(1)  # (G, E)
    starts = torch.cumsum(counts, -1) - counts
    pos_in_e = (torch.arange(tl * k, device=dev)[None]
                - torch.gather(starts, 1, sorted_e))
    if span > 1 and tl * span > 256:  # the earlier dp ranks' tokens come first
        pos_in_e = pos_in_e + _offsets(counts[0], dp, span)[sorted_e]
    keep = pos_in_e < capacity
    # slot in the per-group flattened (E·C [+1 overflow row]) buffer
    slot = torch.where(keep, sorted_e * capacity + pos_in_e, e * capacity)

    e0, e_loc = _expert_share(p, e)
    split = e_loc != e
    if split:
        xg, gate_vals = sh.tp_copy(xg), sh.tp_copy(gate_vals)
    gidx = torch.arange(groups, device=dev)[:, None].expand(-1, tl * k)
    xt_sorted = xg[gidx, sorted_t]  # (G, Tl·k, d)
    buf = torch.zeros((groups, e * capacity + 1, d), dtype=x.dtype, device=dev)
    buf.index_put_((gidx, slot), xt_sorted, accumulate=True)
    expert_in = buf[:, : e * capacity].reshape(groups, e, capacity, d)
    expert_out = _experts(p, expert_in[:, e0:e0 + e_loc], "g")
    if split:  # the other ranks' experts' slots stay zero here
        expert_out = torch.cat([expert_out.new_zeros((groups, e0, capacity, d)), expert_out,
                                expert_out.new_zeros((groups, e - e0 - e_loc, capacity, d))],
                               dim=1)

    out_flat = torch.cat([expert_out.reshape(groups, e * capacity, d),
                          torch.zeros((groups, 1, d), dtype=expert_out.dtype,
                                      device=dev)], dim=1)
    y_sorted = out_flat[gidx, slot]
    gates_sorted = (torch.gather(gate_vals.reshape(groups, tl * k), 1, order)
                    * keep.float())
    y = torch.zeros((groups, tl, d), dtype=torch.float32, device=dev)
    y.index_put_((gidx, sorted_t), y_sorted.float() * gates_sorted[..., None],
                 accumulate=True)
    if split:
        y = sh.tp_reduce(y)
    return (y.to(x.dtype).reshape(b, s, d),
            _aux_loss(probs, expert_idx[..., 0], e))
