"""Train and serve step builders — the counterpart of
``repro/launch/steps.py``.

``make_train_step`` builds the training step: microbatched gradient
accumulation in float32, the model's loss with each block checkpointed as
``StepConfig.remat`` says, the optional gradient-compression hook, then the
AdamW update, in place.  ``make_serve_step`` / ``make_prefill_step`` build the
one-token decode step and the prefill step, under ``torch.inference_mode``.

With a mesh (:func:`repro_torch.launch.mesh.make_host_mesh`: one rank per
card) the training step is FSDP × TP: each rank holds its tile of every
parameter and of AdamW's moments (the dims that
:func:`repro_torch.parallel.sharding.param_shardings` names, cut by its
indices over the dp axes and the model axis), gathers each leaf over the dp
axes where it is used — a block at a time, inside the block's checkpoint,
as the reference's scan over its layers does —, runs the layers that
:func:`leaf_plans` names Megatron-parallel over the model axis on their
tiles (the others on leaves gathered whole), and reduce-scatters each
block's gradients over the dp axes into their mean once the block's
backward is done; the update runs on the tiles.  The prefill and decode
steps gather every leaf at once and run the same layers
Megatron-parallel; the decode step also keeps every cache leaf in the tile
that ``cache_shardings`` names (:func:`cache_tile_shardings`,
:func:`shard_cache`), from one step to the next.  On a virtual mesh
(:func:`repro_torch.launch.mesh.make_production_mesh`) each step runs on
``meta`` tensors as rank 0, and its collectives are recorded
(:mod:`repro_torch.launch.dryrun`).

``input_shardings`` / ``cache_shardings`` / ``train_state_shardings``
assign a :class:`~repro_torch.parallel.sharding.NamedSharding` to every
batch, cache and train-state leaf per (arch × shape × mesh), by the
reference's rules:
  * batch dims shard over the dp axes when divisible, else stay replicated
    (long_500k has batch 1);
  * decode-cache sequence dims shard over "model" (and over the dp axes too
    when batch cannot absorb them) — the context-parallel KV layout, which
    the decode step executes: each rank attends over its slots and the
    partial softmaxes are combined over those axes;
  * SSM/recurrent state shards heads/channels over "model"; the decode
    step updates the rank's share.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.api import Model
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.params import TensorTree
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.optim.compression import compress_decompress
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import (LeafPlan, Mesh, NamedSharding,
                                           PartitionSpec as P, all_gather, all_reduce,
                                           batch_axes, check_executable, dp_axes,
                                           fit_spec, gather_for_use, param_shardings,
                                           reduce_gradient, use_mesh)

__all__ = ["StepConfig", "make_train_step", "make_serve_step", "make_prefill_step",
           "input_shardings", "cache_shardings", "cache_tile_shardings", "shard_cache",
           "train_state_shardings", "module_like", "leaf_plans", "init_tiles",
           "init_cache_tiles", "decode_reads", "tp_report", "block_leaves"]


@dataclasses.dataclass(frozen=True)
class StepConfig:
    microbatches: int = 1
    remat: bool | str = True  # False | True | "dots"
    compression: str = "none"  # "none" | "topk" | "int8" (DP-axis grads)


def module_like(params, values: list):
    """A parameter module of ``params``' type, architecture and structure
    whose leaves are ``values`` (in ``tree_util.leaves`` order), not copied."""
    return type(params)(params.cfg, tree_util.unflatten(params, values))


def _all_reduce_sum(x: torch.Tensor, mesh: Mesh, axes=None) -> torch.Tensor:
    """``x`` summed over this rank's group over ``axes`` (default: the whole
    mesh; a group of one: ``x``)."""
    return all_reduce(x, mesh, mesh.axis_names if axes is None else axes)


def _tp_role(path: str) -> str | None:
    """The Megatron group of a leaf at reference path ``path``: an
    attention block's projections (decoder, encoder and cross attention), a
    SwiGLU MLP's matrices, the moe experts, an SSD or RG-LRU block's
    leaves, the vocabulary."""
    parts = path.split("/")
    block, leaf = (parts[-2], parts[-1]) if len(parts) >= 2 else ("", path)
    if block in ("attn", "xattn"):
        return "attn"
    if block in ("mlp", "moe") and leaf in ("w_gate", "w_up", "w_down"):
        return block
    if block in ("ssd", "rec"):
        return "ssd" if block == "ssd" else "rglru"
    if path in ("embed", "unembed"):
        return "vocab"
    return None


# the dim each Megatron leaf splits over the model axis, by (group, leaf):
# columns of the column-parallel matrices, rows of the row-parallel ones and
# of the embedding, the expert axis of the moe's stacked experts; the
# unembedding's rows (d) when the axis does not divide the vocabulary
_TP_DIM = {("attn", "wq"): 1, ("attn", "wk"): 1, ("attn", "wv"): 1, ("attn", "wo"): 0,
           ("mlp", "w_gate"): 1, ("mlp", "w_up"): 1, ("mlp", "w_down"): 0,
           ("moe", "w_gate"): 0, ("moe", "w_up"): 0, ("moe", "w_down"): 0,
           ("ssd", "w_out"): 0,
           ("rglru", "w_in_gate"): 1, ("rglru", "w_in_rec"): 1, ("rglru", "conv_w"): 1,
           ("rglru", "w_a"): 1, ("rglru", "w_x"): 1, ("rglru", "w_out"): 0,
           ("vocab", "embed"): 0, ("vocab", "unembed"): 1}

# leaves a Megatron group reads in part, whole on every model rank or
# gathered whole over it (``LeafPlan.model_sum``): SSD's in-projection and
# convolution (their column blocks do not align with [z | x | B | C | dt]),
# its per-head and per-channel vectors, RG-LRU's per-channel Λ, qk-norm's
# scales
_READ_IN_PART = {("ssd", "w_in"), ("ssd", "conv_w"), ("ssd", "a_log"), ("ssd", "d_skip"),
                 ("ssd", "dt_bias"), ("ssd", "norm_z"), ("rglru", "lambda_raw"),
                 ("attn", "q_norm"), ("attn", "k_norm")}


def _group_splits(cfg, role: str, m: int, kind: str) -> bool:
    """Whether a Megatron ``role`` runs tensor parallel on a model axis of
    ``m`` in a step of ``kind``: attention when the axis divides the KV
    head count or is a multiple of it (each KV head then on ``m / n_kv``
    ranks) and no rank holds every head — the heads themselves in shares
    that may be unequal (:func:`~repro_torch.parallel.sharding.head_range`);
    the experts when it divides their count; the SSD heads (2·d_model/64)
    when there are at least ``m`` (unequal shares), except at decode, where
    the state's tile holds heads only if the axis divides them (else it is
    split over N, and the SSD weights are read whole); the RG-LRU width when
    it divides it; the vocabulary always (where the axis does not divide
    it, the unembedding runs row-parallel over d)."""
    if role == "attn":
        kv, h = cfg.n_kv_heads, cfg.n_heads
        return (kv % m == 0 or m % kv == 0) and -(-h // m) < h
    if role == "moe":
        return cfg.n_experts % m == 0
    if role == "ssd":
        h = 2 * cfg.d_model // 64
        return h % m == 0 if kind == "decode" else h >= m
    if role == "rglru":
        return cfg.d_model % m == 0
    return True


def _heads_of(cfg, role: str, name: str) -> tuple:
    """(heads, entries a head) along the model dim of a leaf that holds a
    Megatron group's heads: attention's ``wq`` columns and ``wo`` rows, the
    SSD's ``w_out`` rows; (0, 0) for any other leaf."""
    if role == "attn" and name in ("wq", "wo"):
        return cfg.n_heads, cfg.resolved_head_dim
    if role == "ssd" and name == "w_out":
        return 2 * cfg.d_model // 64, 64
    return 0, 0


def leaf_plans(model: Model, mesh: Mesh, kind: str = "train") -> list:
    """A :class:`~repro_torch.parallel.sharding.LeafPlan` for every parameter
    leaf (in ``tree_util.leaves`` order) on ``mesh``, for a step of
    ``kind`` ("train", "prefill" or "decode").

    A leaf the rules split over the model axis runs Megatron when its whole
    group does, which the model axis's size decides from the shapes alone
    (:func:`_group_splits`): an attention block — decoder, encoder or
    cross attention — when the axis divides the KV head count or is a
    multiple of it (each KV head replicated over ``model / n_kv_heads``
    ranks, its columns gathered over them); a SwiGLU MLP; the moe experts
    when it divides their count (expert parallelism); an SSD block on its
    heads; an RG-LRU block when it divides its width; the vocabulary (the
    embedding's rows and the unembedding's columns, tied or not; the
    unembedding's tile splits d, so it is gathered whole and cut by its
    columns: ``LeafPlan.relayout``), or, when the axis does not divide the
    vocabulary, the unembedding row-parallel over its d.  Where the axis
    does not divide the heads (qwen3-14b's 40 or internvl2-1b's 14 on 16,
    internvl2-1b's on 4, mamba2-130m's 24 SSD heads on 16), each rank runs
    its unequal share of them (``LeafPlan.heads``: read from its block's
    tiles, a rank of internvl2-1b on 16 holding none); the ranges never
    cross a KV group where the axis is a multiple of the KV head count.
    The leaves such a group reads only in part (``_READ_IN_PART``) get
    ``model_sum``: their gradients are summed over the model axis.  At
    decode, mamba2-130m's SSD on 16 reads its weights whole (the state is
    split over N there).  Any other split leaf of a group that does not
    split is gathered whole, and its layer runs whole on every model rank.
    The plan is decided before a step runs; no layer falls back."""
    cfg = model.cfg
    shapes = model.param_shapes()
    with use_mesh(mesh):
        shardings = tree_util.leaves_of(param_shardings(mesh, shapes))
    paths = sh.param_paths(shapes)
    m = mesh.shape.get("model", 1)
    roles = [_tp_role(p) for p in paths]
    names = [p.split("/")[-1] for p in paths]

    def tp_dim(s):
        return LeafPlan(s).tp_dim

    vocab_parallel = cfg.vocab % m == 0

    def relayout(p, s):  # the unembedding whose d the rules split (``embed$``)
        return 1 if p == "unembed" and tp_dim(s) == 0 and vocab_parallel else None

    def want_dim(role, name):
        if role == "vocab" and not vocab_parallel:  # the embedding whole, the
            return 0 if name == "unembed" else None  # unembedding row-parallel
        return _TP_DIM.get((role, name))

    ok = {}
    for role in ("attn", "mlp", "moe", "ssd", "rglru", "vocab"):
        mine = [(p, s, n) for p, s, r, n in zip(paths, shardings, roles, names) if r == role]
        ok[role] = m > 1 and bool(mine) and _group_splits(cfg, role, m, kind) and all(
            tp_dim(s) == want_dim(role, n) or relayout(p, s) is not None
            for p, s, n in mine if (role, n) not in _READ_IN_PART)
    kv = cfg.n_kv_heads
    kv_block = m // kv if ok["attn"] and kv < m else 0
    plans = []
    for p, s, r, n in zip(paths, shardings, roles, names):
        partial = r is not None and ok[r] and (r, n) in _READ_IN_PART
        if tp_dim(s) is None:
            plans.append(LeafPlan(s, "data", model_sum=partial))
        elif partial:
            plans.append(LeafPlan(s, "megatron", model_sum=True))
        elif r is not None and ok[r]:
            heads, size = _heads_of(cfg, r, n)
            if heads % m:  # an unequal share, cut from its block's tiles
                plans.append(LeafPlan(s, "megatron", m // math.gcd(heads, m),
                                      heads=heads, head_size=size))
                continue
            kb = kv_block if r == "attn" and n in ("wk", "wv") else 0
            rl = relayout(p, s)
            plans.append(LeafPlan(s, "megatron", kb, rl, model_sum=rl is not None))
        else:
            plans.append(LeafPlan(s, "gathered"))
    return plans


def _draw_paths(model: Model) -> list:
    """The place in the parameter tree (its key path, layer indices
    included) of each leaf ``init_dense`` draws for ``model``, in draw
    order: its init on ``meta`` with every draw recorded, each matched to
    its place by identity (the draw order is not the tree's: the embedding,
    the final norm and the unembedding come first, a block's leaves in its
    own order)."""
    drawn = []

    def record(w, dtype):
        drawn.append(w.to(dtype))
        return drawn[-1]

    tree = model.init_tree(None, torch.device("meta"), record)
    where = {id(x): path for path, _, x in sh._param_leaves(tree)}
    return [where[id(x)] for x in drawn]


def init_tiles(model: Model, plans: list, seed: int = 0):
    """This rank's tiles of ``model.init(seed)``, bit for bit, without ever
    holding the whole model: each leaf is drawn in ``init``'s own order
    from the same generator, cut to its tile by its plan (``plans``: the
    :class:`LeafPlan` of :func:`leaf_plans`, or the :class:`NamedSharding`
    of :func:`param_shardings`, of every leaf in ``tree_util.leaves``
    order) as soon as it is drawn, and the rest dropped: beyond its tiles a
    rank holds one leaf's float32 draw and its float32 tile at a time (the
    cut comes before the cast, which is elementwise).  Each draw finds its
    plan by its place in the tree, not by its position in the draws.  The
    leaves ``init_dense`` does not draw (norm scales, per-head vectors) are
    made whole and cut after."""
    paths = [path for path, _, _ in sh._param_leaves(model.param_shapes())]
    by_path = {p: getattr(plan, "sharding", plan) for p, plan in zip(paths, plans)}
    order = _draw_paths(model)
    draws = iter(order)

    def take(w, dtype):
        return sh.shard_tensor(w, by_path[next(draws)]).to(dtype)

    params = model.init(seed, take)
    drawn = set(order)
    return module_like(params, [x if p in drawn else sh.shard_tensor(x, by_path[p])
                                for p, x in zip(paths, tree_util.leaves(params))])


def tp_report(model: Model, plans: list) -> dict:
    """Which leaves (reference paths) run Megatron and which are gathered
    whole over the model axis."""
    paths = sh.param_paths(model.param_shapes())
    out = {"megatron": [], "gathered": []}
    for p, plan in zip(paths, plans):
        if plan.mode in out and p not in out[plan.mode]:
            out[plan.mode].append(p)
    return out


def _split_axes(plan: LeafPlan) -> tuple:
    """The mesh axes over which the leaf's tile is split, in mesh order."""
    mesh = plan.sharding.mesh
    names = {a for _, axes in sh._sharded_dims(plan.sharding) for a in axes}
    return tuple(a for a in mesh.axis_names if a in names)


def block_leaves(params) -> tuple:
    """(the positions of the top-level leaves, the positions of each
    block's leaves) in ``tree_util.leaves`` order of ``params`` (a
    parameter tree or module; ``meta`` serves).  A block is one entry of a
    layer list — a decoder block, a hybrid super-block or tail block, an
    encoder or decoder block —, the unit the model checkpoints
    (``transformer._ck``); the top-level leaves are the others (the
    embedding, the final norms, the unembedding)."""
    top, blocks = [], {}
    for i, (path, layers, _) in enumerate(sh._param_leaves(params)):
        if layers:
            blocks.setdefault(path[:2], []).append(i)
        else:
            top.append(i)
    return top, list(blocks.values())


class _GatheredLeaf(torch.autograd.Function):
    """A block's leaf gathered from the rank's tile (:func:`gather_for_use`)
    inside the block's checkpointed body.  Its gradient is kept in ``slot``
    for the block's reduce and not handed to the tile: autograd would cast
    it to the tile's dtype, and a bf16 tile would round the float32 mean.
    ``anchor``, a scalar that requires grad, puts the gather in the graph."""

    @staticmethod
    def forward(ctx, anchor, tile, plan, slot):
        ctx.slot = slot
        out = gather_for_use(tile, plan)
        slot["like"] = (out.shape, out.dtype)
        return out.view_as(out) if out is tile else out

    @staticmethod
    def backward(ctx, g):
        ctx.slot["grad"] = g
        return None, None, None, None


class _BlockCall:
    """One block of a training step on a mesh: its function, the
    checkpoint wrapper it runs under, its module of tiles with their plans
    and places in tree order, the inputs it passes on (``_Block``), and a
    slot a leaf for the gradient its backward leaves."""

    def __init__(self, ck, fn, blk, plans, positions, passed, reduce):
        self.ck, self.fn, self.blk, self.plans = ck, fn, blk, plans
        self.positions, self.passed, self.reduce = positions, passed, reduce
        self.tiles = tree_util.leaves(blk)
        self.slots = [{} for _ in self.tiles]
        self.tuple = False

    def body(self, anchor):
        """The block's function with its leaves gathered first, inside the
        checkpoint: the gathered leaves are never saved for the backward,
        which gathers them again."""
        def run(*args):
            leaves = [_GatheredLeaf.apply(anchor, x, p, slot)
                      for x, p, slot in zip(self.tiles, self.plans, self.slots)]
            return self.fn(TensorTree(tree_util.unflatten(self.blk, leaves)), *args)

        return run

    def reduce_all(self):
        """Each leaf's gradient (zeros where the rank's loss read none of it:
        a rank with no heads of the block) reduced into its tile, in tree
        order, so every rank issues the same collectives."""
        for i, slot in zip(self.positions, self.slots):
            g = slot.pop("grad", None)
            if g is None:
                shape, dtype = slot["like"]
                g = torch.zeros(shape, dtype=dtype, device=self.tiles[0].device)
            self.reduce(i, g)


class _Block(torch.autograd.Function):
    """A block as one node of the step's graph.  The forward runs the block
    under its checkpoint wrapper on detached inputs, with grad enabled
    inside; the backward runs the block's own backward
    (``torch.autograd.grad`` from its outputs to its inputs and to the
    gathers' anchor: the checkpoint gathers the leaves again there), then
    reduces every leaf of the block, once the block's input gradient
    exists.  ``anchor`` (a scalar that requires grad) keeps the node in the
    step's graph where no input requires grad (the encoder's frames).

    The inputs at ``call.passed`` (after the first, requiring grad: the
    encoder's output, which every decoder block reads) are also passed on,
    identity outputs the next block takes in their place: the gradient then
    reaches each block with the later blocks' sum, which the block's own
    uses add to in the order the whole graph's backward adds them."""

    @staticmethod
    def forward(ctx, call, anchor, *args):
        ins = [x.detach().requires_grad_(x.requires_grad) if torch.is_tensor(x) else x
               for x in args]
        inner = torch.zeros((), device=anchor.device, requires_grad=True)
        with torch.enable_grad():
            out = call.ck(call.body(inner), *ins)
            outs = out if isinstance(out, tuple) else (out,)
            passed = tuple(ins[i].view_as(ins[i]) for i in call.passed)
        call.tuple = isinstance(out, tuple)
        ctx.call, ctx.ins, ctx.outs, ctx.inner = call, ins, outs + passed, inner
        return tuple(o.detach() if torch.is_tensor(o) else o for o in outs + passed)

    @staticmethod
    def backward(ctx, *gs):
        pairs = [(o, g) for o, g in zip(ctx.outs, gs)
                 if torch.is_tensor(o) and o.requires_grad and g is not None]
        wanted = [torch.is_tensor(x) and x.requires_grad for x in ctx.ins]
        got = torch.autograd.grad([o for o, _ in pairs],
                                  [x for x, w in zip(ctx.ins, wanted) if w] + [ctx.inner],
                                  [g for _, g in pairs], allow_unused=True)
        ctx.outs = ctx.ins = None
        ctx.call.reduce_all()
        got = iter(got)
        return (None, None, *[next(got) if w else None for w in wanted])


def make_train_step(model: Model, opt: AdamW, step_cfg: StepConfig,
                    mesh: Mesh | None = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` (the model's ``nn.Module``) is updated in place and returned.
    With ``microbatches`` k > 1 the batch's leading axis splits into k
    microbatches whose gradients accumulate as ``grad.float() / k`` into
    float32 buffers, in order, as the reference's scan does (the gradients
    come from ``torch.autograd.grad``: no ``.grad`` field accumulates).
    ``metrics`` holds ``loss`` (the microbatches' mean), ``grad_norm`` and
    ``lr``, as tensors on the device.

    With a ``mesh`` the step is FSDP × TP: ``params`` and the moments of
    ``opt_state`` hold this rank's tiles
    (:func:`repro_torch.runtime.trainer.Trainer` makes them), ``batch`` the
    slice of the global batch of its index over the dp axes (ranks that
    differ only in their model index hold the same slice).  Each leaf is
    gathered over the dp axes — and over the model axis as
    :func:`leaf_plans` says — where it is used, a block at a time, as the
    reference's scan over its checkpointed layers does.  For each
    microbatch the top-level leaves (:func:`block_leaves`: the embedding,
    a tied table once for both its uses, the final norms, the unembedding)
    are gathered at the loss's start and held to its end; each block's
    leaves are gathered inside the body that ``StepConfig.remat``
    checkpoints, so they are never saved for the backward, and gathered
    again when the backward recomputes the block (with ``remat`` False they
    live from the block's forward to its backward).  Once a block's
    backward is done, each of its leaves' gradients is cast to float32,
    scaled by ``1/k``, reduce-scattered into its float32 mean over the dp
    ranks (:func:`~repro_torch.parallel.sharding.reduce_gradient`, which
    first sums over the model axis what the plan reads in part) and added
    into the rank's float32 tile of the step's gradient — the leaves of a
    block in tree order, zeros for a leaf the rank's loss did not read, so
    that every rank issues the same collectives; the top-level leaves'
    after the microbatch's backward.  A rank thus holds its tiles, their
    moments and float32 gradient tiles, the top-level leaves and one
    block's gathered leaves with their gradients; and it issues, each
    microbatch, one gather of every top-level leaf, one of every block leaf
    (two under ``remat``), one reduce of every leaf — and the layers' own
    collectives over the model axis and the moe's over the dp axes —; then,
    once a step, the loss's mean and the clip's sums.  The hand-written
    kernels run at the rank's batch and head counts.  The update runs on
    the tiles; the global-norm clip sums each leaf's squares over the axes
    its tile is split over, so a replicated leaf counts once.  ``loss`` is
    the mean of the dp ranks' losses.  On a world of one every collective
    is the identity, so the step gives the unsharded step's bits.

    With ``compression`` other than "none" the mesh step keeps the whole
    gradient instead: it gathers every leaf at once, runs the loss, and
    compresses each leaf's local float32 gradient before it is
    reduce-scattered — the compression rounds each tensor of the
    reference's stacked layout (top-k and int8's scale span every layer of
    a group), which a block at a time cannot see.
    """
    k = step_cfg.microbatches

    def microbatch(batch, i):
        return {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
                for key, x in batch.items()} if k > 1 else batch

    def grads_of(params, plist, batch):
        """(loss, the gradient of every leaf of ``plist``): zeros for a leaf
        the loss does not read (on a mesh, a rank with no heads of an
        attention block reads neither its KV head nor qk-norm's scales)."""
        loss, _ = model.loss(params, batch, remat=step_cfg.remat)
        grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(plist, grads)]

    def local_grads(params, batch):
        """(loss, gradient tree) of ``batch`` at ``params``."""
        params.requires_grad_(True)
        tree = params.tree()
        plist = tree_util.leaves(tree)
        if k > 1:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in plist]
            losses = []
            for i in range(k):
                loss, grads = grads_of(params, plist, microbatch(batch, i))
                for a, g in zip(acc, grads):
                    a.add_(g.float() / k)
                losses.append(loss)
                del grads
            grads, loss = acc, torch.stack(losses).mean()
        else:
            loss, grads = grads_of(params, plist, batch)
        grads = tree_util.unflatten(tree, list(grads))
        if step_cfg.compression != "none":
            grads = compress_decompress(grads, step_cfg.compression)
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = local_grads(params, batch)
        params, opt_state, om = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}

    if mesh is None:
        return train_step
    check_executable(mesh, "train")
    plans = leaf_plans(model, mesh, "train")
    split = [_split_axes(p) for p in plans]
    batch_ax = batch_axes(mesh)
    n_batch = math.prod(mesh.shape[a] for a in batch_ax)
    top, _ = block_leaves(model.param_shapes())

    def sum_squares(sq: list) -> list:
        """Each leaf's sum of squares over the whole gradient: the tiles'
        partial sums added over the axes each leaf is split over (one
        all-reduce for each set of axes; a replicated leaf's is whole)."""
        sq = list(sq)
        for axes in dict.fromkeys(a for a in split if a):
            idx = [i for i, a in enumerate(split) if a == axes]
            tot = _all_reduce_sum(torch.stack([sq[i] for i in idx]), mesh, axes)
            for j, i in enumerate(idx):
                sq[i] = tot[j]
        return sq

    def update(shards, opt_state, grads, loss):
        loss = _all_reduce_sum(loss, mesh, batch_ax) / n_batch
        shards, opt_state, om = opt.update(tree_util.unflatten(shards, grads),
                                           opt_state, shards, sum_squares=sum_squares)
        return shards, opt_state, {"loss": loss, **om}

    def whole_step(shards, opt_state, batch):
        with use_mesh(mesh):
            full = module_like(shards, [gather_for_use(x, p) for x, p in
                                        zip(tree_util.leaves(shards), plans)])
            loss, grads = local_grads(full, batch)
            del full
            grads = [reduce_gradient(g, p)
                     for g, p in zip(tree_util.leaves(grads), plans)]
            return update(shards, opt_state, grads, loss)

    def block_loss(shards, tiles, batch, reduce):
        """One microbatch's loss, its gradients reduced into the tiles as
        its backward goes (a block's once the block's is done, the
        top-level leaves' at the end).  Nothing it gathers outlives it."""
        gathered = {i: gather_for_use(tiles[i], plans[i]) for i in top}
        params = module_like(shards, [gathered.pop(i, x) for i, x in enumerate(tiles)])
        plist = tree_util.leaves(params)
        position = {id(x): i for i, x in enumerate(plist)}
        heads = [plist[i].requires_grad_(True) for i in top]
        anchor = torch.zeros((), device=tiles[0].device, requires_grad=True)
        passing = {}  # an input the blocks share: its latest pass

        def run_block(ck, fn, blk, *args):
            pos = [position[id(x)] for x in tree_util.leaves(blk)]
            shared = [i for i, x in enumerate(args) if i and torch.is_tensor(x)
                      and x.requires_grad]
            call = _BlockCall(ck, fn, blk, [plans[i] for i in pos], pos, shared, reduce)
            out = _Block.apply(call, anchor, *[passing.get(id(x), x) for x in args])
            n = len(out) - len(call.passed)
            for i, x in zip(call.passed, out[n:]):
                passing[id(args[i])] = x
            return out[:n] if call.tuple else out[0]

        loss, _ = model.loss(params, batch, remat=step_cfg.remat, run_block=run_block)
        grads = torch.autograd.grad(loss, heads + [anchor], allow_unused=True)
        for i, x, g in zip(top, heads, grads):
            reduce(i, torch.zeros_like(x) if g is None else g)
        return loss.detach()

    def block_step(shards, opt_state, batch):
        with use_mesh(mesh):
            tiles = tree_util.leaves(shards)
            acc = [None] * len(tiles)
            if k > 1:  # the unsharded step's sum, from zeros in order
                acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
                       for x in tiles]

            def reduce(i, g):
                g = g.float() / k if k > 1 else g.float()
                r = reduce_gradient(g, plans[i])
                acc[i] = r if acc[i] is None else acc[i].add_(r)

            losses = [block_loss(shards, tiles, microbatch(batch, mb), reduce)
                      for mb in range(k)]
            loss = torch.stack(losses).mean() if k > 1 else losses[0]
            return update(shards, opt_state, acc, loss)

    step = whole_step if step_cfg.compression != "none" else block_step
    step.plans = plans
    return step


def make_serve_step(model: Model, ring: bool = False, mesh: Mesh | None = None,
                    cache_sh=None, logits: bool = False):
    """(params, cache, token, pos) -> (next_token (B, 1), cache).  ``ring``:
    the cache is a sliding-window ring (``init_cache(..., window_cache=True)``).
    With ``logits`` the step also returns the logits (B, 1, V) it chose from.

    With a ``mesh``, ``params`` are this rank's tiles (each leaf that decode
    reads, :func:`decode_reads`, gathered as :func:`leaf_plans` says, as
    :func:`make_prefill_step` does), ``token``
    its dp slice, and ``cache`` its tile of every cache leaf, placed by
    ``cache_sh`` (:func:`cache_tile_shardings`; :func:`shard_cache` cuts a
    whole cache into them).  Each leaf stays in its tile: attention's
    partial softmaxes are combined over the cache's sequence axes, the
    recurrent layers update their share of the state, and no collective
    moves a cache leaf.  The greedy token is chosen over the vocabulary's
    shares (:func:`_vocab_argmax`) where the vocabulary is split; the
    logits are then this rank's share (B, 1, V / model).  The cache's tiles
    are updated in place (a state leaf replaced in its dict)."""
    if mesh is None:
        @torch.inference_mode()
        def serve_step(params, cache, token, pos):
            out, cache = model.decode(params, cache, token, pos, ring=ring)
            tok = out[:, -1].argmax(dim=-1, keepdim=True).int()
            return (tok, cache, out) if logits else (tok, cache)

        return serve_step
    check_executable(mesh, "decode")
    if cache_sh is None:
        raise ValueError("a serve step on a mesh takes the cache's tile shardings "
                         "(cache_tile_shardings)")
    plans = leaf_plans(model, mesh, "decode")
    reads = decode_reads(model)

    @torch.inference_mode()
    def sharded_serve(shards, cache, token, pos):
        with use_mesh(mesh):
            full = module_like(shards, [gather_for_use(x, p) if r else x for x, p, r in
                                        zip(tree_util.leaves(shards), plans, reads)])
            out, cache = model.decode(full, cache, token, pos, ring=ring,
                                      shardings=cache_sh)
            last = out[:, -1]
            if last.shape[-1] != model.cfg.vocab:
                tok = _vocab_argmax(last, mesh)
            else:
                tok = last.argmax(dim=-1, keepdim=True).int()
        return (tok, cache, out) if logits else (tok, cache)

    sharded_serve.plans = plans
    return sharded_serve


def decode_reads(model: Model) -> list:
    """Whether a decode step reads each parameter leaf (in
    ``tree_util.leaves`` order): every leaf but the encoder's, whose output
    the cache holds (``enc_out``).  A sharded serve step gathers only these,
    as the reference's compiled step keeps only the gathers it uses."""
    return [not p.startswith("enc_") for p in sh.param_paths(model.param_shapes())]


def _vocab_argmax(last: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The greedy token (B, 1) from logits (B, V / model) of this rank's
    share of the vocabulary: each rank's best (value, id), gathered over the
    model axis; the lowest id wins a tie, as ``argmax`` does."""
    val, idx = last.float().max(dim=-1)
    idx = idx + sh.tp_rank() * last.shape[-1]
    pairs = all_gather(torch.stack([val, idx.float()], dim=-1)[None], 0, mesh, ("model",))
    best = pairs[..., 0].argmax(dim=0)  # the first (lowest-rank) maximum
    return pairs[..., 1].gather(0, best[None])[0, :, None].int()


def make_prefill_step(model: Model, mesh: Mesh | None = None, logits: bool = False):
    """(params, batch) -> the greedy next token (B, 1) after the prompt.
    With ``logits`` the step also returns the logits (B, S, V) of every
    position.  With a ``mesh``, ``params`` are this rank's tiles and
    ``batch`` its dp slice: each leaf is gathered as :func:`leaf_plans`
    says, the Megatron layers run on their tiles, and the greedy token is
    chosen over the vocabulary's shares (:func:`_vocab_argmax`); the logits
    are then this rank's share (B, S, V / model)."""

    if mesh is None:
        @torch.inference_mode()
        def prefill_step(params, batch):
            out = model.forward(params, batch)
            tok = out[:, -1].argmax(dim=-1, keepdim=True).int()
            return (tok, out) if logits else tok

        return prefill_step
    check_executable(mesh, "prefill")
    plans = leaf_plans(model, mesh, "prefill")

    @torch.inference_mode()
    def sharded_prefill(shards, batch):
        with use_mesh(mesh):
            full = module_like(shards, [gather_for_use(x, p) for x, p in
                                        zip(tree_util.leaves(shards), plans)])
            out = model.forward(full, batch)
            last = out[:, -1]
            if last.shape[-1] != model.cfg.vocab:
                tok = _vocab_argmax(last, mesh)
            else:
                tok = last.argmax(dim=-1, keepdim=True).int()
        return (tok, out) if logits else tok

    sharded_prefill.plans = plans
    return sharded_prefill


# ---------------------------------------------------------------------------
# sharding assignment
# ---------------------------------------------------------------------------

def _dp_for(mesh: Mesh, n: int):
    """dp axes if they divide n (or n divides them evenly enough): else None."""
    axes = dp_axes(mesh)
    size = 1
    for a in axes:
        size *= mesh.shape[a]
    if n % size == 0:
        return axes
    return None


def _map_named(tree, fn, path=()):
    """``fn(path, leaf)`` over a tree of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _map_named(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def input_shardings(mesh: Mesh, cfg: ArchConfig, shape: ShapeConfig, specs) -> dict:
    """A :class:`NamedSharding` per leaf of ``Model.input_specs``."""
    dp = _dp_for(mesh, shape.global_batch)

    def assign(name, leaf):
        nd = len(leaf.shape)
        if name == "cache":
            raise AssertionError  # handled by cache_shardings
        if name in ("tokens", "labels", "mask", "token"):
            spec = P(dp, *([None] * (nd - 1)))
        elif name in ("patches", "frames"):
            spec = P(dp, "model", None)
        else:
            spec = P(*([None] * nd))
        return NamedSharding(mesh, fit_spec(mesh, leaf.shape, spec))

    out = {}
    for key, leaf in specs.items():
        if key == "cache":
            out[key] = cache_shardings(mesh, cfg, shape, leaf)
        else:
            out[key] = assign(key, leaf)
    return out


def _cache_spec(mesh: Mesh, dp, name: str, shape) -> P:
    """The reference's spec of the stacked cache leaf ``name`` of ``shape``
    (``dp``: the dp axes when they divide the batch, else ``None``)."""
    nd = len(shape)
    if name in ("k", "v"):  # (L, B, S, KV, hd)
        if dp is not None:
            spec = P(None, dp, "model", None, None)
        else:
            # batch too small (long_500k): context-parallel over everything
            spec = P(None, None, tuple(dp_axes(mesh)) + ("model",), None, None)
    elif name == "s":  # SSM state (L, B, H, N, P)
        spec = P(None, dp, "model", None, None)
        if shape[2] % mesh.shape["model"]:
            spec = P(None, dp, None, "model", None)  # shard N instead of H
    elif name == "conv":  # (L, B, K-1, convdim)
        spec = P(None, dp, None, "model")
    elif name == "h":  # rec state (L, B, dr)
        spec = P(None, dp, "model")
    elif name == "enc_out":  # (B, T, d)
        if dp is not None:
            spec = P(dp, "model", None)
        else:
            spec = P(None, tuple(dp_axes(mesh)) + ("model",), None)
    else:
        spec = P(*([None] * nd))
    return fit_spec(mesh, shape, spec)


def cache_shardings(mesh: Mesh, cfg: ArchConfig, shape: ShapeConfig, cache_shapes):
    """Decode-cache shardings in the reference's (stacked) layout: (L, B, S,
    KV, hd) KV caches, SSM/recurrent states, the encoder's output."""
    dp = _dp_for(mesh, shape.global_batch)

    def assign(path, leaf):
        name = str(path[-1]) if path else ""
        return NamedSharding(mesh, _cache_spec(mesh, dp, name, tuple(leaf.shape)))

    return _map_named(cache_shapes, assign)


def cache_tile_shardings(mesh: Mesh, cfg: ArchConfig, shape: ShapeConfig, cache):
    """The :class:`NamedSharding` of every leaf of a whole decode cache in
    the port's per-layer layout (``Model.init_cache``; tensors on ``meta``
    serve), in its structure: the reference's spec of the stacked leaf
    (:func:`cache_shardings`' rule, on the shape with its leading layer
    counts) without its leading layer entries, as :func:`param_shardings`
    does for parameters."""
    dp = _dp_for(mesh, shape.global_batch)
    out = []
    for path, layers, leaf in sh._param_leaves(cache):
        spec = _cache_spec(mesh, dp, str(path[-1]), tuple(layers) + tuple(leaf.shape))
        out.append(NamedSharding(mesh, P(*spec[len(layers):])))
    return tree_util.unflatten(cache, out)


def shard_cache(cache, mesh: Mesh, cfg: ArchConfig, shape: ShapeConfig):
    """This rank's tile of every leaf of a whole decode cache (per-layer
    layout), placed by :func:`cache_tile_shardings`: copies (a whole leaf
    too), so a step's in-place writes touch the tiles alone."""
    tiles = tree_util.leaves_of(cache_tile_shardings(mesh, cfg, shape, cache))
    return tree_util.unflatten(cache, [sh.shard_tensor(x, t).clone()
                                       for x, t in zip(tree_util.leaves(cache), tiles)])


def init_cache_tiles(model: Model, mesh: Mesh, shape: ShapeConfig, fill=None,
                     **cache_kw):
    """This rank's tile of every leaf of the decode cache
    ``model.init_cache(shape.global_batch, shape.seq_len, **cache_kw)``,
    made one leaf at a time in the cache's leaf order: the whole leaf
    (zeros, then ``fill(name, leaf)`` writes it in place; ``name`` its key),
    cut as :func:`shard_cache` cuts it, and dropped before the next.  The
    tiles equal :func:`shard_cache` of the whole cache filled leaf by leaf
    in the same order, with one whole leaf held at a time."""
    spec = Model(model.cfg, torch.device("meta")).init_cache(
        shape.global_batch, shape.seq_len, **cache_kw)
    tiles = tree_util.leaves_of(cache_tile_shardings(mesh, model.cfg, shape, spec))
    out = []
    for (path, _, leaf), tile in zip(sh._param_leaves(spec), tiles):
        whole = torch.zeros(leaf.shape, dtype=leaf.dtype, device=model.device)
        if fill is not None:
            fill(next(str(k) for k in reversed(path) if isinstance(k, str)), whole)
        out.append(sh.shard_tensor(whole, tile))
    return tree_util.unflatten(spec, out)


def train_state_shardings(mesh: Mesh, model: Model, opt: AdamW):
    """(param shardings, opt-state shardings) from the FSDP/TP rules: the
    moments shard as their parameters, the step count is replicated."""
    with use_mesh(mesh):
        pshard = param_shardings(mesh, model.param_shapes())
    oshard = AdamWState(step=NamedSharding(mesh, P()), mu=pshard, nu=pshard)
    return pshard, oshard
