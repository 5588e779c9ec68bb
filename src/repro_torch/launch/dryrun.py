"""Multi-pod dry run: every (architecture × shape × production mesh) cell's
step, run on ``meta`` tensors as rank 0 of a virtual mesh — the counterpart
of ``repro/launch/dryrun.py``.

For each cell this:
  1. builds the production mesh (16×16 single-pod / 2×16×16 multi-pod) as a
     virtual mesh (names and sizes, no card: it executes ``meta`` tensors);
  2. builds the parameters on ``meta`` (``Model.param_shapes``), rank 0's
     tiles of them (and of AdamW's moments) by ``param_shardings``, and rank
     0's slice of the inputs (``input_specs``, ``input_shardings``);
  3. runs the REAL step of the shape's kind — ``make_train_step`` (AdamW,
     microbatched accumulation, remat, FSDP × TP), ``make_prefill_step`` or
     ``make_serve_step`` (one token against rank 0's tile of every cache
     leaf, ``shard_cache``) — once under
     :func:`repro_torch.runtime.hlo_cost.measure_step`: the flops per
     device, an unfused bound on the bytes, and every collective the step
     issues, with its replica groups;
  4. projects the collectives onto the pod-level traffic matrix handed to
     Gemini's controller, which must equal the one counted from the specs
     and the step's plan alone (:func:`planned_collectives`; a cell whose
     matrices differ is ``failed``).

The port compiles no HLO, so its collectives are the ones its step issues by
hand (:mod:`repro_torch.parallel.sharding`), not XLA's, on XLA's schedule
for a scan over checkpointed layers: a training step gathers each block's
leaves where the block runs, once a microbatch and again when the backward
recomputes it, and reduce-scatters each leaf's gradient once a microbatch
(``make_train_step``); a decode step also combines each
attention's partial softmaxes over its cache's sequence axes, which span
the pods where the batch cannot take the dp axes (long_500k).  Cells the
reference skips are ``skipped`` with ``supports_cell``'s reason.  Records go to
``build/dryrun/<arch>__<shape>__pod{1,2}[__tag].json`` in the checkout.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape long_500k --window-cache
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--force]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

__all__ = ["RESULTS", "MICROBATCHES", "CACHE_DTYPES", "cell_path", "run_cell",
           "planned_collectives", "held_param_bytes", "peak_param_bytes", "main"]

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"

# per-arch microbatch counts for train_4k (the reference's: memory fit at 256 chips)
MICROBATCHES = {"dbrx-132b": 8, "qwen3-14b": 8, "gemma3-12b": 8, "llama3-8b": 8,
                "deepseek-7b": 8, "mixtral-8x7b": 8, "recurrentgemma-9b": 8,
                "seamless-m4t-large-v2": 4, "internvl2-1b": 4, "mamba2-130m": 4}

# ``--cache-dtype``: the decode cache's dtype by the reference's names
# ("" and "bf16": the model's own)
CACHE_DTYPES = {"": None, "bf16": None, "f8": "float8_e4m3fn", "f32": "float32"}


def cell_path(arch: str, shape: str, multi_pod: bool, tag: str = "") -> pathlib.Path:
    mesh = "pod2" if multi_pod else "pod1"
    suffix = f"__{tag}" if tag else ""
    return RESULTS / f"{arch}__{shape}__{mesh}{suffix}.json"


def _bytes(tree) -> int:
    from repro_torch.runtime.hlo_cost import _tensor_bytes

    return _tensor_bytes(tree)


def planned_collectives(model, mesh, kind: str = "train", shape=None,
                        window_cache: bool = False, microbatches: int = 1,
                        remat: bool = True) -> list:
    """The collectives over the dp axes that a step of ``kind`` issues on
    ``mesh``, in the step's order, counted from ``param_shardings`` and the
    step's plan alone (no step runs), and the plan's own over the model
    axis.  Gathering a leaf is its tile gathered over the dp axes it is
    split over, then over the model axis as its ``LeafPlan`` says (whole,
    or over a block of ranks: a replicated KV head, an unequal share of the
    heads); reducing its gradient is the plan's float32 sum over the model
    axis (a leaf read in part, a block's reduce-scatter), then the float32
    gradient reduce-scattered over the dp axes it is split over (all-reduced
    over those it is not).

    Prefill gathers every leaf once, decode every leaf decode reads.  A
    training step (``make_train_step``'s schedule, as the reference's scan
    over its checkpointed layers) does, for each of ``microbatches``: every
    top-level leaf gathered (``steps.block_leaves``), every block's leaves
    gathered in block order, then, from the last block to the first, the
    block's leaves gathered again under ``remat`` (the checkpointed body
    runs again in the backward) and each of its leaves' gradients reduced;
    then the top-level leaves' gradients reduced.  Each moe layer, in each
    of its forwards, gathers each dp rank's expert counts where the batch's
    tokens a dispatch exceed 256 (``moe._offsets``; with ``shape``) and
    takes the load-balancing loss's means over the dp ranks
    (``moe._aux_loss``); a prefill's moe layers the counts too.  Once a
    step: the loss's mean and the clip's sums of squares.  Decode
    (``shape`` the cell's ``ShapeConfig``, ``window_cache`` its cache's
    knob) adds every attention's softmax combined over its cache's sequence
    axes, in layer order: the row max, the sum of exponentials and the
    products with v, float32, for each of the rank's rows and heads.  These
    are the step's only collectives whose groups can span pods; the model
    axis's stay inside one (the layers' own — ``tp_copy``, ``tp_reduce``
    and the like — are not counted here)."""
    import math

    import torch

    from repro_torch.launch.steps import (_split_axes, block_leaves, cache_tile_shardings,
                                          decode_reads, leaf_plans)
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_traffic import DTYPE_NAMES, CollectiveOp, _DTYPE_BYTES

    batch = sh.batch_axes(mesh)
    ops = []

    def op(kind_, numel, dtype, axes, block=None):
        groups = mesh.groups(axes, block).tolist()
        name = DTYPE_NAMES[str(dtype).removeprefix("torch.")]
        ops.append(CollectiveOp(kind_, int(numel) * _DTYPE_BYTES[name], len(groups[0]),
                                groups, name))

    m = mesh.shape.get("model", 1)
    plans = leaf_plans(model, mesh, kind)
    shapes = model.param_shapes()
    leaves = tree_util.leaves(shapes)
    tiles = [sh.shard_tensor(x, p.sharding).shape for x, p in zip(leaves, plans)]

    def gather(i):
        leaf, plan = leaves[i], plans[i]
        shape_ = list(tiles[i])
        for dim, names in sh._sharded_dims(plan.sharding, batch):
            shape_[dim] *= math.prod(mesh.shape[a] for a in names)
            op("all-gather", math.prod(shape_), leaf.dtype, names)
        tile = math.prod(shape_)  # the model tile, whole along the dp dims
        if plan.mode == "gathered" or (plan.model_sum and plan.tp_dim is not None):
            op("all-gather", tile * m, leaf.dtype, ("model",))
        elif plan.block > 1:
            op("all-gather", tile * plan.block, leaf.dtype, ("model",), plan.block)

    def reduce(i):
        plan, tile = plans[i], tiles[i]
        split = sh._sharded_dims(plan.sharding, batch)
        shape_ = list(tile)  # the gradient: whole along the dp dims
        for dim, names in split:
            shape_[dim] *= math.prod(mesh.shape[a] for a in names)
        if plan.model_sum:  # into the tile: a reduce-scatter, or an all-reduce
            op("all-reduce" if plan.tp_dim is None else "reduce-scatter",
               math.prod(shape_), torch.float32, ("model",))
        elif plan.block > 1:
            op("reduce-scatter", math.prod(shape_), torch.float32, ("model",), plan.block)
        for dim, names in split:
            shape_[dim] = tile[dim]
            op("reduce-scatter", math.prod(shape_), torch.float32, names)
        done = {a for _, names in split for a in names}
        rest = tuple(a for a in batch if a not in done and mesh.shape[a] > 1)
        if rest:
            op("all-reduce", math.prod(tile), torch.float32, rest)

    cfg = model.cfg
    dp = tuple(a for a in batch if mesh.shape[a] > 1)
    n_dp = math.prod(mesh.shape[a] for a in dp)

    def moe_layer(train: bool):
        """A moe layer's forward: the expert counts' gather (a dispatch over
        several dp ranks), then, training, the load-balancing means."""
        if cfg.family != "moe" or not dp:
            return
        if shape is not None:
            tokens = shape.global_batch * shape.seq_len // (microbatches if train else 1)
            groups = max(1, cfg.moe_groups) if cfg.moe_impl == "sorted" else 1
            if groups < n_dp and tokens // groups > 256:
                op("all-gather", n_dp * cfg.n_experts, torch.float32, dp)
        if train:
            op("all-reduce", 2 * cfg.n_experts, torch.float32, dp)

    if kind != "train":
        reads = decode_reads(model) if kind == "decode" else [True] * len(leaves)
        for i, read in enumerate(reads):
            if read:
                gather(i)
        if kind == "prefill":
            for _ in range(cfg.n_layers):
                moe_layer(False)
            return ops
        whole = model.init_cache(shape.global_batch, shape.seq_len, enc_len=shape.seq_len,
                                 window_cache=window_cache)
        cache_sh = cache_tile_shardings(mesh, cfg, shape, whole)
        attn = [t for (path, _, _), t in zip(sh._param_leaves(whole),
                                             tree_util.leaves_of(cache_sh)) if path[-1] == "k"]
        if cfg.family == "audio":  # each decoder layer: self, then cross attention
            attn = [t for self_kv in attn for t in (self_kv, cache_sh["enc_out"])]
        heads = cfg.n_heads
        for t in attn:
            axes = sh.dim_axes(t, 1)
            if axes:
                rows = shape.global_batch // math.prod(mesh.shape[a] for a in
                                                       sh.dim_axes(t, 0))
                op("all-reduce", rows * heads, torch.float32, axes)  # the row max
                op("all-reduce", rows * heads, torch.float32, axes)  # the sum
                op("all-reduce", rows * heads * cfg.resolved_head_dim, torch.float32, axes)
        return ops
    top, blocks = block_leaves(shapes)
    for _ in range(microbatches):
        for i in top:
            gather(i)
        for blk in blocks:
            for i in blk:
                gather(i)
            moe_layer(True)
        for blk in reversed(blocks):
            if remat:
                for i in blk:
                    gather(i)
                moe_layer(True)
            for i in blk:
                reduce(i)
        for i in top:
            reduce(i)
    if dp:
        op("all-reduce", 1, torch.float32, batch)  # the loss
    split = [_split_axes(p) for p in plans]
    for axes in dict.fromkeys(a for a in split if a):
        if set(axes) & set(batch):  # the clip's sums of squares
            op("all-reduce", sum(a == axes for a in split), torch.float32, axes)
    return ops


def peak_param_bytes(model, mesh, kind: str = "train") -> tuple:
    """(parameter bytes, float32 gradient bytes) a device holds gathered at
    once in a step of ``kind`` on ``mesh``, from the shapes alone (rank 0's
    tiles on ``meta``).  Training (``make_train_step``'s schedule): the
    top-level leaves (``steps.block_leaves``) and the largest block, as its
    layer takes them, and a float32 gradient of each; prefill and decode
    gather every leaf they read at once (:func:`held_param_bytes`)."""
    from repro_torch.launch.steps import block_leaves, leaf_plans
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    if kind != "train":
        return held_param_bytes(model, mesh, kind)
    plans = leaf_plans(model, mesh, kind)
    shapes = model.param_shapes()
    leaves = tree_util.leaves(shapes)
    with sh.use_mesh(mesh):
        used = [sh.gather_for_use(sh.shard_tensor(x, p.sharding), p)
                for x, p in zip(leaves, plans)]
    top, blocks = block_leaves(shapes)

    def nbytes(idx):
        return _bytes([used[i] for i in idx]), 4 * sum(used[i].numel() for i in idx)

    largest = max(blocks, key=lambda b: nbytes(b)[0], default=[])
    return tuple(a + b for a, b in zip(nbytes(top), nbytes(largest)))


def held_param_bytes(model, mesh, kind: str = "train") -> tuple:
    """(gathered parameter bytes, float32 gradient bytes) a step of
    ``kind`` on ``mesh`` reads on a device as its layers take them: every
    leaf the step reads (at decode,
    :func:`~repro_torch.launch.steps.decode_reads`) as ``gather_for_use``
    makes it of rank 0's tile (on ``meta``: no step runs), and a float32
    gradient of each in training (0 otherwise).  A training step does not
    hold them all at once: it gathers a block at a time
    (:func:`peak_param_bytes`)."""
    from repro_torch.launch.steps import decode_reads, leaf_plans
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    plans = leaf_plans(model, mesh, kind)
    leaves = tree_util.leaves(model.param_shapes())
    reads = decode_reads(model) if kind == "decode" else [True] * len(plans)
    with sh.use_mesh(mesh):
        used = [sh.gather_for_use(sh.shard_tensor(x, p.sharding), p)
                for x, p, r in zip(leaves, plans, reads) if r]
    grads = 4 * sum(x.numel() for x in used) if kind == "train" else 0
    return _bytes(used), grads


def run_cell(arch: str, shape_name: str, multi_pod: bool, force: bool = False,
             profile: str = "fsdp", microbatches: int | None = None,
             remat: str = "full", window_cache: bool = False,
             cache_dtype: str = "", moe_impl: str = "", moe_groups: int = 0,
             ssd_chunk: int = 0, tag: str = "") -> dict:
    """One dry-run cell.  The keyword knobs are the reference's: sharding
    profile, microbatch count, remat policy, decode's cache (a ring of the
    window for a pure sliding-window architecture, its dtype by
    :data:`CACHE_DTYPES`' names), moe dispatch and groups, SSD chunk;
    ``tag`` names the variant's record file.  The cache knobs shape a
    decode cell's cache alone: a train or prefill cell raises on them.  A
    record on disk is returned unless ``force``."""
    from repro_torch.models.config import ALL_SHAPES

    shape = {s.name: s for s in ALL_SHAPES}[shape_name]
    if (window_cache or cache_dtype) and shape.kind != "decode":
        raise ValueError(f"window_cache and cache_dtype shape a decode cell's cache; "
                         f"{shape_name} is a {shape.kind} cell")
    out_path = cell_path(arch, shape_name, multi_pod, tag)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import (StepConfig, cache_tile_shardings,
                                          input_shardings, leaf_plans,
                                          make_prefill_step, make_serve_step,
                                          make_train_step, module_like, shard_cache,
                                          tp_report)
    from repro_torch.models.api import Model, supports_cell
    from repro_torch.optim import tree as tree_util
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_cost import measure_step
    from repro_torch.runtime.hlo_traffic import collective_summary, pod_traffic_matrix

    cfg = get_arch(arch)
    ok, why = supports_cell(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": 512 if multi_pod else 256,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }

    def write(rec):
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=2))
        return rec

    if not ok:
        record.update(status="skipped", reason=why)
        return write(record)

    if moe_impl:
        cfg = dataclasses.replace(cfg, moe_impl=moe_impl)
        if moe_groups:
            cfg = dataclasses.replace(cfg, moe_groups=moe_groups)
    if ssd_chunk:
        cfg = dataclasses.replace(cfg, ssd_chunk=ssd_chunk)
    model = Model(cfg, torch.device("meta"))
    mesh = make_production_mesh(multi_pod=multi_pod)
    record.update(profile=profile, remat=remat)
    prev = sh.get_profile()
    sh.set_profile(profile)
    t0 = time.time()
    try:
        plans = leaf_plans(model, mesh, shape.kind)
        shapes = model.param_shapes()
        shards = module_like(shapes, [sh.shard_tensor(x, p.sharding)
                                      for x, p in zip(tree_util.leaves(shapes), plans)])
        cdt = CACHE_DTYPES[cache_dtype] and getattr(torch, CACHE_DTYPES[cache_dtype])
        specs = model.input_specs(shape, cache_dtype=cdt, window_cache=window_cache)
        cache = specs.pop("cache", None)
        in_sh = input_shardings(mesh, cfg, shape, specs)
        batch = {k: sh.shard_tensor(v, in_sh[k], sh.batch_axes(mesh))
                 for k, v in specs.items()}
        gathered, grad_bytes = held_param_bytes(model, mesh, shape.kind)
        peak_gathered, peak_grads = peak_param_bytes(model, mesh, shape.kind)
        cache_bytes = 0
        if shape.kind == "train":
            opt = AdamW()
            mb = microbatches or MICROBATCHES.get(arch, 8)
            step = make_train_step(model, opt, StepConfig(
                microbatches=mb, remat="dots" if remat == "dots" else True), mesh)
            ostate = opt.init(shards)
            record.update(microbatches=mb)
            args = (shards, ostate, batch)
            out_bytes = _bytes(tree_util.leaves(shards)) + _bytes(ostate)
        elif shape.kind == "prefill":
            step = make_prefill_step(model, mesh)
            args = (shards, batch)
            out_bytes = _bytes(torch.empty((next(iter(batch.values())).shape[0], 1),
                                           dtype=torch.int32, device="meta"))
        else:  # decode: one token against rank 0's tile of every cache leaf
            ring = bool(window_cache and cfg.window and not cfg.local_global_ratio)
            whole = tree_util.unstacked(cache, model.init_cache(
                shape.global_batch, shape.seq_len, enc_len=shape.seq_len, dtype=cdt,
                window_cache=window_cache))
            tiles = shard_cache(whole, mesh, cfg, shape)
            step = make_serve_step(model, ring, mesh,
                                   cache_tile_shardings(mesh, cfg, shape, whole))
            record.update(window_cache=window_cache, cache_dtype=cache_dtype or "bf16",
                          ring=ring)
            args = (shards, tiles, batch["token"], shape.seq_len - 1)
            cache_bytes = _bytes(tiles)
            out_bytes = _bytes(batch["token"]) + cache_bytes
        cost = measure_step(step, *args)
        seconds = time.time() - t0
        ops = cost.collective_ops
        summary = collective_summary(ops)
        n_pods = 2 if multi_pod else 1
        tm = pod_traffic_matrix(ops, devices_per_pod=256, n_pods=n_pods)
        planned = pod_traffic_matrix(planned_collectives(
            model, mesh, shape.kind, shape, window_cache, record.get("microbatches", 1)),
            devices_per_pod=256, n_pods=n_pods)
        if not (tm == planned).all():
            raise ValueError(f"the step's pod matrix {tm.tolist()} differs from the one "
                             f"counted from the specs {planned.tolist()}")
        record.update(
            status="ok",
            seconds=seconds,
            flops=float(cost.flops),  # per device
            hbm_bytes=float(cost.hbm_bytes),
            unknown_trip_loops=cost.unknown_trip_loops,
            memory_analysis={
                "argument_bytes": _bytes(tree_util.leaves(args[0])) + _bytes(list(args[1:])),
                "output_bytes": out_bytes,
                "temp_bytes": None,
                "temp_bytes_why": "the step runs on meta tensors, which have no "
                                  "allocator to measure a peak",
                "gathered_param_bytes": gathered,
                "gradient_bytes": grad_bytes,
                "peak_gathered_param_bytes": peak_gathered,
                "peak_gradient_bytes": peak_grads,
                "cache_bytes": cache_bytes,
            },
            collectives=summary,
            pod_tm_bytes=tm.tolist(),
            n_collective_ops=len(ops),
            model_params=cfg.param_count(),
            model_params_active=cfg.active_param_count(),
            tensor_parallel=tp_report(model, plans),
            schedule="each block's leaves gathered where the block runs, once a "
                     "microbatch and again under remat; the top-level leaves once a "
                     "microbatch; each gradient reduce-scattered once a microbatch"
            if shape.kind == "train" else "each leaf gathered once a step",
        )
        print(f"[dryrun] OK  {arch} × {shape_name} × {record['mesh']} "
              f"({seconds:.1f}s, flops {record['flops']:.3g}, "
              f"wire/chip {summary['total_wire_bytes_per_chip']:.3g} B)")
    except Exception as exc:  # recorded and counted: each is a bug to fix
        record.update(status="failed", error=f"{type(exc).__name__}: {exc}",
                      traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] FAIL {arch} × {shape_name} × {record['mesh']}: {exc}")
    finally:
        sh.set_profile(prev)
    return write(record)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--profile", default="fsdp", choices=["fsdp", "fsdp_pod", "tp"])
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--remat", default="full", choices=["full", "dots"])
    ap.add_argument("--window-cache", action="store_true",
                    help="decode cells: a ring of the window for a pure "
                         "sliding-window architecture")
    ap.add_argument("--cache-dtype", default="", choices=list(CACHE_DTYPES),
                    help="decode cells: the cache's dtype")
    ap.add_argument("--moe-impl", default="", choices=["", "onehot", "sorted"])
    ap.add_argument("--ssd-chunk", type=int, default=0)
    ap.add_argument("--moe-groups", type=int, default=0)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCHS
    from repro_torch.models.config import ALL_SHAPES

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in ALL_SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else [args.multi_pod]

    kinds = {s.name: s.kind for s in ALL_SHAPES}
    counts = {"ok": 0, "skipped": 0, "failed": 0}
    slowest = (0.0, "")
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                knobs = (dict(window_cache=args.window_cache, cache_dtype=args.cache_dtype)
                         if kinds[shape] == "decode" else {})  # decode's cache alone
                rec = run_cell(arch, shape, multi_pod, force=args.force,
                               profile=args.profile,
                               microbatches=args.microbatches or None,
                               remat=args.remat, moe_impl=args.moe_impl,
                               moe_groups=args.moe_groups,
                               ssd_chunk=args.ssd_chunk, tag=args.tag, **knobs)
                counts[rec["status"]] = counts.get(rec["status"], 0) + 1
                if rec.get("seconds", 0.0) > slowest[0]:
                    slowest = (rec["seconds"], f"{arch} × {shape} × {rec['mesh']}")
    others = "".join(f", {n} {k}" for k, n in counts.items()
                     if k not in ("ok", "skipped", "failed"))
    print(f"[dryrun] done; {counts['ok']} ok, {counts['skipped']} skipped, "
          f"{counts['failed']} failures{others}; slowest {slowest[1]} {slowest[0]:.1f}s")
    raise SystemExit(1 if counts["failed"] else 0)


if __name__ == "__main__":
    main()
