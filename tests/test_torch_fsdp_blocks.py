"""The FSDP training step that gathers a block at a time
(``launch.steps.make_train_step`` on a mesh), as the reference's scan over
its checkpointed layers does, on ``gloo`` ranks of the CPU
(``repro_torch.launch.train.run_ranks``: one spawn of 4 ranks for each of
the 4×1, 2×2 and 1×4 host meshes, 480 s limit each).

* At most one block gathered: with ``sh.gather_for_use`` wrapped to keep a
  weak reference to every tensor it gathers, the reduced llama3 and
  gemma3 on 4×1 and 2×2 never hold, at any gather, gathered leaves of more
  than one block besides the top-level leaves, and hold none after the
  step.
* Bits against the all-at-once step: the mesh step before the block schedule —
  every leaf gathered at once, ``Model.loss``, ``torch.autograd.grad``,
  ``reduce_gradient`` of each leaf, ``AdamW.update`` with the clip's sums
  over the axes each tile is split over — is written here from public
  functions as the oracle.  At one microbatch the new step gives its bits
  (tiles, moments, loss and gradient norm after a step) for every
  config's ``reduced()`` in its own dtype, on 4×1, 2×2 and 1×4 (a tied
  table is gathered once for both its uses: bit-equal too).  At two
  microbatches, in float32 on 2×2, the tiles add the microbatches after
  the reduce where the oracle adds them before: within ``MULTI_F32_REL``.
* A rank with no heads: the reduced internvl2-1b with 3 heads on one KV
  head on 1×4 (rank 0 holds none, so its loss reads none of a block's
  attention leaves) trains through ``Trainer`` with its tiles drawn from
  the seed, and the collectives its ``gloo`` step records equal, op for op,
  the same step's on a virtual copy of the mesh
  (``Trainer.extract_traffic``).
* Against the reference: the reduced gemma3-12b (tied, its global layer
  among 5:1 locals at a query width other than d_model) and deepseek-7b
  (MHA), the dense features ``tests/test_torch_train.py`` holds, in
  float32 on 4×1 and 2×2, three steps at two microbatches from the
  reference's initial weights (``repro_torch.interop``), against the JAX
  reference's one-device ``make_train_step`` on the same global batches:
  ``test_torch_train.py``'s tolerances (the metrics at 1e-5 relative, the
  parameters and moments at 1e-5).
* A world of one: on ``make_host_mesh()`` without a process group every
  collective is the identity, and two steps give the unsharded step's
  bits for every config's ``reduced()`` at one and two microbatches.
* The streamed truth: ``chip_smoke._dense_truth`` (the 4-card entry's
  one-card truth of step 0, a block drawn, applied and freed at a time)
  against ``Model.loss`` and ``torch.autograd.grad`` of the whole reduced
  gemma3 and deepseek: the loss and each leaf's norm and projection
  within 1e-5.
* The peak count: ``dryrun.peak_param_bytes`` of gemma3-12b's train_4k on
  2×16×16 equals the count from the specs (the top-level leaves and the
  largest block, each leaf less its split over the model axis).
"""

import dataclasses
import functools
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch.train import run_ranks

torch.set_num_threads(1)

MESHES = {"4x1": 1, "2x2": 2, "1x4": 4}  # id: model axis of 4 gloo ranks
B, S, STEPS, REF_STEPS = 8, 16, 1, 3
MULTI_F32_REL = 1e-5  # chip_smoke.MULTI_F32_REL
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)  # test_torch_train.OPT
STEP_TOL = 1e-5  # test_torch_train.STEP_TOL
# the dense features reduced() hides (test_torch_train.DENSE_FEATURES)
DENSE_FEATURES = {"gemma3-12b": {"n_layers": 7, "window": 8, "head_dim": 48},
                  "deepseek-7b": {"n_kv_heads": 4}}
NO_HEADS = {"n_heads": 3, "n_kv_heads": 1}  # internvl2-1b on 1×4: 0, 1, 1, 1 heads
COUNTED = ("llama3-8b", "gemma3-12b")
_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(arch, dtype=None, over=None):
    from repro_torch.configs import get_arch

    over = dict(over or {})
    if dtype:
        over["dtype"] = dtype
    return dataclasses.replace(get_arch(arch).reduced(), **over)


def _numpy_batches(cfg, n, seed=3):
    """``n`` global batches (B sequences of S) from a numpy seed: tokens
    and labels, the audio family's frames and the vlm's patches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def _rank_batch(batch, cfg, mesh):
    """This rank's dp slice of a numpy global batch, as tensors (token ids
    int64, embeddings in the model's dtype)."""
    from repro_torch.parallel import sharding as sh

    rows = sh.tile_slice(B // mesh.shape["data"], mesh, ("data",))
    return {k: (torch.from_numpy(v[rows]).long() if v.dtype.kind == "i"
                else torch.from_numpy(v[rows]).to(getattr(torch, cfg.dtype)))
            for k, v in batch.items()}


def _oracle(model, opt, mesh, plans, k):
    """The all-at-once mesh step, from public functions: every leaf
    gathered (``gather_for_use``), the whole local gradient of the
    microbatches (``grad.float() / k`` summed from zeros for k > 1), then
    each leaf reduce-scattered (``reduce_gradient``) and the update on the
    tiles with the clip's squares summed over the axes each tile is split
    over."""
    from repro_torch.launch.steps import module_like
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    batch_ax = sh.batch_axes(mesh)
    split = [tuple(a for a in mesh.axis_names if any(
        a in sh.dim_axes(p.sharding, d) for d in range(len(p.sharding.spec))))
        for p in plans]

    def sum_squares(sq):
        return [sh.all_reduce(x, mesh, axes) if axes else x for x, axes in zip(sq, split)]

    def step(shards, state, batch):
        with sh.use_mesh(mesh):
            full = module_like(shards, [sh.gather_for_use(x, p) for x, p in
                                        zip(tree_util.leaves(shards), plans)])
            full.requires_grad_(True)
            plist = tree_util.leaves(full)
            acc, losses = None, []
            for i in range(k):
                mb = {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
                      for key, x in batch.items()} if k > 1 else batch
                loss, _ = model.loss(full, mb, remat=True)
                grads = torch.autograd.grad(loss, plist, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(plist, grads)]
                if k > 1:
                    acc = acc or [torch.zeros(p.shape, dtype=torch.float32) for p in plist]
                    for a, g in zip(acc, grads):
                        a.add_(g.float() / k)
                else:
                    acc = grads
                losses.append(loss.detach())
            red = [sh.reduce_gradient(g, p) for g, p in zip(acc, plans)]
            loss = torch.stack(losses).mean() if k > 1 else losses[0]
            loss = sh.all_reduce(loss, mesh, batch_ax) / math.prod(
                mesh.shape[a] for a in batch_ax)
            shards, state, om = opt.update(tree_util.unflatten(shards, red), state, shards,
                                           sum_squares=sum_squares)
        return shards, state, {"loss": loss, **om}

    return step


def _state(params, state) -> list:
    from repro_torch.optim import tree as tree_util

    return [x.detach().clone() for x in tree_util.leaves(params) + [state.step]
            + tree_util.leaves(state.mu) + tree_util.leaves(state.nu)]


def _run(step, model, opt, plans, batches, cfg, mesh):
    """Steps from fresh tiles (``init_tiles``): (state after them, metrics)."""
    from repro_torch.launch.steps import init_tiles

    params = init_tiles(model, plans)
    state = opt.init(params)
    metrics = []
    for batch in batches:
        params, state, m = step(params, state, _rank_batch(batch, cfg, mesh))
        metrics.append([m["loss"].clone(), m["grad_norm"].clone()])
    return _state(params, state), metrics


def _count_gathers(step, model, fn):
    """Run ``fn`` with ``launch.steps.gather_for_use`` keeping a weak
    reference to each tensor it gathers: (the most blocks whose gathered
    leaves were alive at a gather, the most top-level leaves, the gathered
    tensors alive after ``fn``)."""
    from torch.multiprocessing.reductions import StorageWeakRef

    from repro_torch.launch import steps

    top, blocks = steps.block_leaves(model.param_shapes())
    where = {id(step.plans[i]): -1 for i in top}
    where.update({id(step.plans[i]): b for b, blk in enumerate(blocks) for i in blk})
    live, worst = [], {"blocks": 0, "top": 0}
    orig = steps.gather_for_use

    def counted(x, plan):
        live[:] = [(b, r) for b, r in live if not r.expired()]
        worst["blocks"] = max(worst["blocks"], len({b for b, _ in live if b >= 0}))
        worst["top"] = max(worst["top"], sum(b < 0 for b, _ in live))
        out = orig(x, plan)
        if out.untyped_storage().data_ptr() != x.untyped_storage().data_ptr():
            live.append((where[id(plan)], StorageWeakRef(out.untyped_storage())))
        return out

    steps.gather_for_use = counted
    try:
        fn()
    finally:
        steps.gather_for_use = orig
    return worst["blocks"], worst["top"], sum(not r.expired() for _, r in live)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _logical(params, state, plans):
    """The whole parameters and moments gathered from every rank's tiles,
    as the reference's numpy trees (every rank calls it)."""
    from repro_torch import interop
    from repro_torch.launch.steps import module_like
    from repro_torch.optim import tree as tree_util
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.parallel import sharding as sh

    def whole(tree):
        return [sh.gather_tensor(x, p.sharding) for x, p in
                zip(tree_util.leaves(tree), plans)]

    full = module_like(params, whole(params))
    moments = AdamWState(step=state.step, mu=tree_util.unflatten(state.mu, whole(state.mu)),
                         nu=tree_util.unflatten(state.nu, whole(state.nu)))
    return interop.model_to_numpy(full), interop.adamw_state_to_numpy(moments)


def _blocks_rank(rank, world, model_axis, refs):
    from repro_torch import interop
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (StepConfig, init_tiles, leaf_plans,
                                          make_train_step, module_like)
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    mesh = make_host_mesh(model_axis=model_axis)
    out = {"bits": {}, "microbatches": {}, "gathers": {}, "reference": {}}
    for arch in ARCHS:
        for dtype, k in ((None, 1), ("float32", 2))[:2 if model_axis == 2 else 1]:
            cfg = _cfg(arch, dtype)
            model = build_model(cfg, "cpu")
            plans = leaf_plans(model, mesh)
            batches = _numpy_batches(cfg, STEPS)
            opt = AdamW(**OPT)
            step = make_train_step(model, opt, StepConfig(microbatches=k), mesh)
            got, gm = _run(step, model, opt, plans, batches, cfg, mesh)
            want, wm = _run(_oracle(model, opt, mesh, plans, k), model, opt, plans, batches,
                            cfg, mesh)
            if k == 1:
                out["bits"][arch] = all(
                    a.dtype == w.dtype and torch.equal(a, w)
                    for a, w in zip(got + sum(gm, []), want + sum(wm, [])))
            else:
                out["microbatches"][arch] = max(
                    float((a.float() - w.float()).abs().max()
                          / max(float(w.float().abs().max()), 1e-30))
                    for a, w in zip(got + sum(gm, []), want + sum(wm, [])) if w.numel())
        if arch in COUNTED and model_axis < 4:
            cfg = _cfg(arch)
            model = build_model(cfg, "cpu")
            opt = AdamW(**OPT)
            step = make_train_step(model, opt, StepConfig(microbatches=2), mesh)
            params = init_tiles(model, step.plans)
            state = opt.init(params)
            batch = _rank_batch(_numpy_batches(cfg, 1)[0], cfg, mesh)
            out["gathers"][arch] = _count_gathers(step, model,
                                                  lambda: step(params, state, batch))
    for arch, (params_np, batches, over) in refs.items():
        cfg = _cfg(arch, "float32", over)
        model = build_model(cfg, "cpu")
        opt = AdamW(**OPT)
        step = make_train_step(model, opt, StepConfig(microbatches=2), mesh)
        net = interop.model_from_numpy(cfg, params_np, device="cpu").tree()
        shapes = model.param_shapes()  # the reference's keys in init's order
        params = module_like(shapes, [sh.shard_tensor(_at(net, path), p.sharding)
                                      for (path, _, _), p in
                                      zip(sh._param_leaves(shapes), step.plans)])
        state = opt.init(params)
        metrics = []
        for batch in batches:
            params, state, m = step(params, state, _rank_batch(batch, cfg, mesh))
            metrics.append({key: float(v) for key, v in m.items()})
        logical = _logical(params, state, step.plans)
        out["reference"][arch] = (metrics, logical if rank == 0 else None)
    if model_axis == 4:
        out["no_heads"] = _no_heads(rank, mesh)
    return out


def _no_heads(rank, mesh):
    """The reduced internvl2-1b with 3 heads on one KV head, through
    ``Trainer`` on 1×4: rank 0 holds no head.  (the rank's heads, its
    losses, whether its recorded step equals the virtual mesh's op for op,
    the op count)."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import StepConfig, init_tiles
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_traffic import record_collectives
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = _cfg("internvl2-1b", "float32", NO_HEADS)
    model = build_model(cfg, "cpu")
    with tempfile.TemporaryDirectory() as ck:
        tr = Trainer(model, AdamW(**OPT), mesh,
                     DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B),
                     StepConfig(microbatches=2), TrainerConfig(total_steps=2), ck)
        params = init_tiles(model, tr._step_fn.plans)
        state = tr.opt.init(params)
        patches = _numpy_batches(cfg, 1)[0]["patches"]
        losses = []
        for i in range(2):
            batch = tr._device_batch(SyntheticLM(tr.data_config()).batch_at(i))
            batch["patches"] = torch.from_numpy(patches)
            if i == 1:
                tr.extract_traffic(params, state, batch)
                with record_collectives() as real:
                    params, state, m = tr._step_fn(params, state, batch)
            else:
                params, state, m = tr._step_fn(params, state, batch)
            losses.append(float(m["loss"]))
    key = [(o.kind, o.result_bytes, o.group_size, o.groups, o.dtype) for o in real]
    want = [(o.kind, o.result_bytes, o.group_size, o.groups, o.dtype)
            for o in tr.collective_ops]
    return {"heads": sh.head_range(cfg.n_heads, mesh.shape["model"], rank),
            "losses": losses, "ops_equal": key == want, "n_ops": len(key)}


@functools.cache
def _references():
    """For each dense feature config: (the reference's initial weights as
    numpy, the global batches, the config's overrides) to hand the ranks,
    and the reference's metrics, parameters and moments after
    ``REF_STEPS`` steps at two microbatches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.launch.steps import StepConfig as RefStepConfig
    from repro.launch.steps import make_train_step as ref_make_train_step
    from repro.models.api import build_model as ref_build_model
    from repro.optim.adamw import AdamW as RefAdamW

    inputs, results = {}, {}
    for arch, over in DENSE_FEATURES.items():
        over = dict(over)
        ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), dtype="float32", **over)
        assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(_cfg(arch, "float32", over))
        ref_model = ref_build_model(ref_cfg)
        params = ref_model.init(jax.random.key(0))
        params_np = jax.tree_util.tree_map(np.asarray, params)
        batches = _numpy_batches(ref_cfg, REF_STEPS, seed=5)
        opt = RefAdamW(**OPT)
        state = opt.init(params)
        step = jax.jit(ref_make_train_step(ref_model, opt,
                                           RefStepConfig(microbatches=2, remat=True)))
        metrics = []
        for batch in batches:
            params, state, m = step(params, state, {k: jnp.asarray(v) for k, v in
                                                    batch.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        inputs[arch] = (params_np, batches, over)
        results[arch] = (metrics, jax.tree_util.tree_map(np.asarray, params),
                         jax.tree_util.tree_map(np.asarray, state.mu),
                         jax.tree_util.tree_map(np.asarray, state.nu))
    return inputs, results


@functools.cache
def _ranks(mesh_id):
    refs = _references()[0] if mesh_id != "1x4" else {}
    return run_ranks(_blocks_rank, 4, MESHES[mesh_id], refs, backend="gloo", timeout=480)


@pytest.mark.parametrize("arch", COUNTED)
@pytest.mark.parametrize("mesh_id", ["4x1", "2x2"])
def test_at_most_one_block_is_gathered(mesh_id, arch):
    from repro_torch.launch.steps import block_leaves
    from repro_torch.models.api import Model

    top, _ = block_leaves(Model(_cfg(arch), torch.device("meta")).param_shapes())
    for r in _ranks(mesh_id):
        blocks, tops, after = r["gathers"][arch]
        assert blocks == 1 and 0 < tops <= len(top) and after == 0, (blocks, tops, after)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_one_microbatch_is_bit_equal_to_the_all_at_once_step(mesh_id, arch):
    assert all(r["bits"][arch] for r in _ranks(mesh_id)), (mesh_id, arch)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_two_microbatches_match_the_all_at_once_step(arch):
    worst = max(r["microbatches"][arch] for r in _ranks("2x2"))
    assert worst <= MULTI_F32_REL, (arch, worst)


def test_a_rank_with_no_heads_trains_and_records_the_virtual_collectives():
    ranks = [r["no_heads"] for r in _ranks("1x4")]
    assert [h1 - h0 for h0, h1 in (r["heads"] for r in ranks)] == [0, 1, 1, 1]
    assert all(r["ops_equal"] and r["n_ops"] > 0 for r in ranks)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    assert np.isfinite(ranks[0]["losses"]).all()


def _close(ours, theirs, label):
    import jax

    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(ours)), label
    for path, leaf in flat:
        mine = ours
        for p in path:
            mine = mine[p.key]
        np.testing.assert_allclose(mine, np.asarray(leaf, np.float32), rtol=STEP_TOL,
                                   atol=STEP_TOL, err_msg=f"{label} {path}")


@pytest.mark.parametrize("arch", sorted(DENSE_FEATURES))
@pytest.mark.parametrize("mesh_id", ["4x1", "2x2"])
def test_dense_features_match_the_reference_train_step(mesh_id, arch):
    metrics, params, mu, nu = _references()[1][arch]
    ranks = _ranks(mesh_id)
    for r in ranks:
        for a, b in zip(r["reference"][arch][0], metrics):
            for key in b:
                assert abs(a[key] - b[key]) <= STEP_TOL * (1 + abs(b[key])), (key, a, b)
    ours, moments = ranks[0]["reference"][arch][1]
    assert int(moments["step"]) == REF_STEPS
    _close(ours, params, "params")
    _close(moments["mu"], mu, "mu")
    _close(moments["nu"], nu, "nu")


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_a_world_of_one_gives_the_unsharded_steps_bits(arch, k):
    """On a mesh of one rank (``make_host_mesh()`` without a process group)
    every collective is the identity: two steps of the block-at-a-time step
    give the unsharded step's bits, at one and at two microbatches, in the
    config's own dtype."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig, make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW

    cfg = _cfg(arch)
    model = build_model(cfg, "cpu")
    mesh = make_host_mesh()
    runs = []
    for m in (None, mesh):
        opt = AdamW(**OPT)
        step = make_train_step(model, opt, StepConfig(microbatches=k), m)
        params = model.init(0)
        state = opt.init(params)
        for batch in _numpy_batches(cfg, 2):
            params, state, metrics = step(params, state, _rank_batch(batch, cfg, mesh))
        runs.append(_state(params, state) + [metrics["loss"], metrics["grad_norm"]])
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("arch", sorted(DENSE_FEATURES))
def test_streamed_truth_matches_the_whole_model(arch):
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    dp, k = 2, 2
    cfg = dataclasses.replace(cs._train_cfg(f"{arch}-reduced", None, "float32"),
                              **DENSE_FEATURES[arch])
    train_cfg = cs._train_cfg
    cs._train_cfg = lambda *a: cfg
    try:
        truth = cs._dense_truth(arch, B, S, dp, k, cpu)
    finally:
        cs._train_cfg = train_cfg
    model = build_model(cfg, cpu)
    params = model.init(0)
    params.requires_grad_(True)
    loss, _ = model.loss(params, cs._global_batch(cfg, B, S, 0, 4, cpu), remat=False)
    grads = torch.autograd.grad(loss, tree_util.leaves(params))
    want = np.asarray([cs._grad_reading(g, j) for j, g in enumerate(grads)])
    got = np.asarray(truth["reads"])
    norms = np.sqrt(want[:, 0])
    loss = float(loss.detach())
    assert abs(truth["loss"] - loss) <= 1e-6 * abs(loss)
    assert (np.abs(np.sqrt(got[:, 0]) - norms) <= 1e-5 * norms).all()
    assert (np.abs(got[:, 1] - want[:, 1]) <= 1e-5 * norms).all()
    assert (norms > 0).all() and len(got) == len(tree_util.leaves(params))


def test_peak_param_bytes_counts_the_top_level_leaves_and_one_block():
    """gemma3-12b on 2×16×16: its tied table's 262,144 words over the 16
    model ranks and the final norm, and one block (each of its 8 KV heads
    on 2 of the 16 model ranks; qk-norm's scales whole), in bf16, and a
    float32 gradient of each."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.api import Model
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    model = Model(get_arch("gemma3-12b"), torch.device("meta"))
    mesh = make_production_mesh(multi_pod=True)
    shapes = model.param_shapes()
    with sh.use_mesh(mesh):
        specs = tree_util.leaves_of(sh.param_shardings(mesh, shapes))
    numel = 0
    for path, x, s in zip(sh.param_paths(shapes), tree_util.leaves(shapes), specs):
        split = math.prod(16 for entry in s.spec if entry == "model")
        share = x.numel() // split * (2 if path.endswith(("/wk", "/wv")) else 1)
        numel += share
    layers = model.cfg.n_layers
    top = 262_144 * 3840 // 16 + 3840
    per_block = (numel - top) // layers
    assert numel == top + per_block * layers
    assert dryrun.peak_param_bytes(model, mesh, "train") == (2 * (top + per_block),
                                                             4 * (top + per_block))
    rec = dryrun.held_param_bytes(model, mesh, "train")
    assert rec == (2 * numel, 4 * numel)
