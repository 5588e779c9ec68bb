"""Tensor parallelism of the layers the reference's rules split over "tp"
beyond attention, SwiGLU and the vocabulary: the moe's experts (expert
parallelism, one-hot and sorted dispatch), the SSD block on its heads, the
RG-LRU block on its channels, the encoder-decoder's encoder block,
decoder block and cross attention on their heads, and its logits with a
vocabulary of 510 (vocab-parallel on 1×2; row-parallel over d on 1×4,
which does not divide it).  And attention and the SSD block on unequal
shares of their heads, where the model axis does not divide them: model
rank ``r`` of ``m`` runs heads ``[⌊r·H/m⌋, ⌊(r+1)·H/m⌋)``
(``sharding.head_range``), read from its block of ``m / gcd(H, m)`` ranks'
tiles (``LeafPlan.heads``) — self-attention at (H, KV) = (10, 2) with
qk-norm (2, 3, 2, 3 heads a rank on 1×4: qwen3-14b's pattern on 16),
(14, 2) (3, 4, 3, 4: internvl2-1b on 4) and (3, 1) (0, 1, 1, 1: a rank
with no head, as internvl2-1b's on 16), the SSD block at 6 heads (1, 2, 1,
2: mamba2-130m's 24 on 16); a leaf a rank does not read gets a zero
gradient, as ``make_train_step``'s.

Each layer runs on ``gloo`` ranks of a 1×2 and a 1×4 mesh
(``make_host_mesh(model_axis=...)``) as a training step runs it: the rank's
tiles of the reduced float32 model (``leaf_plans``), ``gather_for_use``, the
layer under ``use_mesh``, a loss that is the output's inner product with a
numpy-seeded cotangent (plus 0.37 × the moe's load-balancing loss), the
backward, and ``reduce_gradient`` into each tile; the tiles' gradients are
then gathered into the logical leaves.  Contract: the output, the aux loss,
every parameter gradient of the block and the input gradients (the encoder
output's too) within ``REL`` of one rank's unsharded layer, each relative
to the largest magnitude of its own reference, on every rank; and the
output within ``REL`` of the reference package's function on the same
numpy parameters (``repro.models.moe.moe_ffn_onehot`` /
``moe_ffn_sorted``, ``repro.models.ssd.ssd_block``,
``repro.models.rglru.recurrent_block``, ``repro.models.encdec._dec_block``,
``repro.models.attention.self_attention``).
The gradient traps these catch: the router's gradient through the combine
(the gate values pass ``tp_copy``), the aux loss (the same on every rank,
not summed), SSD's B and C columns of ``w_in`` (read by every rank: their
gradient is a sum of partials), and the gated norm's sum of squares over
d_inner (summed over the model axis with a backward that sums too).

The moe on a (2, 2) mesh, each dp rank routing its slice of a batch that
overflows an expert's capacity: its rows and the dp mean of its gradients
equal one rank's on the whole batch (capacity, cumulative-sum positions and
the aux loss's means are the whole batch's, as the reference's sharded step
computes them).

Also the plans themselves (on ``meta``, no step): on the 2×2 and 1×4 host
meshes no leaf of mixtral-8x7b, mamba2-130m, recurrentgemma-9b,
seamless-m4t-large-v2, internvl2-1b or qwen3-14b is gathered whole; for
the ten configs at model axes of 2, 4 and 16 the head ranges partition the
heads, never cross a KV group where the axis is a multiple of the KV head
count, equal the even split where the axis divides the heads, and the
plans mark ``heads`` exactly where it does not.  The ranks are spawned
processes with a 240 s limit.
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.train import run_ranks
from repro_torch.models.api import Model, build_model
from repro_torch.optim import tree as tree_util

torch.set_num_threads(1)

REL = 1e-5

# name: (arch, block path in the parameter tree, batch, sequence, encoder
# length (0: no encoder input)); moe_onehot at 384 tokens drops past its
# capacity (1.25·384·2/4 = 240), moe_sorted at 128 in two groups
LAYERS = {
    "moe_onehot": ("mixtral-8x7b", ("blocks", 0, "moe"), 2, 192, 0),
    "moe_sorted": ("dbrx-132b", ("blocks", 0, "moe"), 2, 64, 0),
    "ssd": ("mamba2-130m", ("blocks", 0, "ssd"), 2, 64, 0),
    "rglru": ("recurrentgemma-9b", ("super", 0, "rec1", "rec"), 2, 32, 0),
    "enc_block": ("seamless-m4t-large-v2", ("enc_blocks", 0), 2, 16, 0),
    "dec_block": ("seamless-m4t-large-v2", ("dec_blocks", 0), 2, 16, 24),
    "cross_attention": ("seamless-m4t-large-v2", ("dec_blocks", 0, "xattn"), 2, 16, 24),
    "logits": ("seamless-m4t-large-v2", ("unembed",), 2, 16, 0),
    "attn_10_2_qknorm": ("qwen3-14b", ("blocks", 0, "attn"), 2, 64, 0),
    "attn_14_2": ("internvl2-1b", ("blocks", 0, "attn"), 2, 64, 0),
    "attn_3_1": ("llama3-8b", ("blocks", 0, "attn"), 2, 64, 0),
    "ssd_6": ("mamba2-130m", ("blocks", 0, "ssd"), 2, 64, 0),
}
MESHES = (2, 4)  # the model axis of a 1×m mesh
# the unequal-share layers: their config overrides and each rank's heads on 1×4
UNEVEN = {"attn_10_2_qknorm": ({"n_heads": 10, "n_kv_heads": 2}, [2, 3, 2, 3]),
          "attn_14_2": ({"n_heads": 14, "n_kv_heads": 2}, [3, 4, 3, 4]),
          "attn_3_1": ({"n_heads": 3, "n_kv_heads": 1}, [0, 1, 1, 1]),
          "ssd_6": ({"d_model": 192, "ssd_chunk": 32}, [1, 2, 1, 2])}


def _cfg(name):
    over = {"dtype": "float32"}
    if name == "moe_sorted":
        over.update(moe_impl="sorted", moe_groups=2)
    if name == "ssd":
        over.update(ssd_chunk=32)  # two chunks: the state carried across
    if name == "logits":  # 510 = 2·255: vocab-parallel on 1×2, row-parallel on 1×4
        over.update(vocab=510)
    over.update(UNEVEN.get(name, ({}, None))[0])
    return dataclasses.replace(get_arch(LAYERS[name][0]).reduced(), **over)


def _inputs(name, cfg):
    """The layer's inputs from a numpy seed: x (and the encoder output),
    and the output's cotangent."""
    _, _, b, s, t = LAYERS[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32) if t else None
    ct = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return x, enc, ct


def _at(tree, path):
    for key in path:
        tree = tree[key] if isinstance(key, int) else getattr(tree, key)
    return tree


def _apply(name, full, cfg, x, enc, ct):
    """(output, aux loss or None, loss) of the layer ``name`` of the model
    ``full``: the loss is the output's inner product with ``ct`` (plus 0.37
    × the aux loss), or the logits' cross-entropy (their vocab-parallel
    loss where the vocabulary is split; the output is then gathered)."""
    from repro_torch.models import attention, encdec, layers, moe, rglru, ssd, transformer
    from repro_torch.parallel import sharding as sh

    blk = _at(full, LAYERS[name][1])
    aux = None
    if name.startswith("moe"):
        out, aux = getattr(moe, f"moe_ffn_{name[4:]}")(blk, x, cfg)
    elif name.startswith("ssd"):
        out = ssd.ssd_block(blk, x, cfg, chunk=cfg.ssd_chunk)
    elif name.startswith("attn"):
        out = attention.self_attention(blk, x, cfg)
    elif name == "rglru":
        out = rglru.recurrent_block(blk, x)
    elif name == "enc_block":
        out = encdec._enc_block(blk, x, cfg)
    elif name == "dec_block":
        out = encdec._dec_block(blk, x, enc, cfg)
    elif name == "cross_attention":
        out = attention.cross_attention(blk, x, enc, cfg)
    else:
        logits = transformer._project_logits(full, x, cfg)
        labels = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab, x.shape[:2]))
        if logits.shape[-1] != cfg.vocab:
            loss = layers.vocab_parallel_cross_entropy(logits, labels)
            logits = sh.all_gather(logits.detach(), 2, sh.active_mesh(), ("model",))
        else:
            loss = layers.softmax_cross_entropy(logits, labels)
        return logits, None, loss
    loss = (out * torch.from_numpy(ct)).sum()
    return out, aux, loss if aux is None else loss + 0.37 * aux


def _block_leaves(model, path):
    """Indices (in ``tree_util.leaves`` order) and names of the block's
    leaves."""
    from repro_torch.parallel import sharding as sh

    out = []
    for i, (p, _, _) in enumerate(sh._param_leaves(model.param_shapes())):
        if tuple(p[:len(path)]) == tuple(path):
            out.append((i, "/".join(str(k) for k in p[len(path):])))
    return out


def _run(name, leaves, cfg, mesh=None):
    """Forward and backward of the layer: (output, aux, {leaf: gradient of
    the leaf as used, zeros where the layer reads none}, input gradients),
    all with ``leaves`` the used parameter leaves of the whole model."""
    from repro_torch.launch.steps import module_like
    from repro_torch.parallel import sharding as sh

    model_path = LAYERS[name][1]
    x_np, enc_np, ct = _inputs(name, cfg)
    x = torch.from_numpy(x_np).requires_grad_()
    enc = None if enc_np is None else torch.from_numpy(enc_np).requires_grad_()
    full = module_like(_shapes_model(cfg).param_shapes(), [v.detach() for v in leaves])
    full.requires_grad_(True)
    used = tree_util.leaves(full)
    idx = [i for i, _ in _block_leaves(_shapes_model(cfg), model_path)]
    ctx = sh.use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
    with ctx:
        out, aux, loss = _apply(name, full, cfg, x, enc, ct)
        wrt = [used[i] for i in idx] + [x] + ([enc] if enc is not None else [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(w) if g is None else g for w, g in zip(wrt, grads)]
    return (out.detach(), None if aux is None else float(aux.detach()), grads[:len(idx)],
            [g.numpy() for g in grads[len(idx):]])


def _shapes_model(cfg):
    return Model(cfg, torch.device("meta"))


def _rank(rank, world, names):
    """Every layer of ``names`` on this rank of a 1×world mesh: output, aux,
    the block's gradients reduced into the tiles and gathered whole, the
    input gradients."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import leaf_plans
    from repro_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    mesh = make_host_mesh(model_axis=world)
    out = {}
    for name in names:
        cfg = _cfg(name)
        model = build_model(cfg, "cpu")
        params = tree_util.leaves(model.init(0))
        plans = leaf_plans(model, mesh)
        with sh.use_mesh(mesh):
            used = [sh.gather_for_use(sh.shard_tensor(x, p.sharding), p)
                    for x, p in zip(params, plans)]
        y, aux, grads, dins = _run(name, used, cfg, mesh)
        block = _block_leaves(model, LAYERS[name][1])
        idx = {leaf: i for i, leaf in block}
        whole = {}
        for (i, leaf), g in zip(block, grads):
            tile = sh.reduce_gradient(g, plans[i])
            whole[leaf] = sh.gather_tensor(tile, plans[i].sharding).numpy()
        out[name] = {"y": y.numpy(), "aux": aux, "grads": whole, "dins": dins,
                     "modes": {leaf: plans[i].mode for i, leaf in block},
                     "uneven": sorted(leaf for i, leaf in block if plans[i].heads)}
        if name in UNEVEN:  # the heads this rank ran: its wq or w_out share
            i, dim, size = ((idx["w_out"], 0, 64) if name.startswith("ssd")
                            else (idx["wq"], 1, cfg.resolved_head_dim))
            out[name]["heads"] = used[i].shape[dim] // size
    return out


_RESULTS = {}


def _sharded(m):
    """The ranks' results on the 1×m mesh (one start of the ranks for
    every layer)."""
    if m not in _RESULTS:
        _RESULTS[m] = run_ranks(_rank, m, list(LAYERS), backend="gloo", timeout=240)
    return _RESULTS[m]


def _one_rank(name):
    cfg = _cfg(name)
    model = build_model(cfg, "cpu")
    y, aux, grads, dins = _run(name, tree_util.leaves(model.init(0)), cfg)
    block = _block_leaves(model, LAYERS[name][1])
    return y.numpy(), aux, {leaf: g.numpy() for (_, leaf), g in zip(block, grads)}, dins


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= REL, (what, err)


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_one_rank(name, m):
    y, aux, grads, dins = _one_rank(name)
    ranks = _sharded(m)
    assert any(mode == "megatron" for mode in ranks[0][name]["modes"].values())
    assert "gathered" not in ranks[0][name]["modes"].values()
    if name in UNEVEN and m == 4:
        assert [r[name]["heads"] for r in ranks] == UNEVEN[name][1]
        assert ranks[0][name]["uneven"] == (["w_out"] if name.startswith("ssd")
                                            else ["wo", "wq"])
    for r in ranks:
        got = r[name]
        _close(got["y"], y, "output")
        if aux is not None:
            assert got["aux"] == pytest.approx(aux, rel=REL), (got["aux"], aux)
        assert set(got["grads"]) == set(grads)
        for leaf, g in grads.items():
            _close(got["grads"][leaf], g, leaf)
        for i, (a, b) in enumerate(zip(got["dins"], dins)):
            _close(a, b, f"input {i}")


def _jax_tree(module):
    import jax.numpy as jnp

    tree = tree_util.as_tree(module)
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().numpy())


REF_LAYERS = ("moe_onehot", "moe_sorted", "ssd", "rglru", "dec_block", *UNEVEN)


@pytest.mark.parametrize("m", MESHES)
@pytest.mark.parametrize("name", REF_LAYERS)
def test_layer_matches_reference(name, m):
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.models import attention as ref_attention
    from repro.models import encdec as ref_encdec
    from repro.models import moe as ref_moe
    from repro.models import rglru as ref_rglru
    from repro.models import ssd as ref_ssd

    cfg = _cfg(name)
    ref_cfg = dataclasses.replace(ref_get_arch(LAYERS[name][0]).reduced(),
                                  **{f.name: getattr(cfg, f.name)
                                     for f in dataclasses.fields(cfg)})
    p = _jax_tree(_at(build_model(cfg, "cpu").init(0), LAYERS[name][1]))
    x, enc, _ = _inputs(name, cfg)
    x = jnp.asarray(x)
    if name.startswith("moe"):
        want = getattr(ref_moe, f"moe_ffn_{name[4:]}")(p, x, ref_cfg)[0]
    elif name.startswith("ssd"):
        want = ref_ssd.ssd_block(p, x, ref_cfg, chunk=cfg.ssd_chunk)
    elif name.startswith("attn"):
        want = ref_attention.self_attention(p, x, ref_cfg)
    elif name == "rglru":
        want = ref_rglru.recurrent_block(p, x)
    else:
        want = ref_encdec._dec_block(p, x, jnp.asarray(enc), ref_cfg)
    for r in _sharded(m):
        _close(r[name]["y"], np.asarray(want), "output against the reference")


# the moe on a (2, 2) mesh: each dp rank routes its two of four sequences
# (384 tokens in all, activations shifted towards expert 0 so that it
# overflows its capacity of 1.25·384·2/4 = 240), dispatched as one card
# dispatches the whole batch; (impl, moe_groups)
DP_MOE = {"dp_onehot": ("onehot", 1), "dp_sorted": ("sorted", 1)}
DP_B, DP_S = 4, 96


def _dp_cfg(name):
    impl, groups = DP_MOE[name]
    return dataclasses.replace(get_arch("mixtral-8x7b").reduced(), dtype="float32",
                               moe_impl=impl, moe_groups=groups)


def _dp_inputs(cfg, router):
    rng = np.random.default_rng(11)
    r0 = router[:, 0].numpy().astype(np.float64)
    x = rng.normal(0, 1, (DP_B, DP_S, cfg.d_model)) + 3.0 * r0 / np.linalg.norm(r0)
    ct = rng.standard_normal((DP_B, DP_S, cfg.d_model))
    return x.astype(np.float32), ct.astype(np.float32)


def _dp_run(name, leaves, cfg, rows, mesh=None, scale=1.0):
    """The moe layer on batch rows ``rows`` (the loss: ``scale`` × their
    inner product with the cotangent plus 0.37 × the aux loss): (output,
    aux, gradients of the block's leaves, input gradient)."""
    from repro_torch.launch.steps import module_like
    from repro_torch.models import moe
    from repro_torch.parallel import sharding as sh

    full = module_like(_shapes_model(cfg).param_shapes(), [v.detach() for v in leaves])
    full.requires_grad_(True)
    used = tree_util.leaves(full)
    idx = [i for i, _ in _block_leaves(_shapes_model(cfg), ("blocks", 0, "moe"))]
    blk = full.blocks[0].moe
    x_np, ct = _dp_inputs(cfg, blk.router.detach())
    x = torch.from_numpy(x_np[rows]).requires_grad_()
    with sh.use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        out, aux = moe.moe_ffn(blk, x, cfg)
        loss = scale * (out * torch.from_numpy(ct[rows])).sum() + 0.37 * aux
        grads = torch.autograd.grad(loss, [used[i] for i in idx] + [x])
    return out.detach().numpy(), float(aux.detach()), grads[:-1], grads[-1].numpy()


def _dp_rank(rank, world, names):
    """Each dp-sliced moe case on this rank of the (2, 2) mesh: its rows'
    output and input gradient, the aux loss, and the block's gradients
    reduced into the tiles (the mean over the dp ranks) and gathered whole."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import leaf_plans
    from repro_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    mesh = make_host_mesh(model_axis=2)
    rows = sh.tile_slice(DP_B // mesh.shape["data"], mesh, ("data",))
    out = {}
    for name in names:
        cfg = _dp_cfg(name)
        model = build_model(cfg, "cpu")
        plans = leaf_plans(model, mesh)
        with sh.use_mesh(mesh):
            used = [sh.gather_for_use(sh.shard_tensor(x, p.sharding), p)
                    for x, p in zip(tree_util.leaves(model.init(0)), plans)]
        y, aux, grads, dx = _dp_run(name, used, cfg, rows, mesh)
        block = _block_leaves(model, ("blocks", 0, "moe"))
        whole = {leaf: sh.gather_tensor(sh.reduce_gradient(g, plans[i]),
                                        plans[i].sharding).numpy()
                 for (i, leaf), g in zip(block, grads)}
        out[name] = {"rows": (rows.start, rows.stop), "y": y, "aux": aux, "grads": whole,
                     "dx": dx}
    return out


@pytest.mark.parametrize("name", list(DP_MOE))
def test_moe_over_dp_ranks_dispatches_the_whole_batch(name):
    """Capacity and the cumulative-sum positions are the whole batch's, and
    the aux loss takes its means: on the whole batch, where expert 0
    overflows its capacity, one rank's loss is the mean of the dp ranks'
    (half its rows' inner product plus the aux loss), so the dp mean of the
    ranks' gradients equals its gradients, each rank's rows of the output
    equal its rows, and each rank's input gradient is twice its rows'."""
    from repro_torch.models import moe

    cfg = _dp_cfg(name)
    model = build_model(cfg, "cpu")
    leaves = tree_util.leaves(model.init(0))
    p = model.init(0).blocks[0].moe
    x_np, _ = _dp_inputs(cfg, p.router)
    idx = moe._route(p, torch.from_numpy(x_np).reshape(-1, cfg.d_model), cfg.top_k)[2]
    assert int(torch.bincount(idx.reshape(-1)).max()) > moe._capacity(cfg, 384, 384) == 240
    y, aux, grads, dx = _dp_run(name, leaves, cfg, slice(None), scale=0.5)
    block = _block_leaves(model, ("blocks", 0, "moe"))
    if "dp" not in _RESULTS:
        _RESULTS["dp"] = run_ranks(_dp_rank, 4, list(DP_MOE), backend="gloo", timeout=240)
    for r in _RESULTS["dp"]:
        got = r[name]
        rows = slice(*got["rows"])
        _close(got["y"], y[rows], "output")
        _close(got["dx"], 2 * dx[rows], "input")
        assert got["aux"] == pytest.approx(aux, rel=REL)
        for (_, leaf), g in zip(block, grads):
            _close(got["grads"][leaf], g.numpy(), leaf)


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-130m", "recurrentgemma-9b",
                                  "seamless-m4t-large-v2", "internvl2-1b", "qwen3-14b"])
def test_no_leaf_gathered_on_host_meshes(arch, shape):
    """At full width and reduced, on the 2×2 and 1×4 host meshes: every
    leaf the rules split over the model axis runs Megatron (internvl2-1b's
    14 heads on 1×4 on unequal shares)."""
    from repro_torch.launch.steps import leaf_plans, tp_report
    from repro_torch.parallel import sharding as sh

    mesh = sh.Mesh(shape, ("data", "model"))
    for cfg in (get_arch(arch), get_arch(arch).reduced()):
        model = Model(cfg, torch.device("meta"))
        plans = leaf_plans(model, mesh)
        report = tp_report(model, plans)
        assert report["gathered"] == [], (cfg.name, report["gathered"])
        split = {p for p, plan in zip(sh.param_paths(model.param_shapes()), plans)
                 if plan.tp_dim is not None}
        assert split and split <= set(report["megatron"]), (cfg.name, split)


@pytest.mark.parametrize("m", [2, 4, 16])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_head_ranges_partition_the_heads(arch, m):
    """The ranges cover every head once, in order; at most one head apart;
    inside one KV group where the axis is a multiple of the KV head count;
    the even split where the axis divides the heads; and the plan marks
    ``heads`` (with its block) exactly on the leaves whose heads the axis
    does not divide."""
    from repro_torch.launch.steps import leaf_plans
    from repro_torch.models.ssd import HEAD_P
    from repro_torch.parallel import sharding as sh

    cfg = get_arch(arch)
    groups = [("attn", cfg.n_heads, cfg.n_kv_heads)] if cfg.n_heads else []
    if cfg.family == "ssm":
        groups.append(("ssd", 2 * cfg.d_model // HEAD_P, 1))
    for _, h, kv in groups:
        ranges = [sh.head_range(h, m, r) for r in range(m)]
        assert ranges[0][0] == 0 and ranges[-1][1] == h
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        sizes = [hi - lo for lo, hi in ranges]
        assert max(sizes) - min(sizes) <= 1
        if h % m == 0:  # the Megatron split of equal shares
            assert ranges == [(r * (h // m), (r + 1) * (h // m)) for r in range(m)]
        if kv < m and m % kv == 0:  # rank r reads KV head r // (m / kv)
            for r, (lo, hi) in enumerate(ranges):
                assert all(j * kv // h == r // (m // kv) for j in range(lo, hi))
        b = m // math.gcd(h, m)  # a block of ranks holds whole heads
        for first in range(0, m, b):
            assert ranges[first][0] * m == first * h
    model = Model(cfg, torch.device("meta"))
    mesh = sh.Mesh((1, m), ("data", "model"))
    for path, plan in zip(sh.param_paths(model.param_shapes()), leaf_plans(model, mesh)):
        name = path.split("/")[-1]
        heads = dict((g, n) for g, n, _ in groups)
        want = 0
        if path.endswith(("attn/wq", "attn/wo")) and heads["attn"] % m:
            want = heads["attn"]
        if path.endswith("ssd/w_out") and heads["ssd"] % m:
            want = heads["ssd"]
        assert plan.heads == want, (path, plan)
        if want:
            assert plan.mode == "megatron" and plan.block == m // math.gcd(want, m)
            assert plan.head_size == (HEAD_P if name == "w_out" else cfg.resolved_head_dim)
