"""A rank's tiles drawn without the whole model, and the moe family run on a
mesh from them.

* ``launch.steps.init_tiles(model, plans)`` against
  ``shard_tensor(x, plan.sharding)`` of every leaf of ``model.init(0)``,
  bit for bit (values, dtype, shape), for every config's ``reduced()`` in
  its own dtype and in float32, on ``gloo`` ranks of a 1×4 and a 2×2 host
  mesh (``make_host_mesh``), the plans handed as ``LeafPlan`` and as
  ``NamedSharding``: each leaf is drawn in ``init``'s order, cut before its
  cast, and found by its place in the tree.
* ``launch.steps.init_cache_tiles`` against ``shard_cache`` of the whole
  decode cache filled leaf by leaf from a numpy seed, and
  ``chip_smoke._filled_cache(..., tiles=)`` against ``shard_cache`` of its
  whole cache, bit for bit, on the same ranks.
* The reduced mixtral-8x7b and dbrx-132b in float32, every layer, their
  tiles from ``init_tiles`` on a 1×4 mesh (one expert, one head and half a
  KV head's ranks a rank), prefilled through ``make_prefill_step(mesh=,
  logits=True)`` and decoded from a numpy-seeded cache filled tile by tile
  (``init_cache_tiles``, ``make_serve_step(mesh=, cache_sh=)``), against
  the reference's ``forward`` and ``decode`` on the same weights (the
  port's ``init(0)`` through ``repro_torch.interop.model_to_numpy``) and the
  same whole cache: each rank's share of the logits within ``REF_REL`` of
  the row's largest reference logit (the tolerance
  ``tests/test_torch_decode_tp.py`` holds the port's decode to the
  reference at), the greedy tokens the reference's wherever its top-2
  margin clears twice that.
* ``chip_smoke._moe_truth``, the one-card truth of the 4-card entry's
  moe_full part (the model streamed a layer at a time), against
  ``Model.forward`` and ``Model.decode`` of the whole reduced model on the
  CPU, bit for bit.

The ranks are spawned processes with a 240 s limit.
"""

import dataclasses
import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.launch.train import run_ranks

torch.set_num_threads(1)

MESHES = {"1x4": 4, "2x2": 2}  # id: model axis of 4 gloo ranks
B, S, START, STEPS, ENC = 4, 32, 20, 6, 16  # cache batch, length, filled slots, steps
REF_REL = 1e-4
_ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cfg(arch, dtype=None):
    from repro_torch.configs import get_arch

    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _numpy_fill(seed):
    """``fill(name, leaf)`` for ``init_cache_tiles``: KV slots below
    ``START``, every other leaf whole, from one numpy generator in call
    order."""
    rng = np.random.default_rng(seed)

    def fill(name, leaf):
        if name in ("k", "v"):
            n = min(START, leaf.shape[1])
            vals = rng.standard_normal((leaf.shape[0], n) + tuple(leaf.shape[2:]))
            leaf[:, :n] = torch.from_numpy(vals).to(leaf.dtype)
        else:
            leaf.copy_(torch.from_numpy(rng.standard_normal(tuple(leaf.shape))))

    return fill


def _whole_cache(model, fill):
    from repro_torch.parallel import sharding as sh

    cache = model.init_cache(B, S, enc_len=ENC)
    for path, _, leaf in sh._param_leaves(cache):
        fill(next(str(k) for k in reversed(path) if isinstance(k, str)), leaf)
    return cache


def _equal(got, want) -> bool:
    return len(got) == len(want) and all(
        a.dtype == w.dtype and a.shape == w.shape and torch.equal(a, w)
        for a, w in zip(got, want))


def _tiles_rank(rank, world, model_axis):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (init_cache_tiles, init_tiles, leaf_plans,
                                          shard_cache)
    from repro_torch.models.api import build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    cs = _chip_smoke()
    mesh = make_host_mesh(model_axis=model_axis)
    shape = ShapeConfig("decode_test", S, B, "decode")
    out = {}
    for arch in ARCHS:
        r = {"params": True, "named": True, "split": False}
        for dtype in (None, "float32"):
            model = build_model(_cfg(arch, dtype), "cpu")
            plans = leaf_plans(model, mesh)
            whole = tree_util.leaves(model.init(0))
            want = [sh.shard_tensor(x, p.sharding) for x, p in zip(whole, plans)]
            r["params"] &= _equal(tree_util.leaves(init_tiles(model, plans)), want)
            r["named"] &= _equal(tree_util.leaves(init_tiles(model, [p.sharding for p in plans])),
                                 want)
            r["split"] |= any(t.numel() < x.numel() for t, x in zip(want, whole))
        cfg = model.cfg
        want = tree_util.leaves(shard_cache(_whole_cache(model, _numpy_fill(1)), mesh, cfg,
                                            shape))
        got = init_cache_tiles(model, mesh, shape, _numpy_fill(1), enc_len=ENC)
        r["cache"] = _equal(tree_util.leaves(got), want)
        r["cache_split"] = any(t.numel() < x.numel() for t, x in
                               zip(want, tree_util.leaves(model.init_cache(B, S, enc_len=ENC))))
        # chip_smoke's seeded fill: its cache length doubles as the encoder's
        want = shard_cache(cs._filled_cache(model, B, S, START, 1, "cpu"), mesh, cfg,
                           ShapeConfig("decode_test", S, B, "decode"))
        got = cs._filled_cache(model, B, S, START, 1, "cpu", tiles=(mesh, shape))
        r["chip_smoke_cache"] = _equal(tree_util.leaves(got), tree_util.leaves(want))
        out[arch] = r
    return out


@functools.cache
def _tiles(mesh_id):
    return run_ranks(_tiles_rank, 4, MESHES[mesh_id], backend="gloo", timeout=240)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_init_tiles_equal_the_whole_init_cut(mesh_id, arch):
    for r in _tiles(mesh_id):
        assert r[arch]["params"], (mesh_id, arch)
        assert r[arch]["named"], (mesh_id, arch)
    assert _tiles(mesh_id)[0][arch]["split"], (mesh_id, arch)  # some leaf is cut


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("mesh_id", list(MESHES))
def test_cache_tiles_equal_the_whole_cache_cut(mesh_id, arch):
    for r in _tiles(mesh_id):
        assert r[arch]["cache"], (mesh_id, arch)
        assert r[arch]["chip_smoke_cache"], (mesh_id, arch)
    assert _tiles(mesh_id)[0][arch]["cache_split"], (mesh_id, arch)


def _moe_rank(rank, world, arch, tokens, dec_tokens):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (cache_tile_shardings, init_cache_tiles, init_tiles,
                                          input_shardings, leaf_plans, make_prefill_step,
                                          make_serve_step)
    from repro_torch.models.api import Model, build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    cfg = _cfg(arch, "float32")
    mesh = make_host_mesh(model_axis=world)
    model = build_model(cfg, "cpu")
    plans = leaf_plans(model, mesh, "prefill")
    params = init_tiles(model, plans)
    tok, logits = make_prefill_step(model, mesh=mesh, logits=True)(
        params, {"tokens": torch.as_tensor(tokens)})
    shape = ShapeConfig("decode_test", S, B, "decode")
    cache = init_cache_tiles(model, mesh, shape, _numpy_fill(1))
    cache_sh = cache_tile_shardings(mesh, cfg, shape,
                                    Model(cfg, torch.device("meta")).init_cache(B, S))
    step = make_serve_step(model, mesh=mesh, cache_sh=cache_sh, logits=True)
    dec = torch.as_tensor(dec_tokens)
    tok_sh = input_shardings(mesh, cfg, shape, {"token": dec[0]})["token"]
    d_logits, d_toks = [], []
    for i in range(STEPS):
        t, cache, out = step(params, cache, sh.shard_tensor(dec[i], tok_sh), START + i)
        d_logits.append(out[:, -1].numpy())
        d_toks.append(t[:, 0].numpy())
    return {"prefill": logits.numpy(), "token": tok[:, 0].numpy(),
            "decode": np.stack(d_logits), "decode_tokens": np.stack(d_toks),
            "cols": sh.tile_slice(logits.shape[-1], mesh, ("model",)),
            "modes": sorted({p.mode for p in plans})}


@functools.cache
def _moe(arch):
    """(the ranks' results, the reference's prefill logits (B, S, V) and
    decode logits (steps, B, V)) of ``arch``'s reduced config in float32."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.models.api import build_model as ref_build_model
    from repro_torch.interop import model_to_numpy
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree as tree_util

    rng = np.random.default_rng(5)
    tokens = rng.integers(0, _cfg(arch).vocab, (2, S))
    dec_tokens = rng.integers(0, _cfg(arch).vocab, (STEPS, B, 1))
    ranks = run_ranks(_moe_rank, 4, arch, tokens, dec_tokens, backend="gloo", timeout=240)

    cfg = _cfg(arch, "float32")
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), dtype="float32")
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    ref_model = ref_build_model(ref_cfg)
    model = build_model(cfg, "cpu")
    params = jax.tree_util.tree_map(jnp.asarray, model_to_numpy(model.init(0)))
    prefill = np.asarray(ref_model.forward(params, {"tokens": jnp.asarray(tokens, jnp.int32)}),
                         np.float32)
    cache = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.numpy()),
        tree_util.stacked(_whole_cache(model, _numpy_fill(1))))
    step = jax.jit(lambda p, c, t, pos: ref_model.decode(p, c, t, pos))
    decode = []
    for i in range(STEPS):
        logits, cache = step(params, cache, jnp.asarray(dec_tokens[i], jnp.int32),
                             jnp.int32(START + i))
        decode.append(np.asarray(logits, np.float32)[:, -1])
    return ranks, prefill, np.stack(decode)


def _agree(got, want, cols):
    """(the largest error over the row's largest |want|, whether the greedy
    tokens ``got[1]`` equal ``want``'s where its margin clears twice it)."""
    logits, toks = got
    scale = np.abs(want).max(axis=-1)
    worst = float((np.abs(logits - want[..., cols]).max(axis=-1) / scale).max())
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] > 2 * REF_REL * scale
    return worst, bool(np.array_equal(toks[sure], want.argmax(-1)[sure]))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_prefill_from_tiles_matches_reference(arch):
    ranks, prefill, _ = _moe(arch)
    assert ranks[0]["modes"] == ["data", "megatron"]  # experts, heads, vocabulary split
    for r in ranks:
        worst, _ = _agree((r["prefill"], prefill.argmax(-1)), prefill, r["cols"])
        assert worst <= REF_REL, (arch, worst)
        _, tokens_equal = _agree((r["prefill"][:, -1], r["token"]), prefill[:, -1], r["cols"])
        assert tokens_equal, arch


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
def test_moe_decode_from_tiles_matches_reference(arch):
    ranks, _, decode = _moe(arch)
    for r in ranks:
        worst, tokens_equal = _agree((r["decode"], r["decode_tokens"]), decode, r["cols"])
        assert worst <= REF_REL, (arch, worst)
        assert tokens_equal, arch


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b", "llama3-8b"])
def test_streamed_truth_equals_the_whole_model(arch):
    """``chip_smoke._moe_truth`` (one layer drawn, applied and freed at a
    time) gives ``Model.forward``'s prefill logits and ``Model.decode``'s
    over ``_filled_cache``'s cache, float32, bit for bit; with ``ulp`` its
    decode with the cache one ulp off either way moves the logits."""
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.api import build_model

    cs = _chip_smoke()
    cfg = _cfg(arch, "float32")
    cpu = torch.device("cpu")
    truth = cs._moe_truth(f"{arch}-reduced", [16, 24], (S, START, STEPS, B), cpu, ulp=True)
    model = build_model(cfg, cpu)
    params = model.init(0)
    for s in (16, 24):
        want = model.forward(params, {"tokens": cs._prefill_tokens(cfg, s, cpu)})[0]
        assert np.array_equal(truth["prefill"][s], want.numpy()), (arch, s)
    cache = cs._filled_cache(model, B, S, START, 1, cpu)
    want, _, _ = cs._run_decode(make_serve_step(model, logits=True), params, cache,
                                cs._decode_tokens(cfg, B, STEPS, cpu), START, cpu)
    assert np.array_equal(truth[("decode", 0)], want), arch
    for sign in (1, -1):
        assert not np.array_equal(truth[("decode", sign)], want), (arch, sign)
    if cfg.family == "moe":  # one routing record a layer and prefill, a layer and step
        assert [len(truth["routes"][("prefill", s)]) for s in (16, 24)] == [cfg.n_layers] * 2
        assert len(truth["routes"]["decode"]) == cfg.n_layers * STEPS
