"""Decode on a sharded mesh: ``make_serve_step(model, mesh=...)`` over
``gloo`` ranks on the CPU against one rank's unsharded decode, on reduced
configs in float32.

Each case fills a whole cache from a numpy seed — the KV slots below a start
position, every recurrent state and the encoder's output —, cuts it into the
ranks' tiles with ``shard_cache`` and runs ``STEPS`` decode steps from the
start on the same tokens (drawn from the seed, not fed back, so one step's
token cannot steer the next).  Contract, per step and rank:

* the logits (this rank's batch rows and, where the vocabulary is split,
  its share of it) within ``F32_REL`` of one rank's, relative to their
  largest magnitude: the sharded step only changes the order of the
  softmax's and the split products' sums; the greedy tokens equal;
* the collectives recorded over ``gloo`` equal, op for op (kind, result
  bytes, groups, dtype), those of the same step on a virtual copy of the
  mesh on ``meta`` (what the dry run records);
* no collective takes a cache tile, or a view of one, as its input (each
  input's storage against the tiles' storages before and after the step:
  a threshold on bytes could not tell them apart, since parameter gathers
  are larger than small tiles);
* after the run every tile equals one rank's final cache cut by
  ``shard_cache`` within the same bound: each write landed on its owner.

The cases: llama3 on (2, 2) and on (1, 4) (each KV head on two model ranks);
llama3 at B = 1 on (2, 2), where the batch cannot take the dp axes and the
sequence spans every rank (two of them hold no visible slot at first);
qwen3 with qk-norm, six heads and three KV heads on a model axis of 4,
which neither divides the KV heads nor is a multiple of them, so attention
is gathered whole; attention on unequal shares of the heads on (1, 4):
qwen3 (qk-norm) at ten heads and two KV heads (2, 3, 2, 3 heads a rank) and
internvl2 at fourteen and two (3, 4, 3, 4), q padded to the largest share
for the gather; mixtral's ring cache (``window_cache``) on (1, 4), past the
ring's wrap, and mixtral on (1, 2) (both with expert parallelism); mamba2 on
(1, 2) with its heads split (the weights' heads: SSD tensor parallel), and
with three heads (d_model 96), so the state's N is split and the SSD
weights are whole; recurrentgemma (one KV head, h and conv split, RG-LRU on
the weights' channels, a trailing recurrent block) on (2, 2) with
``window_cache``, past its ring's size (the write clamped to the last slot,
on its owner); seamless on (2, 2), Megatron throughout, its encoder output
split over T (cross attention through the folded projections), and on
(1, 4) with a vocabulary of 510, which the model axis does not divide (the
unembedding row-parallel over d), each of its two KV heads on two ranks.
Every case but qwen3's and mamba2's three heads runs with no leaf gathered
whole.  The ranks are spawned processes with a 240 s
limit.

The reference's hybrid decode never passes ``ring``: recurrentgemma decoded
with ``window_cache`` past its ring's size writes the clamped last slot, as
the reference's ``dynamic_update_slice`` does
(``test_hybrid_window_cache_clamps_like_the_reference``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.train import run_ranks

torch.set_num_threads(1)

STEPS = 8
F32_REL = 1e-5  # sharded vs one rank, float32 (chip_smoke.MULTI_F32_REL)

# id: (arch, config overrides, (data, model), batch, cache length, start
# position, window_cache, encoder length)
CASES = {
    "llama3-2x2": ("llama3-8b", {}, (2, 2), 4, 32, 20, False, 0),
    "llama3-1x4": ("llama3-8b", {}, (1, 4), 4, 32, 20, False, 0),
    "llama3-b1-2x2": ("llama3-8b", {}, (2, 2), 1, 32, 3, False, 0),
    "qwen3-gathered-1x4": ("qwen3-14b", {"n_heads": 6, "n_kv_heads": 3}, (1, 4), 2, 32,
                           20, False, 0),
    "qwen3-uneven-10-2-1x4": ("qwen3-14b", {"n_heads": 10}, (1, 4), 2, 32, 20, False, 0),
    "internvl2-uneven-14-2-1x4": ("internvl2-1b", {"n_heads": 14}, (1, 4), 2, 32, 20,
                                  False, 0),
    "mixtral-ring-1x4": ("mixtral-8x7b", {}, (1, 4), 2, 128, 60, True, 0),
    "mixtral-ep-1x2": ("mixtral-8x7b", {}, (1, 2), 2, 32, 20, False, 0),
    "mamba2-heads-1x2": ("mamba2-130m", {}, (1, 2), 2, 32, 0, False, 0),
    "mamba2-state-1x2": ("mamba2-130m", {"d_model": 96}, (1, 2), 2, 32, 0, False, 0),
    "recurrentgemma-window-2x2": ("recurrentgemma-9b", {"n_layers": 4}, (2, 2), 4, 128,
                                  60, True, 0),
    "seamless-2x2": ("seamless-m4t-large-v2", {}, (2, 2), 4, 32, 20, False, 16),
    "seamless-vocab510-1x4": ("seamless-m4t-large-v2", {"vocab": 510}, (1, 4), 2, 32, 20,
                              False, 16),
}


def _cfg(arch, over):
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **over)


def _named_leaves(tree, name=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _named_leaves(v, k)]
    if isinstance(tree, list):
        return [x for v in tree for x in _named_leaves(v, name)]
    return [(name, tree)]


def _fill(cache, start, seed):
    """Fill a whole cache in place from ``seed``: KV slots below ``start``
    (all of a ring past its size), every state and the encoder's output."""
    rng = np.random.default_rng(seed)
    for name, leaf in _named_leaves(cache):
        if name in ("k", "v"):
            n = min(start, leaf.shape[1])
            vals = rng.standard_normal((leaf.shape[0], n) + tuple(leaf.shape[2:]))
            leaf[:, :n] = torch.from_numpy(vals).to(leaf.dtype)
        else:
            leaf.copy_(torch.from_numpy(rng.standard_normal(tuple(leaf.shape))))
    return cache


def _op_key(op):
    return (op.kind, op.result_bytes, op.group_size, op.groups, op.dtype)


def _rank(rank, world, case):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import (cache_tile_shardings, input_shardings,
                                          leaf_plans, make_serve_step, module_like,
                                          shard_cache)
    from repro_torch.models.api import Model, build_model
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import tree as tree_util
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime.hlo_traffic import record_collectives

    torch.set_num_threads(1)
    arch, over, (_, m), b, s, start, window_cache, enc_len = CASES[case]
    cfg = _cfg(arch, over)
    ring = bool(window_cache and cfg.window and not cfg.local_global_ratio)
    shape = ShapeConfig("decode_test", s, b, "decode")
    mesh = make_host_mesh(model_axis=m)
    model = build_model(cfg, "cpu")
    params = model.init(0)
    whole = _fill(model.init_cache(b, s, enc_len=enc_len, window_cache=window_cache),
                  start, seed=1)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab, (STEPS, b, 1)))

    # one rank, unsharded
    ref_cache = tree_util.unflatten(whole, [x.clone() for x in tree_util.leaves(whole)])
    one = make_serve_step(model, ring, logits=True)
    want = [one(params, ref_cache, tokens[i], start + i) for i in range(STEPS)]

    # this rank's tiles, and the decode step's plan
    plans = leaf_plans(model, mesh, "decode")
    shards = module_like(params, [sh.shard_tensor(x, p.sharding)
                                  for x, p in zip(tree_util.leaves(params), plans)])
    cache_sh = cache_tile_shardings(mesh, cfg, shape, whole)
    tiles = shard_cache(whole, mesh, cfg, shape)
    tok_sh = input_shardings(mesh, cfg, shape, {"token": tokens[0]})["token"]
    step = make_serve_step(model, ring, mesh, cache_sh, logits=True)

    issued = []  # every collective's input, kept alive until it is checked
    issue = sh._issue

    def spy(kind, mesh_, axes, block, x, out_shape):
        issued.append(x)
        return issue(kind, mesh_, axes, block, x, out_shape)

    sh._issue = spy
    worst, tokens_equal, on_tile, records = 0.0, True, 0, []
    try:
        for i in range(STEPS):
            before = tree_util.leaves(tiles)
            with record_collectives() as ops:
                tok, tiles, logits = step(shards, tiles, sh.shard_tensor(tokens[i], tok_sh),
                                          start + i)
            records.append([_op_key(op) for op in ops])
            stores = {x.untyped_storage().data_ptr()
                      for x in before + tree_util.leaves(tiles)}
            on_tile += sum(x.untyped_storage().data_ptr() in stores for x in issued)
            issued.clear()
            w_tok, _, w_logits = want[i]
            vocab = "model" if logits.shape[-1] != cfg.vocab else None  # split or whole
            w_logits = sh.shard_tensor(w_logits, sh.NamedSharding(
                mesh, sh.P(tok_sh.spec[0], None, vocab)))
            scale = float(w_logits.abs().max())
            worst = max(worst, float((logits - w_logits).abs().max()) / scale)
            tokens_equal &= torch.equal(tok, sh.shard_tensor(w_tok, tok_sh))
    finally:
        sh._issue = issue

    # the same step on a virtual copy of the mesh, on meta
    vmesh = mesh.virtual_copy()
    vmodel = Model(cfg, torch.device("meta"))
    vshapes = vmodel.param_shapes()
    vshards = module_like(vshapes, [sh.shard_tensor(x, p.sharding) for x, p in
                                    zip(tree_util.leaves(vshapes), leaf_plans(vmodel, vmesh))])
    vwhole = vmodel.init_cache(b, s, enc_len=enc_len, window_cache=window_cache)
    vstep = make_serve_step(vmodel, ring, vmesh, cache_tile_shardings(vmesh, cfg, shape, vwhole))
    vtok = torch.empty(sh.shard_tensor(tokens[0], tok_sh).shape, dtype=torch.int64,
                       device="meta")
    with record_collectives() as vops:
        vstep(vshards, shard_cache(vwhole, vmesh, cfg, shape), vtok, start)

    want_tiles = shard_cache(ref_cache, mesh, cfg, shape)
    tile_err = max(float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
                   for a, w in zip(tree_util.leaves(tiles), tree_util.leaves(want_tiles)))
    return {"worst": worst, "tokens_equal": bool(tokens_equal), "on_tile": on_tile,
            "n_ops": len(records[0]), "same_each_step": all(r == records[0] for r in records),
            "ops_equal": records[0] == [_op_key(op) for op in vops], "tile_err": tile_err,
            "modes": sorted({p.mode for p in plans}),
            "uneven": sorted({p.heads for p in plans if p.heads}),
            "split": sorted({str(t.spec) for t in tree_util.leaves_of(cache_sh)})}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_matches_one_rank(case):
    dp, m = CASES[case][2]
    ranks = run_ranks(_rank, dp * m, case, backend="gloo", timeout=240)
    for r in ranks:
        assert r["worst"] <= F32_REL, (case, r["worst"])
        assert r["tokens_equal"], case
        assert r["tile_err"] <= F32_REL, (case, r["tile_err"])
        assert r["on_tile"] == 0, (case, r["on_tile"])
        assert r["n_ops"] and r["same_each_step"] and r["ops_equal"], case
    assert all(r["split"] == ranks[0]["split"] for r in ranks)
    # every case keeps some cache leaf split over the model axis
    assert any("model" in spec for spec in ranks[0]["split"]), ranks[0]["split"]
    want_modes = {"qwen3-gathered-1x4": ["data", "gathered", "megatron"],
                  "mamba2-state-1x2": ["data", "gathered", "megatron"]}
    assert ranks[0]["modes"] == want_modes.get(case, ["data", "megatron"])
    want_uneven = {"qwen3-uneven-10-2-1x4": [10], "internvl2-uneven-14-2-1x4": [14]}
    assert ranks[0]["uneven"] == want_uneven.get(case, [])


def test_hybrid_window_cache_clamps_like_the_reference():
    """Reduced recurrentgemma (float32) decoded with ``window_cache`` past
    its ring's 64 slots: the reference's hybrid decode passes no ``ring``,
    so its ``dynamic_update_slice`` clamps every write past the last slot
    onto it; the port writes the same slot and gives the reference's logits
    at every position (1e-4 of their largest magnitude: JAX's and torch's
    float32 products differ in the order of their sums)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as ref_get_arch
    from repro.models.api import build_model as ref_build_model
    from repro_torch.interop import model_from_numpy
    from repro_torch.models.api import build_model

    over = {"n_layers": 3, "dtype": "float32"}
    ref_model = ref_build_model(dataclasses.replace(ref_get_arch("recurrentgemma-9b").reduced(),
                                                    **over))
    params = ref_model.init(jax.random.key(0))
    model = build_model(_cfg("recurrentgemma-9b", {"n_layers": 3}), "cpu")
    net = model_from_numpy(model.cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    b, window = 2, model.cfg.window
    cache = model.init_cache(b, 2 * window, window_cache=True)
    ref_cache = ref_model.init_cache(b, 2 * window, window_cache=True)
    assert cache["super"][0]["attn"]["k"].shape[1] == window
    step = jax.jit(lambda p, c, t, pos: ref_model.decode(p, c, t, pos))
    tokens = np.random.default_rng(3).integers(0, model.cfg.vocab, (window + 8, b, 1))
    for pos, tok in enumerate(tokens):
        logits, cache = model.decode(net, cache, torch.as_tensor(tok), pos)
        ref_logits, ref_cache = step(params, ref_cache, jnp.asarray(tok, jnp.int32),
                                     jnp.int32(pos))
        ref_logits = np.asarray(ref_logits)
        err = np.abs(logits.numpy() - ref_logits).max() / np.abs(ref_logits).max()
        assert err <= 1e-4, (pos, err)
    np.testing.assert_allclose(cache["super"][0]["attn"]["k"].numpy(),
                               np.asarray(ref_cache["super"]["attn"]["k"][0]),
                               rtol=1e-4, atol=1e-4)
