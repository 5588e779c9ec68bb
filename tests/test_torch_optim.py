"""The port's AdamW and gradient compression against the reference's on the
same numpy-seeded parameters and gradients.

AdamW: the schedule at every step of warmup and decay, and three updates of
a small parameter tree (matrices, a stacked layer group whose per-layer
vectors the reference decays because its stacked array is 2-D, a bfloat16
leaf) at the default hyperparameters, parameters and moments at 1e-5 (the
bfloat16 leaf at one bfloat16 rounding).  Compression: ``topk_sparsify`` and
the int8 round trip exactly, with ties at the threshold; ``compress_decompress``
on a stacked layer group (the top-k threshold and the int8 scale are taken
over all layers together, as the reference does); ``ErrorFeedback`` over two
calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compression as ref_comp
from repro.optim.adamw import AdamW as RefAdamW
from repro_torch.optim import compression as comp
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW


def _trees(rng):
    """(the reference's stacked tree, the port's tree with a layer list)."""
    ref = {"embed": rng.normal(0, 1, (12, 8)).astype(np.float32),
           "final_norm": rng.normal(0, 1, (8,)).astype(np.float32),
           "blocks": {"norm1": rng.normal(0, 1, (3, 8)).astype(np.float32),
                      "w": rng.normal(0, 1, (3, 8, 5)).astype(np.float32)}}
    port = {"embed": ref["embed"], "final_norm": ref["final_norm"],
            "blocks": [{"norm1": ref["blocks"]["norm1"][i], "w": ref["blocks"]["w"][i]}
                       for i in range(3)]}
    return ref, port


def _to_torch(tree, dtype=torch.float32):
    return tree_util.unflatten(tree, [torch.tensor(np.array(x), dtype=dtype)
                                      for x in tree_util.leaves(tree)])


def _stacked_numpy(tree):
    return tree_util.stacked(tree_util.unflatten(
        tree, [t.detach().float().numpy() for t in tree_util.leaves(tree)]),
        stack=np.stack)


def test_schedule_matches_reference():
    ref, ours = RefAdamW(warmup_steps=5, total_steps=40), AdamW(warmup_steps=5,
                                                               total_steps=40)
    for step in range(45):
        np.testing.assert_allclose(float(ours.schedule(torch.tensor(step))),
                                   float(ref.schedule(jnp.int32(step))), rtol=1e-6)


def test_stacked_ndims_decay_layer_vectors():
    _, port = _trees(np.random.default_rng(0))
    assert tree_util.stacked_ndims(port) == [2, 1] + [2, 3] * 3


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_updates_match_reference(clip):
    rng = np.random.default_rng(1)
    ref_p, port_p = _trees(rng)
    ref_p = jax.tree_util.tree_map(jnp.asarray, ref_p)
    port_p = _to_torch(port_p)
    ref_opt = RefAdamW(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=clip)
    opt = AdamW(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=clip)
    ref_state, state = ref_opt.init(ref_p), opt.init(port_p)
    for _ in range(3):
        g_ref, g_port = _trees(rng)
        ref_p, ref_state, ref_m = ref_opt.update(
            jax.tree_util.tree_map(jnp.asarray, g_ref), ref_state, ref_p)
        port_p, state, m = opt.update(_to_torch(g_port), state, port_p)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-6)
        for ours, theirs in ((port_p, ref_p), (state.mu, ref_state.mu),
                             (state.nu, ref_state.nu)):
            mine = _stacked_numpy(ours)
            for path, leaf in jax.tree_util.tree_flatten_with_path(theirs)[0]:
                x = mine
                for p in path:
                    x = x[p.key]
                np.testing.assert_allclose(x, np.asarray(leaf), rtol=1e-5, atol=1e-6,
                                           err_msg=jax.tree_util.keystr(path))
    assert int(state.step) == int(ref_state.step) == 3


def test_adamw_keeps_a_bfloat16_parameter_in_bfloat16():
    rng = np.random.default_rng(2)
    w = rng.normal(0, 1, (6, 4)).astype(np.float32)
    g = rng.normal(0, 1, (6, 4)).astype(np.float32)
    ref_opt, opt = RefAdamW(warmup_steps=1), AdamW(warmup_steps=1)
    ref_p = {"w": jnp.asarray(w, jnp.bfloat16)}
    port_p = {"w": torch.tensor(w).bfloat16()}
    ref_s, s = ref_opt.init(ref_p), opt.init(port_p)
    for _ in range(2):
        ref_p, ref_s, _ = ref_opt.update({"w": jnp.asarray(g, jnp.bfloat16)}, ref_s, ref_p)
        port_p, s, _ = opt.update({"w": torch.tensor(g).bfloat16()}, s, port_p)
    assert port_p["w"].dtype == torch.bfloat16 and s.mu["w"].dtype == torch.float32
    np.testing.assert_allclose(port_p["w"].float().numpy(),
                               np.asarray(ref_p["w"], np.float32), rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_topk_sparsify_matches_reference_with_ties(frac):
    rng = np.random.default_rng(3)
    g = rng.normal(0, 1, (40, 25)).astype(np.float32)
    g[::7, ::3] = 0.5  # ties around the threshold of either fraction
    g[1::5, 2::4] = -0.5
    ref_kept, ref_res = ref_comp.topk_sparsify(jnp.asarray(g), frac)
    kept, res = comp.topk_sparsify(torch.tensor(g), frac)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(ref_kept))
    np.testing.assert_array_equal(res.numpy(), np.asarray(ref_res))


def test_int8_roundtrip_matches_reference():
    rng = np.random.default_rng(4)
    g = rng.normal(0, 1, (33, 17)).astype(np.float32)
    ref_q, ref_s = ref_comp.int8_quantize(jnp.asarray(g))
    q, s = comp.int8_quantize(torch.tensor(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
    assert float(s) == float(ref_s)
    np.testing.assert_array_equal(comp.int8_dequantize(q, s).numpy(),
                                  np.asarray(ref_comp.int8_dequantize(ref_q, ref_s)))


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compress_decompress_matches_reference(scheme):
    ref_g, port_g = _trees(np.random.default_rng(5))
    ref_out = ref_comp.compress_decompress(jax.tree_util.tree_map(jnp.asarray, ref_g),
                                           scheme)
    out = comp.compress_decompress(_to_torch(port_g), scheme)
    mine = _stacked_numpy(out)
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref_out)[0]:
        x = mine
        for p in path:
            x = x[p.key]
        np.testing.assert_array_equal(x, np.asarray(leaf), err_msg=jax.tree_util.keystr(path))
    with pytest.raises(ValueError, match="unknown compression"):
        comp.compress_decompress(_to_torch(port_g), "fp4")


def test_error_feedback_matches_reference():
    rng = np.random.default_rng(6)
    ref_ef, ef = ref_comp.ErrorFeedback(0.1), comp.ErrorFeedback(0.1)
    for _ in range(2):
        ref_g, port_g = _trees(rng)
        ref_out = ref_ef(jax.tree_util.tree_map(jnp.asarray, ref_g))
        mine = _stacked_numpy(ef(_to_torch(port_g)))
        for path, leaf in jax.tree_util.tree_flatten_with_path(ref_out)[0]:
            x = mine
            for p in path:
                x = x[p.key]
            np.testing.assert_array_equal(x, np.asarray(leaf))
    assert ef.compression_ratio() == ref_ef.compression_ratio()
