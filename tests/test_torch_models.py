"""The port's model stack against the reference's on the same parameters.

The reference initializes each reduced config; its parameter pytree goes
through :func:`repro_torch.interop.model_from_numpy`; the same numpy-seeded
tokens go through both full-sequence forwards (the port's runs the kernels'
plain versions on the CPU) and both token-by-token decodes.  Tolerances:
1e-4 in float32 (``dataclasses.replace(cfg.reduced(), dtype="float32")``),
and in bfloat16 the reference's own decode-vs-forward contract 6e-2
(``tests/test_arch_smoke.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import ARCHS, get_arch
from repro_torch.interop import model_from_numpy
from repro_torch.models.api import build_model
from repro_torch.models.transformer import layer_window

torch.set_num_threads(1)

B, S = 2, 32
TOL = {"float32": 1e-4, "bfloat16": 6e-2}
# (arch, dtype, overrides): the five architectures of the dense, hybrid and
# ssm families; a hybrid with 8 layers (2 super-blocks + 2 trailing
# recurrent blocks) and windows small enough to bite at S = 32
CASES = [(a, dt, {}) for a in ("recurrentgemma-9b", "mamba2-130m", "llama3-8b",
                               "qwen3-14b", "gemma3-12b")
         for dt in ("float32", "bfloat16")]
CASES += [("recurrentgemma-9b", dt, {"n_layers": 8, "window": 12})
          for dt in ("float32", "bfloat16")]
CASES += [("gemma3-12b", "float32", {"window": 8})]
# the dense features that reduced() hides: gemma3 at 7 layers, whose layer 5
# is global among its locals, with a query width of 4 × 48 = 192 against
# d_model 128; deepseek's MHA (4 KV heads for 4 heads: a GQA group of 1)
CASES += [("gemma3-12b", dt, {"n_layers": 7, "window": 8, "head_dim": 48})
          for dt in ("float32", "bfloat16")]
CASES += [("deepseek-7b", dt, {"n_kv_heads": 4}) for dt in ("float32", "bfloat16")]
# the moe and vlm families: mixtral (8 experts top-2 cut to 4, sliding
# window), dbrx (global attention), internvl2 (patches in front of the
# tokens, tied embeddings).  The moe models run in float32 only: top-k
# routing is discontinuous, and in bfloat16 the two packages' rounding
# differs by enough to flip a token whose 2nd and 3rd routing
# probabilities are close (mixtral's reduced config at this seed: a margin
# of 0.0037 in layer 1 at token 27 moves its logits by 0.45), so their
# bf16 outputs agree token by token only where no routing flips.  The moe
# layer itself is held to the reference in bf16 on the same inputs at the
# reference's own 2e-2 (tests/test_torch_moe.py).
CASES += [(a, "float32", {}) for a in ("mixtral-8x7b", "dbrx-132b")]
CASES += [("internvl2-1b", dt, {}) for dt in ("float32", "bfloat16")]


def _configs(arch, dtype, over):
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), dtype=dtype, **over)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype, **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


@pytest.mark.parametrize("arch,dtype,over", CASES,
                         ids=[f"{a}-{d}-{'-'.join(map(str, o.values())) or 'reduced'}"
                              for a, d, o in CASES])
def test_forward_and_decode_match_reference(arch, dtype, over):
    ref_cfg, cfg = _configs(arch, dtype, over)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(2))
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab, (B, S))
    jtok = jnp.asarray(tokens, jnp.int32)
    ref_batch, batch = {"tokens": jtok}, {"tokens": torch.as_tensor(tokens)}
    if cfg.family == "vlm":  # precomputed patch embeddings before the text
        patches = rng.normal(0, 1, (B, cfg.frontend_tokens, cfg.d_model))
        ref_batch["patches"] = jnp.asarray(patches, ref_cfg.dtype)
        batch["patches"] = torch.from_numpy(patches).to(getattr(torch, dtype))
    ref_full = np.asarray(ref_model.forward(params, ref_batch), np.float32)

    model = build_model(cfg, device="cpu")
    net = model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    ttok = batch["tokens"]
    full = model.forward(net, batch)
    assert full.shape == (B, S, cfg.vocab) and full.dtype == getattr(torch, dtype)
    assert torch.equal(net(ttok, batch.get("patches")), full)  # the nn.Module's own
    tol = TOL[dtype]
    np.testing.assert_allclose(full.float().numpy(), ref_full, rtol=tol, atol=tol)
    if "patches" in batch:  # decode below runs the tokens alone
        full = model.forward(net, {"tokens": ttok})

    step = jax.jit(lambda p, c, t, pos: ref_model.decode(p, c, t, pos))
    ref_cache, cache = ref_model.init_cache(B, S), model.init_cache(B, S)
    for pos in range(S):
        ref_logits, ref_cache = step(params, ref_cache, jtok[:, pos:pos + 1],
                                     jnp.int32(pos))
        logits, cache = model.decode(net, cache, ttok[:, pos:pos + 1], pos)
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(ref_logits, np.float32),
                                   rtol=tol, atol=tol, err_msg=f"pos {pos}")
        # decode reproduces the port's own forward, as the reference's does
        np.testing.assert_allclose(logits[:, 0].float().numpy(),
                                   full[:, pos].float().numpy(), rtol=tol, atol=tol)


def test_model_from_numpy_keeps_the_reference_dtypes():
    """bfloat16 leaves arrive as numpy ``ml_dtypes.bfloat16`` arrays (which
    ``torch.from_numpy`` rejects) and go back to bfloat16 exactly; the
    parameters the reference keeps in float32 stay float32; stacked layers
    become one module each."""
    ref_cfg, cfg = _configs("recurrentgemma-9b", "bfloat16", {"n_layers": 8})
    params = ref_build_model(ref_cfg).init(jax.random.key(0))
    net = model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    assert len(net.super) == 2 and len(net.tail) == 2
    w = net.super[1].rec2.rec.w_a
    assert w.dtype == torch.bfloat16 and not w.requires_grad
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(params["super"]["rec2"]["rec"]["w_a"][1], np.float32))
    assert net.tail[0].rec.lambda_raw.dtype == torch.float32
    assert "super.0.attn_blk.attn.wq" in net.state_dict()


def test_layer_windows_match_reference():
    from repro.models.transformer import layer_window as ref_layer_window

    for arch in ("gemma3-12b", "recurrentgemma-9b", "llama3-8b", "mixtral-8x7b"):
        cfg = get_arch(arch)
        assert [layer_window(cfg, i) for i in range(cfg.n_layers)] == [
            int(ref_layer_window(ref_get_arch(arch), i)) for i in range(cfg.n_layers)]


def test_configs_and_param_counts_match_reference():
    from repro.configs import ARCHS as REF_ARCHS

    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(REF_ARCHS[name])
        assert cfg.param_count() == REF_ARCHS[name].param_count()
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            REF_ARCHS[name].reduced())


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_supports_cell_matches_reference(arch):
    """Every (arch, shape) cell is valid, or refused with the same reason, as
    in the reference."""
    from repro.models.api import supports_cell as ref_supports_cell
    from repro.models.config import ALL_SHAPES as REF_SHAPES
    from repro_torch.models.api import supports_cell
    from repro_torch.models.config import ALL_SHAPES

    assert [dataclasses.asdict(s) for s in ALL_SHAPES] == [
        dataclasses.asdict(s) for s in REF_SHAPES]
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        assert supports_cell(get_arch(arch), shape) == ref_supports_cell(
            ref_get_arch(arch), ref_shape)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-130m", "gemma3-12b",
                                  "mixtral-8x7b", "dbrx-132b", "internvl2-1b"])
def test_port_init_matches_reference_tree(arch):
    """The port's own random init has the reference's keys, shapes and
    dtypes, and is the same from the same seed."""
    ref_cfg, cfg = _configs(arch, "bfloat16", {})
    ref = jax.tree_util.tree_map(np.asarray, ref_build_model(ref_cfg).init(jax.random.key(0)))
    model = build_model(cfg, device="cpu")
    net = model.init(seed=5)
    via_numpy = model_from_numpy(cfg, ref, device="cpu")
    ours = net.state_dict()
    theirs = via_numpy.state_dict()
    assert sorted(ours) == sorted(theirs)
    for key, t in ours.items():
        assert t.shape == theirs[key].shape and t.dtype == theirs[key].dtype, key
    again = model.init(seed=5).state_dict()
    assert all(torch.equal(t, again[k]) for k, t in ours.items())


@pytest.mark.parametrize("ring,window", [(True, 0), (False, 6)])
def test_decode_attention_masks_match_reference(ring, window, rng):
    """The ring-buffer cache (slot ``pos % S``, every written slot valid) and
    the sliding-window mask of one-token decode, past the cache's end."""
    from repro.models import attention as ref_attn
    from repro_torch.models import attention as attn
    from repro_torch.models.params import Params

    ref_cfg, cfg = _configs("llama3-8b", "float32", {})
    p = ref_attn.init_attn_params(jax.random.key(0), ref_cfg)
    net = Params({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    s_cache, hd = 8, cfg.resolved_head_dim
    ref_cache = {k: jnp.zeros((B, s_cache, cfg.n_kv_heads, hd)) for k in "kv"}
    cache = {k: torch.zeros((B, s_cache, cfg.n_kv_heads, hd)) for k in "kv"}
    for pos in range(s_cache + 5 if ring else s_cache):
        x = rng.normal(0, 1, (B, 1, cfg.d_model)).astype(np.float32)
        ref_out, ref_cache = ref_attn.decode_attention(
            p, jnp.asarray(x), ref_cache, pos, ref_cfg, window=window, ring=ring)
        out, cache = attn.decode_attention(net, torch.from_numpy(x), cache, pos, cfg,
                                           window=window, ring=ring)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=1e-4,
                                   atol=1e-4, err_msg=f"pos {pos}")
        np.testing.assert_allclose(cache["k"].numpy(), np.asarray(ref_cache["k"]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch,window", [("mixtral-8x7b", 16), ("llama3-8b", 0)])
def test_ring_decode_past_the_window_matches_reference(arch, window):
    """``init_cache(..., window_cache=True)`` and ``decode(..., ring=True)``
    past the window's end (S = 64 over a 16-slot ring) against the
    reference's ring decode, and against the port's windowed forward, in
    float32; an architecture with no window keeps its full cache."""
    ref_cfg, cfg = _configs(arch, "float32", {"window": window})
    s = 64
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(4))
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (B, s))
    jtok, ttok = jnp.asarray(tokens, jnp.int32), torch.as_tensor(tokens)
    model = build_model(cfg, device="cpu")
    net = model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    full = model.forward(net, {"tokens": ttok})
    ref_cache = ref_model.init_cache(B, s, window_cache=True)
    cache = model.init_cache(B, s, window_cache=True)
    assert cache["blocks"][0]["k"].shape[1] == (window or s)
    assert ref_cache["blocks"]["k"].shape[2] == (window or s)
    step = jax.jit(lambda p, c, t, pos: ref_model.decode(p, c, t, pos, ring=True))
    tol = TOL["float32"]
    for pos in range(s):
        ref_logits, ref_cache = step(params, ref_cache, jtok[:, pos:pos + 1],
                                     jnp.int32(pos))
        logits, cache = model.decode(net, cache, ttok[:, pos:pos + 1], pos,
                                     ring=True)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=tol, atol=tol, err_msg=f"pos {pos}")
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, pos].numpy(),
                                   rtol=tol, atol=tol, err_msg=f"pos {pos}")
