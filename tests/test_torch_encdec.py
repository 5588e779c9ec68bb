"""The port's encoder-decoder (the audio family, seamless-m4t-large-v2's
reduced config) against the reference's ``repro/models/encdec.py`` on the
same parameters (``interop.model_from_numpy``) and numpy-seeded inputs.

The port's parameter tree has the reference's keys, shapes and dtypes; the
full forward (a bidirectional encoder through flash attention with
``causal=False``, the decoder's self- and cross-attention; the plain versions
on the CPU) and the token-by-token decode against the encoder's output match
the reference's at ``tests/test_torch_models.py``'s tolerances (1e-4 in
float32, 6e-2 in bfloat16), and so do ``cross_attention`` (Sq != Sk, and one
token) and the encoder alone.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models import attention as ref_attn
from repro.models import encdec as ref_encdec
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.interop import model_from_numpy
from repro_torch.models import attention as attn
from repro_torch.models import encdec
from repro_torch.models.api import build_model
from repro_torch.models.params import Params

torch.set_num_threads(1)

ARCH = "seamless-m4t-large-v2"
B, S_ENC, S_DEC = 2, 24, 16
TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def _configs(dtype):
    ref_cfg = dataclasses.replace(ref_get_arch(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    return ref_cfg, cfg


def _inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    frames = rng.normal(0, 1, (B, S_ENC, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab, (B, S_DEC))
    return frames, tokens


def test_port_init_matches_reference_tree():
    ref_cfg, cfg = _configs("bfloat16")
    ref = jax.tree_util.tree_map(np.asarray, ref_build_model(ref_cfg).init(jax.random.key(0)))
    model = build_model(cfg, device="cpu")
    ours = model.init(seed=5).state_dict()
    theirs = model_from_numpy(cfg, ref, device="cpu").state_dict()
    assert sorted(ours) == sorted(theirs)
    for key, t in ours.items():
        assert t.shape == theirs[key].shape and t.dtype == theirs[key].dtype, key
    assert len(model.init(seed=5).enc_blocks) == cfg.encoder_layers
    assert "dec_blocks.1.xattn.wk" in ours


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_decode_match_reference(dtype):
    ref_cfg, cfg = _configs(dtype)
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(2))
    frames, tokens = _inputs(cfg)
    jframes = jnp.asarray(frames, ref_cfg.dtype)
    jtok = jnp.asarray(tokens, jnp.int32)
    ref_full = np.asarray(ref_model.forward(params, {"frames": jframes, "tokens": jtok}),
                          np.float32)
    model = build_model(cfg, device="cpu")
    net = model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    tframes = torch.from_numpy(frames).to(getattr(torch, dtype))
    ttok = torch.as_tensor(tokens)
    full = model.forward(net, {"frames": tframes, "tokens": ttok})
    assert full.shape == (B, S_DEC, cfg.vocab) and full.dtype == getattr(torch, dtype)
    assert torch.equal(net(tframes, ttok), full)
    tol = TOL[dtype]
    np.testing.assert_allclose(full.float().numpy(), ref_full, rtol=tol, atol=tol)

    # decode against the encoder's output, as the reference's tests do
    ref_cache = ref_model.init_cache(B, S_DEC, enc_len=S_ENC)
    ref_cache["enc_out"] = ref_encdec.encode(params, jframes, ref_cfg)
    cache = model.init_cache(B, S_DEC, enc_len=S_ENC)
    with torch.inference_mode():
        cache["enc_out"][:] = encdec.encode(net, tframes, cfg)
    np.testing.assert_allclose(cache["enc_out"].float().numpy(),
                               np.asarray(ref_cache["enc_out"], np.float32),
                               rtol=tol, atol=tol)
    step = jax.jit(lambda p, c, t, pos: ref_model.decode(p, c, t, pos))
    for pos in range(S_DEC):
        ref_logits, ref_cache = step(params, ref_cache, jtok[:, pos:pos + 1], jnp.int32(pos))
        logits, cache = model.decode(net, cache, ttok[:, pos:pos + 1], pos)
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(ref_logits, np.float32), rtol=tol,
                                   atol=tol, err_msg=f"pos {pos}")
        np.testing.assert_allclose(logits[:, 0].float().numpy(),
                                   full[:, pos].float().numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("s", [1, 7])
def test_cross_attention_matches_reference(s):
    """A full sequence (flash attention, Sq = 7 against Sk = 24) and one token
    (the plain ``_sdpa``) over the encoder's output."""
    ref_cfg, cfg = _configs("float32")
    p = ref_attn.init_cross_attn_params(jax.random.key(1), ref_cfg)
    net = Params({k: torch.from_numpy(np.array(v)) for k, v in p.items()})
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (B, s, cfg.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (B, S_ENC, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_attn.cross_attention(p, jnp.asarray(x), jnp.asarray(enc), ref_cfg))
    got = attn.cross_attention(net, torch.from_numpy(x), torch.from_numpy(enc), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_bidirectional_encoder_matches_reference():
    ref_cfg, cfg = _configs("float32")
    params = ref_build_model(ref_cfg).init(jax.random.key(6))
    net = model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    frames, _ = _inputs(cfg, seed=5)
    want = np.asarray(ref_encdec.encode(params, jnp.asarray(frames), ref_cfg))
    with torch.inference_mode():
        got = encdec.encode(net, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # bidirectional: the first frame's output depends on the last frame
    moved = frames.copy()
    moved[:, -1] += 1.0
    with torch.inference_mode():
        other = encdec.encode(net, torch.from_numpy(moved), cfg)
    assert not torch.allclose(other[:, 0], got[:, 0])
