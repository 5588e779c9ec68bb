"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's on
the same inputs and parameters.

The reference initializes the reduced dbrx and mixtral models; the first
block's expert weights go to the port through
:func:`repro_torch.interop.model_from_numpy`.  The same numpy-seeded
activations go through both packages' ``moe_ffn_onehot`` and
``moe_ffn_sorted``: in float32 the outputs agree at rtol 1e-5, in bfloat16
within the reference's own sorted-vs-onehot bound (2e-2 of the largest
output, ``tests/test_arch_smoke.py``); the aux losses agree at 1e-6.  At 128
tokens dispatch is lossless (capacity = T); at 384 tokens (capacity 1.25·T·k/E)
activations skewed towards one expert drop tokens in the reference's order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_arch as ref_get_arch
from repro.models import moe as ref_moe
from repro.models.api import build_model as ref_build_model
from repro_torch.configs import get_arch
from repro_torch.interop import model_from_numpy
from repro_torch.models import moe

torch.set_num_threads(1)

IMPLS = ("onehot", "sorted")


def _setup(arch, dtype):
    """Both packages' configs, the reference's first-block MoE params and
    the port's copy."""
    ref_cfg = dataclasses.replace(ref_get_arch(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype=dtype)
    params = ref_build_model(ref_cfg).init(jax.random.key(0))
    net = model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    ref_p = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["moe"])
    return ref_cfg, cfg, ref_p, net.blocks[0].moe


def _run(impl, ref_cfg, cfg, ref_p, p, x, dtype):
    yr, ar = getattr(ref_moe, f"moe_ffn_{impl}")(ref_p, jnp.asarray(x, dtype), ref_cfg)
    yp, ap = getattr(moe, f"moe_ffn_{impl}")(
        p, torch.from_numpy(x).to(getattr(torch, dtype)), cfg)
    assert yp.dtype == getattr(torch, dtype) and yp.shape == x.shape
    return np.asarray(yr, np.float32), float(ar), yp.float().numpy(), float(ap)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["dbrx-132b", "mixtral-8x7b"])
@pytest.mark.parametrize("n_seq", [64, 192])
def test_moe_ffn_matches_reference(arch, dtype, impl, n_seq):
    ref_cfg, cfg, ref_p, p = _setup(arch, dtype)
    x = np.random.default_rng(1).normal(0, 1, (2, n_seq, cfg.d_model))
    yr, ar, yp, ap = _run(impl, ref_cfg, cfg, ref_p, p, x, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(yp, yr, rtol=1e-5, atol=1e-5)
    else:
        assert np.abs(yp - yr).max() / np.abs(yr).max() < 2e-2
    assert ap == pytest.approx(ar, abs=1e-6)
    assert p.router.dtype == torch.float32  # the router stays float32


@pytest.mark.parametrize("impl", IMPLS)
def test_capacity_lossless_and_dropping_match_reference(impl):
    """Activations skewed towards expert 0 (shifted along its router
    column): at 128 tokens (≤ 256) every token keeps both its experts, so
    the output is the dense top-k mixture; at 384 tokens expert 0's capacity
    (1.25·384·2/4 = 240) drops the tokens past it in the reference's
    order."""
    ref_cfg, cfg, ref_p, p = _setup("mixtral-8x7b", "float32")
    rng = np.random.default_rng(2)
    r0 = p.router[:, 0].numpy().astype(np.float64)
    shift = 3.0 * r0 / np.linalg.norm(r0)

    def inputs(n):
        return rng.normal(0, 1, (2, n, cfg.d_model)) + shift

    def dense_mixture(x):
        xt = torch.from_numpy(x).float().reshape(-1, cfg.d_model)
        probs = torch.softmax(xt @ p.router, -1)
        gates, idx = torch.topk(probs, cfg.top_k, -1)
        gates = gates / gates.sum(-1, keepdim=True)
        out = torch.zeros_like(xt)
        for j in range(cfg.top_k):
            for e in range(cfg.n_experts):
                sel = idx[:, j] == e
                h = F.silu(xt[sel] @ p.w_gate[e]) * (xt[sel] @ p.w_up[e])
                out[sel] += gates[sel, j, None] * (h @ p.w_down[e])
        return out.reshape(x.shape).numpy(), (idx == 0).any(-1).sum().item()

    x = inputs(64)
    yr, _, yp, _ = _run(impl, ref_cfg, cfg, ref_p, p, x, "float32")
    mix, n_to_0 = dense_mixture(x)
    assert n_to_0 > 64  # more than half of the 128 tokens use expert 0
    np.testing.assert_allclose(yp, mix, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yp, yr, rtol=1e-5, atol=1e-5)

    x = inputs(192)
    yr, _, yp, _ = _run(impl, ref_cfg, cfg, ref_p, p, x, "float32")
    mix, n_to_0 = dense_mixture(x)
    assert n_to_0 > 240  # past expert 0's capacity
    dropped = np.abs(yp - mix).max(-1) > 1e-4
    assert 0 < dropped.sum() <= n_to_0 - 240
    np.testing.assert_allclose(yp, yr, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["dbrx-132b", "mixtral-8x7b"])
def test_sorted_matches_onehot(arch):
    """The port's two dispatch paths agree: bit for bit up to float32
    rounding without drops, and within the reference's bf16 bound."""
    for dtype, check in (("float32", lambda a, b: np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-5)),
                         ("bfloat16", lambda a, b: np.abs(a - b).max()
                          / np.abs(a).max() < 2e-2 or pytest.fail("bf16"))):
        _, cfg, _, p = _setup(arch, dtype)
        x = torch.from_numpy(np.random.default_rng(1).normal(
            0, 1, (2, 64, cfg.d_model))).to(getattr(torch, dtype))
        y1, a1 = moe.moe_ffn_onehot(p, x, cfg)
        y2, a2 = moe.moe_ffn_sorted(p, x, cfg)
        check(y1.float().numpy(), y2.float().numpy())
        assert float(a1) == pytest.approx(float(a2), abs=1e-6)
        cfg_s = dataclasses.replace(cfg, moe_impl="sorted")
        assert torch.equal(moe.moe_ffn(p, x, cfg_s)[0], y2)
        assert torch.equal(moe.moe_ffn(p, x, cfg)[0], y1)
