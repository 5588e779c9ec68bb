"""Gradients of the port's kernel wrappers on the CPU against JAX's autodiff
of the reference's plain versions, on the same numpy-seeded inputs.

Flash attention: the plain backward ``attention_bwd_ref`` (from the forward's
output and log-sum-exp) and ``FlashAttention`` (what training calls) against
``jax.grad`` of the reference's ``_sdpa`` (``repro/models/attention.py``) in
float32 at 1e-5 — causal, causal with a window, non-causal with Sq != Sk
(cross-attention), GQA up to a group of 16, hd 16 to 256 and a ragged 100,
a window across the kernels' 64-row tiles — and the bfloat16 plain
backward within ``bf16_grad_rounding_bound`` (what ``chip_smoke.py`` holds the
kernel to).  The RG-LRU scan: ``RGLRUScan`` (the reversed-scan backward)
against PyTorch's autograd through ``rglru_scan_ref`` and against
``jax.grad`` of the reference's ``rglru_scan_ref`` (an associative scan) at
the reference's 1e-4.  The SSD chunk scan: ``ssd_chunk_ref_bwd`` (the plain
backward) and ``SSDScan`` (what training calls through ``ssd_scan``)
against ``jax.vjp`` of the reference's ``ssd_chunk_ref``
(``repro/kernels/ssd_chunk/ref.py``) in float32, each gradient within 1e-4
of its own largest magnitude: several chunks, one chunk, a chunk halved to
divide S, and Q, N, P not multiples of 4.  The kernels themselves are held
to these on the card (``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase
3).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_scan_ref
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models.attention import _sdpa as ref_sdpa
from repro_torch.kernels.flash_attention import ops as faops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_lse_ref,
                                                     attention_ref,
                                                     bf16_grad_rounding_bound)
from repro_torch.kernels.rglru_scan import ops as rlops
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.kernels.ssd_chunk import ops as sdops
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref_bwd

torch.set_num_threads(1)
GRAD_TOL, RGLRU_TOL, SSD_GRAD_REL = 1e-5, 1e-4, 1e-4

# (B, H, S, P, N, chunk asked for, chunk the wrapper runs)
SSD_CASES = [(2, 3, 48, 16, 8, 16, 16),   # three chunks
             (1, 2, 16, 8, 12, 64, 16),   # one chunk: nothing carries
             (2, 2, 40, 8, 4, 16, 8),     # 16 does not divide 40: halved to 8
             (1, 2, 21, 6, 5, 32, 21)]    # Q, N, P not multiples of 4

# (B, Sq, Sk, H, KV, hd, causal, window)
ATTN_CASES = [(2, 24, 24, 4, 2, 32, True, 0),
              (2, 40, 40, 4, 1, 32, True, 9),
              (2, 12, 36, 4, 4, 100, False, 0),
              (1, 30, 30, 6, 2, 100, True, 0),
              (1, 20, 20, 2, 1, 256, True, 0),     # the widest head
              (1, 20, 28, 16, 1, 32, False, 0),    # a group of 16
              (1, 70, 70, 2, 2, 16, True, 33)]     # a window across the 64-row tiles


def _attn_inputs(b, sq, sk, h, kv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, h, hd)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, hd)).astype(np.float32),
            rng.normal(0, 1, (b, sk, kv, hd)).astype(np.float32),
            rng.normal(0, 1, (b, sq, h, hd)).astype(np.float32))


def _ref_grads(q, k, v, do, h, kv, causal, window):
    """jax.grad of the reference's ``_sdpa`` with its mask semantics."""
    sq, sk = q.shape[1], k.shape[1]
    i, j = np.arange(sq)[:, None], np.arange(sk)[None, :]
    mask = np.ones((sq, sk), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    mask = jnp.broadcast_to(jnp.asarray(mask), (q.shape[0], sq, sk))
    cfg = types.SimpleNamespace(n_heads=h, n_kv_heads=kv)
    _, vjp = jax.vjp(lambda a, b, c: ref_sdpa(a, b, c, mask, cfg), *map(jnp.asarray,
                                                                         (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _rows(x):
    """(B, S, N, hd) -> (B·N, S, hd)"""
    b, s, n, hd = x.shape
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1, 3))).reshape(
        b * n, s, hd)


def _unrows(t, b):
    bn, s, hd = t.shape
    return t.reshape(b, bn // b, s, hd).transpose(1, 2).detach().numpy()


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_backward_matches_jax_grad(case):
    b, sq, sk, h, kv, hd, causal, window = case
    q, k, v, do = _attn_inputs(b, sq, sk, h, kv, hd)
    want = _ref_grads(q, k, v, do, h, kv, causal, window)
    mask = dict(n_heads=h, n_kv=kv, causal=causal, window=window)
    qr, kr, vr, dor = map(_rows, (q, k, v, do))
    o = attention_ref(qr, kr, vr, **mask)
    lse = attention_lse_ref(qr, kr, **mask)
    plain = attention_bwd_ref(qr, kr, vr, o, dor, lse, **mask)
    # FlashAttention through the model's layout, as training calls it
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = faops.flash_attention(qt, kt, vt, causal=causal, window=window)
    out.backward(torch.from_numpy(do))
    for name, got_plain, got_fn, ref in zip("qkv", plain, (qt.grad, kt.grad, vt.grad),
                                           want):
        scale = 1 + np.abs(ref)
        np.testing.assert_allclose(_unrows(got_plain, b) / scale, ref / scale,
                                   rtol=0, atol=GRAD_TOL, err_msg=f"plain d{name}")
        np.testing.assert_allclose(got_fn.numpy() / scale, ref / scale, rtol=0,
                                   atol=GRAD_TOL, err_msg=f"FlashAttention d{name}")


@pytest.mark.parametrize("case", ATTN_CASES[:3], ids=lambda c: "-".join(map(str, c)))
def test_bf16_plain_backward_within_rounding_bound(case):
    """The bfloat16 plain backward (P and dS rounded to bfloat16, as the
    kernel rounds them) differs from the float32 gradient by less than the
    bound ``chip_smoke.py`` holds the kernel to."""
    b, sq, sk, h, kv, hd, causal, window = case
    mask = dict(n_heads=h, n_kv=kv, causal=causal, window=window)
    q, k, v, do = (_rows(x).bfloat16() for x in _attn_inputs(b, sq, sk, h, kv, hd, 1))
    o = attention_ref(q, k, v, **mask)
    got = attention_bwd_ref(q, k, v, o, do, attention_lse_ref(q, k, **mask), **mask)
    ref, bound = bf16_grad_rounding_bound(q, k, v, do, **mask)
    for g, r, t in zip(got, ref, bound):
        assert g.dtype == torch.bfloat16
        assert float(((g.float() - r).abs() / t).max()) <= 1.0


def test_flash_attention_without_grad_keeps_the_forward():
    """Serving (no grad) takes the forward alone, the same bits as before."""
    q, k, v, _ = (torch.from_numpy(x) for x in _attn_inputs(1, 8, 8, 2, 1, 16))
    with torch.no_grad():
        out = faops.flash_attention(q, k, v)
    assert out.grad_fn is None
    want = attention_ref(_rows(q.numpy()), _rows(k.numpy()), _rows(v.numpy()),
                         n_heads=2, n_kv=1, causal=True, window=0)
    assert torch.equal(_rows(out.numpy()), want)


@pytest.mark.parametrize("shape", [(2, 37, 5), (1, 128, 33), (3, 1, 4)])
def test_rglru_backward_matches_autograd_and_jax(shape):
    rng = np.random.default_rng(7)
    a = (0.8 + 0.199 * rng.random(shape)).astype(np.float32)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    dh = rng.normal(0, 1, shape).astype(np.float32)
    at, xt = (torch.from_numpy(t).requires_grad_() for t in (a, x))
    h = rlops.rglru_scan(at, xt)
    assert isinstance(h.grad_fn, torch.autograd.function.BackwardCFunction)
    got = torch.autograd.grad(h, (at, xt), torch.from_numpy(dh))
    a2, x2 = (torch.from_numpy(t).requires_grad_() for t in (a, x))
    # at S = 1, h = x does not touch a: its gradient is zero
    auto = torch.autograd.grad(rglru_scan_ref(a2, x2), (a2, x2), torch.from_numpy(dh),
                               materialize_grads=True)
    _, vjp = jax.vjp(jax_rglru_scan_ref, jnp.asarray(a), jnp.asarray(x))
    want = vjp(jnp.asarray(dh))
    for g, au, w in zip(got, auto, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), au.numpy(), rtol=RGLRU_TOL, atol=RGLRU_TOL)
        np.testing.assert_allclose(g.numpy(), w, rtol=RGLRU_TOL, atol=RGLRU_TOL)


def _ssd_inputs(b, h, s, p, n, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, s, p)).astype(np.float32),
            (0.001 + 0.099 * rng.random((b, h, s, 1))).astype(np.float32),
            -(1.0 + 7.0 * rng.random((h, 1, 1, 1))).astype(np.float32),
            rng.normal(0, 1, (b, 1, s, n)).astype(np.float32),
            rng.normal(0, 1, (b, 1, s, n)).astype(np.float32),
            rng.normal(0, 1, (b, h, s, p)).astype(np.float32))


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_backward_matches_jax_grad(case):
    b, h, s, p, n, chunk, q_len = case
    *ins, dy = _ssd_inputs(b, h, s, p, n)
    _, vjp = jax.vjp(lambda *t: jax_ssd_chunk_ref(*t, q_len), *map(jnp.asarray, ins))
    want = [np.asarray(w) for w in vjp(jnp.asarray(dy))]
    plain = ssd_chunk_ref_bwd(*map(torch.from_numpy, ins), torch.from_numpy(dy), q_len)
    # SSDScan through the wrapper, as training calls it (the chunk halved there)
    ts = [torch.from_numpy(t).requires_grad_() for t in ins]
    out = sdops.ssd_scan(*ts, chunk)
    assert isinstance(out.grad_fn, torch.autograd.function.BackwardCFunction)
    got = torch.autograd.grad(out, ts, torch.from_numpy(dy))
    for name, g_plain, g_fn, w in zip(("dx", "ddt", "da", "db", "dc"), plain, got, want):
        assert g_fn.shape == g_plain.shape == w.shape, name
        scale = float(np.abs(w).max())
        for label, g in (("plain", g_plain), ("SSDScan", g_fn)):
            err = float(np.abs(g.numpy() - w).max())
            assert err <= SSD_GRAD_REL * scale, (label, name, err, scale)


def test_ssd_scan_without_grad_keeps_the_forward():
    """Serving (no grad) takes the forward alone, the plain version's bits."""
    *ins, _ = (torch.from_numpy(t) for t in _ssd_inputs(1, 2, 16, 8, 4))
    out = sdops.ssd_scan(*ins, 8)
    assert out.grad_fn is None
    assert torch.equal(out, sdops.ref.ssd_chunk_ref(*ins, 8))


@pytest.mark.parametrize("remat,runs", [(False, 1), (True, 2), ("dots", 2)])
def test_ssd_scan_under_each_remat_mode(monkeypatch, remat, runs):
    """Through the ssm model's loss, ``SSDScan``'s forward runs once a layer
    without remat and twice under both remat modes (``"dots"`` keeps only
    the matrix products: the custom Function is recomputed, not saved), and
    its backward once a layer; the Function saves nothing but its inputs."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model

    calls = {"fwd": 0, "bwd": 0, "saved": []}
    fwd, bwd = sdops._forward, sdops.ssd_scan_bwd

    def counted_fwd(*args):
        calls["fwd"] += 1
        return fwd(*args)

    def counted_bwd(*args):
        calls["bwd"] += 1
        calls["saved"].append(args[:5])
        return bwd(*args)

    monkeypatch.setattr(sdops, "_forward", counted_fwd)
    monkeypatch.setattr(sdops, "ssd_scan_bwd", counted_bwd)
    model = build_model(get_arch("mamba2-130m").reduced(), device="cpu")
    net = model.init(0)
    net.requires_grad_(True)
    tokens = torch.arange(32).reshape(2, 16)
    loss, _ = model.loss(net, {"tokens": tokens, "labels": tokens}, remat=remat)
    torch.autograd.grad(loss, list(net.parameters()))
    n = model.cfg.n_layers
    assert (calls["fwd"], calls["bwd"]) == (runs * n, n)
    x, dt, a, b, c = calls["saved"][0]
    assert x.dim() == 4 and dt.shape[-1] == 1 and a.dim() == 4 and b.shape == c.shape
