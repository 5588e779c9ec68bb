"""The model kernels' plain PyTorch versions (what the wrappers run on a CPU
tensor) against the reference's ``ops`` wrappers on the same numpy-seeded
inputs, through both of the reference's backends: ``"pallas"`` (the Pallas
kernel in interpret mode on the CPU) and ``"ref"`` (its jnp oracle).

Tolerances are the reference's own (``tests/test_kernels_sweep.py``): flash
attention 2e-3 in float32 and 3e-2 in bfloat16, the RG-LRU scan 1e-4, the
SSD scan relative 1e-3 and chunk invariance 1e-4.  The bound on bf16
rounding that the card holds the bf16 flash kernel to is tested here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.rglru_scan import ops as jrl
from repro.kernels.ssd_chunk import ops as jsd
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.rglru_scan import ops as rl
from repro_torch.kernels.ssd_chunk import ops as sd

torch.set_num_threads(1)

BACKENDS = ["pallas", "ref"]


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,sq,h,kv,hd,causal,window", [
    (2, 128, 4, 2, 64, True, 0), (2, 130, 4, 1, 32, True, 48),
    (1, 65, 4, 1, 100, False, 0), (1, 96, 2, 2, 64, False, 24)])
def test_flash_attention_matches_reference(backend, b, sq, h, kv, hd, causal,
                                           window, rng):
    q = rng.normal(0, 1, (b, sq, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, sq, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, sq, kv, hd)).astype(np.float32)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, backend=backend)
    before = fa.launches
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert fa.launches == before  # the CPU runs the plain version
    assert out.shape == (b, sq, h, hd)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_flash_attention_bf16_matches_reference(backend, rng):
    shapes = ((2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64))
    q, k, v = (rng.normal(0, 1, s).astype(np.float32) for s in shapes)
    ref = jfa.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                              window=32, backend=backend)
    out = fa.flash_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)), window=32)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("shift", [0, -1, 1])
def test_bf16_rounding_bound_separates_a_window_one_key_off(shift, rng):
    """The bound that the card's bf16 flash check uses, on one row at
    recurrentgemma-9b's shape (S 4096, hd 256, window 2048): the kernel's
    arithmetic (float32 scores and sums, the weights and the output rounded
    to bfloat16) stays within it; a window one key short or long does not."""
    s, hd, window = 4096, 256, 2048
    q, k, v = (_t(rng.normal(0, 1, (1, s, hd)), torch.bfloat16) for _ in range(3))
    mask = dict(n_heads=1, n_kv=1, causal=True)
    ref, bound = fa_ref.bf16_rounding_bound(q, k, v, window=window, **mask)
    if shift:
        out = fa_ref.attention_ref(q.float(), k.float(), v.float(),
                                   window=window + shift, **mask)
    else:
        scores = (q.float() @ k.float().transpose(1, 2)) / hd ** 0.5
        i = torch.arange(s)
        band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
        scores = torch.where(band, scores, fa_ref.NEG_INF)
        p = torch.exp(scores - scores.amax(-1, keepdim=True))
        out = ((p.bfloat16().float() @ v.float()) / p.sum(-1, keepdim=True)).bfloat16()
    worst = float(((out.float() - ref).abs() / bound).max())
    assert (worst <= 1.0) == (shift == 0), worst


def _flash_tile_schedule(q, k, v, *, n_heads, n_kv, causal, window, tq=128, tk=64):
    """The bf16 kernel's visit order (``csrc/flash_attention.cu``) in float32:
    per (row, q-tile of ``tq`` rows), the ``tk``-key tiles from the first that
    meets the band of some row of the tile to the last, keys past Sk
    zero-filled and masked, masked scores ``-2e38``, online softmax.  Returns
    the output and the number of rows that a later tile reset (alpha = 0
    after a start of only masked keys)."""
    bh, sq, hd = q.shape
    sk = k.shape[1]
    rows = fa_ref.kv_rows(bh, n_heads, n_kv, q.device)
    pad = (-sk) % tk
    kf = torch.nn.functional.pad(k[rows], (0, 0, 0, pad))
    vf = torch.nn.functional.pad(v[rows], (0, 0, 0, pad))
    out, resets = torch.empty_like(q), 0
    for q0 in range(0, sq, tq):
        qi = torch.arange(q0, q0 + tq)[:, None]
        qt = torch.nn.functional.pad(q[:, q0:q0 + tq], (0, 0, 0, q0 + tq - min(sq, q0 + tq)))
        k_hi = min(sk, q0 + tq) if causal else sk
        k_lo = max(0, q0 - window + 1) if window > 0 else 0
        m = torch.full((bh, tq, 1), fa_ref.NEG_INF)
        l = torch.zeros((bh, tq, 1))
        acc = torch.zeros((bh, tq, hd))
        for k0 in range(k_lo // tk * tk, k_hi, tk):
            kj = torch.arange(k0, k0 + tk)[None, :]
            ok = kj < sk
            if causal:
                ok = ok & (kj <= qi)
            if window > 0:
                ok = ok & (kj > qi - window)
            s = (qt @ kf[:, k0:k0 + tk].transpose(1, 2)) / hd ** 0.5
            s = torch.where(ok[None], s, fa_ref.NEG_INF)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            resets += int(((alpha == 0) & (l > 0))[:, :sq - q0].sum())
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, k0:k0 + tk]
            m = m_new
        out[:, q0:q0 + tq] = (acc / l.clamp_min(1e-30))[:, :sq - q0]
    return out, resets


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("window", [48, 1])
def test_flash_tile_schedule_matches_reference(backend, window, rng):
    """The bf16 kernel's schedule (128-row q-tiles, 64-key tiles, the first
    visited tile per q-tile, -2e38 and the reset of a row that starts on
    masked keys) gives the reference's answer, here in float32 on the CPU."""
    b, s, h, kv, hd = 1, 300, 4, 2, 32
    q = rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, s, kv, hd)).astype(np.float32)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, window=window, backend=backend)
    rows = [_t(x).transpose(1, 2).reshape(-1, s, hd).contiguous() for x in (q, k, v)]
    out, resets = _flash_tile_schedule(*rows, n_heads=h, n_kv=kv, causal=True,
                                       window=window)
    assert resets > 0  # some rows start on tiles with no valid key
    np.testing.assert_allclose(out.reshape(b, h, s, hd).transpose(1, 2).numpy(),
                               np.asarray(ref), rtol=2e-3, atol=2e-3)


def test_flash_attention_wrapper_refuses_bad_inputs():
    q = torch.zeros(8, 16, 32)
    kv = torch.zeros(2, 16, 32)
    args = dict(n_heads=4, n_kv=1, causal=True, window=0)
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_attention_rows(q, kv.bfloat16(), kv.bfloat16(), **args)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention_rows(q, kv, kv, n_heads=4, n_kv=2, causal=True, window=0)
    with pytest.raises(ValueError, match="one of"):
        fa.flash_attention_rows(q.double(), kv.double(), kv.double(), **args)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_rows(q.transpose(1, 2), kv, kv, **args)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,s,d", [(2, 128, 128), (4, 37, 31), (2, 513, 130)])
def test_rglru_scan_matches_reference(backend, b, s, d, rng):
    a = rng.uniform(0.8, 0.999, (b, s, d)).astype(np.float32)
    x = rng.normal(0, 0.5, (b, s, d)).astype(np.float32)
    ref = jrl.rglru_scan(jnp.asarray(a), jnp.asarray(x), backend=backend)
    before = rl.launches
    out = rl.rglru_scan(_t(a), _t(x))
    assert rl.launches == before
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def _rglru_chunk_schedule(a, b, *, warps=16, steps=8):
    """The redesigned kernel's order (``csrc/rglru_scan.cu``) in float32: S
    in segments of ``warps * steps`` rows (past S: a = 1, b = 0), each cut
    into ``warps`` chunks of ``steps`` rows; per chunk the product of a and
    the state from 0, then the chunks walked in order from the state
    entering the segment, then every chunk re-run from its entering state."""
    bsz, s, d = a.shape
    seg = warps * steps
    pad = (-s) % seg
    a = torch.cat([a, torch.ones((bsz, pad, d))], 1).view(bsz, -1, warps, steps, d)
    b = torch.cat([b, torch.zeros((bsz, pad, d))], 1).view(bsz, -1, warps, steps, d)
    h = torch.empty_like(a)
    carry = torch.zeros((bsz, d))
    for g in range(a.shape[1]):
        ag, bg = a[:, g], b[:, g]  # (B, warps, steps, D)
        pa, ph = ag[:, :, 0], bg[:, :, 0]
        for u in range(1, steps):
            ph = ag[:, :, u] * ph + bg[:, :, u]
            pa = pa * ag[:, :, u]
        entering = []
        for k in range(warps):
            entering.append(carry)
            carry = pa[:, k] * carry + ph[:, k]
        hv = torch.stack(entering, 1)
        for u in range(steps):
            hv = ag[:, :, u] * hv + bg[:, :, u]
            h[:, g, :, u] = hv
    return h.view(bsz, -1, d)[:, :s]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s,lo,hi", [
    (256, 0.8, 0.999),   # two whole segments
    (37, 0.8, 0.999),    # less than one segment
    (513, 1e-6, 1e-3),   # ragged; chunk products underflow to 0
    (513, 0.999, 1.0)])  # ragged; a near 1 carries across every segment
def test_rglru_chunk_schedule_matches_reference(backend, s, lo, hi, rng):
    """The chunk-parallel kernel's split and combine order gives the
    reference's answer within its 1e-4, here in float32 on the CPU."""
    a = rng.uniform(lo, hi, (2, s, 33)).astype(np.float32)
    x = rng.normal(0, 0.5, (2, s, 33)).astype(np.float32)
    ref = jrl.rglru_scan(jnp.asarray(a), jnp.asarray(x), backend=backend)
    out = _rglru_chunk_schedule(_t(a), _t(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_rglru_scan_wrapper_refuses_bad_inputs():
    with pytest.raises(ValueError, match="one \\(B, S, D\\)"):
        rl.rglru_scan(torch.zeros(2, 4, 8), torch.zeros(2, 4, 7))
    with pytest.raises(ValueError, match="float32"):
        rl.rglru_scan(torch.zeros(2, 4, 8).double(), torch.zeros(2, 4, 8).double())


def _ssd_inputs(rng, b, h, s, p, n):
    return (rng.normal(0, 1, (b, h, s, p)).astype(np.float32),
            rng.uniform(0.001, 0.1, (b, h, s, 1)).astype(np.float32),
            -rng.uniform(1, 8, (h, 1, 1, 1)).astype(np.float32),
            rng.normal(0, 1, (b, 1, s, n)).astype(np.float32),
            rng.normal(0, 1, (b, 1, s, n)).astype(np.float32))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,h,s,p,n,chunk", [
    (1, 2, 128, 64, 32, 64), (2, 3, 256, 64, 128, 128), (1, 1, 64, 32, 16, 32),
    (1, 2, 96, 32, 16, 64)])  # the last halves its chunk to 32
def test_ssd_scan_matches_reference(backend, b, h, s, p, n, chunk, rng):
    args = _ssd_inputs(rng, b, h, s, p, n)
    # the reference's "ref" backend takes a chunk that divides S as it is
    ref_chunk = chunk if backend == "pallas" or s % chunk == 0 else 32
    ref = np.asarray(jsd.ssd_scan(*(jnp.asarray(x) for x in args), ref_chunk,
                                  backend=backend))
    before = sd.launches
    out = sd.ssd_scan(*(_t(x) for x in args), chunk).numpy()
    assert sd.launches == before
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-3


def test_ssd_scan_is_chunk_invariant(rng):
    """The chunk length does not change the result (the state carry is
    exact)."""
    args = [_t(x) for x in _ssd_inputs(rng, 1, 2, 256, 64, 64)]
    np.testing.assert_allclose(sd.ssd_scan(*args, 64).numpy(),
                               sd.ssd_scan(*args, 128).numpy(), rtol=1e-4, atol=1e-4)


def test_ssd_scan_wrapper_refuses_bad_shapes(rng):
    x, dt, a, b, c = (_t(v) for v in _ssd_inputs(rng, 1, 2, 64, 32, 16))
    with pytest.raises(ValueError, match="disagree"):
        sd.ssd_scan(x, dt[:, :1].contiguous(), a, b, c)
