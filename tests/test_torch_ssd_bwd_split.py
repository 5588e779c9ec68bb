"""The arithmetic of the SSD chunk backward's kernel (#9b,
``src/repro_torch/csrc/ssd_chunk.cu``: ``ssd_walks_kernel`` and
``ssd_grad_kernel``) written out in torch on the CPU, and held against
``jax.vjp`` of the reference's ``ssd_chunk_ref``
(``repro/kernels/ssd_chunk/ref.py``), run in float64 on the float32 inputs.

The kernel walks the states forward (S_in, the state entering each chunk)
and in reverse (G, the gradient of the state leaving it), then per chunk
takes the gradient formulas of the comment above ``ssd_grad_kernel``, with
the head sums of Wᵀ·C and W·B taken once after the heads.  Every product runs
on the tensor cores in 3xTF32: each float32 operand v splits into
hi = tf32(v), rounded to 10 mantissa bits to nearest with ties away from zero
(``cvt.rna.tf32.f32``), and lo = v - hi, which the tensor core reads with its
low 13 bits dropped; a product sums lo·hi' + hi·lo' + hi·hi' and drops
lo·lo'.  Here that split is applied to every product's operands (sums in
float64), and the result is held within 1e-5 of each gradient's largest
|ref|; the same formulas without the split within 1e-6.  This checks the
derivation and the split before a card call; nothing on the main path uses
these functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jax_ssd_chunk_ref

torch.set_num_threads(1)
SPLIT_TOL, PLAIN_TOL = 1e-5, 1e-6

# (B, H, S, P, N, chunk): the kernel's ragged shape (64 halves to 32: three
# chunks, P and N below the tiles) and two chunks of 64
CASES = [(1, 3, 96, 32, 16, 32), (2, 3, 128, 16, 8, 64)]


def _inputs(b, h, s, p, n, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, s, p)).astype(np.float32),
            (0.001 + 0.099 * rng.random((b, h, s, 1))).astype(np.float32),
            -(1.0 + 7.0 * rng.random((h, 1, 1, 1))).astype(np.float32),
            rng.normal(0, 1, (b, 1, s, n)).astype(np.float32),
            rng.normal(0, 1, (b, 1, s, n)).astype(np.float32),
            rng.normal(0, 1, (b, h, s, p)).astype(np.float32))


def tf32_split(v: torch.Tensor):
    """(hi, lo) of float32 v in float64, as the kernel feeds the MMA."""
    v = v.to(torch.float32).contiguous()
    hi = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    lo = ((v - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi.double(), lo.double()


def mm(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b of float32 operands: in 3xTF32 when split, else exactly."""
    if not split:
        return a.float().double() @ b.float().double()
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def ssd_bwd_formulas(x, dt, a, bm, cm, dy, chunk: int, split: bool):
    """(dx, ddt, da, db, dc) of the SSD chunk scan by the kernel's formulas,
    float64, in the kernel's layout (x, dy (B, H, S, P); dt (B, H, S, 1);
    a (H, 1, 1, 1); b, c (B, 1, S, N))."""
    bsz, h, s, p = x.shape
    n, q = bm.shape[-1], chunk
    nc = s // q
    f64 = lambda t: torch.as_tensor(t).double()
    xr, dyr = f64(x).reshape(bsz, h, nc, q, p), f64(dy).reshape(bsz, h, nc, q, p)
    dtr = f64(dt)[..., 0].reshape(bsz, h, nc, q)
    br, cr = f64(bm).reshape(bsz, 1, nc, q, n), f64(cm).reshape(bsz, 1, nc, q, n)
    av = f64(a)[:, 0, 0, 0][None, :, None, None]
    lc = torch.cumsum(dtr * av, dim=-1)                  # L, (B, H, nc, Q)
    lq = lc[..., -1:]
    w, ez, et = torch.exp(lq - lc) * dtr, torch.exp(lc), torch.exp(lq - lc)
    dq = torch.exp(lq[..., 0])                           # (B, H, nc)

    # the two walks: S_in entering chunk c, G leaving it
    s_in = torch.zeros(bsz, h, nc, n, p, dtype=torch.float64)
    g_st = torch.zeros_like(s_in)
    st = torch.zeros(bsz, h, n, p, dtype=torch.float64)
    for c in range(nc):
        s_in[:, :, c] = st
        bw = (br[:, :, c] * w[:, :, c, :, None]).transpose(-1, -2)
        st = st * dq[:, :, c, None, None] + mm(bw, xr[:, :, c], split)
    st = torch.zeros_like(st)
    for c in reversed(range(nc)):
        g_st[:, :, c] = st
        ce = (cr[:, :, c] * ez[:, :, c, :, None]).transpose(-1, -2)
        st = st * dq[:, :, c, None, None] + mm(ce, dyr[:, :, c], split)

    dx, ddt = torch.zeros_like(xr), torch.zeros_like(dtr)
    db, dc = torch.zeros(bsz, nc, q, n, dtype=torch.float64), torch.zeros(bsz, nc, q, n,
                                                                         dtype=torch.float64)
    da = torch.zeros(h, dtype=torch.float64)
    ts = torch.arange(q)
    causal = ts[None, :] >= ts[:, None]                  # (t, s): s >= t
    for c in range(nc):
        x_c, dy_c, b_c, c_c = xr[:, :, c], dyr[:, :, c], br[:, :, c], cr[:, :, c]
        l_c, dt_c, e_c, et_c = lc[:, :, c], dtr[:, :, c], ez[:, :, c], et[:, :, c]
        cbt = mm(b_c, c_c.transpose(-1, -2), split)      # (t, s): B_t . C_s
        dec_t = torch.where(causal, torch.exp(l_c[..., None, :] - l_c[..., :, None]), 0.0)
        d_t = mm(x_c, dy_c.transpose(-1, -2), split)     # D^T: (t, s)
        w_t = dec_t * dt_c[..., :, None] * d_t           # W^T
        a_t = cbt * dec_t                                # A^T
        m_t = cbt * w_t                                  # M^T
        bg = mm(b_c.expand(-1, h, -1, -1), g_st[:, :, c], split)
        g = mm(a_t, dy_c, split) + et_c[..., None] * bg
        dx[:, :, c] = dt_c[..., None] * g
        v = mm(dy_c, s_in[:, :, c].transpose(-1, -2), split)   # dy S_in^T: (s, n)
        r = et_c * dt_c * (x_c * bg).sum(-1)
        dl = (m_t.sum(-2) - m_t.sum(-1) + e_c * (c_c * v).sum(-1) - r)
        dl[..., -1] += r.sum(-1) + e_c[..., -1] * (s_in[:, :, c] * g_st[:, :, c]).sum((-1, -2))
        rc = torch.flip(torch.cumsum(torch.flip(dl, [-1]), -1), [-1])   # sum_{u >= t}
        ddt[:, :, c] = (x_c * g).sum(-1) + av[..., 0] * rc
        da += (dt_c * rc).sum((0, 2))
        x_w = x_c * (et_c * dt_c)[..., None]
        wsum = w_t.sum(1)                                # (B, t, s), summed over heads
        db[:, c] = (mm(x_w, g_st[:, :, c].transpose(-1, -2), split).sum(1)
                    + mm(wsum, c_c[:, 0], split))
        dc[:, c] = ((e_c[..., None] * v).sum(1)
                    + mm(wsum.transpose(-1, -2), b_c[:, 0], split))
    return (dx.reshape(bsz, h, s, p), ddt.reshape(bsz, h, s, 1), da.reshape(h, 1, 1, 1),
            db.reshape(bsz, 1, s, n), dc.reshape(bsz, 1, s, n))


@pytest.mark.parametrize("split,tol", [(True, SPLIT_TOL), (False, PLAIN_TOL)],
                         ids=["3xtf32", "exact"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ssd_bwd_formulas_match_jax_vjp(case, split, tol):
    b, h, s, p, n, chunk = case
    *ins, dy = _inputs(b, h, s, p, n)
    # the reference in float64: in float32 its own rounding of da is ~1e-5
    with jax.enable_x64(True):
        f64 = lambda t: jnp.asarray(t, dtype=jnp.float64)
        _, vjp = jax.vjp(lambda *t: jax_ssd_chunk_ref(*t, chunk), *map(f64, ins))
        want = [np.asarray(w) for w in vjp(f64(dy))]
    got = ssd_bwd_formulas(*ins, dy, chunk, split)
    for name, g, w in zip(("dx", "ddt", "da", "db", "dc"), got, want):
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol * scale, (name, err, scale)


def test_tf32_split_rounds_to_nearest_and_keeps_the_rest():
    """hi keeps 10 mantissa bits, rounded to nearest (ties away from zero);
    hi + lo is v within 2^-21 |v| (lo read at tf32 precision)."""
    v = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12),
                      3.14159265, -2.718281828e-3], dtype=torch.float32)
    hi, lo = tf32_split(v)
    assert hi.tolist()[:4] == [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]
    assert ((hi.float().view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi + lo - v.double()).abs() <= 2.0 ** -21 * v.double().abs()).all()
