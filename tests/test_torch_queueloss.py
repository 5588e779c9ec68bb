"""Port vs reference: the epoch-batched fluid-queue loss scan.

The port's ``queue_loss_batched`` runs its plain PyTorch version here; the
reference runs its Pallas kernel in interpret mode.  Tolerance: rtol 3e-4,
atol 1e-4 — the contract of ``tests/test_kernels_queueloss.py`` (float32
loads and queue against float64).
"""

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro.kernels.queueloss import ops as ref_ops
from repro_torch.kernels.queueloss import ops

torch.set_num_threads(1)

RTOL, ATOL = 3e-4, 1e-4
DT = 25.0


def _inputs(seed, b, ts, c, e):
    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 5.0, (b, ts, c))
    d *= 1.0 + 3.0 * (rng.random((b, ts, c)) < 0.05)  # bursts overflow buffers
    w = rng.random((b, c, e)) * (rng.random((b, c, e)) < 0.3)
    cap = rng.uniform(20.0, 60.0, (b, e))
    cap[rng.random((b, e)) < 0.1] = 0.0  # dead links
    buf = cap * 0.025
    return d, w, cap, buf


@pytest.mark.parametrize("b,ts,c,e", [(3, 40, 30, 30), (4, 150, 20, 20)])
def test_queue_loss_batched_matches_reference(b, ts, c, e):
    """The queue carries across many sub-steps (more than the reference's
    time tile), and drops are non-trivial."""
    d, w, cap, buf = _inputs(ts, b, ts, c, e)
    ref = ref_ops.queue_loss_batched(d, w, cap, buf, DT, backend="pallas")
    ref_np = ref_ops.queue_loss_batched(d, w, cap, buf, DT, backend="numpy")
    out = ops.queue_loss_batched(d, w, cap, buf, DT, backend="torch", device="cpu")
    for a, r, p in zip(out, ref_np, ref):
        assert a.shape == (b, ts) and a.dtype == np.float64
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(a, p, rtol=RTOL, atol=ATOL)
    assert out[0].sum() > 0.0, "the comparison must see real drops"
    for a, r in zip(ops.queue_loss_batched(d, w, cap, buf, DT, backend="numpy"),
                    ref_np):
        np.testing.assert_array_equal(a, r)


def test_queue_resets_per_epoch():
    """Equal epochs give equal drops: no queue state crosses an epoch."""
    d, w, cap, buf = _inputs(7, 3, 24, 12, 12)
    for x in (d, w, cap, buf):
        x[2] = x[0]
    drop, _ = ops.queue_loss_batched(d, w, cap, buf, DT, backend="torch",
                                     device="cpu")
    assert drop[0].sum() > 0.0
    np.testing.assert_allclose(drop[2], drop[0], rtol=1e-6, atol=0.0)


def test_zero_padded_tail_never_adds_drops():
    """Padded sub-steps (zero demand) only drain the queue."""
    d, w, cap, buf = _inputs(11, 2, 20, 12, 12)
    padded = np.concatenate([d, np.zeros((2, 12, 12))], axis=1)
    short, _ = ops.queue_loss_batched(d, w, cap, buf, DT, backend="torch",
                                      device="cpu")
    long, _ = ops.queue_loss_batched(padded, w, cap, buf, DT, backend="torch",
                                     device="cpu")
    assert short.sum() > 0.0
    np.testing.assert_allclose(long[:, :20], short, rtol=1e-6, atol=1e-9)
    assert (long[:, 20:] == 0.0).all()


def test_wrapper_refuses_mixed_placements():
    z = torch.zeros((1, 2, 3))
    with pytest.raises(ValueError, match="float32"):
        ops.queueloss_batched(z, torch.zeros((1, 3, 4)), torch.zeros((1, 4)),
                              torch.zeros((1, 4), dtype=torch.float64), 1.0)
    with pytest.raises(ValueError, match="disagree"):
        ops.queueloss_batched(z, torch.zeros((1, 3, 4)), torch.zeros((1, 5)),
                              torch.zeros((1, 4)), 1.0)
