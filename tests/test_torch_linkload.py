"""Port vs reference: the epoch-batched link-load metrics.

The port's ``link_metrics_batched`` runs its plain PyTorch version here (CPU
tensors); the reference runs its Pallas kernel in interpret mode and its
float64 numpy oracle.  Tolerance: rtol 3e-4, atol 1e-4 — the contract of
``tests/test_kernels_linkload.py`` (float32 accumulation against float64).
"""

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro.kernels.linkload import ops as ref_ops
from repro_torch.kernels.linkload import ops

torch.set_num_threads(1)

RTOL, ATOL = 3e-4, 1e-4
NAMES = ("mlu", "alu", "olr", "tot")


def _inputs(seed, b, t, c, e):
    rng = np.random.default_rng(seed)
    d = rng.gamma(2.0, 10.0, (b, t, c))
    w = rng.random((b, c, e)) * (rng.random((b, c, e)) > 0.5)
    cap = rng.uniform(50, 500, (b, e))
    cap[rng.random((b, e)) < 0.1] = 0.0  # dead links
    return d, w, cap


@pytest.mark.parametrize("b,t,c,e", [(3, 7, 132, 132), (4, 13, 30, 30),
                                     (3, 3, 56, 56)])
def test_link_metrics_batched_matches_reference(b, t, c, e):
    d, w, cap = _inputs(b * 100 + t, b, t, c, e)
    ref_pallas = ref_ops.link_metrics_batched(d, w, cap, 0.8, backend="pallas")
    ref_numpy = ref_ops.link_metrics_batched(d, w, cap, 0.8, backend="numpy")
    out = ops.link_metrics_batched(d, w, cap, 0.8, backend="torch", device="cpu")
    for a, r, p, name in zip(out, ref_numpy, ref_pallas, NAMES):
        assert a.shape == (b, t), name
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(a, p, rtol=RTOL, atol=ATOL, err_msg=name)
    # the port's numpy oracle is the reference's, line for line
    for a, r in zip(ops.link_metrics_batched(d, w, cap, 0.8, backend="numpy"),
                    ref_numpy):
        np.testing.assert_array_equal(a, r)


def test_dead_links_are_excluded_from_alu_and_olr():
    """ALU/OLR average over each epoch's own live links; an all-dead epoch
    scores 0 (as the reference's n_live clamp)."""
    d, w, cap = _inputs(5, 3, 4, 20, 20)
    cap[1] = 0.0
    out = ops.link_metrics_batched(d, w, cap, 0.8, backend="torch", device="cpu")
    ref = ref_ops.link_metrics_batched(d, w, cap, 0.8, backend="numpy")
    for a, r, name in zip(out, ref, NAMES):
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL, err_msg=name)
    assert (out[0][1] == 0).all() and (out[1][1] == 0).all()


def test_wrapper_refuses_what_the_kernel_does_not_take():
    d = torch.zeros((2, 3, 4))
    w = torch.zeros((2, 4, 5))
    ic = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="float32"):
        ops.linkload_batched(d.double(), w, ic, 0.8)
    with pytest.raises(ValueError, match="contiguous"):
        ops.linkload_batched(d, w.transpose(1, 2).contiguous().transpose(1, 2), ic, 0.8)
    with pytest.raises(ValueError, match="disagree"):
        ops.linkload_batched(d, w, torch.zeros((2, 4)), 0.8)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.link_metrics_batched(np.zeros((1, 1, 2)), np.zeros((1, 2, 2)),
                                 np.ones((1, 2)), backend="pallas")
