"""Port vs reference: critical TMs (k-means) are identical.

The reference's Lloyd iterations run in JAX's default float type — float32,
or float64 with x64 mode on (CI) — so the port is handed the same dtype.
Contract: exact equality of the critical TMs (both take element-wise cluster
maxima of the same float64 window, so equal assignments give equal bits).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.clustering import critical_tms as ref_critical_tms
from repro_torch.core.clustering import critical_tms

torch.set_num_threads(1)

DTYPE = torch.float64 if jax.config.jax_enable_x64 else torch.float32


@pytest.mark.parametrize("seed,k", [(0, 4), (1, 12), (7, 12), (3, 1)])
def test_critical_tms_equal_reference(small_trace, seed, k):
    window = small_trace.demand[seed * 5: seed * 5 + 48]
    ref = ref_critical_tms(window, k=k, seed=seed)
    out = critical_tms(window, k=k, seed=seed, dtype=DTYPE, device="cpu")
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed", [2, 5])
def test_critical_tms_equal_reference_random_windows(seed):
    rng = np.random.default_rng(seed)
    window = rng.gamma(2.0, 30.0, size=(60, 42))
    np.testing.assert_array_equal(
        critical_tms(window, k=6, seed=seed, dtype=DTYPE, device="cpu"),
        ref_critical_tms(window, k=6, seed=seed))
