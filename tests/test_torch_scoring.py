"""Port vs reference: batched scoring of a sweep, burst loss included.

Same blocks (ragged lengths), weights, capacities and burst seeds through
``repro.core.simulator.route_metrics_batched`` (Pallas kernels in interpret
mode) and the port's (plain PyTorch versions on the CPU).  Tolerance 1e-5
rtol/atol — the contract of ``tests/test_backend_parity.py``.
"""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro.burst import BurstParams, LossConfig
from repro.core.baselines import vlb_weights
from repro.core.graph import uniform_topology
from repro.core.simulator import route_metrics_batched as ref_route_metrics_batched
from repro_torch import interop
from repro_torch.core.simulator import route_metrics_batched

torch.set_num_threads(1)

TOL = 1e-5
FIELDS = ("mlu", "alu", "olr", "stretch", "loss")
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=6, buffer_ms=25.0, seed=3)


@pytest.fixture(scope="module")
def sweep(small_fabric, small_trace):
    """Five epochs of ragged length, each with its own weights and capacities
    (one with a dead trunk); mostly-direct routing so bursts overflow."""
    rng = np.random.default_rng(0)
    cap0 = small_fabric.capacities(uniform_topology(small_fabric))
    vlb = vlb_weights(small_fabric.n_pods)
    lens = [6, 6, 3, 6, 5]
    starts = np.cumsum([0] + lens[:-1])
    blocks = [small_trace.demand[s: s + n] for s, n in zip(starts, lens)]
    mix = rng.uniform(0.1, 0.4, len(lens))
    weights = np.stack([a * vlb + (1 - a) * np.eye(cap0.size) for a in mix])
    caps = np.stack([cap0 * rng.uniform(0.8, 1.2, cap0.size) for _ in lens])
    caps[3, :2] = 0.0
    seeds = [LOSS.seed + int(s) for s in starts]
    return blocks, weights, caps, seeds


@pytest.mark.parametrize("ref_backend,backend", [("pallas", "torch"),
                                                 ("numpy", "numpy")])
def test_route_metrics_batched_matches_reference(sweep, ref_backend, backend):
    blocks, weights, caps, seeds = sweep
    ref = ref_route_metrics_batched(blocks, weights, caps, 0.8,
                                    backend=ref_backend, loss_cfg=LOSS,
                                    loss_seeds=seeds, interval_seconds=3600.0)
    out = route_metrics_batched(
        blocks, weights, caps, 0.8, backend=backend,
        loss_cfg=interop.loss_config_from_dict(dataclasses.asdict(LOSS)),
        loss_seeds=seeds, interval_seconds=3600.0, device="cpu")
    for field in FIELDS:
        a, r = getattr(out, field), getattr(ref, field)
        assert a.shape == r.shape == (sum(len(b) for b in blocks),), field
        np.testing.assert_allclose(a, r, rtol=TOL, atol=TOL, err_msg=field)
    assert out.loss.max() > 0.0, "parity must be exercised on non-trivial loss"
