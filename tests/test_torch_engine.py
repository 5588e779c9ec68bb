"""Port vs reference: the whole slice — ``run_controller`` end to end.

The port's ``run_controller(..., device="cpu")`` against the reference's
batched engine with ``backend="pallas"`` (interpret mode) and burst loss on,
in the configuration of ``tests/test_core_engine.py`` (12-hour routing,
3-day topology and aggregation, 4 critical TMs), Gemini (nonuniform topology +
hedging).  State crosses over through :mod:`repro_torch.interop`.

(a) ``solver_backend="scipy"`` on F1 (the conftest fixtures): the same HiGHS
    solves on both sides, so the contract is the one of
    ``test_core_engine.py:77-89`` — counts and final topology equal,
    ``transit_fraction`` rel 1e-6, p999 summaries rel 1e-3 abs 1e-4, loss
    rtol 2e-3 atol 1e-5.
(b) ``solver_backend="pdhg"`` on the 6-pod F18: per-epoch ``u*`` rel ≤
    2·``pdhg_tol`` (both certified to the tolerance) and p999_mlu rel ≤ 0.05.
    Observed on the CPU: per-epoch ``u*`` within 7.2e-7 relative, p999_mlu
    within 1.1e-6 relative, and identical per-epoch PDHG iteration counts.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.burst import BurstParams, LossConfig
from repro.core import ControllerConfig, SolverConfig, Strategy, run_controller
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.jaxlp import JaxRoutingSolver
from repro_torch import interop
from repro_torch.core import run_controller as port_run_controller
from repro_torch.core.pdhg import TorchRoutingSolver

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=3.0,
                      aggregation_days=3.0, k_critical=4)
SC = SolverConfig(stage1_method="scaled")
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=4, buffer_ms=25.0, seed=3)
P999 = ("p999_mlu", "p999_alu", "p999_olr", "p999_stretch")
GEMINI = Strategy(nonuniform=True, hedging=True)
# the reference's k-means runs in JAX's default float type (x64 on in CI)
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"


def _both(fabric, trace, cc):
    """Run the reference and the port on the same state."""
    ref = run_controller(fabric, trace, GEMINI, cc, SC)
    port = port_run_controller(
        interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed),
        interop.trace_from_numpy(trace.name, trace.demand,
                                 trace.interval_minutes, trace.n_pods),
        interop.strategy_from_dict(dataclasses.asdict(GEMINI)),
        dataclasses.replace(
            interop.controller_config_from_dict(dataclasses.asdict(cc)),
            kmeans_dtype=KMEANS_DTYPE),
        interop.solver_config_from_dict(dataclasses.asdict(SC)),
        device="cpu")
    return ref, port


def test_scipy_engine_matches_reference(small_fabric, small_trace):
    cc = dataclasses.replace(CC, solver_backend="scipy", backend="pallas",
                             loss=LOSS)
    ref, port = _both(small_fabric, small_trace, cc)
    assert port.n_routing_updates == ref.n_routing_updates
    assert port.n_topology_updates == ref.n_topology_updates
    np.testing.assert_array_equal(port.final_topology, ref.final_topology)
    assert port.transit_fraction == pytest.approx(ref.transit_fraction, rel=1e-6)
    for k in P999:
        assert port.summary[k] == pytest.approx(ref.summary[k], rel=1e-3,
                                                abs=1e-4), k
    assert port.metrics.mlu.shape == ref.metrics.mlu.shape
    np.testing.assert_allclose(port.metrics.loss, ref.metrics.loss,
                               rtol=2e-3, atol=1e-5)
    assert port.solver_stats is None and set(port.stage_times) == set(ref.stage_times)


def test_pdhg_engine_matches_reference(monkeypatch):
    spec = FLEET_SPECS[17]  # F18: 6 pods
    fabric = make_fabric(spec)
    trace = make_trace(spec, fabric, days=9.0, interval_minutes=120.0)
    solved = {}

    def recorder(cls, key):
        orig = cls.solve_routing_batch

        def wrapped(self, *args, **kwargs):
            solved[key] = orig(self, *args, **kwargs)
            return solved[key]
        monkeypatch.setattr(cls, "solve_routing_batch", wrapped)

    recorder(JaxRoutingSolver, "ref")
    recorder(TorchRoutingSolver, "port")
    cc = dataclasses.replace(CC, solver_backend="pdhg", backend="pallas",
                             loss=LOSS)
    ref, port = _both(fabric, trace, cc)
    assert port.n_routing_updates == ref.n_routing_updates
    assert port.n_topology_updates == ref.n_topology_updates
    np.testing.assert_array_equal(port.final_topology, ref.final_topology)
    np.testing.assert_allclose(solved["port"]["u_star"], solved["ref"]["u_star"],
                               rtol=2 * cc.pdhg_tol)
    assert port.summary["p999_mlu"] == pytest.approx(ref.summary["p999_mlu"],
                                                     rel=0.05)
    assert set(port.solver_stats.stages) == set(ref.solver_stats.stages)
    for m in (port.metrics.mlu, port.metrics.loss):
        assert np.isfinite(m).all()
