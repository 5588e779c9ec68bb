"""Port vs reference: the sequential controller walk and the predictor.

The port's ``run_controller(..., engine="sequential", device="cpu")`` against
the reference's sequential walk with ``backend="pallas"`` (interpret mode) and
burst loss on, in the configuration of ``tests/test_torch_engine.py`` (12-hour
routing, 3-day topology and aggregation, 4 critical TMs), Gemini.  Every
epoch scores through ``route_metrics`` — the single-block kernels' path.

(a) ``solver_backend="scipy"`` on F1: counts and final topology equal,
    ``transit_fraction`` rel 1e-6, p999 summaries rel 1e-3 abs 1e-4, loss
    rtol 2e-3 atol 1e-5 (the engine test's contract (a)); observed p999
    summaries within 7.2e-8 relative.
(b) ``solver_backend="pdhg"`` on the 6-pod F18: per-epoch u* rel ≤
    2·``pdhg_tol`` and p999_mlu rel ≤ 0.05 (contract (b)); observed u*
    within 9.5e-7, p999_mlu within 1.7e-6, identical iteration counts.

``pick_best`` and ``predict_from_window`` choose what the reference chooses,
and the port's decision audit replays ``pick_best`` and
``should_reconfigure`` records.
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
from repro.core.predictor import pick_best as ref_pick_best
from repro.core.predictor import predict_from_window as ref_predict_from_window
from repro_torch import interop, obs
from repro_torch.core import run_controller as port_run_controller
from repro_torch.core.pdhg import TorchRoutingSolver
from repro_torch.core.predictor import pick_best, predict_from_window

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=3.0,
                      aggregation_days=3.0, k_critical=4, backend="pallas",
                      engine="sequential")
SC = SolverConfig(stage1_method="scaled")
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=4, buffer_ms=25.0, seed=3)
P999 = ("p999_mlu", "p999_alu", "p999_olr", "p999_stretch")
GEMINI = Strategy(nonuniform=True, hedging=True)
# the reference's k-means runs in JAX's default float type (x64 on in CI)
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"


def _port(fabric, trace, cc):
    return (interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed),
            interop.trace_from_numpy(trace.name, trace.demand,
                                     trace.interval_minutes, trace.n_pods),
            dataclasses.replace(
                interop.controller_config_from_dict(dataclasses.asdict(cc)),
                kmeans_dtype=KMEANS_DTYPE),
            interop.solver_config_from_dict(dataclasses.asdict(SC)))


def _both(fabric, trace, cc):
    ref = run_controller(fabric, trace, GEMINI, cc, SC)
    pfab, ptrace, pcc, psc = _port(fabric, trace, cc)
    port = port_run_controller(
        pfab, ptrace, interop.strategy_from_dict(dataclasses.asdict(GEMINI)),
        pcc, psc, device="cpu")
    return ref, port


def test_sequential_scipy_matches_reference(small_fabric, small_trace):
    cc = dataclasses.replace(CC, solver_backend="scipy", loss=LOSS)
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
    assert port.solver_stats is None
    assert set(port.stage_times) == set(ref.stage_times)
    assert port.splits.shape[0] == port.n_routing_updates


def test_sequential_pdhg_matches_reference(monkeypatch):
    spec = FLEET_SPECS[17]  # F18: 6 pods
    fabric = make_fabric(spec)
    trace = make_trace(spec, fabric, days=7.0, interval_minutes=120.0)
    solved = {"ref": [], "port": []}

    def recorder(cls, key):
        orig = cls.solve_routing_batch

        def wrapped(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            solved[key].append(out)
            return out
        monkeypatch.setattr(cls, "solve_routing_batch", wrapped)

    recorder(JaxRoutingSolver, "ref")
    recorder(TorchRoutingSolver, "port")
    cc = dataclasses.replace(CC, solver_backend="pdhg", loss=LOSS)
    ref, port = _both(fabric, trace, cc)
    assert port.n_routing_updates == ref.n_routing_updates == len(solved["port"])
    assert port.n_topology_updates == ref.n_topology_updates
    np.testing.assert_array_equal(port.final_topology, ref.final_topology)
    np.testing.assert_allclose([o["u_star"][0] for o in solved["port"]],
                               [o["u_star"][0] for o in solved["ref"]],
                               rtol=2 * cc.pdhg_tol)
    assert port.summary["p999_mlu"] == pytest.approx(ref.summary["p999_mlu"],
                                                     rel=0.05)
    np.testing.assert_array_equal(port.u_star,
                                  [o["u_star"][0] for o in solved["port"]])
    for stage, st in port.solver_stats.stages.items():
        assert st.iters == ref.solver_stats.stages[stage].iters, stage
    for m in (port.metrics.mlu, port.metrics.loss):
        assert np.isfinite(m).all()


PER_STRATEGY = {
    "(uniform,plain)": {"p999_mlu": 0.90, "p999_alu": 0.30, "p999_loss": 0.020},
    "(uniform,hedge)": {"p999_mlu": 0.86, "p999_alu": 0.33, "p999_loss": 0.004},
    "(nonuniform,plain)": {"p999_mlu": 0.84, "p999_alu": 0.31, "p999_loss": 0.010},
    "(nonuniform,hedge)": {"p999_mlu": 0.85, "p999_alu": 0.29, "p999_loss": 0.0041},
}


@pytest.mark.parametrize("objective,cushion", [("mlu", 0.05), ("mlu", 0.0),
                                               ("loss", 0.05), ("loss", 0.5)])
def test_pick_best_matches_reference_and_replays(objective, cushion):
    obs.audit.enable()
    obs.audit.clear()
    try:
        choice = pick_best(PER_STRATEGY, cushion, objective=objective,
                           fabric="F0")
        recs = obs.audit.records()
    finally:
        obs.audit.disable()
    assert choice == ref_pick_best(PER_STRATEGY, cushion, objective=objective)
    assert len(recs) == 1 and recs[0]["chosen"] == choice
    assert obs.audit.verify(recs) == []
    assert obs.audit.replay({"kind": "should_reconfigure", "benefit": 1.0,
                             "disruption": 0.0, "hysteresis": 0.0}) is True
    # the failure-aware blend needs the cont_* keys, as the reference's does
    for pick in (pick_best, ref_pick_best):
        with pytest.raises(ValueError, match="contingency-aware"):
            pick(PER_STRATEGY, cushion, objective=objective,
                 contingency_weight=0.5)


def test_predict_from_window_matches_reference(small_fabric, small_trace):
    cc = dataclasses.replace(CC, engine="batched", solver_backend="scipy")
    agg = int(round(cc.aggregation_days * small_trace.intervals_per_day()))
    window = small_trace.demand[:agg]
    ref = ref_predict_from_window(small_fabric, window,
                                  small_trace.interval_minutes, cc, SC)
    pfab, _, pcc, psc = _port(small_fabric, small_trace, cc)
    out = predict_from_window(pfab, window, small_trace.interval_minutes, pcc,
                              psc, device="cpu")
    assert out.strategy.name == ref.strategy.name
    assert set(out.per_strategy) == set(ref.per_strategy)
    for name, summary in out.per_strategy.items():
        assert summary["p999_mlu"] == pytest.approx(
            ref.per_strategy[name]["p999_mlu"], rel=1e-3), name
    with pytest.raises(ValueError, match="too short"):
        predict_from_window(pfab, window[:2], small_trace.interval_minutes,
                            pcc, psc, device="cpu")
