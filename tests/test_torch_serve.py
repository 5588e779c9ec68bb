"""Port vs reference: the streaming controller (``serve``) and its warm-started
PDHG solve.

State crosses over through :mod:`repro_torch.interop`; the reference runs its
Pallas kernels in interpret mode (``backend="pallas"``), the port its plain
PyTorch versions on the CPU.  Configuration of ``tests/test_serve.py``:
12-hour routing, 3-day topology and aggregation, 4 critical TMs.

* ``RollingWindow`` / ``TMStream``: the same rows, views and means (exact).
* ``solve_routing_warm`` seeded from the same reference state: u* within
  2·``pdhg_tol`` (both certified to it), r* within 10·``pdhg_tol`` (stage 2
  may exit on a 10·tol stall); observed u* within 9.3e-7 and r* within 3.6e-6
  relative, and equal per-stage iteration counts.  Warm-started chains spend
  no more stage-1 iterations (median) than cold starts.
* Replay parity of ``StreamingController``.  scipy on F1: identical
  ``Decision`` fields (latency aside) and the contract of
  ``tests/test_torch_engine.py`` (a); observed p999 summaries within 7.2e-8
  relative.  PDHG on F18: the same decisions, u* per decision within
  2·``pdhg_tol`` (observed 9.1e-7) and p999_mlu within 0.05 (observed
  8.1e-7), identical per-epoch iteration counts.
* ``auto_strategy`` picks the strategy the reference picks.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.burst import BurstParams, LossConfig
from repro.core import clustering
from repro.core.controller import ControllerConfig
from repro.core.engine import _pad_tms, routing_solver_for
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.graph import uniform_topology
from repro.core.lp import estimate_delta
from repro.core.rounding import realize
from repro.core.solver import SolverConfig, Strategy
from repro.serve import (RollingWindow, ServeConfig, StreamingController,
                         TMStream, stream_fleet_fabric)
from repro_torch import interop
from repro_torch import serve as port_serve
from repro_torch.core.engine import routing_solver_for as port_solver_for

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=3.0,
                      aggregation_days=3.0, k_critical=4, backend="pallas")
SC = SolverConfig(stage1_method="scaled")
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=4, buffer_ms=25.0, seed=3)
P999 = ("p999_mlu", "p999_alu", "p999_olr", "p999_stretch")
GEMINI = Strategy(nonuniform=True, hedging=True)
# the reference's k-means runs in JAX's default float type (x64 on in CI)
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"
DECISION = ("epoch", "start", "topology_solved", "topology_applied")


def _port(fabric, trace):
    return (interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed),
            interop.trace_from_numpy(trace.name, trace.demand,
                                     trace.interval_minutes, trace.n_pods))


def _port_cc(cc):
    return dataclasses.replace(
        interop.controller_config_from_dict(dataclasses.asdict(cc)),
        kmeans_dtype=KMEANS_DTYPE)


def _both(fabric, trace, strategy, cc, serve, max_intervals=None):
    """The reference's and the port's streaming run on the same state."""
    ref = StreamingController(fabric, TMStream.from_trace(trace), strategy,
                              cc, SC, serve=serve).run(max_intervals)
    pfab, ptrace = _port(fabric, trace)
    port = port_serve.StreamingController(
        pfab, port_serve.TMStream.from_trace(ptrace),
        None if strategy is None
        else interop.strategy_from_dict(dataclasses.asdict(strategy)),
        _port_cc(cc), interop.solver_config_from_dict(dataclasses.asdict(SC)),
        serve=interop.serve_config_from_dict(dataclasses.asdict(serve)),
        device="cpu").run(max_intervals)
    return ref, port


# ---- ingest ------------------------------------------------------------------


def test_rolling_window_matches_reference(rng):
    rows = rng.random((60, 12)) * np.logspace(-2, 4, 12)
    ref, win = RollingWindow(7, 12), port_serve.RollingWindow(7, 12)
    for row in rows:
        ref.push(row)
        win.push(row)
        np.testing.assert_array_equal(win.view(), ref.view())
        np.testing.assert_array_equal(win.mean(), ref.mean())
    assert win.full and len(win) == len(ref) == 7
    with pytest.raises(ValueError):
        win.push(np.zeros(5))


def test_tm_stream_matches_reference():
    spec, fab, stream, trace = stream_fleet_fabric(17, days=2.0,
                                                   interval_minutes=60.0)
    p_spec, p_fab, p_stream, p_trace = port_serve.stream_fleet_fabric(
        17, days=2.0, interval_minutes=60.0)
    assert dataclasses.asdict(p_spec) == dataclasses.asdict(spec)
    np.testing.assert_array_equal(p_fab.radix, fab.radix)
    np.testing.assert_array_equal(p_trace.demand, trace.demand)
    assert (p_stream.n_commodities, p_stream.intervals_per_day()) == \
        (stream.n_commodities, stream.intervals_per_day())
    np.testing.assert_array_equal(np.stack(list(p_stream)), np.stack(list(stream)))


# ---- warm-started PDHG -------------------------------------------------------


@pytest.fixture(scope="module")
def f18():
    spec = FLEET_SPECS[17]  # F18: 6 pods
    fab = make_fabric(spec)
    return fab, make_trace(spec, fab, days=9.0, interval_minutes=120.0)


def _epochs(fab, trace, n):
    caps = fab.capacities(realize(fab, uniform_topology(fab))[0])
    for epoch in range(n):
        start = 36 + 6 * epoch
        window = trace.demand[start - 36: start]
        tms = _pad_tms(clustering.critical_tms(window, k=4, seed=epoch), 4)
        yield tms, caps, estimate_delta(window)


def test_solve_routing_warm_from_the_same_state(f18):
    fab, trace = f18
    ref_solver = routing_solver_for(fab, 4, CC.pdhg_max_iters, CC.pdhg_tol)
    solver = port_solver_for(_port(fab, trace)[0], 4, CC.pdhg_max_iters,
                             CC.pdhg_tol, device="cpu")
    (tms0, caps, d0), (tms1, _, d1) = _epochs(fab, trace, 2)
    _, ref_state = ref_solver.solve_routing_warm(tms0, caps, hedging=True,
                                                 delta=d0)
    state = interop.warm_state_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in dataclasses.asdict(ref_state).items()}, device="cpu")
    assert state.f2 is not None and state.y3.device.type == "cpu"
    for anchor, ref_anchor in ((state, ref_state), (None, None)):
        ref, _ = ref_solver.solve_routing_warm(tms1, caps, hedging=True,
                                               delta=d1, anchor_state=ref_anchor)
        out, new = solver.solve_routing_warm(tms1, caps, hedging=True,
                                             delta=d1, anchor_state=anchor)
        assert out["u_star"] == pytest.approx(ref["u_star"], rel=2 * CC.pdhg_tol)
        assert out["r_star"] == pytest.approx(ref["r_star"], rel=10 * CC.pdhg_tol)
        assert set(out["stats"]) == set(ref["stats"])
        assert out["stats"]["anchor_seconds"] == 0.0
        for stage in ("stage1", "stage2", "stage3"):
            np.testing.assert_array_equal(out["stats"][stage]["iters"],
                                          ref["stats"][stage]["iters"])
        assert out["f"].shape == ref["f"].shape
        assert new.f2 is not None and new.y3 is not None


def test_warm_chain_spends_no_more_stage1_iterations(f18):
    fab, trace = f18
    solver = port_solver_for(_port(fab, trace)[0], 4, CC.pdhg_max_iters,
                             CC.pdhg_tol, device="cpu")
    warm_it, cold_it, state = [], [], None
    for tms, caps, delta in _epochs(fab, trace, 4):
        warm, state = solver.solve_routing_warm(tms, caps, hedging=False,
                                                anchor_state=state)
        cold, _ = solver.solve_routing_warm(tms, caps, hedging=False)
        assert warm["u_star"] == pytest.approx(cold["u_star"], rel=2 * CC.pdhg_tol)
        assert warm["r_star"] is None and state.f2 is None
        warm_it.append(int(warm["stats"]["stage1"]["iters"][0]))
        cold_it.append(int(cold["stats"]["stage1"]["iters"][0]))
    assert np.median(warm_it) <= np.median(cold_it)


def test_solver_cache_returns_the_same_solver(f18, monkeypatch):
    fab, trace = f18
    pfab = _port(fab, trace)[0]
    a = port_solver_for(pfab, 4, 3000, 1e-2, device="cpu")
    other = dataclasses.replace(pfab, name="same-shape")
    b = port_solver_for(other, 4, 3000, 1e-2, device="cpu")
    assert a is b and b.fabric is other
    assert port_solver_for(pfab, 4, 3000, 5e-3, device="cpu") is not a
    # the cached solver outlives the TF32 setting: every solve checks it
    tms, caps, _ = next(_epochs(fab, trace, 1))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        a.solve_routing_warm(tms, caps, hedging=False)
    with pytest.raises(RuntimeError, match="TF32"):
        a.solve_routing_batch(tms[None], caps[None], hedging=False)


# ---- replay parity -----------------------------------------------------------


def test_streaming_replay_parity_scipy(small_fabric, small_trace):
    cc = dataclasses.replace(CC, solver_backend="scipy", loss=LOSS)
    ref, port = _both(small_fabric, small_trace, GEMINI, cc,
                      ServeConfig(auto_strategy=False))
    assert len(port.decisions) == len(ref.decisions) > 0
    for a, r in zip(port.decisions, ref.decisions):
        for field in DECISION + ("u_star",):
            assert getattr(a, field) == getattr(r, field), field
    on, off = port.result, ref.result
    assert on.n_routing_updates == off.n_routing_updates
    assert on.n_topology_updates == off.n_topology_updates
    np.testing.assert_array_equal(on.final_topology, off.final_topology)
    assert on.transit_fraction == pytest.approx(off.transit_fraction, rel=1e-6)
    for k in P999:
        assert on.summary[k] == pytest.approx(off.summary[k], rel=1e-3,
                                              abs=1e-4), k
    assert on.metrics.mlu.shape == off.metrics.mlu.shape
    np.testing.assert_allclose(on.metrics.loss, off.metrics.loss,
                               rtol=2e-3, atol=1e-5)
    assert port.n_intervals == ref.n_intervals
    assert port.latencies_s.shape == (len(port.decisions),)


def test_streaming_replay_parity_pdhg(f18):
    fab, trace = f18
    cc = dataclasses.replace(CC, solver_backend="pdhg")
    ref, port = _both(fab, trace, GEMINI, cc, ServeConfig(auto_strategy=False))
    assert len(port.decisions) == len(ref.decisions) > 0
    for a, r in zip(port.decisions, ref.decisions):
        for field in DECISION:
            assert getattr(a, field) == getattr(r, field), field
        assert a.u_star == pytest.approx(r.u_star, rel=2 * cc.pdhg_tol)
    on, off = port.result, ref.result
    assert on.n_topology_updates == off.n_topology_updates
    np.testing.assert_array_equal(on.final_topology, off.final_topology)
    assert on.summary["p999_mlu"] == pytest.approx(off.summary["p999_mlu"],
                                                   rel=0.05)
    assert set(on.solver_stats.stages) == set(off.solver_stats.stages)
    for stage in on.solver_stats.stages:
        assert (on.solver_stats.stages[stage].iters
                == off.solver_stats.stages[stage].iters), stage
    assert np.isfinite(on.metrics.mlu).all()
    assert on.splits.shape[0] == on.capacities.shape[0] == len(port.decisions)
    np.testing.assert_array_equal(on.u_star, [d.u_star for d in port.decisions])


def test_auto_strategy_picks_what_the_reference_picks(small_fabric, small_trace):
    """The predictor runs on the warm-up window at the first re-plan; the run
    stops one interval later."""
    cc = dataclasses.replace(CC, solver_backend="scipy")
    agg = int(round(cc.aggregation_days * small_trace.intervals_per_day()))
    ref, port = _both(small_fabric, small_trace, None, cc, ServeConfig(),
                      max_intervals=agg + 1)
    assert port.result.strategy.name == ref.result.strategy.name
    assert len(port.decisions) == len(ref.decisions) == 1
    assert port.decisions[0].topology_solved == ref.decisions[0].topology_solved
