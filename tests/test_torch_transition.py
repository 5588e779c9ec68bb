"""Port vs reference: reconfiguration transitions (``repro_torch.transition``)
and the §4.6 gate in every engine.

State crosses over through :mod:`repro_torch.interop`; the reference scores
with its float64 oracle (``backend="numpy"``) or its Pallas kernels in
interpret mode, the port with its plain PyTorch versions on the CPU.
Configuration of ``tests/test_transition.py``: 12-hour routing, 3-day
topology and aggregation, 4 critical TMs, 4 patch panels.  Tolerances:

* framework-free pieces (diff, drain schedule, proxy MLU, spans, the
  decision rule): exact — the same integers and the same float64 arithmetic;
* ``evaluate_transition`` on scipy/HiGHS: the same LPs, per-stage u within
  1e-9 relative; on PDHG u within 2·``pdhg_tol`` (both certified to it); a
  stranded stage is ``inf`` on both backends;
* ``stage_metrics`` on the port's torch backend (float32) against the
  reference's float64 oracle within 1e-5 (the scoring contract);
* the engines on scipy: counts, topology and transition logs equal, MLU
  within the kernels' rtol 3e-4 / atol 1e-4, loss rtol 2e-3 atol 1e-5 (the
  contract of ``tests/test_torch_engine.py`` (a)); on PDHG the per-epoch u*
  within 2·``pdhg_tol`` and p999 MLU within 0.05 (its contract (b));
* the port's own engines against each other: sequential, batched and
  streaming on scipy within 1e-12 of each other; the fleet engine's
  drain-stage intervals (scored under the gate's own stage routing, the same
  in both) match the per-fabric engine within 1e-5, the rest within the
  fleet's p999 rel 1e-3;
* ``transition=None`` gives the same bits as before the gate existed (the
  same sweep with the gate modeled as instantaneous, and a single topology
  epoch, where the gate never runs).
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

import repro.transition as ref_tr
import repro_torch.transition as port_tr
from repro.burst import BurstParams, LossConfig
from repro.core import (ControllerConfig, FleetJob, SolverConfig, Strategy,
                        TransitionConfig, run_controller, run_fleet)
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.graph import Fabric, trunk_index, uniform_topology
from repro.core.rounding import realize
from repro.obs import audit as ref_audit
from repro.serve import StreamingController, TMStream
from repro_torch import interop, obs
from repro_torch import serve as port_serve
from repro_torch.core import FleetJob as PortFleetJob
from repro_torch.core import run_controller as port_run_controller
from repro_torch.core import run_fleet as port_run_fleet

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=3.0,
                      aggregation_days=3.0, k_critical=4)
SC = SolverConfig(stage1_method="scaled")
TC = TransitionConfig(n_panels=4, stage_intervals=1)
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=4, buffer_ms=25.0, seed=3)
GEMINI = Strategy(nonuniform=True, hedging=True)
P999 = ("p999_mlu", "p999_alu", "p999_olr", "p999_stretch")
LOG_EXACT = ("start", "order", "total_moves", "total_fiber_moves", "applied")
LOG_FLOATS = ("u_old", "u_new", "worst_stage_u", "proxy_worst",
              "proxy_worst_naive", "benefit", "disruption")
# the reference's k-means runs in JAX's default float type (x64 on in CI)
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"


def _port_fab(fabric):
    return interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed)


def _port_trace(trace):
    return interop.trace_from_numpy(trace.name, trace.demand,
                                    trace.interval_minutes, trace.n_pods)


def _port_cc(cc, **over):
    return dataclasses.replace(
        interop.controller_config_from_dict(dataclasses.asdict(cc)),
        kmeans_dtype=KMEANS_DTYPE, **over)


def _port_sc():
    return interop.solver_config_from_dict(dataclasses.asdict(SC))


def _port_run(fabric, trace, cc, strategy=GEMINI, **over):
    return port_run_controller(_port_fab(fabric), _port_trace(trace), strategy,
                               _port_cc(cc, **over), _port_sc(), device="cpu")


@pytest.fixture(scope="module")
def topologies(small_fabric):
    """Two distinct realized integer topologies of the small fabric (the
    reference test's fixture)."""
    n_uni = realize(small_fabric, uniform_topology(small_fabric))[0]
    rng = np.random.default_rng(5)
    v = small_fabric.n_pods
    skew = np.zeros_like(n_uni, dtype=np.float64)
    hot = rng.permutation(v)[:2]
    for e, (i, j) in enumerate(trunk_index(v)):
        if i in hot and j in hot:
            skew[e] = 4.0
    n_skew = realize(small_fabric, np.maximum(n_uni + skew - 0.5, 1.0))[0]
    assert (n_skew != n_uni).any()
    return n_uni, n_skew


# ---- framework-free pieces: exact -------------------------------------------


RULES = [  # (benefit, disruption, hysteresis, contingency_weight, b_w, d_w)
    (1.0, 0.5, 0.0, None, None, None), (0.4, 0.5, 0.0, None, None, None),
    (0.0, 0.0, 0.0, None, None, None), (0.1, 0.0, 0.0, None, None, None),
    (0.6, 0.5, 0.0, None, None, None), (0.6, 0.5, 0.5, None, None, None),
    (-1.0, 0.0, 0.0, None, None, None), (1.0, 0.5, 0.0, 0.0, -5.0, 9.0),
    (1.0, 0.5, 0.0, 0.5, 0.2, 2.0), (1.0, 0.5, 0.0, 1.0, 3.0, 1.0),
    (2.0, float("inf"), 0.0, None, None, None)]


@pytest.mark.parametrize("rule", RULES)
def test_should_reconfigure_matches_reference(rule):
    """The §4.6 rule over the reference's table, the contingency blend
    included; both audit records carry the same fields and replay."""
    b, d, h, w, bw, dw = rule
    kw = ({} if w is None else
          dict(contingency_weight=w, benefit_worst=bw, disruption_worst=dw))
    ref_audit.enable()
    ref_audit.clear()
    obs.audit.enable()
    obs.audit.clear()
    try:
        want = ref_tr.should_reconfigure(b, d, h, fabric="F0", **kw)
        got = port_tr.should_reconfigure(b, d, h, fabric="F0", **kw)
        ref_rec, port_rec = ref_audit.records(), obs.audit.records()
    finally:
        ref_audit.disable()
        obs.audit.disable()
    assert got == want
    assert len(port_rec) == len(ref_rec) == 1
    drop = ("seq", "t")
    assert ({k: v for k, v in port_rec[0].items() if k not in drop}
            == {k: v for k, v in ref_rec[0].items() if k not in drop})
    assert obs.audit.replay(port_rec[0]) == want
    assert obs.audit.verify(port_rec) == []


def test_should_reconfigure_refuses_a_partial_blend():
    with pytest.raises(ValueError, match="benefit_worst"):
        port_tr.should_reconfigure(1.0, 0.5, contingency_weight=0.5)


def test_audit_replays_gate_records_after_a_jsonl_round_trip(tmp_path):
    """Gate decisions land in the audit log with their inputs; written to
    JSONL and read back, each replays to its recorded outcome, and an edited
    input re-derives a different one."""
    obs.audit.enable()
    obs.audit.clear()
    try:
        for b, d, h, *_ in RULES[:7]:
            port_tr.should_reconfigure(b, d, h, fabric="F1")
        path = tmp_path / "audit.jsonl"
        obs.audit.export_jsonl(path)
    finally:
        obs.audit.disable()
    recs = obs.audit.read_jsonl(path)
    assert [r["kind"] for r in recs] == ["should_reconfigure"] * 7
    assert obs.audit.verify(recs) == []
    flipped = dict(recs[0], disruption=10.0)
    assert obs.audit.replay(flipped) is False
    assert obs.audit.verify([flipped]) != []


@pytest.mark.parametrize("n_panels", [2, 3, 4])
def test_diff_topologies_matches_reference(small_fabric, topologies, n_panels):
    n_uni, n_skew = topologies
    v = small_fabric.n_pods
    for old, new in ((n_uni, n_skew), (n_skew, n_uni), (n_uni, n_uni)):
        ref = ref_tr.diff_topologies(v, old, new, n_panels)
        port = port_tr.diff_topologies(v, old, new, n_panels)
        for field in ("old_counts", "new_counts", "moves_per_panel",
                      "fiber_moves_per_panel"):
            np.testing.assert_array_equal(getattr(port, field),
                                          getattr(ref, field))
        np.testing.assert_array_equal(port.panels_with_moves,
                                      ref.panels_with_moves)
        assert (port.total_moves, port.total_fiber_moves) == (
            ref.total_moves, ref.total_fiber_moves)


@pytest.mark.parametrize("max_exact", [8, 0])
def test_schedule_drains_matches_reference(small_fabric, small_trace,
                                           topologies, max_exact):
    """The Held–Karp order (``max_exact`` 8) and the greedy one (0): the
    same order and the same worst-stage proxy MLU, bit for bit; the exact
    order is the best of all permutations."""
    n_uni, n_skew = topologies
    v = small_fabric.n_pods
    ref_d = ref_tr.diff_topologies(v, n_uni, n_skew, 4)
    port_d = port_tr.diff_topologies(v, n_uni, n_skew, 4)
    tms = small_trace.demand[:6]
    pfab = _port_fab(small_fabric)
    ref = ref_tr.schedule_drains(small_fabric, tms, ref_d, max_exact=max_exact)
    port = port_tr.schedule_drains(pfab, tms, port_d, max_exact=max_exact)
    assert port == ref
    np.testing.assert_array_equal(port_tr.stage_trunks_for_order(port_d, port[0]),
                                  ref_tr.stage_trunks_for_order(ref_d, ref[0]))
    if max_exact:
        best = min(max(port_tr.proxy_mlu(pfab, tms, pfab.capacities(
            port_tr.residual_trunks(port_d, perm[:s], p)))
            for s, p in enumerate(perm))
            for perm in itertools.permutations(port[0]))
        assert port[1] == best


def test_residual_trunks_and_proxy_mlu_match_reference(small_fabric,
                                                       small_trace, topologies):
    n_uni, n_skew = topologies
    v = small_fabric.n_pods
    ref_d = ref_tr.diff_topologies(v, n_uni, n_skew, 4)
    port_d = port_tr.diff_topologies(v, n_uni, n_skew, 4)
    pfab = _port_fab(small_fabric)
    tms = small_trace.demand[:6]
    from repro.core.paths import build_paths
    from repro_torch.core.paths import build_paths as port_build_paths

    for drained, p in (([], 0), ([0], 1), ([0, 1, 2], 3), ([2], 2)):
        r = port_tr.residual_trunks(port_d, drained, p)
        np.testing.assert_array_equal(r, ref_tr.residual_trunks(ref_d, drained, p))
        caps = small_fabric.capacities(r)
        assert (port_tr.proxy_mlu(pfab, tms, caps)
                == ref_tr.proxy_mlu(small_fabric, tms, caps))
        np.testing.assert_array_equal(
            port_tr.proxy_splits(port_build_paths(v), caps),
            ref_tr.proxy_splits(build_paths(v), caps))
    dead = np.zeros(small_fabric.n_directed)
    assert port_tr.proxy_mlu(pfab, tms, dead) == float("inf")
    assert port_tr.proxy_splits(port_build_paths(v), dead) is None


@pytest.mark.parametrize("n_stages,stage_intervals,length", [
    (3, 2, 10), (3, 2, 3), (2, 5, 4), (4, 1, 3), (0, 1, 3), (2, 1, 1)])
def test_stage_spans_and_partition_match_reference(n_stages, stage_intervals,
                                                   length):
    assert (port_tr.stage_spans(n_stages, stage_intervals, length)
            == ref_tr.stage_spans(n_stages, stage_intervals, length))

    class Ev:  # the fields stage_partition reads
        pass

    ev = Ev()
    ev.n_stages, ev.stage_intervals = n_stages, stage_intervals
    ev.transition_intervals = n_stages * stage_intervals
    for seed in (None, 7):
        assert (port_tr.stage_partition(ev, length, 100, seed)
                == ref_tr.stage_partition(ev, length, 100, seed))


# ---- evaluation and stage scoring ---------------------------------------------


@pytest.fixture(scope="module")
def evaluated(small_fabric, small_trace, topologies):
    """The reference's and the port's evaluation of one change, on scipy."""
    n_uni, n_skew = topologies
    tms = small_trace.demand[:4]
    cc = dataclasses.replace(CC, solver_backend="scipy")
    ref = ref_tr.evaluate_transition(small_fabric, tms, n_uni, n_skew, TC, cc,
                                     SC, horizon_intervals=24)
    port = port_tr.evaluate_transition(
        _port_fab(small_fabric), tms, n_uni, n_skew,
        port_tr.TransitionConfig(**dataclasses.asdict(TC)), _port_cc(cc),
        _port_sc(), horizon_intervals=24, device="cpu")
    return ref, port


def test_evaluate_transition_scipy_matches_reference(evaluated):
    ref, port = evaluated
    assert port.order == ref.order and port.n_stages == ref.n_stages > 0
    np.testing.assert_array_equal(port.stage_trunks, ref.stage_trunks)
    np.testing.assert_array_equal(port.stage_caps, ref.stage_caps)
    np.testing.assert_allclose(port.stage_u, ref.stage_u, rtol=1e-9)
    np.testing.assert_allclose(port.stage_w, ref.stage_w, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(port.steady_w, ref.steady_w, rtol=1e-9,
                               atol=1e-12)
    for k in LOG_FLOATS:
        assert port.log_entry(96, True)[k] == pytest.approx(
            ref.log_entry(96, True)[k], rel=1e-9, abs=1e-12), k
    for k in LOG_EXACT:
        assert port.log_entry(96, True)[k] == ref.log_entry(96, True)[k], k


def test_evaluate_transition_none_without_moves(small_fabric, small_trace,
                                                topologies):
    n_uni, _ = topologies
    cc = dataclasses.replace(CC, solver_backend="scipy")
    assert port_tr.evaluate_transition(
        _port_fab(small_fabric), small_trace.demand[:4], n_uni, n_uni,
        port_tr.TransitionConfig(), _port_cc(cc), _port_sc(),
        horizon_intervals=24, device="cpu") is None


def test_evaluate_transition_pdhg_matches_reference(small_fabric, small_trace,
                                                    topologies):
    """One PDHG batch over the old, new and stage capacities on each side:
    every u within 2·tol of the reference's (both certified to tol)."""
    n_uni, n_skew = topologies
    tms = small_trace.demand[:4]
    cc = dataclasses.replace(CC, solver_backend="pdhg")
    ref = ref_tr.evaluate_transition(small_fabric, tms, n_uni, n_skew, TC, cc,
                                     SC, horizon_intervals=24)
    port = port_tr.evaluate_transition(
        _port_fab(small_fabric), tms, n_uni, n_skew, TC, _port_cc(cc),
        _port_sc(), horizon_intervals=24, device="cpu")
    assert port.order == ref.order
    np.testing.assert_array_equal(port.stage_caps, ref.stage_caps)
    np.testing.assert_allclose(
        np.r_[port.u_old, port.u_new, port.stage_u],
        np.r_[ref.u_old, ref.u_new, ref.stage_u], rtol=2 * cc.pdhg_tol)
    assert np.isfinite(port.stage_u).all()


@pytest.mark.parametrize("backend", ["scipy", "pdhg"])
def test_score_stage_batch_stranded_stage_is_infinite(backend):
    """A drain stage that strands a commodity scores u = inf on both
    backends, as in the reference; a live stage stays finite and close."""
    fab = Fabric.homogeneous("Tiny", 4, 6)
    tms = np.ones((2, fab.n_directed))
    caps = np.stack([fab.capacities(np.full(fab.n_trunks, 2.0)),
                     np.zeros(fab.n_directed)])
    cc = dataclasses.replace(CC, solver_backend=backend, k_critical=2,
                             pdhg_max_iters=200)
    f, u = port_tr.score_stage_batch(_port_fab(fab), tms, caps, 0.0, False,
                                     _port_sc(), _port_cc(cc), device="cpu")
    f_ref, u_ref = ref_tr.score_stage_batch(fab, tms, caps, 0.0, False, SC, cc)
    assert f.shape == f_ref.shape and u[1] == u_ref[1] == float("inf")
    assert np.isfinite(u[0])
    assert u[0] == pytest.approx(u_ref[0], rel=2 * cc.pdhg_tol)


@pytest.mark.parametrize("loss", [False, True])
def test_stage_metrics_matches_the_numpy_oracle(small_trace, evaluated, loss):
    """Every stage on the leading batch axis of one call: the port's float32
    plain version against the reference's float64 oracle within 1e-5."""
    ref_ev, port_ev = evaluated
    demand = small_trace.demand[:5] * 4.0
    kw = {}
    if loss:
        kw = dict(loss_seeds=[3 + k for k in range(port_ev.n_stages)],
                  interval_seconds=small_trace.interval_minutes * 60.0)
    ref = ref_tr.stage_metrics(demand, ref_ev, backend="numpy",
                               loss_cfg=LOSS if loss else None, **kw)
    port = port_tr.stage_metrics(
        demand, port_ev, backend="torch", device="cpu",
        loss_cfg=interop.loss_config_from_dict(dataclasses.asdict(LOSS))
        if loss else None, **kw)
    assert len(port) == len(ref) == port_ev.n_stages
    for p, r in zip(port, ref):
        for field in ("mlu", "alu", "olr", "stretch") + (("loss",) if loss else ()):
            np.testing.assert_allclose(getattr(p, field), getattr(r, field),
                                       rtol=1e-5, atol=1e-5, err_msg=field)
        assert p.mlu.shape == (5,)
    if loss:
        assert max(float(r.loss.max()) for r in ref) > 0.0


# ---- the engines against the reference's --------------------------------------


def _staged_mask(res, trace, cc, tc):
    """Intervals (in the metrics' order) scored under drain stages."""
    ipd = trace.intervals_per_day()
    agg = max(1, int(round(cc.aggregation_days * ipd)))
    step = max(1, int(round(cc.routing_interval_hours * ipd / 24.0)))
    mask = np.zeros(trace.n_intervals - agg, bool)
    if tc.instantaneous:
        return mask
    for e in res.transition_log:
        if e["applied"]:
            lo = e["start"] - agg
            mask[lo: lo + min(len(e["order"]) * tc.stage_intervals, step)] = True
    return mask


def _assert_logs_match(port, ref, rel=1e-9):
    assert len(port.transition_log) == len(ref.transition_log)
    for a, b in zip(port.transition_log, ref.transition_log):
        for k in LOG_EXACT:
            assert a[k] == b[k], k
        for k in LOG_FLOATS:
            assert a[k] == pytest.approx(b[k], rel=rel, abs=1e-12), k


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_engine_with_transitions_matches_reference_scipy(small_fabric,
                                                         small_trace, engine):
    """Forced staging (``decide=False``), two intervals a stage, burst loss:
    the same decisions, logs and topology; metrics within the kernels'
    contract (the reference's Pallas kernels in interpret mode)."""
    tc = dataclasses.replace(TC, decide=False, stage_intervals=2)
    cc = dataclasses.replace(CC, solver_backend="scipy", backend="pallas",
                             loss=LOSS, transition=tc, engine=engine)
    ref = run_controller(small_fabric, small_trace, GEMINI, cc, SC)
    port = _port_run(small_fabric, small_trace, cc)
    assert port.n_topology_updates == ref.n_topology_updates
    assert port.n_skipped_topology == ref.n_skipped_topology == 0
    assert len(port.transition_log) == port.n_topology_updates - 1 >= 1
    _assert_logs_match(port, ref)
    np.testing.assert_array_equal(port.final_topology, ref.final_topology)
    assert _staged_mask(port, small_trace, cc, tc).any()
    for field in ("mlu", "alu", "olr", "stretch"):
        np.testing.assert_allclose(getattr(port.metrics, field),
                                   getattr(ref.metrics, field),
                                   rtol=3e-4, atol=1e-4, err_msg=field)
    np.testing.assert_allclose(port.metrics.loss, ref.metrics.loss,
                               rtol=2e-3, atol=1e-5)
    assert set(port.stage_times) == set(ref.stage_times)
    assert "transition" in port.stage_times


def test_batched_engine_with_transitions_matches_reference_pdhg():
    """PDHG on the 6-pod F18: the same decisions and drain orders, gate u's
    and per-epoch u* within 2·tol, p999 MLU within 0.05."""
    spec = FLEET_SPECS[17]
    fabric = make_fabric(spec)
    trace = make_trace(spec, fabric, days=9.0, interval_minutes=120.0)
    tc = dataclasses.replace(TC, decide=False)
    cc = dataclasses.replace(CC, solver_backend="pdhg", loss=LOSS,
                             transition=tc)
    ref = run_controller(fabric, trace, GEMINI, cc, SC)
    port = _port_run(fabric, trace, cc)
    assert port.n_topology_updates == ref.n_topology_updates
    assert port.n_skipped_topology == ref.n_skipped_topology
    np.testing.assert_array_equal(port.final_topology, ref.final_topology)
    _assert_logs_match(port, ref, rel=2 * cc.pdhg_tol)
    assert port.summary["p999_mlu"] == pytest.approx(ref.summary["p999_mlu"],
                                                     rel=0.05)
    for m in (port.metrics.mlu, port.metrics.loss):
        assert np.isfinite(m).all()


# the gate deciding (``decide=True``) on PDHG, one update applied and one
# skipped: the 9-pod F5, a 2.5-day hourly trace, 1-day aggregation, 3-hour
# routing and a topology solve every 12 hours (three joint solves, the gate
# at the second and third); chip_smoke.py phase 9 runs the same walk on the
# card and expects these decisions
GATE_DECIDE = dict(spec_index=4, days=2.5, interval_minutes=60.0,
                   cc=dict(routing_interval_hours=3.0, topology_interval_days=0.5,
                           aggregation_days=1.0, k_critical=4))
GATE_DECISIONS = [True, False]


def test_gate_decides_like_the_reference_pdhg():
    """The §4.6 gate with ``decide=True`` on PDHG: the port applies and
    skips the same updates as the reference, benefit and disruption within
    2·tol, one update applied and one skipped."""
    spec = FLEET_SPECS[GATE_DECIDE["spec_index"]]
    fabric = make_fabric(spec)
    trace = make_trace(spec, fabric, days=GATE_DECIDE["days"],
                       interval_minutes=GATE_DECIDE["interval_minutes"])
    cc = ControllerConfig(solver_backend="pdhg", backend="numpy",
                          transition=TransitionConfig(n_panels=4, stage_intervals=1),
                          **GATE_DECIDE["cc"])
    assert cc.transition.decide
    sc = SolverConfig()
    ref = run_controller(fabric, trace, GEMINI, cc, sc)
    port = port_run_controller(
        _port_fab(fabric), _port_trace(trace), GEMINI, _port_cc(cc),
        interop.solver_config_from_dict(dataclasses.asdict(sc)), device="cpu")
    assert [e["applied"] for e in ref.transition_log] == GATE_DECISIONS
    assert [e["applied"] for e in port.transition_log] == GATE_DECISIONS
    assert port.n_topology_updates == ref.n_topology_updates
    assert port.n_skipped_topology == ref.n_skipped_topology == 1
    _assert_logs_match(port, ref, rel=2 * cc.pdhg_tol)
    np.testing.assert_array_equal(port.final_topology, ref.final_topology)


def test_high_hysteresis_skips_like_the_reference(small_fabric, small_trace):
    tc = dataclasses.replace(TC, hysteresis=50.0)
    cc = dataclasses.replace(CC, solver_backend="scipy", transition=tc)
    ref = run_controller(small_fabric, small_trace, GEMINI, cc, SC)
    port = _port_run(small_fabric, small_trace, cc)
    base = _port_run(small_fabric, small_trace,
                     dataclasses.replace(cc, transition=None))
    assert port.n_skipped_topology == ref.n_skipped_topology >= 1
    assert (port.n_topology_updates + port.n_skipped_topology
            == base.n_topology_updates)
    _assert_logs_match(port, ref)
    skipped = [e for e in port.transition_log if not e["applied"]]
    assert skipped and all(not port_tr.should_reconfigure(
        e["benefit"], e["disruption"], 50.0) for e in skipped)


# ---- the port's engines against each other ------------------------------------


@pytest.fixture(scope="module")
def scipy_runs(small_fabric, small_trace):
    """The port's sequential, batched and streaming runs with forced
    staging and loss, and the batched run without transitions."""
    tc = dataclasses.replace(TC, decide=False, stage_intervals=2)
    cc = dataclasses.replace(CC, solver_backend="scipy", loss=LOSS,
                             transition=tc)
    seq = _port_run(small_fabric, small_trace, cc, engine="sequential")
    bat = _port_run(small_fabric, small_trace, cc, engine="batched")
    stream = port_serve.StreamingController(
        _port_fab(small_fabric), port_serve.TMStream.from_trace(
            _port_trace(small_trace)), GEMINI, _port_cc(cc), _port_sc(),
        serve=port_serve.ServeConfig(auto_strategy=False),
        device="cpu").run()
    off = _port_run(small_fabric, small_trace, cc, transition=None)
    return cc, tc, seq, bat, stream, off


def test_sequential_and_batched_engines_agree(scipy_runs):
    """The same solves and the same gate; the two score through different
    plain versions on the CPU (one block against a batch), which agree to
    1e-12 (the reference holds its engines to MLU rtol 1e-3)."""
    _, _, seq, bat, _, _ = scipy_runs
    assert seq.n_topology_updates == bat.n_topology_updates
    assert seq.n_skipped_topology == bat.n_skipped_topology
    np.testing.assert_array_equal(seq.final_topology, bat.final_topology)
    assert seq.transition_log == bat.transition_log
    for field in ("mlu", "alu", "olr", "stretch", "loss"):
        np.testing.assert_allclose(getattr(seq.metrics, field),
                                   getattr(bat.metrics, field), rtol=1e-12,
                                   atol=1e-15, err_msg=field)


def test_streaming_replays_the_batched_engine(scipy_runs):
    """The gate and the drain-staged scoring survive the move online
    (``tests/test_serve.py:152``)."""
    _, _, _, bat, stream, _ = scipy_runs
    on = stream.result
    assert on.n_topology_updates == bat.n_topology_updates
    assert on.n_skipped_topology == bat.n_skipped_topology
    assert on.transition_log == bat.transition_log
    assert sum(d.topology_applied for d in stream.decisions) == bat.n_topology_updates
    for field in ("mlu", "alu", "olr", "stretch", "loss"):
        np.testing.assert_allclose(getattr(on.metrics, field),
                                   getattr(bat.metrics, field), atol=1e-12)


def test_streaming_matches_reference_streaming(small_fabric, small_trace):
    """The reference's streaming controller with the gate, on the same
    state (its float64 oracle against the port's float32 plain versions)."""
    cc = dataclasses.replace(CC, solver_backend="scipy", transition=TC)
    ref = StreamingController(small_fabric, TMStream.from_trace(small_trace),
                              GEMINI, cc, SC).run()
    port = port_serve.StreamingController(
        _port_fab(small_fabric), port_serve.TMStream.from_trace(
            _port_trace(small_trace)), GEMINI, _port_cc(cc, backend="torch"),
        _port_sc(), device="cpu").run()
    assert port.result.n_topology_updates == ref.result.n_topology_updates
    assert port.result.n_skipped_topology == ref.result.n_skipped_topology
    _assert_logs_match(port.result, ref.result)
    assert [d.topology_applied for d in port.decisions] == [
        d.topology_applied for d in ref.decisions]
    np.testing.assert_allclose(port.result.metrics.mlu, ref.result.metrics.mlu,
                               rtol=3e-4, atol=1e-4)


def test_staged_intervals_differ_only_where_staged(scipy_runs, small_trace):
    """With the same routing solves, the staged sweep and the sweep without
    transitions differ only in the drain-staged intervals."""
    cc, tc, _, bat, _, off = scipy_runs
    mask = _staged_mask(bat, small_trace, cc, tc)
    assert mask.any() and not mask.all()
    np.testing.assert_array_equal(bat.metrics.mlu[~mask], off.metrics.mlu[~mask])
    assert not np.array_equal(bat.metrics.mlu[mask], off.metrics.mlu[mask])


def test_transition_none_is_bit_identical(small_fabric, small_trace):
    """``transition=None`` scores as before the gate existed: the same bits
    as the gate modeled as instantaneous (its decisions forced, its staging
    off), and no log; with a single topology epoch the gate never runs."""
    cc = dataclasses.replace(CC, solver_backend="scipy", loss=LOSS)
    for engine in ("sequential", "batched"):
        off = _port_run(small_fabric, small_trace, cc, engine=engine)
        inst = _port_run(small_fabric, small_trace, cc, engine=engine,
                         transition=dataclasses.replace(
                             TC, decide=False, instantaneous=True))
        assert off.n_skipped_topology == 0 and off.transition_log == ()
        assert len(inst.transition_log) >= 1
        assert "transition" not in off.stage_times
        for field in ("mlu", "alu", "olr", "stretch", "loss"):
            np.testing.assert_array_equal(getattr(inst.metrics, field),
                                          getattr(off.metrics, field))
        np.testing.assert_array_equal(inst.splits, off.splits)
    short = dataclasses.replace(cc, topology_interval_days=30.0)
    one = _port_run(small_fabric, small_trace, short, transition=TC)
    none = _port_run(small_fabric, small_trace, short)
    assert one.transition_log == () and one.n_topology_updates == 1
    np.testing.assert_array_equal(one.metrics.mlu, none.metrics.mlu)
    np.testing.assert_array_equal(one.metrics.loss, none.metrics.loss)


# ---- the fleet engine --------------------------------------------------------


def test_fleet_job_with_transitions_matches_per_fabric_and_reference():
    """F1 (11 pods, padded to 12) with forced staging in the fleet engine:
    its drain stages score in the bucket's padded layout under the gate's
    own routing (the per-fabric engine's), so staged intervals match the
    per-fabric engine within 1e-5; the rest within the fleet contract (p999
    rel 1e-3).  Against the reference's fleet engine: the same decisions and
    logs within 2·tol, p999 MLU rel 1e-3."""
    spec = FLEET_SPECS[0]
    fabric = make_fabric(spec)
    trace = make_trace(spec, fabric, days=7.0, interval_minutes=120.0)
    tc = dataclasses.replace(TC, decide=False, stage_intervals=2)
    cc = dataclasses.replace(CC, loss=LOSS, transition=tc)
    hedge = Strategy(nonuniform=True, hedging=True)
    job = PortFleetJob(_port_fab(fabric), _port_trace(trace), hedge,
                       _port_cc(cc), _port_sc())
    fl = port_run_fleet([job], device="cpu")[0]
    per = port_run_controller(job.fabric, job.trace, hedge, job.cc, job.sc,
                              device="cpu")
    ref = run_fleet([FleetJob(fabric, trace, hedge, cc, SC)], mesh=None)[0]
    assert fl.n_topology_updates == per.n_topology_updates == ref.n_topology_updates
    assert fl.transition_log == per.transition_log
    _assert_logs_match(fl, ref, rel=2 * cc.pdhg_tol)
    mask = _staged_mask(fl, trace, cc, tc)
    assert mask.any()
    for field in ("mlu", "alu", "olr", "stretch"):
        np.testing.assert_allclose(getattr(fl.metrics, field)[mask],
                                   getattr(per.metrics, field)[mask],
                                   rtol=1e-5, atol=1e-5, err_msg=field)
    for k in P999:
        assert fl.summary[k] == pytest.approx(per.summary[k], rel=1e-3,
                                              abs=1e-6), k
        assert fl.summary[k] == pytest.approx(ref.summary[k], rel=1e-3,
                                              abs=1e-6), k
    assert "transition" in fl.stage_times
