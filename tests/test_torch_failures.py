"""Port vs reference: failure contingencies (``repro_torch.failures``) in the
sequential, batched and fleet engines.

State crosses over through :mod:`repro_torch.interop`; the reference scores
with its float64 oracle (``backend="numpy"``) or its Pallas kernels in
interpret mode, the port with its plain PyTorch versions on the CPU
(``backend="torch"``) or its own float64 oracle.  Configuration of
``tests/test_failures.py``: daily routing, 3-day topology, 2-day
aggregation, 3 critical TMs, 8 scenarios at ``p_link=0.1``.  Tolerances:

* sampling and masks: bit-equal (the same numpy streams keyed by crc32, fed
  by the port's copies of ``realize`` and ``assign_panels``);
* the fused contingency scoring against the per-scenario loop and the
  reference's backends: 1e-5 (the reference's own contract); the port's
  float64 oracle against the reference's: bit-equal;
* the engines on scipy: sequential and batched ``cont_*`` within 1e-12 of
  each other, and within the engine contract (p999 rel 1e-3 abs 1e-4, loss
  rtol 2e-3 atol 1e-5) of the reference's engines; re-solve ≤ fixed + 1e-6;
  the fleet engine within rel 1e-3 of the batched engine;
* ``failures=None``: the same bits as a run that never heard of failures;
* the policies: exact (the same float64 arithmetic).
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.failures as ref_f
import repro_torch.failures as port_f
from repro.burst import BurstParams, LossConfig
from repro.core import (STRATEGIES, ControllerConfig, FailureConfig,
                        SolverConfig, TransitionConfig, run_controller)
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.fleet_engine import predict_fleet as ref_predict_fleet
from repro.core.graph import uniform_topology
from repro.core.paths import build_paths, routing_weight_matrices
from repro.core.predictor import pick_best as ref_pick_best
from repro.core.rounding import realize
from repro.core.simulator import IntervalMetrics as RefIntervalMetrics
from repro.transition import should_reconfigure as ref_should_reconfigure
from repro_torch import interop, obs
from repro_torch.core import FleetJob as PortFleetJob
from repro_torch.core import predict_fleet as port_predict_fleet
from repro_torch.core import run_controller as port_run_controller
from repro_torch.core import run_fleet as port_run_fleet
from repro_torch.core.predictor import pick_best as port_pick_best
from repro_torch.core.simulator import IntervalMetrics, route_metrics
from repro_torch.core.simulator import route_metrics_batched as port_rmb
from repro_torch.transition import should_reconfigure as port_should_reconfigure

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=24.0, topology_interval_days=3.0,
                      aggregation_days=2.0, k_critical=3)
SC = SolverConfig(stage1_method="scaled")
FC = FailureConfig(n_scenarios=8, p_link=0.1, seed=0)
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=4, buffer_ms=25.0, seed=3)
GEMINI = STRATEGIES[3]
CONT_MLU = ("cont_worst_p999_mlu", "cont_mean_p999_mlu")
CONT_LOSS = ("cont_worst_p999_loss", "cont_mean_p999_loss")
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


def _port_fc(fc):
    return port_f.FailureConfig(**dataclasses.asdict(fc))


# ---- sampling and masks: bit-equal ------------------------------------------

MODES = {
    "link": dict(p_link=0.1),
    "trunk": dict(p_link=0.0, p_trunk=0.2),
    "panel": dict(p_link=0.0, p_panel=0.7, n_panels=4),
    "pod": dict(p_link=0.0, p_pod=0.3, pod_degrade=0.25),
    "all": dict(p_link=0.05, p_trunk=0.05, p_panel=0.5, p_pod=0.1),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("idx", [0, 2, 16, 20])
def test_sampling_and_masks_are_bit_equal(idx, mode):
    fabric = make_fabric(FLEET_SPECS[idx])
    fc = FailureConfig(n_scenarios=16, seed=idx, **MODES[mode])
    ref_scen, ref_masks = ref_f.sample_masks(fabric, fc)
    scen, masks = port_f.sample_masks(_port_fab(fabric), _port_fc(fc))
    for field in ("trunk_keep", "pod_keep", "n_failed_links", "n_ref_links"):
        np.testing.assert_array_equal(getattr(scen, field),
                                      getattr(ref_scen, field), err_msg=field)
    np.testing.assert_array_equal(masks, ref_masks)
    np.testing.assert_array_equal(
        port_f.directed_masks(_port_fab(fabric), scen), masks)
    assert port_f.scenario_seed(fabric.name, idx, mode) == \
        ref_f.scenario_seed(fabric.name, idx, mode)


def test_link_draws_stay_paired_across_config_changes(small_fabric):
    """Turning other failure modes on does not shift the port's link draws
    (one generator per component), as in the reference."""
    fab = _port_fab(small_fabric)
    base = port_f.sample_scenarios(fab, _port_fc(FC))
    both = port_f.sample_scenarios(
        fab, _port_fc(dataclasses.replace(FC, p_panel=0.5, p_pod=0.3)))
    assert (both.trunk_keep <= base.trunk_keep + 1e-12).all()
    np.testing.assert_array_equal(both.pod_keep.shape, base.pod_keep.shape)
    ref_both = ref_f.sample_scenarios(
        small_fabric, dataclasses.replace(FC, p_panel=0.5, p_pod=0.3))
    np.testing.assert_array_equal(both.trunk_keep, ref_both.trunk_keep)
    n_ref = np.maximum(base.n_ref_links, 1)
    np.testing.assert_array_equal(
        base.n_failed_links, np.rint(((1 - base.trunk_keep) * n_ref).sum(1)))


def test_failure_config_validates_as_the_reference():
    for bad in (dict(n_scenarios=0), dict(p_link=1.5), dict(n_panels=0),
                dict(contingency_weight=2.0)):
        with pytest.raises(ValueError):
            FailureConfig(**bad)
        with pytest.raises(ValueError):
            port_f.FailureConfig(**bad)
    assert dataclasses.asdict(port_f.FailureConfig()) == \
        dataclasses.asdict(FailureConfig())


# ---- the fused contingency scoring ------------------------------------------

def _plan_inputs(fabric, trace, k, p_link=0.15):
    caps = np.asarray(fabric.capacities(
        realize(fabric, uniform_topology(fabric))[0]), float)
    t = trace.demand.shape[0] // 4
    blocks = [trace.demand[:t], trace.demand[t:2 * t]]
    paths = build_paths(fabric.n_pods)
    w = routing_weight_matrices(
        paths, np.full((2, paths.n_paths), 1.0 / (fabric.n_pods - 1)))
    caps_b = np.stack([caps, caps * 0.9])
    _, masks = ref_f.sample_masks(
        fabric, dataclasses.replace(FC, n_scenarios=k, p_link=p_link))
    return blocks, w, caps_b, masks


def _close(a, b, tol=1e-5):
    for field in ("mlu", "alu", "olr", "stretch", "loss"):
        np.testing.assert_allclose(getattr(a, field), getattr(b, field),
                                   atol=tol, err_msg=field)


@pytest.mark.parametrize("k", [8, 64])
def test_contingency_metrics_match_reference_and_loop(small_fabric,
                                                      small_trace, k):
    """K scenarios as K rows of one fused call == the K-iteration loop over
    ``route_metrics_batched``, on the port's plain versions, within 1e-5;
    the port's float64 oracle gives the reference oracle's bits; K = 8 also
    against the reference's Pallas kernels in interpret mode."""
    blocks, w, caps_b, masks = _plan_inputs(small_fabric, small_trace, k)
    kw = dict(loss_cfg=LOSS, loss_seeds=[11, 12], interval_seconds=3600.0)
    fused = port_f.contingency_metrics(blocks, w, caps_b, masks, 0.8,
                                       backend="torch", device="cpu", **kw)
    oracle = port_f.contingency_metrics(blocks, w, caps_b, masks, 0.8,
                                        backend="numpy", **kw)
    ref = ref_f.contingency_metrics(blocks, w, caps_b, masks, 0.8,
                                    backend="numpy", **kw)
    ref_pl = (ref_f.contingency_metrics(blocks, w, caps_b, masks, 0.8,
                                        backend="pallas", **kw)
              if k == 8 else None)
    assert len(fused) == len(oracle) == k
    assert masks.min() == 0.0  # dead links carrying live weights are scored
    for ki in range(k):
        loop = port_rmb(blocks, w, caps_b * masks[ki][None, :], 0.8,
                        backend="torch", loss_seeds=[11, 12],
                        loss_cfg=LOSS, interval_seconds=3600.0, device="cpu")
        _close(fused[ki], loop)
        _close(fused[ki], ref[ki])
        for field in ("mlu", "alu", "olr", "stretch", "loss"):
            np.testing.assert_array_equal(getattr(oracle[ki], field),
                                          getattr(ref[ki], field))
        if ref_pl is not None:
            _close(fused[ki], ref_pl[ki])


def test_contingency_rows_share_their_plan(small_fabric, small_trace):
    """Two fixed-routing jobs and a re-solve job (per-scenario weights) in one
    call give each job what a call of its own gives, bit for bit."""
    blocks, w, caps_b, masks = _plan_inputs(small_fabric, small_trace, 3)
    w_k = np.stack([w * (1.0 + 0.01 * i) for i in range(3)])
    jobs = [port_f.EvalJob(blocks, w, caps_b, masks),
            port_f.EvalJob(blocks, w[::-1], caps_b[::-1], masks[:2]),
            port_f.EvalJob(blocks, w, caps_b, masks, weights_k=w_k)]
    both = port_f.contingency_metrics_jobs(jobs, backend="torch",
                                           device="cpu")
    for job, ms in zip(jobs, both):
        alone = port_f.contingency_metrics_jobs([job], backend="torch",
                                                device="cpu")[0]
        assert len(ms) == len(alone) == job.masks.shape[0]
        for a, b in zip(ms, alone):
            np.testing.assert_array_equal(a.mlu, b.mlu)
            np.testing.assert_array_equal(a.olr, b.olr)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_all_dead_capacities_score_zero(backend, rng):
    v = 4
    paths = build_paths(v)
    w = routing_weight_matrices(
        paths, np.full((1, paths.n_paths), 1.0 / (v - 1)))[0]
    demand = rng.random((5, v * (v - 1)))
    m = route_metrics(demand, w, np.zeros(v * (v - 1)), backend=backend,
                      device="cpu")
    for x in (m.mlu, m.alu, m.olr):
        np.testing.assert_array_equal(x, np.zeros(5))


@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_dead_link_excluded_from_mlu_but_drops_its_demand(backend):
    """A fully-failed link carries no utilization (``inv_cap = 0``) while the
    demand still aimed at it is dropped (``buf = cap·buffer_ms = 0``) — on
    the single-block path, and on the fused contingency path where the dead
    link is a scenario's mask."""
    v = 4
    e_d = v * (v - 1)
    paths = build_paths(v)
    w = routing_weight_matrices(
        paths, np.full((1, paths.n_paths), 1.0 / (v - 1)))[0]
    demand = np.full((4, e_d), 0.2)
    caps = np.ones(e_d)
    caps_dead = caps.copy()
    caps_dead[3] = 0.0
    kw = dict(backend=backend, loss_cfg=LOSS, interval_seconds=3600.0,
              device="cpu")
    m_live = route_metrics(demand, w, caps, **kw)
    m_dead = route_metrics(demand, w, caps_dead, **kw)
    assert np.isfinite(m_dead.mlu).all()
    assert (m_dead.loss >= m_live.loss - 1e-12).all()
    assert m_dead.loss.mean() > m_live.loss.mean()
    ref = RefIntervalMetrics(**{f: getattr(m_dead, f) for f in
                                ("mlu", "alu", "olr", "stretch", "loss")})
    fused = port_f.contingency_metrics(
        [demand], w[None], caps[None], np.stack([np.ones(e_d), caps_dead]),
        loss_seeds=[LOSS.seed], **kw)
    _close(fused[1], ref)
    _close(fused[0], m_live)


# ---- engines ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_failures_none_is_bit_identical(small_fabric, small_trace, engine):
    cc = dataclasses.replace(CC, engine=engine, loss=LOSS)
    r0 = _port_run(small_fabric, small_trace, cc, backend="torch")
    r1 = _port_run(small_fabric, small_trace,
                   dataclasses.replace(cc, failures=FC), backend="torch")
    for field in ("mlu", "alu", "olr", "stretch", "loss"):
        np.testing.assert_array_equal(getattr(r0.metrics, field),
                                      getattr(r1.metrics, field))
    np.testing.assert_array_equal(r0.splits, r1.splits)
    assert r0.summary == {k: v for k, v in r1.summary.items()
                          if not k.startswith("cont_")}
    assert r0.contingency is None and "failures" not in r0.stage_times
    assert r1.contingency.n_scenarios == FC.n_scenarios
    assert len(r1.contingency.n_failed_links) == FC.n_scenarios
    assert r1.stage_times["failures"] > 0


@pytest.fixture(scope="module")
def engine_runs(small_fabric, small_trace):
    """Both engines of both packages on scipy with burst loss, the port on
    its plain versions (its float64 oracle gives the reference oracle's bits:
    ``test_contingency_metrics_match_reference_and_loop``)."""
    cc = dataclasses.replace(CC, failures=FC, loss=LOSS)
    out = {}
    for engine in ("sequential", "batched"):
        cce = dataclasses.replace(cc, engine=engine)
        out["ref", engine] = run_controller(small_fabric, small_trace, GEMINI,
                                            cce, SC)
        out["port", engine] = _port_run(small_fabric, small_trace, cce,
                                        backend="torch")
    return out


def test_sequential_and_batched_contingency_agree(engine_runs):
    rs, rb = engine_runs["port", "sequential"], engine_runs["port", "batched"]
    keys = [k for k in rs.summary if k.startswith("cont_")]
    assert set(keys) == {"cont_n_scenarios", *CONT_MLU, *CONT_LOSS}
    for key in keys:
        assert rs.summary[key] == pytest.approx(rb.summary[key],
                                                abs=1e-12), key
    assert rs.contingency.to_dict() == rb.contingency.to_dict()


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_engines_match_reference_contingency(engine_runs, engine):
    ref, port = engine_runs["ref", engine], engine_runs["port", engine]
    np.testing.assert_array_equal(port.contingency.n_failed_links,
                                  ref.contingency.n_failed_links)
    for key in CONT_MLU:
        assert port.summary[key] == pytest.approx(ref.summary[key], rel=1e-3,
                                                  abs=1e-4), key
    for key in CONT_LOSS:
        assert port.summary[key] == pytest.approx(ref.summary[key], rel=2e-3,
                                                  abs=1e-5), key
    np.testing.assert_allclose(port.contingency.p999_mlu,
                               ref.contingency.p999_mlu, rtol=1e-3, atol=1e-4)


def test_resolve_mode_is_no_worse_than_fixed(small_fabric, small_trace):
    """Re-solved routing (one PDHG batch over (scenario × block)) can only
    help the what-if MLU against frozen splits, as in the reference."""
    fc = dataclasses.replace(FC, n_scenarios=4, p_link=0.3)
    fixed = _port_run(small_fabric, small_trace,
                      dataclasses.replace(CC, failures=fc), STRATEGIES[0],
                      backend="torch")
    resolved = _port_run(
        small_fabric, small_trace,
        dataclasses.replace(CC, failures=dataclasses.replace(fc, resolve=True)),
        STRATEGIES[0], backend="torch")
    assert resolved.contingency.resolve and not fixed.contingency.resolve
    assert (resolved.summary["cont_worst_p999_mlu"]
            <= fixed.summary["cont_worst_p999_mlu"] + 1e-6)
    assert np.isfinite(resolved.contingency.p999_mlu).all()


def test_fleet_contingency_matches_batched_engine():
    """The fleet engine against the per-fabric batched engine, within rel
    1e-3: F17 (6 pods) with fixed routing and F2 (7 pods) in re-solve mode
    share the 8-pod bucket (uniform + hedging) — one fused launch over every
    (job, scenario) row of the fixed job, masks padded into the bucket
    layout; the re-solve job in its native layout."""
    fabs = []
    for idx in (16, 1):
        spec = FLEET_SPECS[idx]
        fab = make_fabric(spec)
        fabs.append((fab, make_trace(spec, fab, days=5.0,
                                     interval_minutes=120.0)))
    cc = _port_cc(dataclasses.replace(CC, failures=FC, loss=LOSS),
                  backend="torch", solver_backend="pdhg")
    cc_rs = dataclasses.replace(cc, failures=dataclasses.replace(
        cc.failures, n_scenarios=3, resolve=True))
    jobs = [PortFleetJob(_port_fab(f), _port_trace(t), STRATEGIES[1], c,
                         _port_sc())
            for (f, t), c in zip(fabs, (cc, cc_rs))]
    fleet = port_run_fleet(jobs, device="cpu")
    for job, res_f in zip(jobs, fleet):
        res_b = port_run_controller(job.fabric, job.trace, job.strategy,
                                    job.cc, job.sc, device="cpu")
        assert res_f.contingency.resolve == job.cc.failures.resolve
        for key in CONT_MLU:
            assert res_f.summary[key] == pytest.approx(res_b.summary[key],
                                                       rel=1e-3), key
        assert res_f.stage_times["failures"] > 0


# ---- policies and the gate --------------------------------------------------

PER = {
    "a": {"p999_mlu": 1.00, "p999_alu": 0.5, "p999_loss": 0.02,
          "cont_worst_p999_mlu": 3.0, "cont_worst_p999_loss": 0.10},
    "b": {"p999_mlu": 1.04, "p999_alu": 0.4, "p999_loss": 0.03,
          "cont_worst_p999_mlu": 1.2, "cont_worst_p999_loss": 0.04},
    "c": {"p999_mlu": 1.02, "p999_alu": 0.45, "p999_loss": 0.021,
          "cont_worst_p999_mlu": 2.0, "cont_worst_p999_loss": 0.05},
}


@pytest.mark.parametrize("objective", ["mlu", "loss"])
@pytest.mark.parametrize("weight", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("cushion", [0.0, 0.01, 0.05])
def test_pick_best_contingency_matches_reference(objective, weight, cushion):
    ref = ref_f.pick_best_contingency(PER, cushion, objective, weight)
    assert port_f.pick_best_contingency(PER, cushion, objective, weight) == ref
    assert port_pick_best(PER, cushion, objective=objective,
                          contingency_weight=weight) == ref
    assert ref_pick_best(PER, cushion, objective=objective,
                         contingency_weight=weight) == ref


def test_pick_best_contingency_refuses_what_the_reference_refuses():
    missing = {"a": {"p999_mlu": 1.0, "p999_alu": 0.1}}
    with pytest.raises(ValueError, match="cont_worst_p999_mlu"):
        port_f.pick_best_contingency(missing, 0.05, "mlu", 0.5)
    with pytest.raises(ValueError, match="contingency_weight"):
        port_f.pick_best_contingency(PER, 0.05, "mlu", 1.5)
    with pytest.raises(ValueError, match="objective"):
        port_f.pick_best_contingency(PER, 0.05, "stretch", 0.5)


def test_fixed_mlu_under_masks_and_transition_worst_case_match(rng):
    """Both policies on the same fixed routings: exact.  The worst case
    samples its masks for the fabric itself (F17, 6 pods)."""
    fabric = make_fabric(FLEET_SPECS[16])
    v = fabric.n_pods
    e_d = v * (v - 1)
    paths = build_paths(v)
    f = rng.dirichlet(np.ones(v - 1), size=(6, e_d)).reshape(6, -1)
    w = routing_weight_matrices(paths, f)
    tms = rng.random((3, e_d))
    caps = 1.0 + rng.random((6, e_d))
    masks = np.where(rng.random((7, e_d)) < 0.2, 0.0, rng.random((7, e_d)))
    np.testing.assert_array_equal(
        port_f.fixed_mlu_under_masks(tms, w, caps, masks),
        ref_f.fixed_mlu_under_masks(tms, w, caps, masks))
    fc = dataclasses.replace(FC, n_scenarios=16, p_link=0.3, p_trunk=0.1)
    for n_stages in (4, 0):
        ev = types.SimpleNamespace(
            steady_w=w[:2], stage_w=w[2:2 + n_stages], steady_caps=caps[:2],
            stage_caps=caps[2:2 + n_stages], horizon_intervals=12,
            transition_intervals=n_stages)
        assert port_f.transition_worst_case(_port_fab(fabric), tms, ev,
                                            _port_fc(fc)) == \
            ref_f.transition_worst_case(fabric, tms, ev, fc)


BLEND = [(1.0, 0.5, None, None, None), (0.4, 0.5, None, None, None),
         (1.0, 0.5, 0.0, -5.0, 9.0), (1.0, 0.5, 0.9, -5.0, 9.0),
         (1.0, 0.5, 0.5, 0.8, 0.3), (2.0, 0.1, 1.0, 0.05, 0.2)]


@pytest.mark.parametrize("b,d,w,bw,dw", BLEND)
def test_blended_should_reconfigure_matches_reference(b, d, w, bw, dw):
    kw = ({} if w is None else
          dict(contingency_weight=w, benefit_worst=bw, disruption_worst=dw))
    assert port_should_reconfigure(b, d, **kw) == \
        ref_should_reconfigure(b, d, **kw)


def test_failure_aware_gate_vetoes_at_least_as_many(small_fabric,
                                                    small_trace):
    """contingency_weight = 1 with catastrophic scenarios vetoes at least the
    transitions the expected-case gate vetoes; both gates decide what the
    reference's gates decide."""
    tc = TransitionConfig(n_panels=4, stage_intervals=1)
    cc_exp = dataclasses.replace(CC, transition=tc, failures=FC)
    cc_rob = dataclasses.replace(
        CC, transition=tc,
        failures=dataclasses.replace(FC, contingency_weight=1.0, p_link=0.6,
                                     n_scenarios=16))
    runs = {}
    for name, cc in (("exp", cc_exp), ("rob", cc_rob)):
        ref = run_controller(small_fabric, small_trace, STRATEGIES[2], cc, SC)
        port = _port_run(small_fabric, small_trace, cc, STRATEGIES[2],
                         backend="torch")
        assert [e["applied"] for e in port.transition_log] == \
            [e["applied"] for e in ref.transition_log], name
        assert port.n_skipped_topology == ref.n_skipped_topology
        runs[name] = port
    assert len(runs["rob"].transition_log) == len(runs["exp"].transition_log)
    assert runs["rob"].n_skipped_topology >= runs["exp"].n_skipped_topology


def test_predict_fleet_contingency_weight_matches_reference(small_fabric,
                                                            small_trace):
    cc = dataclasses.replace(CC, failures=FC)
    ref = ref_predict_fleet([(small_fabric, small_trace)], cc, SC, mesh=None,
                            contingency_weight=0.5)[0]
    port = port_predict_fleet(
        [(_port_fab(small_fabric), _port_trace(small_trace))],
        _port_cc(cc, backend="torch"), _port_sc(), contingency_weight=0.5,
        device="cpu")[0]
    assert port.strategy.name == ref.strategy.name
    for name, summary in ref.per_strategy.items():
        assert port.per_strategy[name]["cont_worst_p999_mlu"] == \
            pytest.approx(summary["cont_worst_p999_mlu"], rel=1e-3, abs=1e-4)


# ---- the report -------------------------------------------------------------

@pytest.mark.parametrize("with_loss", [False, True])
def test_report_to_dict_and_gauges_match_reference(small_fabric, rng,
                                                   with_loss):
    from repro.obs import metrics as ref_metrics

    scen = ref_f.sample_scenarios(small_fabric, FC)
    k, t = FC.n_scenarios, 7
    arrays = [dict(mlu=rng.random(t), alu=rng.random(t), olr=rng.random(t),
                   stretch=1 + rng.random(t),
                   loss=rng.random(t) * 0.01 if with_loss else None)
              for _ in range(k)]
    ref = ref_f.report_from_metrics(
        scen, [RefIntervalMetrics(**a) for a in arrays], resolve=False,
        n_fallbacks=2)
    port_scen = port_f.sample_scenarios(_port_fab(small_fabric),
                                        _port_fc(FC))
    port = port_f.report_from_metrics(
        port_scen, [IntervalMetrics(**a) for a in arrays], resolve=False,
        n_fallbacks=2)
    assert port.to_dict() == ref.to_dict()
    assert port.summary_update() == ref.summary_update()
    snaps = []
    for mod, record, rep in ((obs.metrics, port_f.evaluate
                              .record_contingency_gauges, port),
                             (ref_metrics, ref_f.evaluate
                              .record_contingency_gauges, ref)):
        mod.enable()
        mod.clear()
        try:
            record(small_fabric.name, rep)
            snaps.append(mod.snapshot())
        finally:
            mod.disable()
            mod.clear()
    assert snaps[0] == snaps[1]


def test_failures_package_imports_first():
    """``import repro_torch.failures`` as the first import works (the
    package and ``repro_torch.core`` re-export each other's names)."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import repro_torch.failures as f, repro_torch.core as c; "
         "assert c.FailureConfig is f.FailureConfig; "
         "assert c.ContingencyReport is f.ContingencyReport"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(Path(__file__).parents[1] / "src")))
    assert out.returncode == 0, out.stderr


def test_streaming_controller_refuses_failures(small_fabric, small_trace):
    """Contingency analysis is offline-only: both streaming controllers
    refuse it with ``ValueError``."""
    from repro.serve import StreamingController, TMStream
    from repro_torch import serve as port_serve

    cc = dataclasses.replace(CC, failures=FC)
    with pytest.raises(ValueError, match="offline-only"):
        StreamingController(small_fabric, TMStream.from_trace(small_trace),
                            GEMINI, cc, SC)
    with pytest.raises(ValueError, match="offline-only"):
        port_serve.StreamingController(
            _port_fab(small_fabric),
            port_serve.TMStream.from_trace(_port_trace(small_trace)), GEMINI,
            _port_cc(cc), _port_sc(), device="cpu")
