"""Port vs reference: the re-solve mode of the contingency evaluator
(``FailureConfig(resolve=True)``) on PDHG.

Re-solve routes every (scenario, block) pair anew on its masked capacities:
one flattened ``(K·B)`` PDHG batch, the non-finite scipy fallback, then the
routing weight matrices.  Both packages certify each element's u* to
``pdhg_tol``, so the utilization of the re-solved routing, the per-scenario
p99.9 MLU and the ``cont_*`` summary are held at ``rel 2·pdhg_tol`` (the
contract ``tests/test_torch_transition.py`` holds PDHG evaluations to), and
the fallback count exactly.  The ``resolve_weights`` unit runs at
``pdhg_tol=1e-3``, so that 2·tol separates a hedged routing from an
unhedged one.  Configuration of ``tests/test_failures.py`` (daily routing,
3-day topology, 2-day aggregation, 3 critical TMs) on six days of the
small trace, 4 scenarios at ``p_link=0.1``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (the reference's import order)
import repro.failures as ref_f
import repro_torch.failures as port_f
from repro.core import (STRATEGIES, ControllerConfig, FailureConfig,
                        SolverConfig, run_controller)
from repro.core.fleet import FLEET_SPECS, make_trace
from repro.core.graph import uniform_topology
from repro.core.lp import estimate_delta
from repro.core.rounding import realize
from repro_torch import interop
from repro_torch.core import run_controller as port_run_controller

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=24.0, topology_interval_days=3.0,
                      aggregation_days=2.0, k_critical=3,
                      solver_backend="pdhg")
SC = SolverConfig(stage1_method="scaled")
FC = FailureConfig(n_scenarios=4, p_link=0.1, seed=0, resolve=True)
GEMINI = STRATEGIES[3]  # nonuniform + hedging: re-solve carries the deltas


@pytest.fixture(scope="module")
def short_trace(small_fabric):
    """Six days of the small fixture's fabric and trace generator (nine in
    ``small_trace``): fewer routing epochs to solve on both packages."""
    return make_trace(FLEET_SPECS[0], small_fabric, days=6.0,
                      interval_minutes=120.0)


def _port_fab(fabric):
    return interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed)


def _port_cc(cc):
    return interop.controller_config_from_dict(dataclasses.asdict(cc))


def _port_sc():
    return interop.solver_config_from_dict(dataclasses.asdict(SC))


def _utilization(tms, w, caps):
    """Per (scenario, block) MLU of routing ``w`` over the block's TMs,
    ``(K, B)``, as the solver and the scoring count it: a dead link
    (capacity 0) carries no utilization."""
    load = np.einsum("btc,kbce->kbte", tms, w)
    inv_cap = np.where(caps > 0, 1.0 / np.where(caps > 0, caps, 1.0), 0.0)
    return (load * inv_cap[:, :, None, :]).max(axis=(2, 3))


def _risk(w, caps):
    """Per (scenario, block) hedging risk of routing ``w``, ``(K, B)``: the
    largest split mass one live link carries for one commodity, over its
    capacity (stage 2's objective up to the scalar δ; every (commodity,
    link) pair lies on exactly one path)."""
    inv_cap = np.where(caps > 0, 1.0 / np.where(caps > 0, caps, 1.0), 0.0)
    return (w * inv_cap[:, :, None, :]).max(axis=(2, 3))


def test_resolve_weights_match_reference(small_fabric, small_trace):
    """The same (tms, caps, masks, deltas) through both packages'
    ``resolve_weights``: each (scenario, block) element's routing carries
    the same utilization and the same hedging risk within 2·tol.  The blocks
    differ in capacities, and only the second hedges (δ > 0), so a lost
    mask, a wrong deltas broadcast or a (K, B) reshape out of order shows."""
    fabric, demand = small_fabric, small_trace.demand
    caps = np.asarray(fabric.capacities(
        realize(fabric, uniform_topology(fabric))[0]), float)
    caps_b = np.stack([caps, caps * 0.8])
    tms = np.stack([demand[[6, 18, 30]], demand[[42, 54, 66]]])
    deltas = np.asarray([0.0, estimate_delta(demand[36:72])])
    assert deltas[1] > 0
    _, masks = ref_f.sample_masks(fabric, FC)
    assert masks.min() == 0.0
    caps_kb = caps_b[None] * masks[:, None, :]
    cc = dataclasses.replace(CC, pdhg_tol=1e-3)
    w_ref, nfb_ref = ref_f.resolve_weights(fabric, tms, caps_b, masks, deltas,
                                           cc, SC)
    w_port, nfb_port = port_f.resolve_weights(
        _port_fab(fabric), tms, caps_b, masks, deltas, _port_cc(cc),
        _port_sc(), device="cpu")
    assert w_port.shape == w_ref.shape == (FC.n_scenarios, 2) + w_ref.shape[2:]
    assert nfb_port == nfb_ref
    u_ref = _utilization(tms, w_ref, caps_kb)
    u_port = _utilization(tms, w_port, caps_kb)
    assert (u_port > 0).all()
    np.testing.assert_allclose(u_port, u_ref, rtol=2 * cc.pdhg_tol)
    r_ref, r_port = _risk(w_ref, caps_kb), _risk(w_port, caps_kb)
    np.testing.assert_allclose(r_port, r_ref, rtol=2 * cc.pdhg_tol)


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_resolve_engine_matches_reference(small_fabric, short_trace, engine):
    """The engine's re-solve contingency report against the reference's on
    PDHG: per-scenario p99.9 MLU and the ``cont_*`` summary within 2·tol,
    the same failed-link counts and fallback count."""
    cc = dataclasses.replace(CC, failures=FC, engine=engine)
    ref = run_controller(small_fabric, short_trace, GEMINI, cc, SC)
    port = port_run_controller(
        _port_fab(small_fabric),
        interop.trace_from_numpy(short_trace.name, short_trace.demand,
                                 short_trace.interval_minutes,
                                 short_trace.n_pods),
        GEMINI, _port_cc(cc), _port_sc(), device="cpu")
    rc, pc = ref.contingency, port.contingency
    assert pc.resolve and rc.resolve
    assert pc.n_fallbacks == rc.n_fallbacks
    np.testing.assert_array_equal(pc.n_failed_links, rc.n_failed_links)
    assert np.isfinite(pc.p999_mlu).all()
    np.testing.assert_allclose(pc.p999_mlu, rc.p999_mlu, rtol=2 * cc.pdhg_tol)
    np.testing.assert_allclose(pc.mean_mlu, rc.mean_mlu, rtol=2 * cc.pdhg_tol)
    for key in ("cont_worst_p999_mlu", "cont_mean_p999_mlu"):
        assert port.summary[key] == pytest.approx(ref.summary[key],
                                                  rel=2 * cc.pdhg_tol), key
