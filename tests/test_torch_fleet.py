"""Port vs reference: the fleet engine — ``solve_routing_fleet`` and
``run_fleet``.

(a) PDHG.  The same padded bucket (fabrics of 6, 7 and 8 pods in the 8-pod
    layout, each element with its own pod mask, one anchor per fabric)
    through :meth:`repro.core.jaxlp.JaxRoutingSolver.solve_routing_fleet` and
    the port's.  Contract: equal per-stage iteration counts for every
    element, per-element u* within 2·tol (both are certified to tol).
    Observed on the CPU: u* within 7e-7 relative, splits within 2.1e-5.  The
    port does not pad the batch (the reference quantizes it for jit-shape
    stability), so a sub-batch must give each of its elements bit-equal
    results.
(b) Engine.  ``run_fleet(device="cpu")`` against the reference's
    ``run_fleet`` on a two-fabric fleet of distinct pod counts, each padded
    (F1: 11 → 12 pods, F2: 7 → 8), in the configuration of
    ``tests/test_fleet_engine.py`` with burst loss on.  Contract: equal
    counts, final topology and per-stage PDHG iterations; p999 summaries rel
    1e-4, transit fraction abs 1e-4, loss rtol 1e-3 atol 1e-5 (the
    reference's own fleet contract is 1e-3, ``tests/test_fleet_engine.py:96``).
    Observed on the CPU: p999 within 1.9e-6 relative.
(c) Other paths: a non-``pdhg`` job is bit-equal to the port's
    ``run_controller``; burst loss through the fleet path stays paired with
    the port's per-fabric engine; a non-finite PDHG element is re-solved by
    scipy in the padded layout.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.burst import BurstParams, LossConfig
from repro.core import ControllerConfig, SolverConfig, Strategy
from repro.core.clustering import critical_tms
from repro.core.fleet import (FLEET_SPECS, commodity_slots, make_fabric,
                              make_trace, scatter_pad)
from repro.core.fleet_engine import FleetJob, run_fleet
from repro.core.graph import Fabric, directed_edge_index, uniform_topology
from repro.core.jaxlp import JaxRoutingSolver
from repro.core.lp import estimate_delta
from repro.core.paths import build_paths
from repro_torch import interop
from repro_torch.core import FleetJob as PortFleetJob
from repro_torch.core import run_controller as port_run_controller
from repro_torch.core import run_fleet as port_run_fleet
from repro_torch.core.pdhg import TorchRoutingSolver

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=3.0,
                      aggregation_days=3.0, k_critical=4, solver_backend="pdhg")
SC = SolverConfig(stage1_method="scaled")
LOSS = LossConfig(burst=BurstParams(rate=0.05, shape=1.6, scale=2.5, clip=8.0),
                  n_sub=4, buffer_ms=25.0, seed=3)
P999 = ("p999_mlu", "p999_alu", "p999_olr", "p999_stretch")
HEDGE = Strategy(nonuniform=False, hedging=True)
# the reference's k-means runs in JAX's default float type (x64 on in CI)
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"


def _port_cc(cc):
    return dataclasses.replace(
        interop.controller_config_from_dict(dataclasses.asdict(cc)),
        kmeans_dtype=KMEANS_DTYPE)


def _port_job(fabric, trace, strategy, cc):
    return PortFleetJob(
        interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed),
        interop.trace_from_numpy(trace.name, trace.demand,
                                 trace.interval_minutes, trace.n_pods),
        interop.strategy_from_dict(dataclasses.asdict(strategy)), _port_cc(cc),
        interop.solver_config_from_dict(dataclasses.asdict(SC)))


# ---- (a) fleet PDHG ------------------------------------------------------------

VP, M, TOL = 8, 4, 1e-2


@pytest.fixture(scope="module")
def bucket():
    """A padded 8-pod bucket: F17 (6 pods, 3 epochs), F2 (7 pods, 4 epochs,
    one unhedged) and F9 (8 pods, 5 epochs); critical TMs from each
    fabric's own trace, uniform-topology capacities, one anchor per fabric."""
    cp = VP * (VP - 1)
    fab_b = Fabric(name="bucket-V8", radix=np.full(VP, 2), speed=np.ones(VP))
    ref = JaxRoutingSolver(fab_b, M, max_iters=3000, tol=TOL)
    tms, caps, valids, deltas, anchor_elems, anchor_of, spans = ([] for _ in range(7))
    n = 0
    for fi, idx in enumerate((16, 1, 8)):
        spec = FLEET_SPECS[idx]
        fab = make_fabric(spec)
        trace = make_trace(spec, fab, days=3.0, interval_minutes=120.0)
        slots = commodity_slots(fab.n_pods, VP)
        cap = scatter_pad(fab.capacities(uniform_topology(fab)), slots, cp)
        b = 3 + fi
        for e in range(b):
            window = trace.demand[4 * e: 4 * e + 12]
            t = np.asarray(critical_tms(window, k=M, seed=e))
            t = np.concatenate([t, np.zeros((M - len(t), t.shape[1]))])
            tms.append(scatter_pad(t, slots, cp, axis=1))
            caps.append(cap)
            valids.append(ref.valid_for_pods(fab.n_pods))
            deltas.append(0.0 if (fi, e) == (1, 0)
                          else estimate_delta(window, 0.99))
        anchor_of += [fi] * b
        anchor_elems.append(n + b // 2)
        spans.append((n, n + b))
        n += b
    args = (np.stack(tms), np.stack(caps), np.stack(valids),
            np.asarray(anchor_elems), np.asarray(anchor_of))
    port = TorchRoutingSolver(
        interop.fabric_from_numpy(fab_b.name, fab_b.radix, fab_b.speed), M,
        tol=TOL, device="cpu")
    kw = dict(hedging=True, deltas=np.asarray(deltas))
    return {"ref_solver": ref, "port_solver": port, "args": args, "kw": kw,
            "spans": spans, "ref": ref.solve_routing_fleet(*args, **kw),
            "port": port.solve_routing_fleet(*args, **kw)}


def test_valid_for_pods_matches_reference(bucket):
    for n_real in (5, 6, 7, 8):
        np.testing.assert_array_equal(
            bucket["port_solver"].valid_for_pods(n_real),
            np.asarray(bucket["ref_solver"].valid_for_pods(n_real)))


def test_solve_routing_fleet_matches_reference(bucket):
    ref, port = bucket["ref"], bucket["port"]
    for stage in ("stage1", "stage2", "stage3"):
        np.testing.assert_array_equal(port["stats"][stage]["iters"],
                                      ref["stats"][stage]["iters"], err_msg=stage)
    np.testing.assert_array_equal(port["stats"]["stage2"]["active"],
                                  ref["stats"]["stage2"]["active"])
    np.testing.assert_allclose(port["u_star"], ref["u_star"], rtol=2 * TOL)
    np.testing.assert_allclose(port["r_star"], ref["r_star"], rtol=2 * TOL)
    assert port["f"].shape == ref["f"].shape
    assert np.isfinite(port["f"]).all() and port["stats"]["anchor_seconds"] > 0
    # padded pods carry no mass: a path touching one has exactly 0, and
    # every real commodity's splits sum to 1
    paths = build_paths(VP)
    edges = directed_edge_index(VP)
    top_pod = np.where(paths.path_edges >= 0,
                       edges[paths.path_edges].max(axis=2), -1).max(axis=1)
    for (lo, hi), n_real in zip(bucket["spans"], (6, 7, 8)):
        f = port["f"][lo:hi]
        assert (f[:, top_pod >= n_real] == 0).all()
        real_comm = edges.max(axis=1) < n_real
        sums = f.reshape(hi - lo, -1, VP - 1).sum(axis=2)
        np.testing.assert_allclose(sums[:, real_comm], 1.0, atol=1e-5)
        assert (sums[:, ~real_comm] == 0).all()


@pytest.mark.parametrize("fabric", [0, 2])
def test_solve_routing_fleet_is_batch_independent(bucket, fabric):
    """One fabric's elements solved on their own (its anchor re-indexed)
    give bit-equal splits, u* and iteration counts to the full batch."""
    tms, caps, valids, anchor_elems, _ = bucket["args"]
    lo, hi = bucket["spans"][fabric]
    deltas = bucket["kw"]["deltas"]
    sub = bucket["port_solver"].solve_routing_fleet(
        tms[lo:hi], caps[lo:hi], valids[lo:hi],
        np.asarray([anchor_elems[fabric] - lo]), np.zeros(hi - lo, np.int64),
        hedging=True, deltas=deltas[lo:hi])
    full = bucket["port"]
    np.testing.assert_array_equal(sub["f"], full["f"][lo:hi])
    np.testing.assert_array_equal(sub["u_star"], full["u_star"][lo:hi])
    for stage in ("stage1", "stage2", "stage3"):
        np.testing.assert_array_equal(sub["stats"][stage]["iters"],
                                      full["stats"][stage]["iters"][lo:hi])


# ---- (b) run_fleet ---------------------------------------------------------------

def _fleet(indices, days):
    out = []
    for idx in indices:
        spec = FLEET_SPECS[idx]
        fabric = make_fabric(spec)
        out.append((fabric, make_trace(spec, fabric, days=days,
                                       interval_minutes=120.0)))
    return out


def test_run_fleet_matches_reference():
    fleet = _fleet((0, 1), days=6.0)  # F1: 11 pods → 12, F2: 7 pods → 8
    cc = dataclasses.replace(CC, loss=LOSS)
    ref = run_fleet([FleetJob(f, t, HEDGE, cc, SC) for f, t in fleet], mesh=None)
    port = port_run_fleet([_port_job(f, t, HEDGE, cc) for f, t in fleet],
                          device="cpu")
    for (fabric, _), r, p in zip(fleet, ref, port):
        assert p.n_routing_updates == r.n_routing_updates
        assert p.n_topology_updates == r.n_topology_updates
        np.testing.assert_array_equal(p.final_topology, r.final_topology)
        assert p.metrics.mlu.shape == r.metrics.mlu.shape
        for k in P999:
            assert p.summary[k] == pytest.approx(r.summary[k], rel=1e-4,
                                                 abs=1e-6), (fabric.name, k)
        assert p.transit_fraction == pytest.approx(r.transit_fraction, abs=1e-4)
        np.testing.assert_allclose(p.metrics.loss, r.metrics.loss, rtol=1e-3,
                                   atol=1e-5)
        assert set(p.stage_times) == set(r.stage_times)
        for stage, st in r.solver_stats.stages.items():
            assert p.solver_stats.stages[stage].iters == st.iters, stage
        # the splits come back in the fabric's own path layout
        assert p.splits.shape[0] == p.n_routing_updates
        per_commodity = p.splits.reshape(p.n_routing_updates, -1,
                                         fabric.n_pods - 1).sum(axis=2)
        np.testing.assert_allclose(per_commodity, 1.0, atol=1e-5)
        assert p.capacities.shape == (p.n_routing_updates,
                                      fabric.n_pods * (fabric.n_pods - 1))


def test_scipy_job_is_bit_equal_to_run_controller(small_fabric, small_trace):
    """A job whose routing solves are not PDHG takes the per-fabric engine."""
    cc = dataclasses.replace(CC, solver_backend="scipy")
    job = _port_job(small_fabric, small_trace, HEDGE, cc)
    out = port_run_fleet([job], device="cpu")[0]
    ref = port_run_controller(job.fabric, job.trace, job.strategy, job.cc,
                              job.sc, device="cpu")
    np.testing.assert_array_equal(out.metrics.mlu, ref.metrics.mlu)
    assert out.summary == ref.summary
    assert out.solver_stats is None


def test_fleet_loss_is_paired_with_per_fabric(small_fabric, small_trace):
    """Burst expansion runs on native-layout blocks with the same seeds, so
    the fleet path's loss differs from the per-fabric engine's only through
    solver-tolerance-level splits (``tests/test_fleet_engine.py:134``)."""
    from repro.core.traffic import Trace

    hot = Trace(small_trace.name, small_trace.demand[:60] * 6.0,
                small_trace.interval_minutes, small_trace.n_pods)
    job = _port_job(small_fabric, hot, HEDGE, dataclasses.replace(CC, loss=LOSS))
    out = port_run_fleet([job], device="cpu")[0]
    ref = port_run_controller(job.fabric, job.trace, job.strategy, job.cc,
                              job.sc, device="cpu")
    assert ref.metrics.loss is not None and ref.metrics.loss.max() > 0
    np.testing.assert_allclose(out.metrics.loss, ref.metrics.loss, rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(out.u_star, ref.u_star, rtol=2 * CC.pdhg_tol)


def test_nonfinite_element_falls_back_to_scipy(monkeypatch):
    """A PDHG element that comes back NaN is re-solved with HiGHS in the
    padded bucket layout; the sweep stays finite and counts the fallback."""
    orig = TorchRoutingSolver.solve_routing_fleet

    def poisoned(self, *args, **kwargs):
        out = orig(self, *args, **kwargs)
        out["f"][1] = np.nan
        return out

    monkeypatch.setattr(TorchRoutingSolver, "solve_routing_fleet", poisoned)
    (fabric, trace), = _fleet((16,), days=5.0)  # F17: 6 pods → 8
    out = port_run_fleet([_port_job(fabric, trace, HEDGE, CC)], device="cpu")[0]
    assert out.solver_stats.n_fallbacks == 1
    assert np.isfinite(out.metrics.mlu).all() and np.isfinite(out.splits).all()
