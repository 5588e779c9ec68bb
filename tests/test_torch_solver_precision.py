"""Port vs reference: mixed-precision (bf16) PDHG — the port's counterpart of
``tests/test_solver_precision.py``.

``precision="bf16"`` rounds the operands of the iteration's load operator
and its adjoint to bfloat16 and accumulates in float32; every reported
quantity — the duality-gap certificate, the returned utilization, the step
sizes — is evaluated in float32.  Contracts: bf16 MLU within 1 % of the f32
solver's and within 1 % of the reference's bf16 solver's; the reported u is
the float32 evaluation of the final flows, bit for bit; the bf16 operators
give the reference's bits on the CPU (both compute exact bf16 products in
float32); every engine, the streaming controller included, runs bf16 with
its p99.9 MLU within 1 % of its f32 run.
"""

import dataclasses

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.clustering import critical_tms
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.graph import Fabric, uniform_topology
from repro.core.jaxlp import JaxRoutingSolver
from repro_torch import interop
from repro_torch import serve as port_serve
from repro_torch.core import (ControllerConfig, FleetJob, SolverConfig,
                              Strategy, run_controller, run_fleet)
from repro_torch.core.engine import routing_solver_for
from repro_torch.core.fleet import fleet_bucket_key
from repro_torch.core.pdhg import TorchRoutingSolver, _bmm_bf16

torch.set_num_threads(1)

KW = dict(max_iters=4000, dual_topk=128)
HEDGE = Strategy(nonuniform=False, hedging=True)


def _instance(v=6, m=4, b=6, seed=0):
    """The reference test's instance: ``b`` epochs of ``m`` critical TMs of
    a homogeneous ``v``-pod fabric at its uniform capacities."""
    rng = np.random.default_rng(seed)
    fabric = Fabric.homogeneous("mp", v, radix=40, speed=100.0)
    cap = fabric.capacities(uniform_topology(fabric))
    tms_b = np.stack([critical_tms(rng.gamma(2.0, 30.0, (50, v * (v - 1))),
                                   k=m) for _ in range(b)])
    caps_b = np.ascontiguousarray(np.broadcast_to(cap, (b, cap.shape[0])))
    return fabric, tms_b, caps_b


def _port_solver(fabric, m, **kw):
    return TorchRoutingSolver(
        interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed), m,
        device="cpu", **dict(KW, **kw))


def _stage1(solver, tms_b, caps_b):
    return solver.solve_routing_batch(tms_b, caps_b, hedging=False,
                                      skip_stage3=True)["u_star"]


def test_bf16_mlu_parity_within_1pct():
    """The port's bf16 stage-1 u* within 1 % of its f32 u* and of the
    reference's bf16 u*, element by element and in the p99.9."""
    fabric, tms_b, caps_b = _instance()
    m = tms_b.shape[1]
    u32 = _stage1(_port_solver(fabric, m), tms_b, caps_b)
    u16 = _stage1(_port_solver(fabric, m, precision="bf16"), tms_b, caps_b)
    ref16 = np.asarray(JaxRoutingSolver(
        fabric, m, precision="bf16", fleet_batch_quantum=16,
        **KW).solve_mlu_batch(tms_b, caps_b)[1], np.float64)
    for other in (u32, ref16):
        rel = np.abs(u16 - other) / np.maximum(np.abs(other), 1e-9)
        assert rel.max() <= 0.01, (u16, other)
        assert abs(np.percentile(u16, 99.9) - np.percentile(other, 99.9)) \
            <= 0.01 * np.percentile(other, 99.9)


def test_bf16_operators_match_reference():
    """The mixed operators round what the reference rounds: on the CPU both
    compute exact bf16 products in float32, so they agree bit for bit here
    (the CUDA path, a bf16 GEMM with a float32 output, is held to them in
    ``tests/test_torch_gpu.py``)."""
    fabric, tms_b, caps_b = _instance(b=1, seed=4)
    m, v = tms_b.shape[1], fabric.n_pods
    ref = JaxRoutingSolver(fabric, m, precision="bf16", fleet_batch_quantum=16,
                           **KW)
    port = _port_solver(fabric, m, precision="bf16")
    rng = np.random.default_rng(4)
    f3 = rng.random((v, v, v)).astype(np.float32)
    y = rng.random((m, v, v)).astype(np.float32)
    d3j, icj = ref._dense_tms(tms_b[0]), ref._dense_inv_cap(caps_b[0])
    d3, ic = port._dense_tms(tms_b[:1]), port._dense_inv_cap(caps_b[:1])
    u = port._util(torch.from_numpy(f3)[None], d3, ic)[0].numpy()
    g = port._util_adj(torch.from_numpy(y)[None], d3, ic)[0].numpy()
    np.testing.assert_array_equal(u, np.asarray(ref._util(jnp.asarray(f3),
                                                          d3j, icj)))
    np.testing.assert_array_equal(g, np.asarray(ref._util_adj(jnp.asarray(y),
                                                              d3j, icj)))
    u32 = port._util_f32(torch.from_numpy(f3)[None], d3, ic)[0].numpy()
    assert 0 < np.abs(u - u32).max() <= 1e-2 * np.abs(u32).max()


def test_bmm_bf16_is_exact_products_in_f32(rng):
    a = torch.from_numpy(rng.random((3, 5, 7)).astype(np.float32))
    b = torch.from_numpy(rng.random((3, 7, 4)).astype(np.float32))
    out = _bmm_bf16(a.to(torch.bfloat16), b.to(torch.bfloat16))
    assert out.dtype == torch.float32
    exact = (a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double())
    np.testing.assert_allclose(out.double().numpy(), exact.numpy(),
                               rtol=1e-6)


def test_bf16_certificate_and_reported_u_are_f32():
    """The returned utilization is the *float32* evaluation of the final
    flows (not a bf16 by-product of the iterate path), and the bf16 iterate
    path is live (distinct from the f32 solver's)."""
    fabric, tms_b, caps_b = _instance(b=1, seed=3)
    m = tms_b.shape[1]
    s16 = _port_solver(fabric, m, precision="bf16", max_iters=1500)
    d3, ic = s16._dense_tms(tms_b), s16._dense_inv_cap(caps_b)
    f3, u, it, _, gap = s16._mlu_core(d3, ic, s16.valid[None],
                                      *s16._mlu_inits(d3, ic, s16.valid[None]))
    assert u.dtype == torch.float32 and gap.dtype == torch.float32
    assert float(u[0]) == float(s16._util_f32(f3, d3, ic).amax())
    s32 = _port_solver(fabric, m, max_iters=1500)
    f3_32, _, it32, _, _ = s32._mlu_core(d3, ic, s32.valid[None],
                                         *s32._mlu_inits(d3, ic,
                                                         s32.valid[None]))
    assert int(it[0]) != int(it32[0]) or not torch.equal(f3, f3_32)
    out, _ = s16.solve_routing_warm(tms_b[0], caps_b[0], hedging=False,
                                    skip_stage3=True)
    f3w = torch.zeros((1,) + tuple(s16.valid.shape))
    f3w.reshape(1, -1)[0, torch.as_tensor(s16._path_slot)] = torch.from_numpy(
        out["f"].astype(np.float32))
    assert out["u_star"] == float(s16._util_f32(f3w, d3, ic).amax())


def test_invalid_precision_rejected():
    fabric, tms_b, _ = _instance(b=1)
    with pytest.raises(ValueError, match="precision"):
        _port_solver(fabric, tms_b.shape[1], precision="f16")
    with pytest.raises(ValueError, match="solver_precision"):
        ControllerConfig(solver_precision="f16")
    assert ControllerConfig(solver_precision="bf16").solver_precision == "bf16"
    assert ControllerConfig().solver_precision == "f32"


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_tf32_refusal_still_fires(precision, monkeypatch):
    """The float32 certificate needs full float32 matmuls in both modes."""
    fabric, tms_b, caps_b = _instance(b=1)
    solver = _port_solver(fabric, tms_b.shape[1], precision=precision)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        _port_solver(fabric, tms_b.shape[1], precision=precision)
    with pytest.raises(RuntimeError, match="TF32"):
        _stage1(solver, tms_b, caps_b)


def test_solver_cache_keyed_by_precision():
    fabric = interop.fabric_from_numpy(
        "ck", np.full(6, 40), np.full(6, 100.0))
    a = routing_solver_for(fabric, 4, 1000, 5e-3, "f32", device="cpu")
    b = routing_solver_for(fabric, 4, 1000, 5e-3, "bf16", device="cpu")
    c = routing_solver_for(fabric, 4, 1000, 5e-3, "f32", device="cpu")
    assert a is c and a is not b
    assert a.precision == "f32" and b.precision == "bf16"


def test_fleet_bucket_key_includes_precision():
    cc = ControllerConfig(routing_interval_hours=12.0, k_critical=4)
    sc = SolverConfig(stage1_method="scaled")
    spec = FLEET_SPECS[0]
    fab = make_fabric(spec)
    tr = make_trace(spec, fab, days=4.0, interval_minutes=120.0)
    pfab = interop.fabric_from_numpy(fab.name, fab.radix, fab.speed)
    ptr = interop.trace_from_numpy(tr.name, tr.demand, tr.interval_minutes,
                                   tr.n_pods)
    k_f32 = fleet_bucket_key(pfab, cc, sc, ptr)
    k_bf16 = fleet_bucket_key(
        pfab, dataclasses.replace(cc, solver_precision="bf16"), sc, ptr)
    assert k_f32 != k_bf16 and k_f32[:5] == k_bf16[:5]
    assert (k_f32[5], k_bf16[5]) == ("f32", "bf16")
    assert k_f32[-1] == k_bf16[-1] == 120.0


@pytest.fixture(scope="module")
def f17():
    spec = FLEET_SPECS[16]  # F17: 6 pods
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=4.0, interval_minutes=60.0)
    return (interop.fabric_from_numpy(fab.name, fab.radix, fab.speed),
            interop.trace_from_numpy(trace.name, trace.demand,
                                     trace.interval_minutes, trace.n_pods))


CC = ControllerConfig(routing_interval_hours=12.0, aggregation_days=2.0,
                      k_critical=4)


def _both_precisions(run):
    out = {p: run(dataclasses.replace(CC, solver_precision=p))
           for p in ("f32", "bf16")}
    a, b = out["f32"], out["bf16"]
    assert b.summary["p999_mlu"] == pytest.approx(a.summary["p999_mlu"],
                                                  rel=0.01)
    np.testing.assert_allclose(b.u_star, a.u_star, rtol=0.01)
    return a, b


@pytest.mark.parametrize("engine", ["batched", "sequential"])
def test_engines_run_bf16(f17, engine):
    fab, trace = f17
    _both_precisions(lambda cc: run_controller(
        fab, trace, HEDGE, dataclasses.replace(cc, engine=engine),
        device="cpu"))


def test_fleet_and_streaming_run_bf16(f17):
    fab, trace = f17
    _both_precisions(lambda cc: run_fleet([FleetJob(fab, trace, HEDGE, cc)],
                                          device="cpu")[0])
    _both_precisions(lambda cc: port_serve.StreamingController(
        fab, port_serve.TMStream.from_trace(trace), HEDGE, cc,
        serve=port_serve.ServeConfig(auto_strategy=False),
        device="cpu").run().result)
