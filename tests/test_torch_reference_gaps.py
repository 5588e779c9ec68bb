"""Four comparisons of the port with the reference, measured by running
both packages on the CPU with the same inputs.

Run one comparison at full size (minutes to tens of minutes each) with

    PYTHONPATH=src python tests/test_torch_reference_gaps.py decode
    PYTHONPATH=src python tests/test_torch_reference_gaps.py caps
    PYTHONPATH=src python tests/test_torch_reference_gaps.py serve
    PYTHONPATH=src python tests/test_torch_reference_gaps.py bf16

Each prints one JSON object a line as its results come in:

* ``decode``: mamba2-130m in float32 at full width (B = 2, S = 64).  The
  reference's largest |decode - forward| over the logits, and the port's on
  the same parameters (``interop.model_from_numpy``) and tokens, through the
  kernels' plain versions.
* ``caps``: fabric F12 (8-day trace, 5-minute TMs, uniform topology +
  hedging, ``solver_backend="pdhg"``) through the reference's
  ``run_controller_batched``: the number of routing epochs whose stage-1
  PDHG solve hit the 3,000-iteration cap, and the port's per-fabric engine
  on the same fabric, trace and configuration.
* ``serve``: fabric F21 (8-day trace, 5-minute TMs, Gemini = nonuniform +
  hedging, ``solver_backend="pdhg"``, burst loss): the reference's
  ``StreamingController`` (warm-started PDHG) against its own
  ``run_controller_batched``: the relative p999-MLU gap between the two.
* ``bf16``: fabric F21 (8-day trace, 5-minute TMs, uniform topology +
  hedging, ``solver_backend="pdhg"``, burst loss) through the port's batched
  engine with ``solver_precision="f32"`` and ``"bf16"``: per-epoch u* and
  p999-MLU gaps, and one epoch's stage-1 certified gap after 1,000 to
  20,000 bf16 iterations; and the reference's own stage 1 in f32 and bf16
  on six epochs' critical TMs (one solve each: its batched bf16 dot is
  unimplemented on JAX's CPU backend at this size).  The port's bf16
  operators give the reference's bits on the CPU
  (``tests/test_torch_solver_precision.py``).

The tests below run the same comparisons at a reduced size.
"""

import dataclasses
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.burst import LossConfig as RefLossConfig
from repro.configs import get_arch as ref_get_arch
from repro.core import ControllerConfig as RefControllerConfig
from repro.core import Strategy as RefStrategy
from repro.core.engine import run_controller_batched
from repro.core.fleet import FLEET_SPECS as REF_SPECS
from repro.core.fleet import make_fabric as ref_make_fabric
from repro.core.fleet import make_trace as ref_make_trace
from repro.core.fleet import sub_burst_params as ref_sub_burst_params
from repro.models.api import build_model as ref_build_model
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import StreamingController as RefStreamingController
from repro.serve import TMStream as RefTMStream
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.models.api import build_model

CAP_STAGE = "stage1"


def decode_gap(reduced: bool = False, seq: int = 64) -> dict:
    """max |decode - forward| over all logits of mamba2-130m in float32 at
    B = 2, the reference's and the port's (CPU, plain versions), on one
    parameter set and one token batch; ``reduced``: the reduced config."""
    arch, batch = "mamba2-130m", 2
    ref_cfg, cfg = (dataclasses.replace(g(arch).reduced() if reduced else g(arch),
                                        dtype="float32")
                    for g in (ref_get_arch, get_arch))
    ref_model = ref_build_model(ref_cfg)
    params = ref_model.init(jax.random.key(0))
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (batch, seq))
    jtok = jnp.asarray(tokens, jnp.int32)
    ref_full = np.asarray(ref_model.forward(params, {"tokens": jtok}), np.float64)
    step = jax.jit(lambda p, c, t, pos: ref_model.decode(p, c, t, pos))
    cache = ref_model.init_cache(batch, seq)
    ref_gap = 0.0
    for pos in range(seq):
        logits, cache = step(params, cache, jtok[:, pos:pos + 1], jnp.int32(pos))
        ref_gap = max(ref_gap, float(np.abs(np.asarray(logits[:, 0], np.float64)
                                            - ref_full[:, pos]).max()))

    model = build_model(cfg, device="cpu")
    net = interop.model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, params),
                                   device="cpu")
    ttok = torch.as_tensor(tokens)
    with torch.no_grad():
        full = model.forward(net, {"tokens": ttok}).double()
        tcache = model.init_cache(batch, seq)
        port_gap = 0.0
        for pos in range(seq):
            logits, tcache = model.decode(net, tcache, ttok[:, pos:pos + 1], pos)
            port_gap = max(port_gap, float((logits[:, 0].double() - full[:, pos])
                                           .abs().max()))
    return {"arch": cfg.name, "reduced": reduced, "batch": batch, "seq": seq,
            "reference_gap": ref_gap, "port_gap": port_gap,
            "forward_diff": float(np.abs(full.numpy() - ref_full).max()),
            "max_abs_logit": float(np.abs(ref_full).max())}


def _ref_config(spec_index: int):
    """A fleet fabric, its 8-day trace at 5-minute TMs, and the paper's
    default controller with PDHG and F21's burst-loss configuration (as
    ``chip_smoke.py`` phases 4-7)."""
    spec = REF_SPECS[spec_index]
    fab = ref_make_fabric(spec)
    trace = ref_make_trace(spec, fab, days=8.0, interval_minutes=5.0)
    cc = RefControllerConfig(solver_backend="pdhg",
                             loss=RefLossConfig(burst=ref_sub_burst_params(REF_SPECS[20])))
    return fab, trace, cc


def _capped(stats) -> int:
    return int((np.asarray(stats.stages[CAP_STAGE].iters) >= stats.max_iters).sum())


def stage1_caps() -> dict:
    """Epochs of F12 whose stage-1 PDHG solve hit the iteration cap, in the
    reference's ``run_controller_batched`` and in the port's per-fabric
    engine on the CPU, uniform topology + hedging."""
    from repro_torch.core import run_controller

    fab, trace, cc = _ref_config(11)
    t0 = time.perf_counter()
    res = run_controller_batched(fab, trace, RefStrategy(False, True), cc)
    t_ref = time.perf_counter() - t0
    pcc = dataclasses.replace(
        interop.controller_config_from_dict(dataclasses.asdict(cc)), backend="torch")
    t0 = time.perf_counter()
    pres = run_controller(
        interop.fabric_from_numpy(fab.name, fab.radix, fab.speed),
        interop.trace_from_numpy(trace.name, trace.demand, trace.interval_minutes,
                                 trace.n_pods),
        interop.strategy_from_dict({"nonuniform": False, "hedging": True}),
        pcc, device="cpu")
    ref_it = np.asarray(res.solver_stats.stages[CAP_STAGE].iters)
    port_it = np.asarray(pres.solver_stats.stages[CAP_STAGE].iters)
    return {"fabric": fab.name, "epochs": int(res.n_routing_updates),
            "max_iters": cc.pdhg_max_iters,
            "reference_capped": _capped(res.solver_stats),
            "port_capped": _capped(pres.solver_stats),
            "capped_in_both": int(((ref_it >= cc.pdhg_max_iters)
                                   & (port_it >= cc.pdhg_max_iters)).sum()),
            "stage1_median_iters": [float(np.median(ref_it)),
                                    float(np.median(port_it))],
            "reference_seconds": t_ref, "port_seconds": time.perf_counter() - t0}


def serve_gap() -> dict:
    """The reference's streaming controller against its batched engine on
    F21 (Gemini, warm-started PDHG): the relative p999 gaps."""
    fab, trace, cc = _ref_config(20)
    strategy = RefStrategy(True, True)
    t0 = time.perf_counter()
    off = run_controller_batched(fab, trace, strategy, cc)
    t_off = time.perf_counter() - t0
    print(json.dumps({"batched_seconds": t_off, "batched_summary": off.summary}),
          flush=True)
    t0 = time.perf_counter()
    on = RefStreamingController(fab, RefTMStream.from_trace(trace), strategy, cc,
                                serve=RefServeConfig(warm_start=True,
                                                     auto_strategy=False)).run().result
    rel = {k: abs(on.summary[k] - off.summary[k]) / max(abs(off.summary[k]), 1e-12)
           for k in on.summary if k.startswith("p999")}
    return {"fabric": fab.name, "serve_seconds": time.perf_counter() - t0, "batched_seconds": t_off,
            "n_routing": [int(on.n_routing_updates), int(off.n_routing_updates)],
            "n_topology": [int(on.n_topology_updates), int(off.n_topology_updates)],
            "same_topology": bool(np.array_equal(on.final_topology,
                                                 off.final_topology)),
            "p999_rel": rel, "tol": cc.pdhg_tol}


def bf16_gap() -> dict:
    """The port's bf16 PDHG against its f32 PDHG on F21 (uniform topology +
    hedging): per-epoch u* and p999-MLU gaps over the whole sweep, and how
    far one epoch's bf16 stage-1 certificate gets with more iterations."""
    from repro.core.jaxlp import JaxRoutingSolver
    from repro_torch.core import run_controller
    from repro_torch.core.clustering import critical_tms
    from repro_torch.core.engine import _pad_tms
    from repro_torch.core.pdhg import TorchRoutingSolver

    fab, trace, cc = _ref_config(20)
    pfab = interop.fabric_from_numpy(fab.name, fab.radix, fab.speed)
    ptrace = interop.trace_from_numpy(trace.name, trace.demand,
                                      trace.interval_minutes, trace.n_pods)
    pcc = dataclasses.replace(
        interop.controller_config_from_dict(dataclasses.asdict(cc)), backend="torch")
    runs, secs = {}, {}
    for precision in ("f32", "bf16"):
        t0 = time.perf_counter()
        runs[precision] = run_controller(
            pfab, ptrace, interop.strategy_from_dict(
                {"nonuniform": False, "hedging": True}),
            dataclasses.replace(pcc, solver_precision=precision), device="cpu")
        secs[precision] = time.perf_counter() - t0
    a, b = runs["f32"], runs["bf16"]
    rel = (b.u_star - a.u_star) / a.u_star
    tms = _pad_tms(critical_tms(trace.demand[:2016], k=12, device="cpu"), 12)[None]
    caps = fab.capacities(np.asarray(a.final_topology))[None]
    gaps = {}
    for iters in (1000, 3000, 20000):
        solver = TorchRoutingSolver(pfab, 12, max_iters=iters, tol=1e-4,
                                    precision="bf16", device="cpu")
        out = solver.solve_routing_batch(tms, caps, hedging=False, skip_stage3=True)
        gaps[iters] = float(out["stats"]["stage1"]["gap"][0])
    # the reference's stage 1 on six epochs' TMs, one solve each (its batched
    # bf16 dot is unimplemented on JAX's CPU backend at this size)
    six = np.stack([_pad_tms(critical_tms(trace.demand[3 * i: 2016 + 3 * i], k=12,
                                          seed=i, device="cpu"), 12)
                    for i in range(6)])
    reference = {}
    for precision in ("f32", "bf16"):
        solver = JaxRoutingSolver(fab, 12, max_iters=cc.pdhg_max_iters,
                                  tol=cc.pdhg_tol, precision=precision,
                                  dual_topk=128, fleet_batch_quantum=16)
        reference[precision] = [float(solver.solve_mlu_batch(t[None], caps)[1][0])
                                for t in six]
    return {"fabric": fab.name, "epochs": int(a.n_routing_updates),
            "seconds": secs,
            "u_star_rel": {"median": float(np.median(rel)), "max": float(rel.max()),
                           "min": float(rel.min()),
                           "share_within_1pct": float(np.mean(np.abs(rel) <= 0.01))},
            "p999_mlu": [a.summary["p999_mlu"], b.summary["p999_mlu"]],
            "stage1_median_iters": [
                float(np.median(r.solver_stats.stages["stage1"].iters))
                for r in (a, b)],
            "bf16_stage1_gap_by_iters": gaps, "tol": cc.pdhg_tol,
            "reference_stage1_u": reference,
            "reference_bf16_rel": [u16 / u32 - 1.0 for u16, u32 in
                                   zip(reference["bf16"], reference["f32"])]}


# ---- reduced-size rehearsals -------------------------------------------------


def test_decode_gap_is_float32_rounding_in_both_packages():
    """At reduced width both decodes reproduce their own forward to float32
    rounding, and the two forwards agree."""
    out = decode_gap(reduced=True, seq=16)
    for key in ("reference_gap", "port_gap", "forward_diff"):
        assert out[key] <= 1e-4 * (1.0 + out["max_abs_logit"]), out


if __name__ == "__main__":
    jobs = {"decode": decode_gap, "caps": stage1_caps, "serve": serve_gap,
            "bf16": bf16_gap}
    for name in sys.argv[1:]:
        t0 = time.perf_counter()
        result = jobs[name]()
        print(json.dumps({"job": name, "seconds": time.perf_counter() - t0,
                          **result}), flush=True)
