#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero; the last stdout line is the JSON result):

1. The card: ``nvidia-smi`` name and power limit, the torch device name and
   count.  No CUDA device means exit 1.
2. Build both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each,
   in parallel) and print ptxas' registers/spills.
3. Hold each kernel against its plain PyTorch version on the card, at the
   controller's shapes (B=672 epochs, T=3 / TS=36, C=E=132) and at a ragged
   shape with dead links; time kernel, plain version and the ``torch.bmm``
   yardstick with CUDA events.  A small batched PDHG solve is held against
   scipy/HiGHS.
4. The main path: ``repro_torch.core.run_controller`` over fabric F21 (12
   pods), a 14-day trace at 5-minute TMs, the paper's default controller
   (routing every 15 min, topology daily, 7-day aggregation, 12 critical
   TMs), Gemini (nonuniform topology + hedging) with burst-loss tracking:
   672 routing epochs, batched PDHG and one launch of each kernel.  The
   sweep is re-scored through the float64 numpy oracle.

It imports nothing of JAX or of the JAX package ``repro``.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
LINK_RTOL, LINK_ATOL = 3e-4, 1e-4  # kernel contracts (f32 vs plain/f64)
SCORE_TOL = 1e-5  # scoring vs the float64 numpy oracle
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12  # H100 SXM data sheet, f32 outside the tensor cores
MAIN_B, MAIN_T, MAIN_TS, MAIN_C = 672, 3, 36, 132


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---- timing and bounds -------------------------------------------------------


def time_cuda(fn, reps: int = 20, flush_bytes: int = 256 << 20):
    """Median milliseconds of ``fn()`` on the card, CUDA events around each
    call, with the 50 MB L2 flushed before every call (the engine finds its
    inputs freshly copied, not resident)."""
    import torch

    flush = torch.empty(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes: float, n_flops: float):
    """Least time on an H100 SXM: bytes over HBM rate vs f32 operations over
    the f32 rate; returns (ms, "bytes" | "operations")."""
    tb, tf = n_bytes / HBM_BYTES_PER_S, n_flops / F32_FLOP_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def max_errs(outs, refs):
    """Max abs error, max rel error, and the allclose contract's worst ratio."""
    abs_e = rel_e = worst = 0.0
    for a, r in zip(outs, refs):
        r = r.double()
        d = (a.double() - r).abs()
        nz = r.abs() > 1e-6
        abs_e = max(abs_e, float(d.max()))
        if bool(nz.any()):
            rel_e = max(rel_e, float((d[nz] / r[nz].abs()).max()))
        worst = max(worst, float((d / (LINK_ATOL + LINK_RTOL * r.abs())).max()))
    return abs_e, rel_e, worst


# ---- phases --------------------------------------------------------------------


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {name!r} x{count}")
    return smi, name, count


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build(["linkload", "queueloss"])
    log(f"phase 2: built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per library {({k: round(v, 2) for k, v in secs.items()})})")
    for name, text in sorted(_build.logs().items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas {name}: {line.strip()}")


def _linkload_inputs(b, t, c, e, gen, exact: bool):
    """Inputs on the card.  ``exact``: demand in {0..15} and weights in
    sixteenths, so every load is exact in f32 whatever the summation order and
    the OLR count cannot flip on a rounding tie."""
    import torch

    dev = "cuda"
    if exact:
        d = torch.randint(0, 16, (b, t, c), generator=gen, device=dev).float()
        w = torch.randint(0, 17, (b, c, e), generator=gen, device=dev).float() / 16
        w = w * (torch.rand((b, c, e), generator=gen, device=dev) < 0.05)
        cap = 20.0 + 40.0 * torch.rand((b, e), generator=gen, device=dev)
    else:
        d = torch.rand((b, t, c), generator=gen, device=dev) * 40.0
        w = torch.rand((b, c, e), generator=gen, device=dev)
        w = w * (torch.rand((b, c, e), generator=gen, device=dev) < 0.5)
        cap = 50.0 + 450.0 * torch.rand((b, e), generator=gen, device=dev)
    dead = torch.rand((b, e), generator=gen, device=dev) < 0.1
    inv_cap = torch.where(dead, 0.0, 1.0 / cap)
    return d.contiguous(), w.contiguous(), inv_cap.contiguous()


def _queueloss_inputs(b, ts, c, e, gen):
    import torch

    dev = "cuda"
    d = torch.rand((b, ts, c), generator=gen, device=dev) * 20.0
    d = d * (1.0 + 4.0 * (torch.rand((b, ts, c), generator=gen, device=dev) < 0.05))
    w = torch.rand((b, c, e), generator=gen, device=dev)
    w = w * (torch.rand((b, c, e), generator=gen, device=dev) < 0.08)
    cap = 40.0 + 80.0 * torch.rand((b, e), generator=gen, device=dev)
    cap = torch.where(torch.rand((b, e), generator=gen, device=dev) < 0.1, 0.0, cap)
    buf = cap * 0.025
    return d.contiguous(), w.contiguous(), cap.contiguous(), buf.contiguous()


def phase_kernels():
    import torch

    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.linkload.ref import linkload_metrics_batched_ref
    from repro_torch.kernels.queueloss import ops as qlops
    from repro_torch.kernels.queueloss.ref import queueloss_batched_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}

    # linkload: main-path shapes (exact-arithmetic data) and a ragged shape
    b, t, c, e = MAIN_B, MAIN_T, MAIN_C, MAIN_C
    for label, shape, exact in (("main", (b, t, c, e), True),
                                ("ragged", (4, 13, 30, 200), False)):
        args = _linkload_inputs(*shape, gen, exact)
        out = llops.linkload_batched(*args, 0.8)
        ref = linkload_metrics_batched_ref(*args, 0.8)
        torch.cuda.synchronize()
        abs_e, rel_e, worst = max_errs(out, ref)
        log(f"phase 3: linkload {label} {shape}: max abs err {abs_e:.3e}, "
            f"max rel err {rel_e:.3e}, worst |err|/(atol+rtol|ref|) {worst:.3f}")
        if worst > 1.0 or not all(bool(torch.isfinite(x).all()) for x in out):
            fail(f"linkload {label} disagrees with its plain version")
        if label == "main":
            ms = time_cuda(lambda: llops.linkload_batched(*args, 0.8))
            plain = time_cuda(lambda: linkload_metrics_batched_ref(*args, 0.8))
            bmm = time_cuda(lambda: torch.bmm(args[0], args[1]))
            n_bytes = 4 * (b * t * c + b * c * e + b * e + 4 * b * t)
            n_flops = 2 * b * t * c * e + 5 * b * t * e
            bnd, by = bound_ms(n_bytes, n_flops)
            log(f"  linkload times: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"torch.bmm of the load alone {bmm:.4f} ms, bound {bnd:.4f} ms "
                f"({by}: {n_bytes / 1e6:.1f} MB, {n_flops / 1e6:.1f} MFLOP)")
            rows["linkload"] = {
                "name": "linkload_batched", "route": "cuda",
                "source": "src/repro_torch/csrc/linkload.cu",
                "replaces": "src/repro/kernels/linkload/linkload.py:136",
                "max_abs_err": abs_e, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd, "bound_by": by, "library_ms": None,
                "yardstick_bmm_ms": bmm, "status": "ported"}

    # queueloss: main-path shapes and a ragged shape with dead links
    for label, shape in (("main", (MAIN_B, MAIN_TS, c, e)),
                         ("ragged", (4, 45, 30, 300))):
        args = _queueloss_inputs(*shape, gen)
        out = qlops.queueloss_batched(*args, 30.0)
        ref = queueloss_batched_ref(*args, 30.0)
        torch.cuda.synchronize()
        abs_e, rel_e, worst = max_errs(out, ref)
        drops = float(ref[0].sum())
        log(f"phase 3: queueloss {label} {shape}: max abs err {abs_e:.3e}, "
            f"max rel err {rel_e:.3e}, worst |err|/(atol+rtol|ref|) {worst:.3f}, "
            f"total drop {drops:.3f} Gb")
        if worst > 1.0 or drops <= 0.0:
            fail(f"queueloss {label} disagrees with its plain version "
                 f"(or drops nothing)")
        if label == "main":
            bq, ts = shape[0], shape[1]
            ms = time_cuda(lambda: qlops.queueloss_batched(*args, 30.0))
            plain = time_cuda(lambda: queueloss_batched_ref(*args, 30.0))
            n_bytes = 4 * (bq * ts * c + bq * c * e + 2 * bq * e + 2 * bq * ts)
            n_flops = 2 * bq * ts * c * e + 6 * bq * ts * e
            bnd, by = bound_ms(n_bytes, n_flops)
            log(f"  queueloss times: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                f"bound {bnd:.4f} ms ({by}: {n_bytes / 1e6:.1f} MB, "
                f"{n_flops / 1e6:.1f} MFLOP)")
            rows["queueloss"] = {
                "name": "queueloss_batched", "route": "cuda",
                "source": "src/repro_torch/csrc/queueloss.cu",
                "replaces": "src/repro/kernels/queueloss/queueloss.py:178",
                "max_abs_err": abs_e, "ms": ms, "plain_ms": plain,
                "bound_ms": bnd, "bound_by": by, "library_ms": None,
                "status": "ported"}
    return rows


def phase_pdhg_check():
    """A small batched PDHG solve on the card against scipy/HiGHS."""
    import numpy as np

    from repro_torch.core.clustering import critical_tms
    from repro_torch.core.engine import _pad_tms, routing_solver_for
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric, make_trace
    from repro_torch.core.graph import uniform_topology
    from repro_torch.core.lp import LpBuilder
    from repro_torch.core.paths import build_paths

    spec = FLEET_SPECS[17]  # F18, 6 pods
    fab = make_fabric(spec)
    tr = make_trace(spec, fab, days=4.0, interval_minutes=60.0)
    cap = fab.capacities(uniform_topology(fab))
    tms = [critical_tms(tr.demand[i * 12: i * 12 + 24], k=4, seed=i, device="cuda")
           for i in range(4)]
    tol = 1e-2
    solver = routing_solver_for(fab, 4, 3000, tol, device="cuda")
    out = solver.solve_routing_batch(np.stack([_pad_tms(t, 4) for t in tms]),
                                     np.stack([cap] * 4), hedging=False)
    paths = build_paths(fab.n_pods)
    worst = 0.0
    for i, t in enumerate(tms):
        u_ref = LpBuilder(fab, paths, t).solve_stage1_fixed_topology(cap).scalar
        worst = max(worst, abs(out["u_star"][i] - u_ref) / u_ref)
    log(f"phase 3: PDHG vs HiGHS stage-1 u* on F18, 4 epochs: worst rel err "
        f"{worst:.3e} (contract ≤ 2·tol = {2 * tol})")
    if not worst <= 2 * tol:
        fail("PDHG u* disagrees with HiGHS")


def sweep_config(days: float = 14.0, interval_minutes: float = 5.0, spec_index=20,
                 **cc_over):
    """The main-path configuration: fabric, trace, strategy, configs."""
    from repro_torch.burst import LossConfig
    from repro_torch.core import ControllerConfig, SolverConfig, Strategy
    from repro_torch.core.fleet import (FLEET_SPECS, make_fabric, make_trace,
                                        sub_burst_params)

    spec = FLEET_SPECS[spec_index]
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=days, interval_minutes=interval_minutes)
    cc = ControllerConfig(solver_backend="pdhg", backend="torch",
                          loss=LossConfig(burst=sub_burst_params(spec)), **cc_over)
    return fab, trace, Strategy(nonuniform=True, hedging=True), cc, SolverConfig()


def phase_sweep(fab, trace, strategy, cc, sc, device):
    """Run the main path once with the launch counters zeroed around it,
    check it, and return (counts, result)."""
    import numpy as np
    import torch

    from repro_torch.core import run_controller
    from repro_torch.core.engine import plan_controller
    from repro_torch.core.paths import build_paths, routing_weight_matrices
    from repro_torch.core.simulator import route_metrics_batched
    from repro_torch.device import synchronize
    from repro_torch.kernels.linkload import ops as llops
    from repro_torch.kernels.queueloss import ops as qlops

    log(f"phase 4: {fab.name} ({fab.n_pods} pods), trace {trace.demand.shape} "
        f"at {trace.interval_minutes} min, {cc}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    synchronize(device)
    llops.launches = 0
    qlops.launches = 0
    t0 = time.perf_counter()
    res = run_controller(fab, trace, strategy, cc, sc, device=device)
    synchronize(device)
    wall = time.perf_counter() - t0
    counts = {"linkload": llops.launches, "queueloss": qlops.launches}
    log(f"  sweep wall {wall:.3f} s; n_routing_updates {res.n_routing_updates}, "
        f"n_topology_updates {res.n_topology_updates}")
    log(f"  stage_times {res.stage_times}")
    topo_s = res.solver_seconds - res.stage_times["solve"]
    log(f"  plan: the {res.n_topology_updates} joint topology solves (host, "
        f"scipy/HiGHS) took {topo_s:.3f} s of the plan's "
        f"{res.stage_times['plan']:.3f} s")
    log(f"  summary {res.summary}")
    st = res.solver_stats
    med = {k: float(np.median(v.iters)) for k, v in st.stages.items()}
    mx = {k: int(np.max(v.iters)) for k, v in st.stages.items()}
    log(f"  PDHG median iterations {med}, max {mx}, capped share "
        f"{st.frac_capped():.4f}, fallbacks {st.n_fallbacks}")
    log(f"  kernel launches in the sweep {counts}")
    if device.type == "cuda":
        log(f"  torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()} B")

    if counts["linkload"] < 1 or counts["queueloss"] < 1:
        fail(f"the sweep did not launch both kernels: {counts}")
    m = res.metrics
    plan = plan_controller(trace, cc, strategy.nonuniform)
    for field in ("mlu", "alu", "olr", "stretch", "loss"):
        arr = getattr(m, field)
        if (arr is None or arr.shape != (trace.n_intervals - plan.agg,)
                or not np.isfinite(arr).all()):
            fail(f"metric {field} is missing, mis-shaped or not finite")
    if not all(np.isfinite(v) for v in res.summary.values()):
        fail(f"non-finite summary {res.summary}")
    if not 1.0 <= res.summary["p999_stretch"] <= 2.0:
        fail(f"p999_stretch {res.summary['p999_stretch']} outside [1, 2]")

    # re-score the sweep's splits through the float64 numpy oracle
    blocks = [trace.demand[ep.start: ep.stop] for ep in plan.epochs]
    seeds = [cc.loss.seed + ep.start for ep in plan.epochs]
    w_b = routing_weight_matrices(build_paths(fab.n_pods), res.splits)
    t0 = time.perf_counter()
    oracle = route_metrics_batched(
        blocks, w_b, res.capacities, cc.overload_threshold, backend="numpy",
        loss_cfg=cc.loss, loss_seeds=seeds,
        interval_seconds=trace.interval_minutes * 60.0)
    worst = {}
    for field in ("mlu", "alu", "olr", "stretch", "loss"):
        a, r = getattr(m, field), getattr(oracle, field)
        worst[field] = float(np.max(np.abs(a - r) / (SCORE_TOL + SCORE_TOL * np.abs(r))))
    log(f"  numpy-oracle re-score ({time.perf_counter() - t0:.2f} s): worst "
        f"|err|/(atol+rtol|ref|) per metric {worst}, oracle p999_loss "
        f"{np.percentile(oracle.loss, 99.9)}")
    if max(worst.values()) > 1.0:
        fail("the sweep's scores disagree with the numpy oracle")
    return counts, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()
    smi, name, count = phase_card()
    phase_build()
    rows = phase_kernels()
    phase_pdhg_check()
    counts, _ = phase_sweep(*sweep_config(), device=torch.device("cuda"))
    for key in rows:
        rows[key]["launches"] = counts[key]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [rows["linkload"], rows["queueloss"]]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
