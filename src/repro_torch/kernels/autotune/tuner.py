"""Search the body/knob space and record certified winners in the table —
the counterpart of ``repro/kernels/autotune/tuner.py``.

Body tuning (:func:`tune_tiles`) is the reference's tile tuning: it times
each body a kernel family's CUDA entries can launch (:data:`table.BODIES`)
on representative random inputs and, before a candidate may win, checks its
outputs **bit-identical** against the default body's (the one the entry
picks by its own cut).  The bodies sum in different orders — the staged
link-load body adds each load over quarters of C, the batched body over C in
order (``csrc/linkload.cu``); the queue-loss bodies fold their links in
different orders — so a switch is expected to fail the certification and
the entry to record the default; the check is empirical per tuned shape, as
the reference's is.  On the CPU each family has one body, its plain version,
and the tuner records that.

Solver tuning (:func:`tune_solver`) searches the PDHG ``dual_topk`` support
cap.  It changes the iterate path, so its gate is the solver's convergence
contract, as in the reference: a candidate is eligible only if every
element's stage-1 u* lies within ``2·tol`` of the default's.

Run ``python -m repro_torch.kernels.autotune`` to tune the standard shapes
on the card and persist the winners to the user cache.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.device import resolve_device, synchronize
from repro_torch.kernels.autotune import table as _table

__all__ = ["tune_tiles", "tune_solver", "tile_candidates", "FAMILIES"]

#: the kernel families, wrapper by wrapper (#3, #1, #5, #4, #2, #6)
FAMILIES = ("linkload", "linkload_batched", "linkload_fleet",
            "queueloss", "queueloss_batched", "queueloss_fleet")


# card clock cycles the body timings hold the card for before each call:
# 10 ms at the H100's 1.98 GHz, above the host's time to issue a wrapper call
_HOLD_CYCLES = 20_000_000


def _time(fn, device, reps: int = 3, warm: bool = True,
          hold: bool = False) -> float:
    """Least seconds of ``fn()`` over ``reps`` calls, after a warm one if
    ``warm``: CUDA events on the card, the host clock on the CPU.  ``hold``
    keeps the card busy while the host issues the call, so a call of a few
    microseconds is timed by its device work, not by its host side."""
    if warm:
        fn()
    synchronize(device)
    ts = []
    for _ in range(reps):
        if device.type == "cuda":
            if hold:
                torch.cuda._sleep(_HOLD_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            ts.append(time.perf_counter() - t0)
    return min(ts)


def _default_body(family: str, t: int, c: int, e: int) -> tuple[str, list[str]]:
    """The body the family's CUDA entry takes at (t, c, e) by its own cut,
    and the bodies it can launch there (``table.BODIES`` less those that do
    not fit the shape, which the entry would replace by its default)."""
    if family.startswith("linkload"):
        from repro_torch.kernels.linkload import ops

        staged = ops._single_fits(t, c, e)
        return ("staged" if staged else "batched",
                ["staged", "batched"] if staged else ["batched"])
    from repro_torch.kernels.queueloss import ops

    fleet = ["fleet"] if ops._fleet_fits(t, c, e) else []
    if family == "queueloss":
        cluster = ops._single_fits(t, c, e)
        return ("cluster" if cluster else "etiled",
                (["cluster"] if cluster else []) + fleet + ["etiled"])
    return ("fleet" if fleet else "etiled", fleet + ["etiled"])


def tile_candidates(family: str, t: int, c: int, e: int,
                    device=None) -> list[str]:
    """The bodies of ``family`` at (t, c, e) on ``device``, default first:
    "auto" (the entry's own cut) then every other body the entry can launch
    at that shape on the card; "plain" alone on the CPU."""
    if resolve_device(device).type != "cuda":
        return ["plain"]
    default, bodies = _default_body(family, t, c, e)
    return ["auto", *(b for b in bodies if b != default)]


def _family_inputs(family: str, t: int, c: int, e: int, device, seed: int = 0):
    """Representative random inputs (the reference's distributions, float32
    on ``device``) and ``call(body)`` running the family's wrapper."""
    from repro_torch.kernels.linkload import ops as ll
    from repro_torch.kernels.queueloss import ops as ql

    rng = np.random.default_rng(seed)
    lead = ()
    if family.endswith("_batched"):
        lead = (4,)
    elif family.endswith("_fleet"):
        lead = (2, 2)

    def put(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(device)

    d = put(rng.gamma(2.0, 10.0, lead + (t, c)))
    w = put(rng.random(lead + (c, e)))
    cap = put(rng.uniform(100.0, 900.0, lead + (e,)))
    body_arg = (lambda b: {}) if device.type != "cuda" else (lambda b: {"body": b})
    if family.startswith("linkload"):
        fn = {"linkload": ll.linkload, "linkload_batched": ll.linkload_batched,
              "linkload_fleet": ll.linkload_fleet}[family]
        inv_cap = 1.0 / cap

        def call(body):
            return fn(d, w, inv_cap, 0.8, **body_arg(body))
    else:
        buf = put(rng.uniform(5.0, 50.0, lead + (e,)))
        fn = {"queueloss": ql.queueloss, "queueloss_batched": ql.queueloss_batched,
              "queueloss_fleet": ql.queueloss_fleet}[family]

        def call(body):
            return fn(d, w, cap, buf, 0.05, **body_arg(body))
    return call


def _identical(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def tune_tiles(family: str, t: int, c: int, e: int, reps: int = 3,
               seed: int = 0, persist: bool = True, device=None) -> dict:
    """Tune one (family, shape-bucket) key on ``device`` (``None`` = CUDA)
    and record the winner.

    Returns the recorded entry: the winning body ("auto" if the default
    wins), the body the entry takes by its own cut (``default_body``), the
    default's and the winner's seconds (CUDA events of the device work
    alone on the card) and speedup, the (always True, by construction)
    ``bit_identical`` flag, and the bodies the certification rejected.
    """
    assert family in FAMILIES, family
    dev = resolve_device(device)
    call = _family_inputs(family, t, c, e, dev, seed)
    default, *others = tile_candidates(family, t, c, e, dev)
    hold = dev.type == "cuda"
    ref = call(default)
    default_s = _time(lambda: call(default), dev, reps, hold=hold)
    best, rejected = (default_s, default), []
    for body in others:
        if not _identical(ref, call(body)):
            rejected.append(body)  # another summation order: ineligible
            continue
        cand_s = _time(lambda: call(body), dev, reps, hold=hold)
        if cand_s < best[0]:
            best = (cand_s, body)
    tuned_s, body = best
    entry = {"body": body,
             "default_body": _default_body(family, t, c, e)[0] if hold else "plain",
             "default_s": round(default_s, 7), "tuned_s": round(tuned_s, 7),
             "speedup": round(default_s / max(tuned_s, 1e-12), 3),
             "bit_identical": True, "rejected": rejected}
    backend = "cuda" if dev.type == "cuda" else "plain"
    _table.get_table().put(_table.tile_key(family, backend, t, c, e, dev),
                           entry, persist=persist)
    return entry


def tune_solver(fabric, m: int, reps: int = 2, batch: int = 8,
                seed: int = 0, persist: bool = True, device=None,
                candidates=(32, 64, 256), max_iters: int = 3000,
                tol: float = 5e-3) -> dict:
    """Tune the PDHG ``dual_topk`` knob for ``fabric``'s pod count and ``m``
    critical TMs on ``device`` (``None`` = CUDA), and record the entry.

    Each candidate solves stage 1 cold on one batch of ``batch`` random
    elements (the reference's inputs); it is eligible only if every
    element's u* lies within ``2·tol`` of the default knob's (a too-small
    support cap slows or stalls convergence, and the candidate loses either
    way), and it wins if it is faster.  Times are CUDA events on the card,
    the host clock on the CPU; each solver's check solve is its warm-up.
    ``max_iters``/``tol`` are the solver's (the reference's defaults).

    ``fleet_batch_quantum`` is recorded as its default, untimed: the entry
    keeps the reference's key schema, but the port's solver does not pad its
    fleet batch (nothing here is compiled per shape), so no quantum changes
    what it runs.
    """
    from repro_torch.core.pdhg import TorchRoutingSolver

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    v = fabric.n_pods
    c = v * (v - 1)
    tms = rng.gamma(2.0, 10.0, (batch, m, c))
    caps = rng.uniform(100.0, 900.0, (batch, c))

    def solver(k):
        return TorchRoutingSolver(fabric, m, max_iters=max_iters, tol=tol,
                                  dual_topk=k, device=dev)

    iters = {}

    def run(sol):
        d3, ic = sol._dense_tms(tms), sol._dense_inv_cap(caps)
        valid = sol.valid.expand(batch, -1, -1, -1)
        _, u, it, _, _ = sol._mlu_core(d3, ic, valid, *sol._mlu_inits(d3, ic, valid))
        iters[sol.dual_topk] = int(it.max())
        return u.cpu().numpy().astype(np.float64)  # per-element u*

    default = dict(_table.DEFAULT_SOLVER_KNOBS)
    ref_solver = solver(default["dual_topk"])
    u_ref = run(ref_solver)
    default_s = _time(lambda: run(ref_solver), dev, reps, warm=False)
    best, times, rejected = (default_s, default["dual_topk"]), {}, []
    for k in candidates:
        if k >= c * (v - 1) or k == default["dual_topk"]:
            continue
        cand = solver(k)
        u_cand = run(cand)
        if not np.all(np.abs(u_cand - u_ref)
                      <= 2.0 * tol * np.maximum(np.abs(u_ref), 1e-6)):
            rejected.append(k)  # convergence contract violated: ineligible
            continue
        times[k] = _time(lambda: run(cand), dev, reps, warm=False)
        if times[k] < best[0]:
            best = (times[k], k)
    topk_s, topk = best
    entry = {"dual_topk": int(topk),
             "fleet_batch_quantum": default["fleet_batch_quantum"],
             "default_s": round(default_s, 6), "tuned_s": round(topk_s, 6),
             "speedup": round(default_s / max(topk_s, 1e-12), 3),
             "candidate_s": {str(k): round(s, 6) for k, s in times.items()},
             "rejected": rejected, "max_iters": max_iters,
             "stage1_iters": {str(k): n for k, n in iters.items()}}
    _table.get_table().put(_table.solver_key(v, m, dev), entry, persist=persist)
    return entry
