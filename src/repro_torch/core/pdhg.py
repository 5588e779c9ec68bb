"""Batched PDHG routing solver in PyTorch — the counterpart of
``repro/core/jaxlp.py``'s batch path (:meth:`JaxRoutingSolver.solve_routing_batch`),
its fleet path (:meth:`JaxRoutingSolver.solve_routing_fleet`: many fabrics
padded to one pod count, each element with its own pod mask) and its
streaming path (:meth:`JaxRoutingSolver.solve_routing_warm`, one epoch
warm-started from the previous epoch's iterates, :class:`RoutingWarmState`).

The routing stages with a fixed topology are small structured LPs over the
per-commodity path simplex:

  stage 1:  min u  s.t.  U(f)_{t,e} ≤ u            (U = capacity-normalized load)
  stage 2:  min r  s.t.  U(f) ≤ u*,  f_p δ/C_e ≤ r  ∀ e ∈ p
  stage 3:  min Σ_t Σ_p f_p d_{t,c(p)} len(p)  s.t.  U(f) ≤ u*, risk ≤ r*

All three are solved with a reflected-Halpern primal–dual hybrid gradient
iteration on the dense pod tensor ``f3[b, i, j, k]`` (epoch ``b``, commodity
``i→j`` via transit ``k``; the ``k = j`` slot is the direct path), so the
load operator and its adjoint are ``einsum`` contractions with a leading
batch axis written out.  The arithmetic is the reference's, step for step.

The reference runs a ``lax.while_loop`` under ``vmap``: a batch runs until its
slowest element is done, and finished elements are frozen.  Here the loop
carries an ``active`` mask and updates every state tensor with
``torch.where(active, new, old)``; each element counts its own iterations and
checks convergence at its own ``it % check_every == 0``.  Active elements
share one iteration count, so ``active`` can only change at a check, and the
host syncs once per check (``active`` read back), not once per iteration.

Every core takes a per-element ``valid`` slot mask.  The fleet path embeds a
fabric with ``v < V`` pods in the ``V``-pod layout and masks out padded
endpoints and padded transit pods (:meth:`TorchRoutingSolver.valid_for_pods`):
their zero-capacity links carry ``inv_cap = 0`` and would otherwise look like
free capacity.  The reference pads the fleet batch to a quantum for jit-shape
stability; nothing here is compiled per shape, so the port does not pad, and
each element's result does not depend on the batch it is solved in.

With a ``mesh`` (:func:`repro_torch.parallel.sharding.fleet_mesh`) the
fleet path deals each warm stage's batch round-robin over the mesh's cards
(:func:`repro_torch.parallel.sharding.shard_leading` with ``repack=True``,
one host thread per card), on one replica of the solver's constant tensors
per card; the anchors solve unsharded on the solver's device.

Matmuls run in full float32: the solver refuses to start with TF32 matmuls
enabled (about 1e-3 relative error, above the certificate's tolerance).
``precision="bf16"`` is the reference's mixed-precision inner loop: the load
operator and its adjoint in the iteration steps take bf16-rounded operands
and accumulate in float32 (:func:`_bmm_bf16`), while the projections, the
step sizes (the power iteration) and every convergence check, certificate
and returned utilization use the exact float32 pair (``_util_f32``,
``_util_adj_f32``).
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import Fabric, directed_edge_index
from repro_torch.core.paths import PathSet, build_paths
from repro_torch.device import resolve_device, synchronize
from repro_torch.parallel.sharding import host_sync_point

__all__ = ["RoutingWarmState", "TorchRoutingSolver", "project_simplex_rows"]


@dataclasses.dataclass
class RoutingWarmState:
    """Converged primal/dual iterates of one routing solve, reusable as the
    next epoch's starting point (:meth:`TorchRoutingSolver.solve_routing_warm`).

    Consecutive streaming epochs share all but one window interval, so the
    previous optimum is near-feasible and near-optimal for the next solve.
    Stage-2/3 fields are ``None`` when the producing solve did not run that
    stage (no hedging / ``skip_stage3``); a ``None`` field falls back to the
    cold init for just that stage.  The tensors stay on the solver's device,
    so carrying the state adds no host round trips.
    """

    f1: torch.Tensor  # (V, V, V) stage-1 primal splits
    y1: torch.Tensor  # (m, V, V) stage-1 dual
    f2: torch.Tensor | None = None  # stage-2 primal splits
    y2: torch.Tensor | None = None  # stage-2 MLU dual
    z2: torch.Tensor | None = None  # stage-2 risk dual (V, V, V, 2)
    y3: torch.Tensor | None = None  # stage-3 MLU dual


def _bc(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """View a per-element (B,) tensor so it broadcasts against ``like``."""
    return s.reshape((-1,) + (1,) * (like.dim() - 1))


def project_simplex_rows(x: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row of ``x`` onto the probability simplex."""
    n = x.shape[-1]
    u = torch.sort(x, dim=-1, descending=True).values
    css = torch.cumsum(u, dim=-1) - 1.0
    idx = torch.arange(1, n + 1, dtype=x.dtype, device=x.device)
    cond = u - css / idx > 0
    # rho ≥ 1 always holds mathematically; the guard keeps NaN/degenerate
    # inputs from dividing 0/0
    rho = torch.clamp(cond.sum(-1), min=1)
    theta = torch.gather(css, -1, (rho - 1)[..., None]) / rho[..., None].to(x.dtype)
    return torch.clamp(x - theta, min=0.0)


def _michelot_rows(x: torch.Tensor, valid: torch.Tensor, passes: int) -> torch.Tensor:
    """Masked per-row simplex projection via Michelot's algorithm (``passes``
    ≥ the number of valid entries per row makes it exact)."""
    x = torch.where(valid, x, 0.0)
    act = valid.expand(x.shape)
    theta = x.new_zeros(x.shape[:-1])
    for _ in range(passes):
        nact = act.sum(-1).to(x.dtype)
        s = torch.where(act, x, 0.0).sum(-1)
        theta = (s - 1.0) / torch.clamp(nact, min=1.0)
        act = act & (x - theta[..., None] > 0)
    return torch.where(valid, torch.clamp(x - theta[..., None], min=0.0), 0.0)


def _capped_simplex_rows(x: torch.Tensor, ub: torch.Tensor, valid: torch.Tensor,
                         iters: int = 24) -> torch.Tensor:
    """Masked per-row projection onto ``{f : Σf = 1, 0 ≤ f ≤ ub}`` by
    bisection on the threshold θ of ``f = clip(x - θ, 0, ub)``."""
    x = torch.where(valid, x, -1e18)
    ub = torch.where(valid, ub, 0.0)
    target = torch.clamp(ub.sum(-1), max=1.0)
    lo = torch.where(valid, x - ub, math.inf).amin(-1) - 1.0
    hi = torch.where(valid, x, -math.inf).amax(-1)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        s = torch.minimum(torch.clamp(x - mid[..., None], min=0.0), ub).sum(-1)
        gt = s > target
        lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
    theta = 0.5 * (lo + hi)
    return torch.where(
        valid, torch.minimum(torch.clamp(x - theta[..., None], min=0.0), ub), 0.0)


def _project_simplex_topk(x: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Per-element projection of ``x[b]`` (flattened) onto the simplex, using
    only its top-``k`` entries to locate the threshold."""
    b = x.shape[0]
    flat = torch.where(valid, x, -1e9).reshape(b, -1)
    k = min(k, flat.shape[1])
    top = torch.topk(flat, k, dim=1).values
    css = torch.cumsum(top, dim=1) - 1.0
    idx = torch.arange(1, k + 1, dtype=x.dtype, device=x.device)
    rho = torch.clamp((top - css / idx > 0).sum(1), min=1)
    theta = torch.gather(css, 1, (rho - 1)[:, None]) / rho[:, None].to(x.dtype)
    out = torch.clamp(flat - theta, min=0.0).reshape(x.shape)
    out = torch.where(valid, out, 0.0)
    # more than k entries above the threshold over-weigh the thresholded
    # point; renormalizing keeps the iterate on the simplex
    return out / _bc(torch.clamp(out.reshape(b, -1).sum(1), min=1e-30), out)


def _refuse_tf32() -> None:
    """Raise if TF32 matmuls are on: about 1e-3 relative error, above the
    PDHG certificate's tolerance.  Checked at construction and at every solve
    (a cached solver outlives the setting it was built under)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: TF32 matmuls "
            "carry ~1e-3 relative error, above the PDHG certificate's")


def _bmm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over a batch of bf16 matrices, accumulated and returned in
    float32 (the reference's ``preferred_element_type=float32``).

    On CUDA one bf16 GEMM with a float32 output (``aten::bmm.dtype``, the
    tensor cores; the output is never rounded to bf16).  The CPU has no such
    kernel, so there the operands go up to float32 first: the product of two
    bf16 values is exact in float32, so it is the same arithmetic.
    """
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).amax(1)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(1)


class TorchRoutingSolver:
    """Per-(fabric, m) batched PDHG routing solver.

    :meth:`solve_routing_batch` runs the stage 1 → [2] → 3 pipeline over a
    batch of routing epochs, each with its own (m, C) critical TMs and (E,)
    capacities.  ``check_every``/``tol`` drive the convergence-based early
    exit; ``max_iters`` bounds it.

    ``dual_topk`` is the support cap of the dual simplex projection; ``None``
    consults the autotune table for this (pods, m) shape on ``device``
    (:func:`repro_torch.kernels.autotune.solver_knobs`, 128 without an entry
    or with ``REPRO_AUTOTUNE=0``), as the reference's solver does; a value
    is a pin.  The table's other knob, ``fleet_batch_quantum``, has no use
    here: the reference pads its fleet batch to it for jit-shape stability,
    and this solver does not pad its fleet batch.
    """

    def __init__(self, fabric: Fabric, m: int, max_iters: int = 3000,
                 check_every: int = 100, tol: float = 5e-3,
                 restart_every: int = 150, dual_topk: int | None = None,
                 precision: str = "f32", device=None):
        if precision not in ("f32", "bf16"):
            raise ValueError(f"unknown PDHG precision {precision!r}")
        _refuse_tf32()
        self.precision = precision
        self._mp = precision == "bf16"
        self.fabric = fabric
        self.m = m
        self.max_iters = max_iters
        self.check_every = check_every
        self.tol = tol
        self.restart_every = restart_every
        self.device = resolve_device(device)
        if dual_topk is None:
            from repro_torch.kernels.autotune import solver_knobs

            dual_topk = solver_knobs(fabric.n_pods, m, self.device)["dual_topk"]
        self.dual_topk = dual_topk
        v = fabric.n_pods
        paths: PathSet = build_paths(v)
        self.paths = paths
        self.V = v
        self.C = paths.n_commodities
        self.E = paths.n_directed

        # commodity c = (i, j) enumeration == directed-edge enumeration
        comm = directed_edge_index(v)
        self._comm_flat = comm[:, 0].astype(np.int64) * v + comm[:, 1]
        # path p ↔ dense slot (i, j, k): direct path stored at k = j
        slot = np.empty(paths.n_paths, dtype=np.int64)
        for c in range(self.C):
            i, j = int(comm[c, 0]), int(comm[c, 1])
            ps = paths.commodity_paths[c]
            slot[ps[0]] = (i * v + j) * v + j
            ks = [k for k in range(v) if k != i and k != j]
            for s_idx, k in enumerate(ks):
                slot[ps[1 + s_idx]] = (i * v + j) * v + k
        self._path_slot = slot

        dev = self.device
        ii, jj, kk = np.meshgrid(np.arange(v), np.arange(v), np.arange(v),
                                 indexing="ij")
        self.valid = torch.as_tensor((ii != jj) & (kk != ii), device=dev)
        self.mask_kj = torch.as_tensor(1.0 - np.eye(v), dtype=torch.float32,
                                       device=dev)  # [j != k] on (..., j, k)
        self._len3 = torch.as_tensor(np.where(kk == jj, 1.0, 2.0),
                                     dtype=torch.float32, device=dev)
        self._replicas = {dev: self}  # device -> solver with constants there
        self._fleet_fns_cache: dict = {}  # mesh fingerprint -> sharded stages

    # ---- replicas and sharded stages (the fleet path over a mesh) -----------

    def _replica(self, device: torch.device) -> "TorchRoutingSolver":
        """This solver with its constant tensors on ``device`` (made once)."""
        _refuse_tf32()
        if device not in self._replicas:
            rep = copy.copy(self)
            rep.device = device
            rep.valid = self.valid.to(device)
            rep.mask_kj = self.mask_kj.to(device)
            rep._len3 = self._len3.to(device)
            self._replicas[device] = rep
        return self._replicas[device]

    def _fleet_fns(self, mesh):
        """The three warm stages, each dealt over ``mesh`` by
        ``shard_leading(..., repack=True)`` and run on the replica of the
        shard's device; cached per mesh fingerprint."""
        key = None if mesh is None else (mesh.axis_names, tuple(mesh.devices))
        if key not in self._fleet_fns_cache:
            names = ("_mlu_core", "_risk_core", "_stretch_core")

            def on_shard(name):
                return lambda *args: getattr(self._replica(args[0].device), name)(*args)

            if mesh is None:
                fns = {n: getattr(self, n) for n in names}
            else:
                from repro_torch.parallel.sharding import shard_leading

                for dev in mesh.devices:  # replicas before the threads start
                    self._replica(dev)
                fns = {n: shard_leading(on_shard(n), mesh, repack=True) for n in names}
            self._fleet_fns_cache[key] = fns
        return self._fleet_fns_cache[key]

    # ---- dense conversions ---------------------------------------------------

    def _dense_tms(self, tms: np.ndarray) -> torch.Tensor:
        """(B, m, C) commodity TMs → (B, m, V, V) dense pod matrices."""
        tms = np.asarray(tms, np.float32)
        out = np.zeros(tms.shape[:-1] + (self.V * self.V,), np.float32)
        out[..., self._comm_flat] = tms
        return torch.from_numpy(
            out.reshape(tms.shape[:-1] + (self.V, self.V))).to(self.device)

    def _dense_inv_cap(self, capacities: np.ndarray) -> torch.Tensor:
        """(B, E) directed capacities → (B, V, V) dense inverse capacities."""
        cap = np.asarray(capacities, np.float64)
        ic = np.where(cap > 1e-9, 1.0 / np.maximum(cap, 1e-9), 0.0)
        out = np.zeros(cap.shape[:-1] + (self.V * self.V,), np.float32)
        out[..., self._comm_flat] = ic
        return torch.from_numpy(
            out.reshape(cap.shape[:-1] + (self.V, self.V))).to(self.device)

    def _flat_f(self, f3: torch.Tensor) -> np.ndarray:
        """(B, V, V, V) splits → (B, P) float64 in the PathSet layout."""
        flat = f3.detach().cpu().numpy().astype(np.float64)
        return flat.reshape(flat.shape[0], -1)[:, self._path_slot]

    # ---- linear operators on the pod tensor ---------------------------------

    def _util_f32(self, f3, d3, ic):
        """U[b, t, a, c] = capacity-normalized load of edge (a, c) under TM t
        — always float32 (the certificate / reported-objective path)."""
        load1 = torch.einsum("bmij,bijk->bmik", d3, f3)  # first hops (+ direct)
        load2 = torch.einsum("bmij,bijk->bmkj", d3, f3 * self.mask_kj)
        return (load1 + load2) * ic[:, None]

    def _util_adj_f32(self, y, d3, ic):
        """Adjoint: y (B, m, V, V) → gradient on f3 (B, V, V, V) — always
        float32."""
        yn = y * ic[:, None]
        g1 = torch.einsum("bmij,bmik->bijk", d3, yn)
        g2 = torch.einsum("bmij,bmkj->bijk", d3, yn) * self.mask_kj
        return g1 + g2

    def _util(self, f3, d3, ic):
        """Hot-loop load operator: with ``precision="bf16"`` ``d3``, ``f3``
        and ``f3·mask_kj`` are rounded to bf16, the products accumulate in
        float32 and ``ic`` multiplies afterwards in float32; the exact
        float32 operator otherwise."""
        if not self._mp:
            return self._util_f32(f3, d3, ic)
        bf, b, m, v = torch.bfloat16, d3.shape[0], d3.shape[1], self.V
        d3c = d3.to(bf)
        fk = (f3 * self.mask_kj).to(bf)
        # load1[b, m, i, k] = Σ_j d3[b, m, i, j] f3[b, i, j, k]: an (m × V)
        # by (V × V) product per (b, i)
        load1 = _bmm_bf16(d3c.permute(0, 2, 1, 3).reshape(b * v, m, v),
                          f3.to(bf).reshape(b * v, v, v))
        load1 = load1.reshape(b, v, m, v).permute(0, 2, 1, 3)
        # load2[b, m, k, j] = Σ_i d3[b, m, i, j] fk[b, i, j, k]: per (b, j)
        load2 = _bmm_bf16(d3c.permute(0, 3, 1, 2).reshape(b * v, m, v),
                          fk.permute(0, 2, 1, 3).reshape(b * v, v, v))
        load2 = load2.reshape(b, v, m, v).permute(0, 2, 3, 1)
        return (load1 + load2) * ic[:, None]

    def _util_adj(self, y, d3, ic):
        """Hot-loop adjoint: with ``precision="bf16"`` ``y·ic`` and ``d3``
        are rounded to bf16 before the products (float32 accumulation); the
        exact float32 adjoint otherwise."""
        if not self._mp:
            return self._util_adj_f32(y, d3, ic)
        bf, b, m, v = torch.bfloat16, d3.shape[0], d3.shape[1], self.V
        yn = (y * ic[:, None]).to(bf)
        d3c = d3.to(bf)
        # g1[b, i, j, k] = Σ_m d3[b, m, i, j] yn[b, m, i, k]: per (b, i)
        g1 = _bmm_bf16(d3c.permute(0, 2, 3, 1).reshape(b * v, v, m),
                       yn.permute(0, 2, 1, 3).reshape(b * v, m, v))
        g1 = g1.reshape(b, v, v, v)
        # g2[b, i, j, k] = Σ_m d3[b, m, i, j] yn[b, m, k, j]: per (b, j)
        g2 = _bmm_bf16(d3c.permute(0, 3, 2, 1).reshape(b * v, v, m),
                       yn.permute(0, 3, 1, 2).reshape(b * v, m, v))
        g2 = g2.reshape(b, v, v, v).permute(0, 2, 1, 3) * self.mask_kj
        return g1 + g2

    def _opnorm(self, d3, ic, valid, iters: int = 30):
        """Power iteration for ‖U‖ per element (as an operator on f3) — in
        float32 whatever the precision (the step sizes it sets gate
        convergence)."""
        vv = valid.to(d3.dtype)
        vv = vv / _bc(torch.linalg.vector_norm(vv.reshape(vv.shape[0], -1), dim=1), vv)
        for _ in range(iters):
            v2 = self._util_adj_f32(self._util_f32(vv, d3, ic), d3, ic)
            nrm = torch.linalg.vector_norm(v2.reshape(v2.shape[0], -1), dim=1)
            vv = v2 / _bc(nrm + 1e-30, v2)
        u = self._util_f32(vv, d3, ic)
        return torch.linalg.vector_norm(u.reshape(u.shape[0], -1), dim=1)

    def _proj_f(self, f3, valid):
        return _michelot_rows(f3, valid, self.V)

    def _dual_min(self, coeff, valid):
        """Σ over commodities of ``min_k coeff[b, i, j, k]`` (valid slots only)."""
        per_row = torch.where(valid, coeff, math.inf).amin(-1)
        return _sum(torch.where(torch.isfinite(per_row), per_row, 0.0))

    def _hop_inv_caps(self, ic):
        """Per-slot inverse capacities of the two hops of each path."""
        v = self.V
        ic0 = ic[:, :, None, :].expand(-1, v, v, v)  # hop 1: edge (i, k)
        # hop 2: edge (k, j) — ic1[b, i, j, k] = ic[b, k, j]; zero on the
        # direct slot (single hop)
        ic1 = ic.transpose(1, 2)[:, None, :, :] * self.mask_kj
        return ic0, ic1

    def _halpern(self, halves, anchors, k):
        """Reflected-Halpern update: blend the reflected PDHG step with the
        anchor at weight 1/(k+2); restart the anchor every ``restart_every``
        iterations."""
        lam = (k + 1.0) / (k + 2.0)
        k = k + 1.0
        rs = torch.remainder(k, self.restart_every) == 0
        out, new_anchors = [], []
        for (w, w_h), wa in zip(halves, anchors):
            lw = _bc(lam, w)
            w_new = lw * (2.0 * w_h - w) + (1.0 - lw) * wa
            out.append(w_new)
            new_anchors.append(torch.where(_bc(rs, w), w_new, wa))
        return out, new_anchors, torch.where(rs, 0.0, k)

    def _f_uniform(self, valid):
        n_slots = torch.clamp(valid.sum(-1, keepdim=True), min=1).to(torch.float32)
        return valid.to(torch.float32) / n_slots

    def _run(self, state: dict, step, check):
        """The batched ``while_loop``: iterate ``step`` on every active element
        until each has converged (``check`` at its own ``it % check_every ==
        0``) or hit ``max_iters``; finished elements are frozen.

        ``state`` maps names to (B, ...) tensors.  Returns the final state
        plus per-element ``it`` and ``gap``."""
        b = next(iter(state.values())).shape[0]
        dev = self.device
        it = torch.zeros(b, dtype=torch.int32, device=dev)
        last = torch.full((b,), math.inf, device=dev)
        gap = torch.full((b,), math.inf, device=dev)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        all_active = True
        n = 0
        while n < self.max_iters:
            new = step(state)
            if all_active:
                state = new
            else:
                state = {key: torch.where(_bc(active, val), val, state[key])
                         for key, val in new.items()}
            it = it + active.to(it.dtype)
            n += 1
            if n % self.check_every == 0:
                ok, obj, rel = check(state, last)
                last = torch.where(active, obj, last)
                gap = torch.where(active, rel, gap)
                active = active & ~ok
                host_sync_point()  # a dealt shard hands the host on here
                n_active = int(active.sum())  # the one host sync per check
                if n_active == 0:
                    break
                all_active = n_active == b
        return state, it, gap

    # ---- stage 1: min u  ≡  min_f max_{t,e} U(f) (matrix game) --------------

    def _mlu_inits(self, d3, ic, valid):
        """Cold-start point: uniform splits, dual softmax-concentrated near
        the binding constraints."""
        notdiag = valid.any(-1)
        f0 = self._f_uniform(valid)
        u0 = self._util(f0, d3, ic)
        scale = 0.02 * torch.clamp(_amax(u0), min=1e-12)
        logits = torch.where(notdiag[:, None], u0, -math.inf) / _bc(scale, u0)
        y0 = torch.softmax(logits.reshape(u0.shape[0], -1), dim=1).reshape(u0.shape)
        return f0, y0

    def _mlu_core(self, d3, ic, valid, f0, y0):
        notdiag = valid.any(-1)[:, None]
        tau = 0.99 / torch.clamp(self._opnorm(d3, ic, valid), min=1e-12)
        sig = tau
        tau_f, sig_y = _bc(tau, f0), _bc(sig, y0)

        def step(s):
            f, y = s["f"], s["y"]
            g = self._util_adj(y, d3, ic)
            f_h = self._proj_f(f - tau_f * g, valid)
            fb = 2.0 * f_h - f
            y_h = _project_simplex_topk(y + sig_y * self._util(fb, d3, ic),
                                        notdiag, self.dual_topk)
            (f, y), (fa, ya), k = self._halpern(
                [(f, f_h), (y, y_h)], [s["fa"], s["ya"]], s["k"])
            return {"f": f, "y": y, "fa": fa, "ya": ya, "k": k}

        def check(s, last):
            # exact duality gap of the matrix game: primal = max util of f;
            # dual lower bound = min_f' <y, U f'> (closed form)
            obj = _amax(self._util_f32(s["f"], d3, ic))
            lb = self._dual_min(self._util_adj_f32(s["y"], d3, ic), valid)
            ok = obj - lb <= self.tol * torch.clamp(obj, min=1e-6)
            return ok, obj, (obj - lb) / torch.clamp(obj, min=1e-6)

        b = d3.shape[0]
        state = {"f": f0, "y": y0, "fa": f0, "ya": y0,
                 "k": torch.zeros(b, device=self.device)}
        s, it, gap = self._run(state, step, check)
        return s["f"], _amax(self._util_f32(s["f"], d3, ic)), it, s["y"], gap

    # ---- stage 2: min r  ≡  min_f max(δ f / C) s.t. U(f) ≤ u* ---------------

    def _zvalid(self, valid):
        return torch.stack([valid, valid & (self.mask_kj > 0)], dim=-1)

    def _risk_inits(self, d3, valid):
        b = d3.shape[0]
        f0 = self._f_uniform(valid)
        y0 = torch.zeros((b, self.m, self.V, self.V), device=self.device)
        z0 = self._zvalid(valid).to(torch.float32)
        z0 = z0 / _bc(torch.clamp(_sum(z0), min=1.0), z0)
        return f0, y0, z0

    def _risk_core(self, d3, ic, valid, u_star, delta, f0, y0, z0):
        norm = self._opnorm(d3, ic, valid)
        ic0, ic1 = self._hop_inv_caps(ic)
        rnorm = delta * _amax(ic) * math.sqrt(2.0)
        tau = 0.99 / torch.clamp(norm + rnorm, min=1e-12)
        sig = tau
        zvalid = self._zvalid(valid)
        dl3 = _bc(delta, ic0)
        tau_f, sig_y, sig_z = _bc(tau, f0), _bc(sig, y0), _bc(sig, z0)
        u_y = _bc(u_star, y0)

        def risk_of(f3):
            return torch.stack([dl3 * f3 * ic0, dl3 * f3 * ic1], dim=-1)

        def step(s):
            f, y, z = s["f"], s["y"], s["z"]
            gf = (self._util_adj(y, d3, ic)
                  + dl3 * (z[..., 0] * ic0 + z[..., 1] * ic1))
            f_h = self._proj_f(f - tau_f * gf, valid)
            fb = 2.0 * f_h - f
            y_h = torch.clamp(y + sig_y * (self._util(fb, d3, ic) - u_y), min=0.0)
            z_h = _project_simplex_topk(z + sig_z * risk_of(fb), zvalid,
                                        self.dual_topk)
            (f, y, z), (fa, ya, za), k = self._halpern(
                [(f, f_h), (y, y_h), (z, z_h)], [s["fa"], s["ya"], s["za"]],
                s["k"])
            return {"f": f, "y": y, "z": z, "fa": fa, "ya": ya, "za": za, "k": k}

        def check(s, last):
            # Lagrangian dual lower bound plus an objective-stall test at a
            # 10·tol relative threshold (the risk objective is often
            # minuscule, where the last-iterate bound oscillates)
            f, y, z = s["f"], s["y"], s["z"]
            obj = _amax(risk_of(f))
            u_chk = _amax(self._util_f32(f, d3, ic))
            coeff = (self._util_adj_f32(y, d3, ic)
                     + dl3 * (z[..., 0] * ic0 + z[..., 1] * ic1))
            lb = self._dual_min(coeff, valid) - u_star * _sum(y)
            scale = torch.clamp(obj, min=1e-9)
            gap_ok = obj - lb <= self.tol * scale
            stall = torch.abs(obj - last) <= 10.0 * self.tol * scale
            feas = u_chk <= u_star * (1.0 + 2.0 * self.tol) + 1e-9
            return (gap_ok | stall) & feas, obj, (obj - lb) / scale

        b = d3.shape[0]
        state = {"f": f0, "y": y0, "z": z0, "fa": f0, "ya": y0, "za": z0,
                 "k": torch.zeros(b, device=self.device)}
        s, it, gap = self._run(state, step, check)
        f = s["f"]
        return (f, _amax(risk_of(f)), _amax(self._util_f32(f, d3, ic)),
                s["y"], s["z"], it, gap)

    # ---- stage 3: min stretch s.t. U(f) ≤ u*, risk ≤ r* ---------------------

    def _stretch_core(self, d3, ic, valid, u_star, r_star, delta, f_init, y0):
        """min <cost, f> over the *capped* simplex — the risk budget is a
        per-slot upper bound ``f ≤ r*/(δ·max ic)`` enforced by projection;
        only the MLU budget keeps a Lagrange dual ``y``."""
        norm = self._opnorm(d3, ic, valid)
        ic0, ic1 = self._hop_inv_caps(ic)
        tau = 0.99 / torch.clamp(norm, min=1e-12)
        sig = tau
        dsum = d3.sum(dim=1)  # (B, V, V)
        cost = torch.where(valid, dsum[..., None] * self._len3, 0.0)
        cost = cost / _bc(_amax(torch.abs(cost)) + 1e-30, cost)  # scale-free
        ub = _bc(r_star, ic0) / torch.clamp(
            _bc(delta, ic0) * torch.maximum(ic0, ic1), min=1e-30)
        ub = torch.clamp(ub, max=1.0)  # simplex rows never exceed 1 anyway
        f0 = _capped_simplex_rows(f_init, ub, valid)  # risk-feasible start
        tau_f, sig_y = _bc(tau, f0), _bc(sig, y0)
        u_y = _bc(u_star, y0)

        def step(s):
            f, y = s["f"], s["y"]
            gf = cost + self._util_adj(y, d3, ic)
            f_h = _capped_simplex_rows(f - tau_f * gf, ub, valid)
            fb = 2.0 * f_h - f
            y_h = torch.clamp(y + sig_y * (self._util(fb, d3, ic) - u_y), min=0.0)
            (f, y), (fa, ya), k = self._halpern(
                [(f, f_h), (y, y_h)], [s["fa"], s["ya"]], s["k"])
            return {"f": f, "y": y, "fa": fa, "ya": ya, "k": k}

        def check(s, last):
            f, y = s["f"], s["y"]
            obj = _sum(cost * f)
            u_chk = _amax(self._util_f32(f, d3, ic))
            coeff = cost + self._util_adj_f32(y, d3, ic)
            lb = self._dual_min(coeff, valid) - u_star * _sum(y)
            scale = torch.clamp(torch.abs(obj), min=1e-9)
            gap_ok = obj - lb <= self.tol * scale
            stall = torch.abs(obj - last) <= 10.0 * self.tol * scale
            feas = u_chk <= u_star * (1.0 + 2.0 * self.tol) + 1e-9
            return (gap_ok | stall) & feas, obj, (obj - lb) / scale

        b = d3.shape[0]
        state = {"f": f0, "y": y0, "fa": f0, "ya": y0,
                 "k": torch.zeros(b, device=self.device)}
        s, it, gap = self._run(state, step, check)
        return s["f"], s["y"], it, gap

    # ---- full routing pipeline, batched over epochs -------------------------

    def solve_routing_batch(self, tms: np.ndarray, capacities: np.ndarray,
                            hedging: bool, deltas: np.ndarray | None = None,
                            skip_stage3: bool = False):
        """Stages 1 → [2] → 3 for a batch of routing epochs, warm-started from
        a single **anchor** solve.

        The batch's middle epoch is solved cold first; its primal splits *and*
        dual iterates seed every element (controller epochs are sliding-window
        neighbours, so the anchor is near-optimal for most of the batch).

        Args:
          tms: (B, m, C) critical TMs, zero-padded to the static ``m``.
          capacities: (B, E) realized directed capacities per epoch.
          hedging: run stage 2 (elements with ``deltas == 0`` keep stage 1's f).
          deltas: (B,) burst sizes (ignored unless ``hedging``).
          skip_stage3: skip the stretch-minimization stage.

        Returns dict with ``f`` (B, P) float64, ``u_star`` (B,), ``r_star``
        (B,) or None, and ``stats`` — per-epoch iteration counts, final
        certified relative gaps and Halpern restart counts per stage (stage 2
        carries an ``active`` mask for the elements that hedge), plus
        ``anchor_seconds``.
        """
        b = np.asarray(tms).shape[0]
        return self._solve_anchored(
            tms, capacities, self.valid.expand(b, -1, -1, -1), [b // 2],
            np.zeros(b, np.int64), hedging, deltas, skip_stage3)

    def valid_for_pods(self, n_real: int) -> np.ndarray:
        """(V, V, V) slot mask for a fabric with ``n_real ≤ V`` pods embedded
        in this solver's ``V``-pod layout: commodities with a padded endpoint
        vanish, and padded pods are excluded as transit — their zero-capacity
        links carry ``inv_cap = 0`` and would otherwise look like free
        capacity."""
        v = self.V
        ii, jj, kk = np.meshgrid(np.arange(v), np.arange(v), np.arange(v),
                                 indexing="ij")
        real = (ii < n_real) & (jj < n_real) & (kk < n_real)
        return self.valid.cpu().numpy() & real

    def solve_routing_fleet(self, tms: np.ndarray, capacities: np.ndarray,
                            valids: np.ndarray, anchor_elems: np.ndarray,
                            anchor_of: np.ndarray, hedging: bool,
                            deltas: np.ndarray | None = None,
                            skip_stage3: bool = False, mesh=None):
        """Stages 1 → [2] → 3 for the routing epochs of *many fabrics* at once.

        The flattened batch concatenates every fabric's epochs; element ``i``
        belongs to the fabric whose anchor is ``anchor_elems[anchor_of[i]]``.
        All ``F`` fabric anchors are solved cold in one batched call, then the
        whole batch runs warm-started from its own fabric's anchor (primal and
        dual iterates), stage by stage — the fleet-wide form of
        :meth:`solve_routing_batch`'s anchor scheme.

        Args:
          tms: (N, m, C) critical TMs in this solver's (padded) layout.
          capacities: (N, E) directed capacities (zero on padded links).
          valids: (N, V, V, V) per-element slot masks (:meth:`valid_for_pods`).
          anchor_elems: (F,) element index of each fabric's anchor epoch.
          anchor_of: (N,) index into ``anchor_elems`` per element.
          hedging / deltas / skip_stage3: as :meth:`solve_routing_batch`.
          mesh: optional 1-D mesh
            (:func:`repro_torch.parallel.sharding.fleet_mesh`) — deals every
            warm stage's batch over its cards; each element's result is the
            unsharded call's.

        Returns what :meth:`solve_routing_batch` returns, for the N elements;
        ``stats["anchor_seconds"]`` is the time of the F anchor solves.
        """
        # C order: numpy lays a concatenation of broadcast masks out batch
        # innermost, and a sum's order follows the layout of its operands,
        # so the batch-major copy keeps each element's bits independent of
        # the batch it is solved in (and of the shard it is dealt to)
        valids = torch.as_tensor(np.ascontiguousarray(valids, bool), device=self.device)
        return self._solve_anchored(tms, capacities, valids, anchor_elems,
                                    anchor_of, hedging, deltas, skip_stage3, mesh)

    def _solve_anchored(self, tms, capacities, valids, anchor_elems, anchor_of,
                        hedging, deltas, skip_stage3, mesh=None):
        """The anchored pipeline shared by the batch and fleet paths: the
        anchors (``anchor_elems``) solve cold, each element starts every
        stage from the iterates of its anchor (``anchor_of``); the warm
        stages are dealt over ``mesh`` when one is given."""
        _refuse_tf32()
        dev = self.device
        fns = self._fleet_fns(mesh)

        def warm(name, *args):  # back on this device, whichever card ran it
            return tuple(o.to(dev) for o in fns[name](*args))

        d3 = self._dense_tms(tms)
        ic = self._dense_inv_cap(capacities)
        n = d3.shape[0]
        a_el = torch.as_tensor(np.asarray(anchor_elems, np.int64), device=dev)
        ga = torch.as_tensor(np.asarray(anchor_of, np.int64), device=dev)
        d_a, ic_a, v_a = d3[a_el], ic[a_el], valids[a_el]
        anchor_s = 0.0

        with obs.timed("pdhg.anchor", stage="mlu") as t:
            f_a, _, _, y_a, _ = self._mlu_core(
                d_a, ic_a, v_a, *self._mlu_inits(d_a, ic_a, v_a))
            synchronize(dev)
        anchor_s += t.seconds
        with obs.span("pdhg.stage1", n=n):
            f3, u, it1, _, gap1 = warm("_mlu_core", d3, ic, valids, f_a[ga],
                                       y_a[ga])
        u_budget = u * 1.005 + 1e-9
        stats = {"stage1": self._stage_stats(it1, gap1)}
        r_star = None
        deltas32 = (None if deltas is None
                    else torch.from_numpy(np.asarray(deltas, np.float32)).to(dev))
        if hedging:
            dl = deltas32
            with obs.timed("pdhg.anchor", stage="risk") as t:
                f2_a, _, _, y2_a, z2_a, _, _ = self._risk_core(
                    d_a, ic_a, v_a, u_budget[a_el], dl[a_el],
                    *self._risk_inits(d_a, v_a))
                synchronize(dev)
            anchor_s += t.seconds
            with obs.span("pdhg.stage2", n=n):
                f3r, r, _, _, _, it2, gap2 = warm(
                    "_risk_core", d3, ic, valids, u_budget, dl, f2_a[ga],
                    y2_a[ga], z2_a[ga])
            use = dl > 0
            f3 = torch.where(_bc(use, f3), f3r, f3)
            r_star = torch.where(use, r, math.inf)
            stats["stage2"] = self._stage_stats(it2, gap2,
                                                active=use.cpu().numpy())
        if not skip_stage3:
            if r_star is None:
                r_in = torch.full((n,), 1e9, device=dev)
                dl_in = torch.zeros(n, device=dev)
            else:
                fin = torch.isfinite(r_star)
                r_in = torch.where(fin, r_star * 1.005 + 1e-12, 1e9)
                dl_in = torch.where(fin, deltas32, 0.0)
            with obs.timed("pdhg.anchor", stage="stretch") as t:
                _, y3_a, _, _ = self._stretch_core(
                    d_a, ic_a, v_a, u_budget[a_el], r_in[a_el], dl_in[a_el],
                    f3[a_el],
                    torch.zeros((len(a_el), self.m, self.V, self.V), device=dev))
                synchronize(dev)
            anchor_s += t.seconds
            with obs.span("pdhg.stage3", n=n):
                f3, _, it3, gap3 = warm("_stretch_core", d3, ic, valids,
                                        u_budget, r_in, dl_in, f3, y3_a[ga])
            stats["stage3"] = self._stage_stats(it3, gap3)
        f = self._flat_f(f3)
        out_r = None
        if r_star is not None:
            rr = r_star.cpu().numpy().astype(np.float64)
            out_r = np.where(np.isfinite(rr), rr, np.nan)
        stats["anchor_seconds"] = anchor_s
        return {"f": f, "u_star": u.cpu().numpy().astype(np.float64),
                "r_star": out_r, "stats": stats}

    def solve_routing_warm(self, tms: np.ndarray, capacities: np.ndarray,
                           hedging: bool, delta: float = 0.0,
                           skip_stage3: bool = False,
                           anchor_state: RoutingWarmState | None = None):
        """Stages 1 → [2] → 3 for ONE routing epoch, warm-started from the
        previous epoch's converged iterates.

        The streaming counterpart of :meth:`solve_routing_batch`: instead of
        a batch anchored on a cold middle-epoch solve, every stage takes its
        primal *and* dual start from ``anchor_state``; a stage whose carried
        fields are missing starts from its cold init (stage 1
        :meth:`_mlu_inits`, stage 2 :meth:`_risk_inits`, stage 3 a zero
        dual).  The convergence checks gate the exit exactly as in the cold
        path, so only the iteration count changes.

        Args:
          tms: (m, C) critical TMs, zero-padded to the static ``m``.
          capacities: (E,) realized directed capacities.
          hedging: run stage 2 when ``delta > 0``.
          delta: burst size (ignored unless ``hedging``).
          skip_stage3: skip the stretch-minimization stage.
          anchor_state: the previous epoch's :class:`RoutingWarmState`, or
            ``None`` for a cold start.

        Returns ``(out, state)``: ``out`` has ``f`` (P,) float64,
        ``u_star``, ``r_star`` (None unless hedged), and ``stats`` (the
        :meth:`solve_routing_batch` schema at batch length 1, with
        ``anchor_seconds`` 0.0); ``state`` seeds the next call.
        """
        _refuse_tf32()
        dev = self.device
        d3 = self._dense_tms(np.asarray(tms)[None])
        ic = self._dense_inv_cap(np.asarray(capacities)[None])
        valid = self.valid[None]
        warm = anchor_state

        with obs.span("pdhg.warm_stage1"):
            inits = (self._mlu_inits(d3, ic, valid) if warm is None
                     else (warm.f1[None], warm.y1[None]))
            f3, u, it1, y1, gap1 = self._mlu_core(d3, ic, valid, *inits)
        state = RoutingWarmState(f1=f3[0], y1=y1[0])
        u_budget = u * 1.005 + 1e-9
        stats = {"stage1": self._stage_stats(it1, gap1), "anchor_seconds": 0.0}
        r_star = None
        run2 = hedging and delta > 0
        if run2:
            dl = torch.tensor([delta], dtype=torch.float32, device=dev)
            with obs.span("pdhg.warm_stage2"):
                inits = (self._risk_inits(d3, valid)
                         if warm is None or warm.f2 is None
                         else (warm.f2[None], warm.y2[None], warm.z2[None]))
                f3, r, _, y2, z2, it2, gap2 = self._risk_core(
                    d3, ic, valid, u_budget, dl, *inits)
            state.f2, state.y2, state.z2 = f3[0], y2[0], z2[0]
            r_star = float(r[0])
            stats["stage2"] = self._stage_stats(it2, gap2,
                                                active=np.asarray([True]))
        if not skip_stage3:
            r_in = torch.tensor([r_star * 1.005 + 1e-12 if run2 else 1e9],
                                dtype=torch.float32, device=dev)
            dl_in = torch.tensor([delta if run2 else 0.0], dtype=torch.float32,
                                 device=dev)
            y0 = (torch.zeros((1, self.m, self.V, self.V), device=dev)
                  if warm is None or warm.y3 is None else warm.y3[None])
            with obs.span("pdhg.warm_stage3"):
                f3, y3, it3, gap3 = self._stretch_core(
                    d3, ic, valid, u_budget, r_in, dl_in, f3, y0)
            state.y3 = y3[0]
            stats["stage3"] = self._stage_stats(it3, gap3)
        f = self._flat_f(f3)[0]
        return ({"f": f, "u_star": float(u[0]), "r_star": r_star,
                 "stats": stats}, state)

    def _stage_stats(self, it, gap, active=None) -> dict:
        """Host-side per-element telemetry for one batched stage.  Restarts
        follow the deterministic Halpern schedule (one every
        ``restart_every`` iterations)."""
        iters = it.cpu().numpy().astype(np.int64).reshape(-1)
        out = {"iters": iters,
               "gap": gap.cpu().numpy().astype(np.float64).reshape(-1),
               "restarts": iters // max(self.restart_every, 1)}
        if active is not None:
            out["active"] = np.asarray(active, bool).reshape(-1)
        return out
