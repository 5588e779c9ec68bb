#!/usr/bin/env python3
"""Which PDHG operation's bits depend on the batch it runs in?

    python3 tools/fleet_deal_bits.py [cpu|cuda]

Builds phase 14's fleet bucket of 12 padded pods (F21 and F1 of
``chip_smoke.py``, 7 routing epochs each: 14 elements), then on the device
runs each operation of a stage-1 PDHG step once on the whole batch and once
on each half (the blocks a two-shard contiguous split hands each card), and
prints, per operation and operand shape, whether every element's result is
bit-equal; then traces the first stage-1 iterations of the whole batch and of
its first half side by side and names the first value that differs.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(device: str = "cuda") -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import pdhg, run_fleet

    dev = torch.device(device)
    captured = {}
    orig = pdhg.TorchRoutingSolver._solve_anchored

    def spy(self, tms, caps, valids, *rest, **kw):
        captured.setdefault(self.V, (self, tms, caps, valids))
        return orig(self, tms, caps, valids, *rest, **kw)

    pdhg.TorchRoutingSolver._solve_anchored = spy
    jobs = cs.fleet_config(days=7.0 + 7.0 / 96.0, spec_indices=(20, 0))
    run_fleet(jobs, mesh=None, device=dev)
    pdhg.TorchRoutingSolver._solve_anchored = orig
    sol, tms, caps, valids = captured[12]
    d3, ic = sol._dense_tms(tms), sol._dense_inv_cap(caps)
    n = d3.shape[0]
    halves = [slice(0, n // 2), slice(n // 2, n)]
    f0, y0 = sol._mlu_inits(d3, ic, valids)
    notdiag = valids.any(-1)[:, None]
    tau = 0.99 / torch.clamp(sol._opnorm(d3, ic, valids), min=1e-12)

    def ops(d, i, v, f, y, t):
        nd = v.any(-1)[:, None]
        g = sol._util_adj(y, d, i)
        return {
            "einsum bmij,bijk->bmik + bmij,bijk->bmkj (_util_f32)": sol._util_f32(f, d, i),
            "einsum bmij,bmik->bijk + bmij,bmkj->bijk (_util_adj_f32)": g,
            "_opnorm (power iteration)": sol._opnorm(d, i, v),
            "_michelot_rows": pdhg._michelot_rows(f - pdhg._bc(t, f) * g, v, sol.V),
            "_project_simplex_topk": pdhg._project_simplex_topk(
                y + pdhg._bc(t, y) * sol._util(f, d, i), nd, sol.dual_topk),
            "_dual_min": sol._dual_min(g, v),
            "softmax (_mlu_inits)": sol._mlu_inits(d, i, v)[1],
            # _opnorm's normalization, and ways to take the same norm
            "vector_norm over rows of V^3": torch.linalg.vector_norm(
                g.reshape(g.shape[0], -1), dim=1),
            "sqrt(sum(x*x)) over rows of V^3": torch.sqrt(
                (g * g).reshape(g.shape[0], -1).sum(1)),
            "sqrt of two-level sums (V^2 then V)": torch.sqrt(
                (g * g).reshape(g.shape[0], sol.V, -1).sum(-1).sum(-1)),
            "_sum over rows of V^3 (pdhg._sum)": pdhg._sum(g),
        }

    whole = ops(d3, ic, valids, f0, y0, tau)
    parts = [ops(d3[h], ic[h], valids[h], f0[h], y0[h], tau[h]) for h in halves]
    print(f"device {dev}: bucket V=12, m={sol.m}, {n} elements; halves of {n // 2}")
    for name, w in whole.items():
        same = all(torch.equal(w[h], p[name]) for h, p in zip(halves, parts))
        diff = max(float((w[h] - p[name]).abs().max()) for h, p in zip(halves, parts))
        print(f"  {name}: shape {tuple(w.shape)}, halves bit-equal {same}, max |diff| {diff:.3e}")

    def trace(d, i, v, f, y, t, steps=5):
        nd = v.any(-1)[:, None]
        fa, ya, k = f, y, torch.zeros(d.shape[0], device=d.device)
        out = []
        for _ in range(steps):
            g = sol._util_adj(y, d, i)
            out.append(("adjoint", g))
            fh = sol._proj_f(f - pdhg._bc(t, f) * g, v)
            out.append(("primal projection", fh))
            u = sol._util(2.0 * fh - f, d, i)
            out.append(("load operator", u))
            yh = pdhg._project_simplex_topk(y + pdhg._bc(t, y) * u, nd, sol.dual_topk)
            out.append(("dual projection", yh))
            (f, y), (fa, ya), k = sol._halpern([(f, fh), (y, yh)], [fa, ya], k)
        return out

    h = halves[0]
    a = trace(d3, ic, valids, f0, y0, tau)
    b = trace(d3[h], ic[h], valids[h], f0[h], y0[h], tau[h])
    for step, ((name, x), (_, z)) in enumerate(zip(a, b)):
        if not torch.equal(x[h], z):
            print(f"  first difference in the stage-1 trace: step {step // 4}, "
                  f"{name}, shape {tuple(x.shape)}, max |diff| "
                  f"{float((x[h] - z).abs().max()):.3e}")
            break
    else:
        print("  the stage-1 trace's first steps are bit-equal")
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
