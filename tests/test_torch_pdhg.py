"""Port vs reference: the batched three-stage PDHG routing solve.

``TorchRoutingSolver.solve_routing_batch`` (CPU) against
``JaxRoutingSolver.solve_routing_batch`` on a 6-pod fabric (F18), m=4
critical TMs, B=5 epochs with their own capacities, with and without hedging,
``dual_topk`` passed explicitly to both.  Contracts:

* ``u*`` rel ≤ 2·tol — both sides are certified to ``tol``;
* ``r*`` rel ≤ 10·tol — stage 2 may exit on a 10·tol objective stall
  (``jaxlp.py:518``);
* split rows sum to 1 at atol 1e-4;
* the MLU of the port's final splits on the TMs stays within the budget the
  stages hold it to;
* per-element iteration counts equal, or within one ``check_every``.
"""

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from repro.core.clustering import critical_tms
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.graph import uniform_topology
from repro.core.jaxlp import JaxRoutingSolver
from repro.core.jaxlp import project_simplex_rows as ref_project_simplex_rows
from repro.core.lp import estimate_delta
from repro.core.paths import build_paths, routing_weight_matrix
from repro_torch import interop
from repro_torch.core.pdhg import TorchRoutingSolver, project_simplex_rows

torch.set_num_threads(1)

M, B, TOL, TOPK, MAX_IT = 4, 5, 1e-2, 128, 3000


@pytest.fixture(scope="module")
def problem():
    spec = FLEET_SPECS[17]  # F18: 6 pods
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=4.0, interval_minutes=60.0)
    rng = np.random.default_rng(17)
    cap = fab.capacities(uniform_topology(fab))
    tms, caps, deltas = [], [], []
    for i in range(B):
        window = trace.demand[i * 8: i * 8 + 24]
        t = critical_tms(window, k=M, seed=i)
        tms.append(np.concatenate([t, np.zeros((M - t.shape[0], t.shape[1]))]))
        caps.append(cap * rng.uniform(0.7, 1.3, cap.size))
        deltas.append(estimate_delta(window))
    deltas[1] = 0.0  # one element does not hedge
    jax_solver = JaxRoutingSolver(fab, M, max_iters=MAX_IT, tol=TOL,
                                  dual_topk=TOPK)
    port_fab = interop.fabric_from_numpy(fab.name, fab.radix, fab.speed)
    port_solver = TorchRoutingSolver(port_fab, M, max_iters=MAX_IT, tol=TOL,
                                     dual_topk=TOPK, device="cpu")
    return (fab, np.stack(tms), np.stack(caps), np.asarray(deltas),
            jax_solver, port_solver)


@pytest.mark.parametrize("hedging", [False, True])
def test_solve_routing_batch_matches_reference(problem, hedging):
    fab, tms, caps, deltas, jax_solver, port_solver = problem
    ref = jax_solver.solve_routing_batch(tms, caps, hedging=hedging,
                                         deltas=deltas)
    out = port_solver.solve_routing_batch(tms, caps, hedging=hedging,
                                          deltas=deltas)
    np.testing.assert_allclose(out["u_star"], ref["u_star"], rtol=2 * TOL)
    if hedging:
        np.testing.assert_array_equal(np.isnan(out["r_star"]),
                                      np.isnan(ref["r_star"]))
        np.testing.assert_allclose(out["r_star"], ref["r_star"], rtol=10 * TOL)
        assert np.isnan(out["r_star"][1])  # delta = 0: no stage 2
    else:
        assert out["r_star"] is None
    paths = build_paths(fab.n_pods)
    for f, u, tm, cap in zip(out["f"], out["u_star"], tms, caps):
        sums = np.zeros(paths.n_commodities)
        np.add.at(sums, paths.path_commodity, f)
        np.testing.assert_allclose(sums, 1.0, atol=1e-4)
        # stages 2-3 hold U(f) ≤ u_budget·(1+2·tol), u_budget = 1.005·u*
        mlu = ((tm @ routing_weight_matrix(paths, f)) / cap).max()
        assert mlu <= u * 1.005 * (1.0 + 2.0 * TOL) + 1e-9
    assert set(out["stats"]) == set(ref["stats"])
    for stage in ("stage1", "stage2", "stage3"):
        if stage not in ref["stats"]:
            continue
        a, r = out["stats"][stage], ref["stats"][stage]
        assert np.abs(a["iters"] - r["iters"]).max() <= jax_solver.check_every
        np.testing.assert_array_equal(a["restarts"], a["iters"] // 150)
        if "active" in r:
            np.testing.assert_array_equal(a["active"], r["active"])


def test_project_simplex_rows_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (40, 7)).astype(np.float32)
    x[0] = [-5.0, -3.0, -9.0, -1.0, -2.0, -7.0, -4.0]  # all non-positive row
    out = project_simplex_rows(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref_project_simplex_rows(x)),
                               atol=1e-6)
    np.testing.assert_allclose(out.sum(1), 1.0, atol=1e-5)


def test_solver_refuses_tf32_and_bf16(problem, monkeypatch):
    """TF32 is refused; bf16 runs (``tests/test_torch_solver_precision.py``)
    and an unknown precision is refused."""
    fab = problem[5].fabric
    with pytest.raises(ValueError, match="precision"):
        TorchRoutingSolver(fab, M, precision="f16", device="cpu")
    assert TorchRoutingSolver(fab, M, precision="bf16",
                              device="cpu").precision == "bf16"
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        TorchRoutingSolver(fab, M, device="cpu")
