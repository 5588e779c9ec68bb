"""Port vs reference: ``predict_fleet`` — every strategy on every fabric's
training window in one ``run_fleet`` call, then the operator objective per
fabric.

F17 (6 pods) and F2 (7 pods) share the 8-pod bucket, so their 8 jobs (4
strategies each, the nonuniform ones with joint topology solves) solve in one
padded PDHG batch and score in one launch of each fleet kernel.  Contract:
the same strategy picked per fabric, and every strategy's p999 summaries
within rel 1e-4 (the reference's own fleet-vs-per-fabric contract is 1e-3,
``tests/test_fleet_engine.py:163``).  Observed on the CPU: within 5.4e-7.
"""

import dataclasses

import jax
import pytest
import torch

from repro.core import ControllerConfig, SolverConfig
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.fleet_engine import predict_fleet
from repro_torch import interop
from repro_torch.core import predict_fleet as port_predict_fleet

torch.set_num_threads(1)

CC = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=3.0,
                      aggregation_days=3.0, k_critical=4, solver_backend="pdhg")
SC = SolverConfig(stage1_method="scaled")
P999 = ("p999_mlu", "p999_alu", "p999_olr", "p999_stretch")
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"


def test_predict_fleet_matches_reference():
    fleet = []
    for idx in (16, 1):
        spec = FLEET_SPECS[idx]
        fabric = make_fabric(spec)
        fleet.append((fabric, make_trace(spec, fabric, days=5.0,
                                         interval_minutes=120.0)))
    ref = predict_fleet(fleet, CC, SC, mesh=None)
    port = port_predict_fleet(
        [(interop.fabric_from_numpy(f.name, f.radix, f.speed),
          interop.trace_from_numpy(t.name, t.demand, t.interval_minutes,
                                   t.n_pods)) for f, t in fleet],
        dataclasses.replace(
            interop.controller_config_from_dict(dataclasses.asdict(CC)),
            kmeans_dtype=KMEANS_DTYPE),
        interop.solver_config_from_dict(dataclasses.asdict(SC)), device="cpu")
    for (fabric, _), r, p in zip(fleet, ref, port):
        assert p.fabric == r.fabric == fabric.name
        assert p.strategy.name == r.strategy.name
        assert set(p.per_strategy) == set(r.per_strategy)
        for name, summary in r.per_strategy.items():
            for k in P999:
                assert p.per_strategy[name][k] == pytest.approx(
                    summary[k], rel=1e-4, abs=1e-6), (fabric.name, name, k)
