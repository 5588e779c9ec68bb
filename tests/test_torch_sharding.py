"""Port vs reference: multi-card sharding — ``repro_torch.parallel.sharding``,
``repro_torch.launch.mesh``, the spec functions of ``launch/steps.py`` and
the fleet's PDHG dealt over a mesh.

(a) ``shard_leading(repack=True)``: outputs bit-equal to the unsharded call
    for n = 1..11 on D = 1, 2, 4 shards (``fleet_mesh([cpu] * D)``: one host
    thread a shard), and the round-robin deal the one the reference's
    ``shard_map`` receives: the reference runs in-process on its one device
    for D = 1 and in a subprocess with ``--xla_force_host_platform_device_count``
    for D = 2 and 4, as ``tests/test_sharding_repack.py`` runs it.
(b) Specs: ``param_spec_for``/``fit_spec`` through ``param_shardings`` for
    every parameter of the ten configs (reduced, and full through
    ``Model.param_shapes`` on ``meta``), under the three profiles, on mesh
    shapes (1, 1), (4, 1), (2, 2), (16, 16) and (2, 16, 16); and
    ``input_shardings``, ``cache_shardings`` and ``train_state_shardings``
    for the four shape cells.  Contract: each port leaf's spec equals the
    reference's spec of the stacked array without its (replicated) layer
    entries; the input stand-ins have the reference's keys, shapes and
    dtypes.  The reference's functions read only a mesh's names and sizes,
    so the port's ``Mesh`` stands in for a JAX mesh, and its
    ``NamedSharding`` is replaced by the bare spec.
(c) The fleet: ``solve_routing_fleet(mesh=...)`` and ``run_fleet`` over
    ``fleet_mesh([cpu] * D)`` bit-equal to the unsharded port (f, u*, r*,
    iterations and gaps per element), and ``run_fleet`` within
    ``tests/test_torch_fleet.py``'s tolerance of the reference's fleet.
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.steps as ref_steps
import repro.parallel.sharding as ref_sh
from repro.configs import get_arch as ref_get_arch
from repro.core import ControllerConfig, SolverConfig, Strategy
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.core.fleet_engine import FleetJob, run_fleet
from repro.models.api import build_model as ref_build_model
from repro.models.config import ALL_SHAPES as REF_SHAPES
from repro.optim.adamw import AdamW as RefAdamW
from repro_torch import interop
from repro_torch.configs import ARCHS, get_arch
from repro_torch.core import FleetJob as PortFleetJob
from repro_torch.core import run_fleet as port_run_fleet
from repro_torch.core.fleet import commodity_slots, scatter_pad
from repro_torch.core.fleet import FLEET_SPECS as PORT_SPECS
from repro_torch.core.fleet import make_fabric as port_make_fabric
from repro_torch.core.graph import Fabric, uniform_topology
from repro_torch.core.pdhg import TorchRoutingSolver
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.api import build_model
from repro_torch.models.config import ALL_SHAPES
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as sh

torch.set_num_threads(1)

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
CPU = torch.device("cpu")
MESHES = [((1, 1), ("data", "model")), ((4, 1), ("data", "model")),
          ((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
PROFILES = ("fsdp", "fsdp_pod", "tp")


@pytest.fixture(autouse=True)
def _restore_globals():
    yield
    for mod in (sh, ref_sh):
        mod.set_profile("fsdp")
        mod.set_active_mesh(None)


# ---- (a) shard_leading ---------------------------------------------------------

def _elementwise(x, y):
    return x * 2.0 + y[:, :1], torch.flip(x, [1]) - y


_REF_DEAL = r"""
import json
import jax
import jax.experimental.shard_map as smod
import jax.numpy as jnp
import numpy as np
from repro.parallel.sharding import fleet_mesh, shard_leading

real, seen = smod.shard_map, []

def spy(fn, **kw):
    inner = real(fn, **kw)
    def run(*args):
        seen.append(np.asarray(args[0]).astype(int).tolist())
        return inner(*args)
    return run

smod.shard_map = spy
mesh = fleet_mesh()
assert len(mesh.devices.flat) == %d
sharded = shard_leading(lambda x: x + 1, mesh, repack=True)
out = {}
for n in range(1, 12):
    seen.clear()
    got = np.asarray(sharded(jnp.arange(n, dtype=jnp.float32)))
    assert np.array_equal(got, np.arange(n) + 1), n
    out[n] = seen[0]
print(json.dumps(out))
"""


def _reference_deal(d: int) -> dict:
    """n -> the leading-axis order the reference's ``shard_map`` receives."""
    if d == 1:
        mesh = ref_sh.fleet_mesh(jax.devices()[:1])
        sharded = ref_sh.shard_leading(lambda x: x, mesh, repack=True)
        out = {}
        for n in range(1, 12):
            x = jax.numpy.arange(n, dtype=jax.numpy.float32)
            assert np.array_equal(np.asarray(sharded(x)), np.arange(n))
            out[n] = list(range(n))  # one device: the batch as it is
        return out
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={d}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _REF_DEAL % d], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return {int(k): v for k, v in json.loads(r.stdout.strip().splitlines()[-1]).items()}


@pytest.mark.parametrize("d", [1, 2, 4])
def test_shard_leading_repack_matches_the_reference(d):
    ref = _reference_deal(d)
    mesh = sh.fleet_mesh([CPU] * d)
    sharded = sh.shard_leading(_elementwise, mesh, repack=True)
    rng = np.random.default_rng(d)
    for n in range(1, 12):
        deal = sh._deal(n, d)
        order = list(range(n)) if deal is None else deal[0].tolist()
        assert order == ref[n], (n, order, ref[n])
        if deal is not None:  # the inverse undoes the deal, element by element
            gather, inv, rows = deal
            assert len(gather) == rows * d and np.array_equal(gather[inv], np.arange(n))
        x = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(n, 24)).astype(np.float32))
        got, want = sharded(x, y), _elementwise(x, y)
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w), n
    plain = sh.shard_leading(_elementwise, mesh)  # repack=False: a multiple of D
    x = torch.ones((2 * d, 3))
    assert all(torch.equal(g, w) for g, w in zip(plain(x, x), _elementwise(x, x)))
    if d > 1:
        with pytest.raises(ValueError, match="repack=True"):
            plain(torch.ones((2 * d + 1, 3)), torch.ones((2 * d + 1, 3)))


def test_meshes():
    pm = make_production_mesh()
    assert pm.shape == {"data": 16, "model": 16} and pm.devices is None
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    host = make_host_mesh()  # no process group: one rank
    assert host.shape == {"data": 1, "model": 1} and host.rank_index == 0
    assert sh.dp_axes(make_production_mesh(multi_pod=True)) == ("pod", "data")
    assert tuple(sh.P("data", None)) == tuple(ref_sh.P("data", None))
    with sh.use_mesh(pm):
        assert tuple(sh.spec("dp", "tp", None, "sp")) == ("data", "model", None, "model")
        assert tuple(sh.spec("dp")) == tuple(ref_sh.P(("data",)))
        x = torch.ones(2)
        assert sh.constrain(x, "dp") is x  # tensor parallelism places its own collectives
    for kind in ("train", "prefill", "decode"):
        sh.check_executable(pm, kind)  # a model axis of 16 executes (on meta: virtual)
        sh.check_executable(host, kind)
    with pytest.raises(ValueError, match="not train, prefill or decode"):
        sh.check_executable(pm, "serve")
    x = torch.ones(2)
    with sh.use_mesh(host):
        assert sh.constrain(x, "dp", None) is x  # a model axis of 1: as it is
    assert sh.constrain(x, "dp") is x and sh.active_mesh() is None


# ---- (b) specs -------------------------------------------------------------------

def _mesh(shape, names):
    return sh.Mesh(shape, names)


def _ref_param_specs(shapes, mesh) -> dict:
    """Reference path -> (stacked shape, spec) of each leaf, as the
    reference's ``param_shardings`` computes it."""
    out = {}

    def visit(path, leaf):
        p = ref_sh._path_str(path)
        spec = ref_sh.fit_spec(mesh, leaf.shape, ref_sh.param_spec_for(p, len(leaf.shape)))
        out[p] = (tuple(leaf.shape), tuple(spec))

    jax.tree_util.tree_map_with_path(visit, shapes)
    return out


def _check_port_specs(port_shapes, port_specs, ref: dict, label):
    """Every port leaf: its reference path is a reference leaf's, its shape
    that leaf's without the layer axes, its spec the reference's without
    their (replicated) entries; every reference leaf is covered."""
    leaves = list(sh._param_leaves(port_shapes))
    specs = tree_util.leaves_of(port_specs)
    assert len(leaves) == len(specs)
    seen = set()
    for (path, layers, leaf), ns in zip(leaves, specs):
        key = sh._path_str(path)
        shape, spec = ref[key]
        n = len(layers)
        assert shape == tuple(layers) + tuple(leaf.shape), (label, key)
        assert spec[:n] == (None,) * n, (label, key, spec)
        assert tuple(ns.spec) == spec[n:], (label, key, tuple(ns.spec), spec)
        seen.add(key)
    assert seen == set(ref), (label, set(ref) - seen)


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_train_state_specs_match_reference(arch, reduced, monkeypatch):
    monkeypatch.setattr(ref_sh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    if reduced:
        cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
    model, ref_model = build_model(cfg, CPU), ref_build_model(ref_cfg)
    port_shapes, ref_shapes = model.param_shapes(), ref_model.param_shapes()
    assert all(x.device.type == "meta" for x in tree_util.leaves(port_shapes))
    # train_state_shardings asks both models for their shapes again: once serves
    monkeypatch.setattr(type(model), "param_shapes", lambda self: port_shapes)
    monkeypatch.setattr(type(ref_model), "param_shapes", lambda self: ref_shapes)
    for profile in PROFILES:
        sh.set_profile(profile)
        ref_sh.set_profile(profile)
        for shape, names in MESHES:
            mesh = _mesh(shape, names)
            label = (arch, profile, shape)
            with sh.use_mesh(mesh):
                ref_sh.set_active_mesh(mesh)
                ref = _ref_param_specs(ref_shapes, mesh)
                _check_port_specs(port_shapes, sh.param_shardings(mesh, port_shapes),
                                  ref, label)
                # the train state: moments as their parameters, the step
                # replicated (the reference's dry run calls it under the mesh)
                pshard, oshard = steps.train_state_shardings(mesh, model, AdamW())
                ref_p, ref_o = ref_steps.train_state_shardings(mesh, ref_model, RefAdamW())
                ref_sh.set_active_mesh(None)
            assert tuple(oshard.step.spec) == tuple(ref_o.step) == ()
            for name, tree in (("params", pshard), ("mu", oshard.mu), ("nu", oshard.nu)):
                ref_tree = {"params": ref_p, "mu": ref_o.mu, "nu": ref_o.nu}[name]
                ref = {}
                jax.tree_util.tree_map_with_path(
                    lambda p, s: ref.__setitem__(ref_sh._path_str(p), tuple(s)), ref_tree)
                ref = {k: (_stacked_shape(ref_shapes, k), v) for k, v in ref.items()}
                _check_port_specs(port_shapes, tree, ref, label + (name,))


def _stacked_shape(shapes, key):
    node = shapes
    for k in key.split("/"):
        node = node[k]
    return tuple(node.shape)


def _flat_specs(tree, prefix="") -> dict:
    """"a/b/c" -> spec entries, for a dict tree of ``NamedSharding`` (the
    port's) or of bare specs (the reference's)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat_specs(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: tuple(getattr(tree, "spec", tree))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_and_cache_specs_match_reference(arch, monkeypatch):
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    cfg, ref_cfg = get_arch(arch), ref_get_arch(arch)
    model, ref_model = build_model(cfg, CPU), ref_build_model(ref_cfg)
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        assert dataclasses.astuple(shape) == dataclasses.astuple(ref_shape)
        specs, ref_specs = model.input_specs(shape), ref_model.input_specs(ref_shape)
        got = {}
        jax.tree_util.tree_map_with_path(
            lambda p, x: got.__setitem__(ref_sh._path_str(p), (tuple(x.shape),
                                                               str(x.dtype))),
            ref_specs)
        flat = {}

        def walk(t, prefix=""):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{prefix}{k}/")
            else:
                assert t.device.type == "meta"
                flat[prefix[:-1]] = (tuple(t.shape), str(t.dtype).removeprefix("torch."))

        walk(specs)
        assert list(specs) == list(ref_specs) and flat == got, (arch, shape.name)
        for dims, names in MESHES:
            mesh = _mesh(dims, names)
            port = _flat_specs(steps.input_shardings(mesh, cfg, shape, specs))
            ref = _flat_specs(ref_steps.input_shardings(mesh, ref_cfg, ref_shape, ref_specs))
            assert port == ref, (arch, shape.name, dims)
            if "cache" in specs:
                assert _flat_specs(steps.cache_shardings(mesh, cfg, shape, specs["cache"])) \
                    == _flat_specs(ref_steps.cache_shardings(mesh, ref_cfg, ref_shape,
                                                             ref_specs["cache"]))


def test_long_context_cache_absorbs_every_axis(monkeypatch):
    """long_500k (batch 1): the KV sequence axis shards over every axis."""
    cfg = get_arch("gemma3-12b")
    model = build_model(cfg, CPU)
    shape = [s for s in ALL_SHAPES if s.name == "long_500k"][0]
    mesh = _mesh((2, 16, 16), ("pod", "data", "model"))
    got = steps.cache_shardings(mesh, cfg, shape, model.input_specs(shape)["cache"])
    k = got["blocks"]["k"].spec
    assert tuple(k) == (None, None, ("pod", "data", "model"), None, None)


# ---- (c) the fleet -------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_bucket():
    """An 8-pod bucket of three fabrics (6, 7 and 8 pods) with 2, 2 and 3
    epochs: 7 elements, dealt unevenly over 2 and 4 shards."""
    vp, m = 8, 4
    cp = vp * (vp - 1)
    # iterations capped at 300 (three checks a stage) to keep the threads'
    # CPU time short: capped or converged, each element's path is its own
    solver = TorchRoutingSolver(Fabric("bucket-V8", np.full(vp, 2), np.ones(vp)), m,
                                max_iters=300, tol=1e-2, device="cpu")
    rng = np.random.default_rng(5)
    tms, caps, valids, deltas, anchor_elems, anchor_of = ([] for _ in range(6))
    n = 0
    for fi, (idx, b) in enumerate(((16, 2), (1, 2), (8, 3))):
        fab = port_make_fabric(PORT_SPECS[idx])
        slots = commodity_slots(fab.n_pods, vp)
        cap = scatter_pad(fab.capacities(uniform_topology(fab)), slots, cp)
        nc = fab.n_pods * (fab.n_pods - 1)
        for e in range(b):
            tms.append(scatter_pad(rng.gamma(2.0, 1.0, (m, nc)), slots, cp, axis=1))
            caps.append(cap)
            valids.append(solver.valid_for_pods(fab.n_pods))
            deltas.append(0.0 if (fi, e) == (1, 0) else 0.5)
        anchor_of += [fi] * b
        anchor_elems.append(n + b // 2)
        n += b
    args = (np.stack(tms), np.stack(caps), np.stack(valids),
            np.asarray(anchor_elems), np.asarray(anchor_of))
    kw = dict(hedging=True, deltas=np.asarray(deltas))
    return solver, args, kw, solver.solve_routing_fleet(*args, **kw)


@pytest.mark.parametrize("d", [2, 4])
def test_solve_routing_fleet_over_a_mesh_is_bit_equal(port_bucket, d):
    solver, args, kw, want = port_bucket
    got = solver.solve_routing_fleet(*args, **kw, mesh=sh.fleet_mesh([CPU] * d))
    for key in ("f", "u_star", "r_star"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for stage in ("stage1", "stage2", "stage3"):
        for field in ("iters", "gap", "restarts"):
            np.testing.assert_array_equal(got["stats"][stage][field],
                                          want["stats"][stage][field],
                                          err_msg=f"{stage} {field}")


CC = ControllerConfig(routing_interval_hours=12.0, topology_interval_days=3.0,
                      aggregation_days=3.0, k_critical=4, solver_backend="pdhg")
SC = SolverConfig(stage1_method="scaled")
HEDGE = Strategy(nonuniform=False, hedging=True)
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"
P999 = ("p999_mlu", "p999_alu", "p999_olr", "p999_stretch")


def _port_job(fabric, trace):
    cc = dataclasses.replace(interop.controller_config_from_dict(dataclasses.asdict(CC)),
                             kmeans_dtype=KMEANS_DTYPE)
    return PortFleetJob(
        interop.fabric_from_numpy(fabric.name, fabric.radix, fabric.speed),
        interop.trace_from_numpy(trace.name, trace.demand, trace.interval_minutes,
                                 trace.n_pods),
        interop.strategy_from_dict(dataclasses.asdict(HEDGE)), cc,
        interop.solver_config_from_dict(dataclasses.asdict(SC)))


def test_run_fleet_over_a_mesh_matches_unsharded_and_reference():
    """F2 (7 → 8 pods) and F17 (6 → 8), 3 epochs each: one bucket of 6
    elements dealt round-robin over 4 shards, bit-equal to the unsharded
    port; the reference's fleet within tests/test_torch_fleet.py's
    tolerance."""
    fleet = []
    for idx in (1, 16):
        fabric = make_fabric(FLEET_SPECS[idx])
        fleet.append((fabric, make_trace(FLEET_SPECS[idx], fabric, days=4.5,
                                         interval_minutes=120.0)))
    ref = run_fleet([FleetJob(f, t, HEDGE, CC, SC) for f, t in fleet], mesh=None)
    jobs = [_port_job(f, t) for f, t in fleet]
    base = port_run_fleet(jobs, mesh=None, device="cpu")
    for d in (4,):
        got = port_run_fleet(jobs, mesh=sh.fleet_mesh([CPU] * d), device="cpu")
        for a, b in zip(base, got):
            np.testing.assert_array_equal(b.splits, a.splits)
            np.testing.assert_array_equal(b.u_star, a.u_star)
            for stage, st in a.solver_stats.stages.items():
                assert b.solver_stats.stages[stage].iters == st.iters
                np.testing.assert_array_equal(b.solver_stats.stages[stage].gaps, st.gaps)
            for m in ("mlu", "alu", "olr", "stretch", "loss"):
                np.testing.assert_array_equal(getattr(b.metrics, m), getattr(a.metrics, m))
    for (fabric, _), r, p in zip(fleet, ref, got):
        assert p.n_routing_updates == r.n_routing_updates == 3
        for k in P999:
            assert p.summary[k] == pytest.approx(r.summary[k], rel=1e-4, abs=1e-6)
        assert p.transit_fraction == pytest.approx(r.transit_fraction, abs=1e-4)
        for stage, st in r.solver_stats.stages.items():
            assert p.solver_stats.stages[stage].iters == st.iters, stage
