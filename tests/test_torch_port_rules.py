"""The port's rules, for this and every later slice.

* ``repro_torch`` imports neither ``jax`` nor any module of the reference
  package ``repro``;
* its entry points run on CUDA unless the caller asks for the CPU, and
  raise without a card — there is no silent CPU fallback;
* features of later slices raise instead of being ignored;
* a kernel wrapper launches its kernel for a CUDA tensor and runs its plain
  version for a CPU tensor or a ``meta`` one (shapes alone: the dry run);
* its copy of the synthetic fleet generates bit-equal fabrics, traces and
  bursts, so both packages can be handed the same state.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

import repro.burst.expander as ref_expander
import repro.core.fleet as ref_fleet
import repro_torch.burst.expander as port_expander
import repro_torch.core.fleet as port_fleet
from repro.core import ControllerConfig as RefControllerConfig
from repro_torch import interop
from repro_torch.core import (ControllerConfig, FleetJob, Strategy,
                              TransitionConfig, predict_fleet, run_controller,
                              run_fleet)
from repro_torch.core import fleet_engine
from repro_torch.configs import get_arch
from repro_torch.core.baselines import uniform_vlb_metrics
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as model_transformer
from repro_torch.models.api import build_model
from repro_torch.device import resolve_device
from repro_torch.serve import StreamingController, TMStream

torch.set_num_threads(1)


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys, repro_torch.core.engine, repro_torch.interop, "
            "repro_torch.kernels.linkload.ops, repro_torch.kernels.queueloss.ops, "
            "repro_torch.serve, repro_torch.core.predictor, "
            "repro_torch.core.baselines, repro_torch.obs.audit, "
            "repro_torch.core.fleet_engine, repro_torch.configs, "
            "repro_torch.models.api, repro_torch.launch.steps, "
            "repro_torch.launch.serve, repro_torch.kernels.flash_attention.ops, "
            "repro_torch.kernels.rglru_scan.ops, repro_torch.kernels.ssd_chunk.ops, "
            "repro_torch.transition, repro_torch.core.patch_panels, "
            "repro_torch.failures, repro_torch.obs.health, "
            "repro_torch.obs.report, repro_torch.kernels.autotune, "
            "repro_torch.kernels.autotune.__main__, repro_torch.models.moe, "
            "repro_torch.models.encdec, repro_torch.optim.adamw, "
            "repro_torch.optim.compression, repro_torch.runtime.trainer, "
            "repro_torch.checkpoint.manager, repro_torch.data.pipeline, "
            "repro_torch.launch.train, repro_torch.parallel.sharding, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.runtime.hlo_cost, repro_torch.runtime.hlo_traffic\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ), timeout=300, check=True)
    assert out.stdout.strip() == ""


def _imported_roots(path):
    """Top-level package of every absolute import statement in the file at
    ``path`` (a relative import stays inside its own package)."""
    import ast

    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_port_file_nor_chip_smoke_imports_jax_or_reference():
    """Every module of ``src/repro_torch`` and ``chip_smoke.py`` (whose
    imports sit inside its phase functions), read statement by statement."""
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 40
    port = root / "src" / "repro_torch"
    assert {port / "failures" / f"{m}.py" for m in
            ("config", "scenarios", "mask", "policy", "evaluate")} | {
        port / "obs" / "health.py", port / "obs" / "report.py"} <= set(files)
    bad = {str(f.relative_to(root)): sorted(r & {"jax", "jaxlib", "repro"})
           for f in files for r in [_imported_roots(f)] if r & {"jax", "jaxlib", "repro"}}
    assert bad == {}


# reference modules whose port counterpart has another path: the PDHG
# solver, and the five Pallas kernel files (their CUDA sources)
COUNTERPARTS = {
    "core/jaxlp.py": "core/pdhg.py",
    "kernels/linkload/linkload.py": "csrc/linkload.cu",
    "kernels/queueloss/queueloss.py": "csrc/queueloss.cu",
    "kernels/flash_attention/flash_attention.py": "csrc/flash_attention.cu",
    "kernels/rglru_scan/rglru_scan.py": "csrc/rglru_scan.cu",
    "kernels/ssd_chunk/ssd_chunk.py": "csrc/ssd_chunk.cu",
}
# reference modules of later slices: none is left since the dry run and the
# HLO tools were ported
LATER_SLICES = frozenset()
# reference modules without an ``__all__`` that the port added with the audio
# family and training, with multi-card sharding, and with the dry run and the
# HLO tools: the port's ``__all__`` holds their public names (less
# ``NOT_PORTED_NAMES``)
NO_ALL_MODULES = ("models/encdec.py", "optim/adamw.py", "optim/compression.py",
                  "runtime/trainer.py", "checkpoint/manager.py",
                  "data/pipeline.py", "launch/train.py", "parallel/sharding.py",
                  "launch/mesh.py", "launch/dryrun.py", "runtime/hlo_cost.py",
                  "runtime/hlo_traffic.py")
# public names of those modules that the port leaves out: the readers of
# compiled HLO text (the port compiles none, and its tests read the
# reference's HLO with the reference's own readers) and the flattening of a
# pod matrix into commodities (nothing in the port calls it)
NOT_PORTED_NAMES = {"runtime/hlo_cost.py": {"parse_module", "analyze"},
                    "runtime/hlo_traffic.py": {"parse_collectives", "traffic_to_commodities"}}
_SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _modules(pkg):
    return {str(f.relative_to(_SRC / pkg)) for f in (_SRC / pkg).rglob("*.py")}


def _dotted(pkg, rel):
    return ".".join([pkg, *rel[:-3].split("/")]).removesuffix(".__init__")


def test_every_reference_module_has_a_port_counterpart():
    """Each module of ``repro`` has one at the same path in ``repro_torch``,
    or one named in ``COUNTERPARTS``, or belongs to a later slice."""
    missing = _modules("repro") - _modules("repro_torch")
    assert missing == set(COUNTERPARTS) | LATER_SLICES
    for other in COUNTERPARTS.values():
        assert (_SRC / "repro_torch" / other).is_file(), other


@pytest.mark.parametrize("rel", sorted(
    rel for rel in _modules("repro") & _modules("repro_torch")
    if "__all__" in (_SRC / "repro" / rel).read_text()
    and not rel.endswith("__main__.py")))
def test_port_all_contains_reference_all(rel):
    """A port module at a reference module's path exports every name of the
    reference's ``__all__`` (``repro_torch.core`` once lacked ``Prediction``,
    ``pick_best`` and ``predict``, and its clustering ``hull_contains``)."""
    import importlib

    ref = importlib.import_module(_dotted("repro", rel))
    port = importlib.import_module(_dotted("repro_torch", rel))
    assert set(ref.__all__) - set(getattr(port, "__all__", ())) == set()
    assert all(hasattr(port, name) for name in ref.__all__)


def _public_names(path):
    """Top-level public functions and classes of the module at ``path``."""
    import ast

    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
            and not n.name.startswith("_")}


@pytest.mark.parametrize("rel", NO_ALL_MODULES)
def test_port_all_contains_reference_public_names(rel):
    """The reference's modules of the audio family and training define no
    ``__all__``: the port's ``__all__`` holds every public function and class
    the reference's module defines, but for those ``NOT_PORTED_NAMES`` names."""
    import importlib

    names = _public_names(_SRC / "repro" / rel)
    port = importlib.import_module(_dotted("repro_torch", rel))
    assert names and names - set(port.__all__) == NOT_PORTED_NAMES.get(rel, set())
    assert all(hasattr(port, name) for name in names - NOT_PORTED_NAMES.get(rel, set()))


def test_default_device_raises_without_a_card(small_fabric, small_trace,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    fab = interop.fabric_from_numpy(small_fabric.name, small_fabric.radix,
                                    small_fabric.speed)
    trace = interop.trace_from_numpy(small_trace.name, small_trace.demand,
                                     small_trace.interval_minutes,
                                     small_trace.n_pods)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_controller(fab, trace, Strategy(False, False))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_controller(fab, trace, Strategy(False, False),
                       ControllerConfig(engine="sequential"))
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingController(fab, TMStream.from_trace(trace), Strategy(False, True))
    with pytest.raises(RuntimeError, match="CUDA"):
        uniform_vlb_metrics(fab, trace)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.warm_state_from_numpy({"f1": np.zeros(1), "y1": np.zeros(1)})
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fleet([FleetJob(fab, trace, Strategy(False, True))])
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_fleet([(fab, trace)])
    cfg = get_arch("mamba2-130m").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("mamba2-130m", requests=1, batch=1, prompt_len=2, gen_len=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        interop.model_from_numpy(cfg, {})
    from repro_torch.failures import FailureConfig, contingency_metrics

    with pytest.raises(RuntimeError, match="CUDA"):
        contingency_metrics([trace.demand[:3]], np.zeros((1, 110, 110)),
                            np.ones((1, 110)), np.ones((2, 110)))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_controller(fab, trace, Strategy(False, False),
                       ControllerConfig(failures=FailureConfig()))
    assert resolve_device("cpu").type == "cpu"


def test_ssm_trains_and_the_decoder_refuses_audio():
    """The ssm family trains: ``Model.loss`` runs on the CPU and its
    gradient reaches every parameter (through the SSD chunk scan's
    ``SSDScan``); the decoder-only model refuses the audio family, which is
    the encoder-decoder's."""
    model = build_model(get_arch("mamba2-130m").reduced(), device="cpu")
    params = model.init(0)
    params.requires_grad_(True)
    tokens = torch.arange(16).reshape(2, 8) % model.cfg.vocab
    loss, metrics = model.loss(params, {"tokens": tokens, "labels": tokens})
    assert loss.shape == () and bool(torch.isfinite(loss))
    grads = torch.autograd.grad(loss, list(params.parameters()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert sum(bool(g.abs().sum() > 0) for g in grads) == len(grads)
    audio = get_arch("seamless-m4t-large-v2").reduced()
    with pytest.raises(ValueError, match="encdec"):
        model_transformer.init_params(torch.Generator(), audio, "cpu")
    with pytest.raises(ValueError, match="encdec"):
        model_transformer.init_cache(audio, 1, 4, "cpu")


def test_audio_serves_on_the_cpu():
    """The audio family serves (the encoder's output cached, decode from
    each prompt's first token) with the reference's report keys."""
    res = serve("seamless-m4t-large-v2", requests=2, batch=2, prompt_len=4,
                gen_len=3, device="cpu")
    assert res["requests"] == 2 and res["tokens_generated"] == 6


@pytest.mark.parametrize("engine", ["sequential", "batched"])
def test_transition_requires_realized_topologies(engine):
    """Panel decomposition (Thm. 4) needs integer, even-degree topologies:
    ``transition`` without ``realize_topology`` raises ``ValueError`` in
    every engine, as the reference does (here at construction)."""
    with pytest.raises(ValueError, match="realize_topology"):
        ControllerConfig(engine=engine, transition=TransitionConfig(),
                         realize_topology=False)
    assert ControllerConfig(engine=engine,
                            transition=TransitionConfig()).transition.n_panels == 4


def _port_fleet_job(small_fabric, small_trace, cc):
    return FleetJob(
        interop.fabric_from_numpy(small_fabric.name, small_fabric.radix,
                                  small_fabric.speed),
        interop.trace_from_numpy(small_trace.name, small_trace.demand,
                                 small_trace.interval_minutes,
                                 small_trace.n_pods),
        Strategy(False, True), cc)


def test_fleet_mesh_resolves_like_the_reference(small_fabric, small_trace,
                                                monkeypatch):
    """The reference's ``_resolve_mesh``: ``None`` never shards; ``"auto"``
    shards over every card when more than one is visible (and the run is on
    CUDA); a mesh is used as given.  A mesh that is not a 1-D device mesh
    (a bare object) fails instead of running unsharded."""
    from repro_torch.parallel.sharding import fleet_mesh

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert fleet_engine._resolve_mesh(None, cuda) is None
    assert fleet_engine._resolve_mesh("auto", cpu) is None
    given = fleet_mesh([cpu] * 2)
    assert fleet_engine._resolve_mesh(given, cpu) is given
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert fleet_engine._resolve_mesh("auto", cuda) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    auto = fleet_engine._resolve_mesh("auto", cuda)
    assert auto.axis_names == ("fleet",) and auto.devices == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    assert fleet_engine._resolve_mesh("auto", cpu) is None
    job = _port_fleet_job(small_fabric, small_trace, ControllerConfig())
    with pytest.raises(TypeError, match="fleet_mesh"):
        run_fleet([job], mesh=object(), device="cpu")


def test_sequential_engine_runs(small_fabric, small_trace):
    """``engine="sequential"`` runs now (it raised before this slice); the
    reference-parity tests are in ``tests/test_torch_sequential.py``."""
    fab = interop.fabric_from_numpy(small_fabric.name, small_fabric.radix,
                                    small_fabric.speed)
    trace = interop.trace_from_numpy(small_trace.name, small_trace.demand[:60],
                                     small_trace.interval_minutes,
                                     small_trace.n_pods)
    cc = ControllerConfig(engine="sequential", solver_backend="scipy",
                          routing_interval_hours=12.0, aggregation_days=3.0,
                          k_critical=4)
    res = run_controller(fab, trace, Strategy(False, True), cc, device="cpu")
    assert res.n_routing_updates == 4 and res.metrics.mlu.shape == (24,)
    with pytest.raises(ValueError, match="unknown engine"):
        ControllerConfig(engine="fleet")


def test_controller_config_carries_reference_fields():
    from repro.core import TransitionConfig as RefTransitionConfig

    ref = dataclasses.asdict(RefControllerConfig(backend="pallas",
                                                 solver_backend="pdhg"))
    port = interop.controller_config_from_dict(ref)
    tc = RefTransitionConfig(n_panels=3, stage_intervals=2, decide=False,
                             hysteresis=0.5, instantaneous=True)
    carried = interop.controller_config_from_dict(
        dict(ref, transition=dataclasses.asdict(tc))).transition
    assert isinstance(carried, TransitionConfig)
    assert dataclasses.asdict(carried) == dataclasses.asdict(tc)
    from repro.core import FailureConfig as RefFailureConfig
    from repro_torch.core import FailureConfig

    fc = RefFailureConfig(n_scenarios=5, p_trunk=0.1, resolve=True,
                          contingency_weight=0.25, seed=3)
    carried = interop.controller_config_from_dict(
        dict(ref, failures=dataclasses.asdict(fc))).failures
    assert isinstance(carried, FailureConfig)
    assert dataclasses.asdict(carried) == dataclasses.asdict(fc)
    assert set(ref) <= set(dataclasses.asdict(port))
    assert port.backend == "torch" and port.solver_backend == "pdhg"
    assert interop.controller_config_from_dict(
        dict(ref, backend="numpy")).backend == "numpy"
    assert ControllerConfig().backend == "torch"
    assert ControllerConfig().solver_backend == "pdhg"


@pytest.mark.parametrize("idx", [0, 2, 17, 20])
def test_fleet_copy_is_bit_equal(idx):
    ref_spec, spec = ref_fleet.FLEET_SPECS[idx], port_fleet.FLEET_SPECS[idx]
    assert dataclasses.asdict(ref_spec) == dataclasses.asdict(spec)
    ref_fab, fab = ref_fleet.make_fabric(ref_spec), port_fleet.make_fabric(spec)
    np.testing.assert_array_equal(fab.radix, ref_fab.radix)
    np.testing.assert_array_equal(fab.speed, ref_fab.speed)
    ref_tr = ref_fleet.make_trace(ref_spec, ref_fab, days=3.0, interval_minutes=60.0)
    tr = port_fleet.make_trace(spec, fab, days=3.0, interval_minutes=60.0)
    np.testing.assert_array_equal(tr.demand, ref_tr.demand)
    ref_burst = ref_fleet.sub_burst_params(ref_spec)
    burst = port_fleet.sub_burst_params(spec)
    assert dataclasses.asdict(burst) == dataclasses.asdict(ref_burst)
    np.testing.assert_array_equal(
        port_expander.expand(tr.demand[:5], 12, burst, seed=idx),
        ref_expander.expand(ref_tr.demand[:5], 12, ref_burst, seed=idx))


def test_kernel_wrappers_run_their_plain_version_on_meta():
    """The wrappers' third case: ``meta`` tensors (the dry run's virtual
    mesh) run the plain version, which only propagates shapes — forward and
    backward of the flash attention and of the SSD chunk scan, and the
    RG-LRU scan — and count no launch."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rglru_scan import ops as rg
    from repro_torch.kernels.ssd_chunk import ops as sd

    before = (fa.launches, fa.bwd_launches, rg.launches, sd.launches, sd.bwd_launches)
    q = torch.empty((2, 16, 4, 32), device="meta", requires_grad=True)
    kv = torch.empty((2, 16, 2, 32), device="meta", requires_grad=True)
    out = fa.flash_attention(q, kv, kv, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    dq, dk = torch.autograd.grad(out.sum(), [q, kv])
    assert dq.shape == q.shape and dk.shape == kv.shape
    a = torch.empty((2, 16, 8), device="meta")
    assert rg.rglru_scan(a, a).shape == a.shape
    x = torch.empty((1, 2, 64, 16), device="meta", requires_grad=True)
    y = sd.ssd_scan(x, torch.empty((1, 2, 64, 1), device="meta"),
                    torch.empty((2, 1, 1, 1), device="meta"),
                    torch.empty((1, 1, 64, 8), device="meta"),
                    torch.empty((1, 1, 64, 8), device="meta"), chunk=32)
    assert y.shape == x.shape and torch.autograd.grad(y.sum(), x)[0].shape == x.shape
    assert (fa.launches, fa.bwd_launches, rg.launches, sd.launches,
            sd.bwd_launches) == before


def _chip_smoke():
    """``chip_smoke.py`` as a module (its imports sit inside its phases, so
    importing it needs no card)."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ["gemma3-12b", "llama3-8b", "recurrentgemma-9b"])
def test_train_flops_count_each_layer_at_its_window(arch):
    """The MFU's model FLOPs (``chip_smoke._train_flops``) count each
    attention layer's visible (q, k) pairs at that layer's window: gemma3's
    8 global layers at window 0 beside its 40 locals at 1024; llama3-8b (every
    layer global) and recurrentgemma-9b (one attention block a super-block,
    at its window) as before the per-layer count."""
    cs = _chip_smoke()
    cfg, n, b, s = get_arch(arch), 10 ** 9, 2, 2048
    per_pair = 4 * cfg.resolved_head_dim * b * cfg.n_heads
    if arch == "gemma3-12b":
        windows = [model_transformer.layer_window(cfg, i) for i in range(cfg.n_layers)]
        assert windows.count(0) == 8 and windows.count(1024) == 40
        pairs = sum(cs._band_pairs(s, s, True, w) for w in windows)
        assert pairs > cfg.n_layers * cs._band_pairs(s, s, True, cfg.window)
    else:  # the count before: every attention layer at cfg.window
        n_attn = cfg.n_layers // 3 if cfg.family == "hybrid" else cfg.n_layers
        pairs = n_attn * cs._band_pairs(s, s, True, cfg.window)
    assert cs._train_flops(cfg, n, b, s) == 6.0 * n * b * s + 3.0 * per_pair * pairs
