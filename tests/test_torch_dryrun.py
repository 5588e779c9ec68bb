"""The dry run and the training-traffic bridge to the controller —
``repro_torch.launch.dryrun``, the recorder of
``repro_torch.runtime.hlo_traffic`` on a virtual mesh, and
``Trainer.extract_traffic``.

(a) A reduced llama3's train step on ``meta`` over a virtual (2, 2, 2)
    (pod, data, model) mesh: its pod traffic matrix equals, to the byte, the
    one counted from ``param_shardings`` and the step's plan alone
    (``dryrun.planned_collectives``); no collective over the model axis
    crosses a pod, so tensor parallelism (Megatron or gathered) moves no
    byte of the matrix Gemini sees.
(b) The reference's train step of the same reduced config, lowered on a
    (2, 2, 2) JAX mesh in a subprocess with 8 host devices as its
    ``run_cell`` lowers it, and its collectives read by the reference's
    ``analyze``: both pod matrices are symmetric, zero on the
    diagonal and nonzero off it.  Their ratio is printed (``PERF.md``
    records it): the port gathers a block at a time where XLA's scan
    does, but XLA may fuse, order and place collectives its own way, so
    the test asserts only what must agree.  The subprocess has a 300 s
    limit.
(c) The full-size mamba2-130m ``train_4k`` cell on 2×16×16 completes on
    ``meta`` with the reference's record keys (one microbatch: the flops
    do not depend on the count, and the pod matrix is
    ``planned_collectives``' at that count, ``tests/test_torch_hlo_tools.py``),
    its SSD on unequal shares of its 24 heads; qwen3-14b train_4k and
    internvl2-1b decode_32k run attention on unequal shares of the heads,
    their collectives over blocks of the model axis as planned and their
    flops a device below the whole layer's;
    decode cells run the sharded serve step: llama3-8b decode_32k holds
    2^31 B of cache a device on 16×16 (2^30 on 2×16×16), each decode
    record's pod matrix equals ``planned_collectives(..., "decode")`` (at
    long_500k the attention's combine crosses the pods), decode's cache
    knobs apply to decode cells and raise on train and prefill cells, and
    the reference's skips are ``skipped``.
(d) The counterpart of ``tests/test_system_e2e.py``'s
    ``test_framework_bridge_traffic_to_controller``: ``extract_traffic`` on
    one host gives the reference's (1, 1) matrix (and the reference's
    collective summary) and then drives ``repro_torch.core.run_controller``
    on the CPU to a finite p99.9 MLU; on a virtual 2-pod mesh it gives a
    nonzero, symmetric (2, 2) matrix equal to the planned count.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.steps import (StepConfig, leaf_plans, make_train_step,
                                      module_like, tp_report)
from repro_torch.models.api import Model, build_model
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW
from repro_torch.parallel import sharding as sh
from repro_torch.runtime.hlo_traffic import (collective_summary, pod_traffic_matrix,
                                             record_collectives)

torch.set_num_threads(1)

B, S, MB = 8, 32, 2  # global batch, sequence, microbatches of the (2, 2, 2) cell
NAMES = ("pod", "data", "model")


def _virtual_step(arch, shape=(2, 2, 2)):
    """(ops, model, mesh) of one train step of the reduced ``arch`` on a
    virtual mesh, as rank 0."""
    model = Model(get_arch(arch).reduced(), torch.device("meta"))
    mesh = sh.Mesh(shape, NAMES)
    plans = leaf_plans(model, mesh)
    shapes = model.param_shapes()
    shards = module_like(shapes, [sh.shard_tensor(x, p.sharding)
                                  for x, p in zip(tree_util.leaves(shapes), plans)])
    opt = AdamW()
    step = make_train_step(model, opt, StepConfig(microbatches=MB), mesh)
    local = B // (shape[0] * shape[1])
    batch = {k: torch.empty((local, S), dtype=torch.int64, device="meta")
             for k in ("tokens", "labels")}
    with record_collectives() as ops:
        step(shards, opt.init(shards), batch)
    return ops, model, mesh


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m"])
def test_pod_matrix_equals_the_planned_count(arch):
    ops, model, mesh = _virtual_step(arch)
    tm = pod_traffic_matrix(ops, 4, 2)
    want = pod_traffic_matrix(dryrun.planned_collectives(model, mesh, microbatches=MB), 4, 2)
    assert np.array_equal(tm, want)
    assert tm[0, 1] == tm[1, 0] > 0 and tm[0, 0] == tm[1, 1] == 0
    model_groups = mesh.groups(("model",)).tolist()
    tp_ops = [o for o in ops if o.groups == model_groups]
    assert tp_ops and all(len({d // 4 for d in g}) == 1 for o in tp_ops for g in o.groups)
    report = tp_report(model, leaf_plans(model, mesh))
    if arch == "llama3-8b":
        assert {"blocks/attn/wq", "blocks/mlp/w_down", "embed", "unembed"} <= set(
            report["megatron"]) and report["gathered"] == []
    else:  # the reduced mamba2's 4 SSD heads split over the model axis of 2
        assert "blocks/ssd/w_out" in report["megatron"] and report["gathered"] == []


_REF_LOWER = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch.steps import (StepConfig, input_shardings, make_train_step,
                                train_state_shardings)
from repro.models.api import build_model
from repro.models.config import ShapeConfig
from repro.optim.adamw import AdamW
from repro.parallel.sharding import param_shardings, use_mesh
from repro.runtime import hlo_traffic as ref
from repro.runtime.hlo_cost import analyze

B, S, MB = (int(a) for a in sys.argv[1:4])
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
cfg = get_arch("llama3-8b").reduced()
model = build_model(cfg)
shape = ShapeConfig(name="t", seq_len=S, global_batch=B, kind="train")
with use_mesh(mesh):
    pshapes = model.param_shapes()
    pshard = param_shardings(mesh, pshapes)
    specs = model.input_specs(shape)
    opt = AdamW()
    step = make_train_step(model, opt, StepConfig(microbatches=MB, remat=True))
    oshapes = jax.eval_shape(lambda p: opt.init(p), pshapes)
    _, oshard = train_state_shardings(mesh, model, opt)
    in_sh = input_shardings(mesh, cfg, shape, specs)
    metr = {k: NamedSharding(mesh, P()) for k in ("loss", "grad_norm", "lr")}
    hlo = jax.jit(step, in_shardings=(pshard, oshard, in_sh),
                  out_shardings=(pshard, oshard, metr)).lower(
        pshapes, oshapes, specs).compile().as_text()
ops = analyze(hlo).collective_ops
print(json.dumps({"tm": ref.pod_traffic_matrix(ops, 4, 2).tolist(),
                  "summary": ref.collective_summary(ops)}))
"""


def test_reference_pod_matrix_on_a_virtual_2x2x2_mesh():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_LOWER, str(B), str(S), str(MB)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    ops, _, _ = _virtual_step("llama3-8b")
    tms = {"reference": np.asarray(ref["tm"]), "port": pod_traffic_matrix(ops, 4, 2)}
    for tm in tms.values():
        assert tm.shape == (2, 2) and tm[0, 1] == tm[1, 0] > 0 and tm[0, 0] == tm[1, 1] == 0
    port_summary = collective_summary(ops)
    print(f"inter-pod bytes a step, reference / port: "
          f"{tms['reference'][0, 1] / tms['port'][0, 1]:.4f} "
          f"({tms['reference'][0, 1]:.0f} / {tms['port'][0, 1]:.0f})")
    for kind in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        r, p = ref["summary"][kind], port_summary[kind]
        print(f"  {kind}: reference {r['count']} ops {r['wire_bytes_per_chip']:.0f} B/chip, "
              f"port {p['count']} ops {p['wire_bytes_per_chip']:.0f} B/chip")


REF_KEYS = {"status", "flops", "hbm_bytes", "unknown_trip_loops", "collectives",
            "pod_tm_bytes", "n_collective_ops", "model_params", "model_params_active",
            "memory_analysis", "arch", "shape", "mesh", "n_devices"}


def test_full_size_mamba2_cell_on_the_production_mesh(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    rec = dryrun.run_cell("mamba2-130m", "train_4k", True, microbatches=1, tag="mb1")
    assert rec["status"] == "ok", rec.get("traceback")
    assert REF_KEYS <= set(rec) and rec["unknown_trip_loops"] == 0
    assert {"argument_bytes", "output_bytes", "temp_bytes"} <= set(rec["memory_analysis"])
    assert rec["memory_analysis"]["temp_bytes"] is None
    assert not {"xla_flops_once", "bytes_accessed", "lower_seconds",
                "compile_seconds"} & set(rec)
    tm = np.asarray(rec["pod_tm_bytes"])
    assert tm.shape == (2, 2) and tm[0, 1] == tm[1, 0] > 0 and tm[0, 0] == 0
    assert rec["flops"] > 0 and rec["n_devices"] == 512 and rec["seconds"] > 0
    # its 24 SSD heads on 16 model ranks, 1 or 2 a rank: w_out on the rank's
    # rows, the convolution read in part (its w_in the rules leave whole)
    assert rec["tensor_parallel"] == {"megatron": ["blocks/ssd/conv_w", "blocks/ssd/w_out"],
                                      "gathered": []}
    assert json.loads(dryrun.cell_path("mamba2-130m", "train_4k", True,
                                       "mb1").read_text()) == rec


def test_decode_cells_are_not_ported_and_skips_are_the_reference(tmp_path, monkeypatch,
                                                                  capsys):
    """Decode cells run the sharded serve step: ``ok`` records with the
    train and prefill records' keys, the cache's bytes a device, and a pod
    matrix equal to the one counted from the shardings alone; the
    reference's skips stay ``skipped``; decode's cache knobs apply to
    decode cells and raise on the others."""
    from repro_torch.models.config import ALL_SHAPES

    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    shapes = {s.name: s for s in ALL_SHAPES}

    def planned(arch, shape, multi_pod, window_cache=False):
        mesh = sh.Mesh((2, 16, 16) if multi_pod else (16, 16),
                       NAMES if multi_pod else NAMES[1:])
        return pod_traffic_matrix(dryrun.planned_collectives(
            Model(get_arch(arch), torch.device("meta")), mesh, "decode", shapes[shape],
            window_cache), 256, 2 if multi_pod else 1)

    # llama3-8b decode_32k: 32 × 2 × 128 × 32768 × 8 × 128 × 2 B = 2^39 B of cache
    for multi_pod, per_device in ((False, 2 ** 31), (True, 2 ** 30)):
        rec = dryrun.run_cell("llama3-8b", "decode_32k", multi_pod)
        assert rec["status"] == "ok", rec.get("traceback")
        assert REF_KEYS <= set(rec) and rec["unknown_trip_loops"] == 0
        assert rec["memory_analysis"]["cache_bytes"] == per_device
        assert (rec["window_cache"], rec["cache_dtype"], rec["ring"]) == (False, "bf16", False)
        assert np.array_equal(np.asarray(rec["pod_tm_bytes"]),
                              planned("llama3-8b", "decode_32k", multi_pod))
        assert rec["flops"] > 0 and "blocks/attn/wq" in rec["tensor_parallel"]["megatron"]
    # long_500k: batch 1, the sequence over every axis — the combine crosses pods
    rec = dryrun.run_cell("mixtral-8x7b", "long_500k", True, window_cache=True)
    assert rec["status"] == "ok" and rec["ring"], rec.get("traceback")
    tm = np.asarray(rec["pod_tm_bytes"])
    assert np.array_equal(tm, planned("mixtral-8x7b", "long_500k", True, True))
    gathers = pod_traffic_matrix(dryrun.planned_collectives(
        Model(get_arch("mixtral-8x7b"), torch.device("meta")),
        sh.Mesh((2, 16, 16), NAMES), "prefill"), 256, 2)
    assert tm[0, 1] == tm[1, 0] > gathers[0, 1] > 0 and tm[0, 0] == 0
    # a ring of the 4096-slot window: 32 × 2 × 4096 × 8 × 128 × 2 B over 512 devices
    assert rec["memory_analysis"]["cache_bytes"] == 2 ** 20
    rec = dryrun.run_cell("mixtral-8x7b", "decode_32k", False, cache_dtype="f8")
    assert rec["status"] == "ok" and rec["cache_dtype"] == "f8"
    assert rec["memory_analysis"]["cache_bytes"] == 2 ** 30  # one byte a value
    rec = dryrun.run_cell("llama3-8b", "long_500k", True)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "qwen3-14b", "--shape", "decode_32k", "--both-meshes"])
    assert done.value.code == 0
    assert "2 ok, 0 skipped, 0 failures" in capsys.readouterr().out
    for knob in ({"window_cache": True}, {"cache_dtype": "f8"}):  # decode's cache knobs
        for shape in ("train_4k", "prefill_32k"):
            with pytest.raises(ValueError, match="decode cell"):
                dryrun.run_cell("mixtral-8x7b", shape, False, force=True, **knob)


def test_bridge_traffic_to_controller(tmp_path):
    """Train step → recorded collectives → pod TM → the controller, as the
    reference's ``test_framework_bridge_traffic_to_controller``."""
    import jax

    from repro.configs import get_arch as ref_get_arch
    from repro.data.pipeline import DataConfig as RefDataConfig
    from repro.data.pipeline import SyntheticLM as RefSyntheticLM
    from repro.launch.mesh import make_host_mesh as ref_host_mesh
    from repro.launch.steps import StepConfig as RefStepConfig
    from repro.models.api import build_model as ref_build_model
    from repro.optim.adamw import AdamW as RefAdamW
    from repro.parallel.sharding import use_mesh as ref_use_mesh
    from repro.runtime.trainer import Trainer as RefTrainer
    from repro.runtime.trainer import TrainerConfig as RefTrainerConfig
    from repro_torch.core import ControllerConfig, Strategy, run_controller
    from repro_torch.core.graph import Fabric
    from repro_torch.core.traffic import Trace
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    arch, dc = "mamba2-130m", dict(seq_len=32, global_batch=4)
    rcfg = ref_get_arch(arch).reduced()
    rmodel, rmesh, ropt = ref_build_model(rcfg), ref_host_mesh(), RefAdamW()
    rtr = RefTrainer(rmodel, ropt, rmesh, RefDataConfig(vocab=rcfg.vocab, **dc),
                     RefStepConfig(), RefTrainerConfig(total_steps=1, devices_per_pod=1),
                     tmp_path / "ref")
    with ref_use_mesh(rmesh):
        rparams = rmodel.init(jax.random.key(0))
        rstate = ropt.init(rparams)
    batch = RefSyntheticLM(RefDataConfig(vocab=rcfg.vocab, **dc)).batch_at(0)
    want = rtr.extract_traffic(rparams, rstate, batch)

    cfg = get_arch(arch).reduced()
    model, opt = build_model(cfg, "cpu"), AdamW()
    tr = Trainer(model, opt, make_host_mesh(), DataConfig(vocab=cfg.vocab, **dc),
                 StepConfig(), TrainerConfig(total_steps=1, devices_per_pod=1), tmp_path)
    params, state = tr.shard(model.init(0))
    tm = tr.extract_traffic(params, state,
                            SyntheticLM(DataConfig(vocab=cfg.vocab, **dc)).batch_at(0))
    assert tm.shape == want.shape == (1, 1) and np.array_equal(tm, want)
    assert tr.collectives == rtr.collectives
    assert not any(p.device.type == "meta" for p in params.parameters())

    v = 4  # a 4-pod fleet trace from the measured intensity, as the reference's
    base = max(float(tm.sum()), 1.0)
    rng = np.random.default_rng(0)
    demand = rng.uniform(0.5, 1.0, (6 * 24, v * (v - 1))) * base
    demand *= 0.5 * 800.0 / demand.max()
    res = run_controller(Fabric.homogeneous("bridge", v, radix=8, speed=100.0),
                         Trace("bridge", demand, 60.0, v), Strategy(False, False),
                         ControllerConfig(routing_interval_hours=12.0,
                                          topology_interval_days=2.0,
                                          aggregation_days=1.0, k_critical=2),
                         device="cpu")
    assert np.isfinite(res.summary["p999_mlu"])

    # a virtual 2-pod mesh: rank 0's tiles, a nonzero pod matrix
    vmesh = sh.Mesh((2, 2, 2), NAMES)
    vtr = Trainer(Model(get_arch("llama3-8b").reduced(), torch.device("cpu")), opt, vmesh,
                  DataConfig(vocab=512, seq_len=S, global_batch=B),
                  StepConfig(microbatches=MB),
                  TrainerConfig(total_steps=1, devices_per_pod=4, n_pods=2), tmp_path / "v")
    vp, vs = vtr.shard(vtr.model.init(0))
    batch = SyntheticLM(vtr.data_config()).batch_at(0)
    tm2 = vtr.extract_traffic(vp, vs, batch)
    assert tm2.shape == (2, 2) and tm2[0, 1] == tm2[1, 0] > 0 and tm2[0, 0] == 0
    assert np.array_equal(tm2, pod_traffic_matrix(
        dryrun.planned_collectives(Model(vtr.model.cfg, torch.device("meta")), vmesh,
                                   microbatches=MB), 4, 2))
    with pytest.raises(ValueError, match="meta"):
        vtr._step_fn(vp, vs, vtr._device_batch(batch))
    assert dataclasses.asdict(vtr.data_config())["n_hosts"] == 4


# the leaves gathered whole over the model axis of 16 (both production
# meshes), by step kind: none in training and prefill (attention whose head
# count the axis does not divide — qwen3-14b's 40 heads, internvl2-1b's 14 —
# and mamba2-130m's 24 SSD heads run on unequal shares of the heads); at
# decode mamba2-130m's SSD state is split over N (the reference's
# cache_shardings), so its split leaves (its convolution and out-projection;
# its 3352-wide w_in the rules leave whole) are read whole
PRODUCTION_GATHERED = {"decode": {"mamba2-130m": ["blocks/ssd/conv_w", "blocks/ssd/w_out"]}}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma3-12b", "llama3-8b", "deepseek-7b",
                                  "dbrx-132b", "mixtral-8x7b", "internvl2-1b",
                                  "recurrentgemma-9b", "seamless-m4t-large-v2",
                                  "mamba2-130m"])
def test_gathered_leaves_on_the_production_meshes(arch, multi_pod):
    from repro_torch.launch.mesh import make_production_mesh

    model = Model(get_arch(arch), torch.device("meta"))
    mesh = make_production_mesh(multi_pod=multi_pod)
    for kind in ("train", "prefill", "decode"):
        report = tp_report(model, leaf_plans(model, mesh, kind))
        assert report["gathered"] == PRODUCTION_GATHERED.get(kind, {}).get(arch, []), kind


def _block_key(ops, model_axis=16):
    """The collectives over a block of the model axis (2 to 15 ranks: a
    replicated KV head, a block of unequal head shares), as a sorted list."""
    return sorted((o.kind, o.result_bytes, o.group_size, str(o.groups), o.dtype)
                  for o in ops if 1 < o.group_size < model_axis)


@pytest.mark.parametrize("arch,shape", [("qwen3-14b", "train_4k"),
                                        ("internvl2-1b", "decode_32k")])
def test_uneven_heads_cells_on_the_production_mesh(arch, shape, tmp_path, monkeypatch):
    """qwen3-14b train_4k (2 or 3 of its 40 heads a model rank) and
    internvl2-1b decode_32k (0 or 1 of its 14; rank 0, the dry run's, holds
    none) on 2×16×16: no leaf gathered; the record's pod matrix and its
    collectives over blocks of the model axis (the head shares' gathers
    and, in training, reduce-scatters, and the replicated KV heads') equal
    ``planned_collectives``; and a device's flops fall from those of the
    same cell with its attention gathered whole (the plan before unequal
    shares)."""
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.config import ALL_SHAPES
    from repro_torch.runtime import hlo_cost

    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    captured = []
    measure = hlo_cost.measure_step

    def spy(*args, **kw):
        cost = measure(*args, **kw)
        captured.append(cost.collective_ops)
        return cost

    monkeypatch.setattr(hlo_cost, "measure_step", spy)
    kw = {"microbatches": 1} if shape == "train_4k" else {}
    rec = dryrun.run_cell(arch, shape, True, **kw)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["tensor_parallel"]["gathered"] == []
    assert {"blocks/attn/wq", "blocks/attn/wo"} <= set(rec["tensor_parallel"]["megatron"])
    cell = {s.name: s for s in ALL_SHAPES}[shape]
    model = Model(get_arch(arch), torch.device("meta"))
    planned = dryrun.planned_collectives(model, make_production_mesh(multi_pod=True),
                                         cell.kind, cell, microbatches=1)
    assert np.array_equal(np.asarray(rec["pod_tm_bytes"]),
                          pod_traffic_matrix(planned, 256, 2))
    assert _block_key(captured[-1]) == _block_key(planned) != []
    splits = steps._group_splits
    monkeypatch.setattr(steps, "_group_splits",
                        lambda cfg, role, m, kind: role != "attn" and splits(cfg, role, m,
                                                                             kind))
    whole = dryrun.run_cell(arch, shape, True, tag="whole_attention", **kw)
    assert whole["status"] == "ok" and "blocks/attn/wq" in whole["tensor_parallel"]["gathered"]
    assert rec["flops"] < whole["flops"]
    print(f"{arch} {shape}: flops a device {rec['flops']:.6e} (attention gathered whole: "
          f"{whole['flops']:.6e}); parameter bytes a device "
          f"{rec['memory_analysis']['gathered_param_bytes']} "
          f"({whole['memory_analysis']['gathered_param_bytes']})")


@pytest.mark.parametrize("multi_pod", [False, True])
def test_dbrx_holds_one_expert_a_model_rank(multi_pod):
    """dbrx-132b's parameter bytes a device, as its layers take them, and
    its float32 gradient bytes in training, counted from the specs alone:
    each leaf whole less its split over the model axis (each of the 8 KV
    heads on 2 of the 16 model ranks) — one of the 16 experts a rank.  Its
    decode_32k cell reads 16,528,650,240 B a device (254,345,687,040 before
    expert parallelism, less 15/16 of the experts' 253,671,505,920 B)."""
    from repro_torch.launch.mesh import make_production_mesh

    model = Model(get_arch("dbrx-132b"), torch.device("meta"))
    mesh = make_production_mesh(multi_pod=multi_pod)
    shapes = model.param_shapes()
    with sh.use_mesh(mesh):
        specs = tree_util.leaves_of(sh.param_shardings(mesh, shapes))
    numel = nbytes = 0
    for path, x, s in zip(sh.param_paths(shapes), tree_util.leaves(shapes), specs):
        split = math.prod(16 for entry in s.spec if entry == "model")
        share = x.numel() // split * (2 if path.endswith(("/wk", "/wv")) else 1)
        numel += share
        nbytes += share * x.element_size()
    experts = 3 * 16 * 6144 * 10752 * 40 * 2
    assert experts == 253_671_505_920
    assert nbytes == 254_345_687_040 - experts * 15 // 16 == 16_528_650_240
    for kind, grads in (("decode", 0), ("train", 4 * numel)):
        assert dryrun.held_param_bytes(model, mesh, kind) == (nbytes, grads)
