"""FSDP training over ``torch.distributed`` on the CPU: 2 and 4 ``gloo``
ranks (``repro_torch.launch.train.run_ranks``) through
``Trainer(mesh=make_host_mesh())`` on a reduced mamba2 and a reduced llama3,
against one rank in this process on the same global batches.

Contract (the card-vs-CPU train-step tests' of ``tests/test_torch_gpu.py``:
float32, AdamW eps 1e-3): losses within 1e-5 relative, the logical
parameters and moments within 1e-4; every rank reports the same losses; each
rank holds a 1/W share of every sharded leaf.  On 4 ranks also: the step-3
checkpoint (gathered, written by the first rank) restored on one rank bit for
bit; a checkpoint written on one rank restored on 4 bit for bit; a restart
from step 2 bit-equal to the uninterrupted run; ``remesh`` to ranks 0 and 1
keeping the logical state bit for bit (the reference's
``tests/test_runtime.py:125-142`` on one device), with one step there.
The ranks are spawned processes with a 240 s limit.

Tensor parallelism (FSDP × TP, ``make_host_mesh(model_axis=...)``): a
reduced llama3 on (2, 2) and on (1, 4) — Megatron attention, MLP and
vocabulary; on (1, 4) each of its two KV heads replicated over two ranks —,
a reduced qwen3 on (2, 2) (Megatron attention with qk-norm: the norms'
scales, whole on every rank, see only the rank's heads, so their gradients
are summed over the model axis), a reduced recurrentgemma on (2, 2) (its one
KV head replicated over the whole model axis; RG-LRU on the rank's
channels), a reduced mamba2 on (2, 2) (SSD on the rank's heads), a reduced
mixtral on (2, 2) and (1, 4) (expert parallelism: 2 and 1 of its 4 experts
a rank) and a reduced seamless on (2, 2) (the encoder's and decoder's
attention, cross attention, MLPs and vocabulary Megatron; frames from a
numpy seed, since the token pipeline draws none), against one rank on the
same global batches (those of the dp ranks' pipelines), no leaf gathered
whole: the
same contract, losses within 1e-5 relative and the logical state within
1e-4; the collectives recorded in the ``gloo`` run equal, op for op (kind,
result bytes, groups, dtype), those of the same step on a virtual copy of
the mesh on ``meta`` (``Trainer.extract_traffic``); the (2, 2) run's
step-3 checkpoint restores on one rank bit for bit.
"""

import dataclasses
import pathlib
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.steps import StepConfig, make_train_step, module_like
from repro_torch.launch.train import run_ranks
from repro_torch.models.api import build_model
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.runtime.hlo_traffic import record_collectives

torch.set_num_threads(1)

B, S, STEPS = 4, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, eps=1e-3)
LOSS_REL, STATE_TOL = 1e-5, 1e-4


def _cfg(arch):
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32")


def _numpy_state(params, opt_state) -> list:
    return [x.detach().float().numpy().copy() for x in
            tree_util.leaves(params) + [opt_state.step] + tree_util.leaves(opt_state.mu)
            + tree_util.leaves(opt_state.nu)]


def _frames(cfg, step):
    """The encoder-decoder's frame embeddings (B, S, d) of ``step``, from a
    numpy seed (the token pipeline has none)."""
    rng = np.random.default_rng(1000 + step)
    return torch.from_numpy(rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))


def _global_batch(cfg, step, world):
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, n_hosts=world)
    parts = [SyntheticLM(dataclasses.replace(dc, host_id=h)).batch_at(step)
             for h in range(world)]
    batch = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).long()
             for k in parts[0]}
    if cfg.family == "audio":
        batch["frames"] = _frames(cfg, step)
    return batch


def _audio_run(tr, cfg, mesh):
    """``STEPS`` steps of the trainer's step on the dp slice of each global
    batch, frames included (``Trainer.run`` draws tokens alone): the run's
    dict as ``Trainer.run`` returns it."""
    from repro_torch.parallel import sharding as sh

    params, state = tr.shard(tr.model.init(0))
    rows = sh.tile_slice(B // mesh.shape["data"], mesh, ("data",))
    losses = []
    for i in range(STEPS):
        batch = tr._device_batch(SyntheticLM(tr.data_config()).batch_at(i))
        batch["frames"] = _frames(cfg, i)[rows]
        params, state, m = tr._step_fn(params, state, batch)
        losses.append(float(m["loss"]))
    return {"params": params, "opt_state": state, "losses": losses}


def _rank(rank, world, arch, ckdir, one_dir):
    """One rank: 3 steps through the Trainer; on 4 ranks also the restart,
    the 1 → 4 restore and the remesh to 2."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    cfg = _cfg(arch)
    model = build_model(cfg, "cpu")
    mesh = make_host_mesh()

    def trainer():
        return Trainer(model, AdamW(**OPT), mesh,
                       DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B),
                       StepConfig(), TrainerConfig(total_steps=STEPS, checkpoint_every=2),
                       ckdir)

    tr = trainer()
    run = tr.run(resume=False)
    p, o = tr.logical(run["params"], run["opt_state"])
    out = {"losses": run["losses"],
           "shard_numel": [x.numel() for x in tree_util.leaves(run["params"])],
           "state": _numpy_state(p, o) if rank == 0 else None}
    if world != 4:
        return out
    ck = pathlib.Path(ckdir)
    if rank == 0:  # keep the uninterrupted run's step 3 aside for the 4 -> 1 restore
        (ck / "kept").mkdir()
        shutil.move(str(ck / f"step_{STEPS:08d}"), str(ck / "kept"))
    dist.barrier()
    out["restart"] = trainer().run(resume=True)["losses"]
    # a checkpoint written on one rank, restored on four
    fresh = trainer()
    shards, state = fresh.shard(model.init(0))
    got, _ = CheckpointManager(one_dir).restore(
        {"params": shards, "opt": state._asdict()}, shardings=fresh.state_shardings())
    lp, lo = fresh.logical(module_like(shards, tree_util.leaves(got["params"])),
                           AdamWState(**got["opt"]))
    out["one_to_four"] = _numpy_state(lp, lo) if rank == 0 else None
    # elastic downsizing to ranks 0 and 1
    p2, o2 = tr.remesh(make_host_mesh(ranks=[0, 1]), run["params"], run["opt_state"])
    out["remesh_events"] = tr.stats["remesh_events"]
    if p2 is None:
        out["remesh"] = None
        return out
    lp, lo = tr.logical(p2, o2)
    out["remesh"] = all(np.array_equal(a, b) for a, b in
                        zip(_numpy_state(lp, lo), _numpy_state(p, o)))
    batch = tr._device_batch(SyntheticLM(tr.data_config()).batch_at(STEPS))
    _, _, m = tr._step_fn(p2, o2, batch)
    out["remesh_loss"] = float(m["loss"])
    return out


def _one_rank(arch, world):
    """The same steps on one rank, unsharded: (losses, state, final params,
    optimizer state)."""
    cfg = _cfg(arch)
    model = build_model(cfg, "cpu")
    net = model.init(0)
    opt = AdamW(**OPT)
    state = opt.init(net)
    step = make_train_step(model, opt, StepConfig())
    losses = []
    for i in range(STEPS):
        net, state, m = step(net, state, _global_batch(cfg, i, world))
        losses.append(float(m["loss"]))
    return losses, _numpy_state(net, state), net, state


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("arch", ["mamba2-130m", "llama3-8b"])
def test_fsdp_matches_one_rank(tmp_path, arch, world):
    losses, want, net, state = _one_rank(arch, world)
    one_dir = tmp_path / "one"
    CheckpointManager(one_dir).save(STEPS, {"params": net, "opt": state._asdict()})
    ranks = run_ranks(_rank, world, arch, str(tmp_path / "ck"), str(one_dir),
                      backend="gloo", timeout=240)
    got = ranks[0]["losses"]
    assert all(r["losses"] == got for r in ranks)
    for a, b in zip(got, losses):
        assert abs(a - b) <= LOSS_REL * abs(b), (got, losses)
    for a, b in zip(ranks[0]["state"], want):
        np.testing.assert_allclose(a, b, rtol=STATE_TOL, atol=STATE_TOL)
    # each rank holds 1/W of a sharded leaf, a replicated leaf whole
    full = [x.numel() for x in tree_util.leaves(net)]
    for i, n in enumerate(full):
        shares = [r["shard_numel"][i] for r in ranks]
        assert shares == [n] * world or shares == [n // world] * world
    whole = sum(n for i, n in enumerate(full) if ranks[0]["shard_numel"][i] == n)
    assert whole < 0.05 * sum(full)  # norms, biases, scalars
    if world != 4:
        return
    # the 4-rank step-3 checkpoint restored on one rank
    kept = CheckpointManager(tmp_path / "ck" / "kept")
    template = build_model(_cfg(arch), "cpu").init(0)
    restored, meta = kept.restore({"params": template,
                                   "opt": AdamW(**OPT).init(template)._asdict()})
    assert meta["mesh"] == {"data": 4, "model": 1}
    assert all(np.array_equal(a, b) for a, b in zip(
        _numpy_state(restored["params"], AdamWState(**restored["opt"])),
        ranks[0]["state"]))
    # one rank's checkpoint restored on four
    assert all(np.array_equal(a, b) for a, b in
               zip(ranks[0]["one_to_four"], _numpy_state(net, state)))
    assert all(r["restart"] == got[2:] for r in ranks)
    assert [r["remesh"] for r in ranks] == [True, True, None, None]
    assert [r["remesh_events"] for r in ranks] == [1] * 4
    assert np.isfinite(ranks[0]["remesh_loss"])
    assert ranks[0]["remesh_loss"] == ranks[1]["remesh_loss"]


def _op_key(op):
    return (op.kind, op.result_bytes, op.group_size, op.groups, op.dtype)


def _tp_rank(rank, world, arch, model_axis, ckdir):
    """One rank of FSDP × TP: 3 steps through the Trainer, the logical state
    after them, then one more step recorded for real and on ``meta``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    cfg = _cfg(arch)
    mesh = make_host_mesh(model_axis=model_axis)
    tr = Trainer(build_model(cfg, "cpu"), AdamW(**OPT), mesh,
                 DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B), StepConfig(),
                 TrainerConfig(total_steps=STEPS, checkpoint_every=100), ckdir)
    audio = cfg.family == "audio"
    run = _audio_run(tr, cfg, mesh) if audio else tr.run(resume=False)
    p, o = tr.logical(run["params"], run["opt_state"])
    out = {"losses": run["losses"], "state": _numpy_state(p, o) if rank == 0 else None,
           "modes": sorted({pl.mode for pl in tr._step_fn.plans}),
           "shard_numel": [x.numel() for x in tree_util.leaves(run["params"])]}
    batch = tr._device_batch(SyntheticLM(tr.data_config()).batch_at(STEPS))
    if audio:
        from repro_torch.parallel import sharding as sh

        batch["frames"] = _frames(cfg, STEPS)[sh.tile_slice(B // mesh.shape["data"], mesh,
                                                             ("data",))]
    tr.extract_traffic(run["params"], run["opt_state"], batch)
    with record_collectives() as real:
        tr._step_fn(run["params"], run["opt_state"], batch)
    out["ops"] = [_op_key(op) for op in real]
    out["virtual_ops"] = [_op_key(op) for op in tr.collective_ops]
    return out


@pytest.mark.parametrize("arch,model_axis", [("llama3-8b", 2), ("llama3-8b", 4),
                                             ("mamba2-130m", 2), ("qwen3-14b", 2),
                                             ("recurrentgemma-9b", 2), ("mixtral-8x7b", 2),
                                             ("mixtral-8x7b", 4),
                                             ("seamless-m4t-large-v2", 2)])
def test_tensor_parallel_matches_one_rank(tmp_path, arch, model_axis):
    world = 4
    dp = world // model_axis
    losses, want, net, _ = _one_rank(arch, dp)
    ranks = run_ranks(_tp_rank, world, arch, model_axis, str(tmp_path / "ck"),
                      backend="gloo", timeout=240)
    got = ranks[0]["losses"]
    assert all(r["losses"] == got for r in ranks)
    for a, b in zip(got, losses):
        assert abs(a - b) <= LOSS_REL * abs(b), (got, losses)
    for a, b in zip(ranks[0]["state"], want):
        np.testing.assert_allclose(a, b, rtol=STATE_TOL, atol=STATE_TOL)
    assert ranks[0]["modes"] == ["data", "megatron"]  # no leaf gathered whole
    full = [x.numel() for x in tree_util.leaves(net)]
    for i, n in enumerate(full):  # a tile of 1/dp, 1/model_axis or 1/world, or whole
        assert {r["shard_numel"][i] for r in ranks} <= {n, n // dp, n // model_axis,
                                                        n // world}
    for r in ranks:  # what the dry run records is what the ranks issue
        assert r["ops"] and r["ops"] == r["virtual_ops"]
    assert ranks[0]["ops"] == ranks[-1]["ops"]
    if (arch, model_axis) == ("llama3-8b", 2):  # the (2, 2) checkpoint on one rank
        template = build_model(_cfg(arch), "cpu").init(0)
        restored, meta = CheckpointManager(tmp_path / "ck").restore(
            {"params": template, "opt": AdamW(**OPT).init(template)._asdict()})
        assert meta["mesh"] == {"data": 2, "model": 2}
        assert all(np.array_equal(a, b) for a, b in zip(
            _numpy_state(restored["params"], AdamWState(**restored["opt"])),
            ranks[0]["state"]))


def test_train_cli_runs_tensor_parallel(tmp_path, capsys):
    """``python -m repro_torch.launch.train --world-size 4 --model-axis 2``
    on the CPU: four ``gloo`` ranks on a 2×2 (data, model) mesh; the report
    names the mesh and the leaves that ran Megatron."""
    import json

    from repro_torch.launch import train as train_cli

    train_cli.main(["--arch", "llama3-8b", "--steps", "2", "--batch", "4", "--seq", "16",
                    "--device", "cpu", "--world-size", "4", "--model-axis", "2",
                    "--ckpt-dir", str(tmp_path)])
    report = json.loads(capsys.readouterr().out)
    assert report["mesh"] == {"data": 2, "model": 2} and report["steps"] == 2
    assert np.isfinite(report["loss_last"])
    assert {"embed", "blocks/attn/wq", "blocks/mlp/w_down"} <= set(
        report["tensor_parallel"]["megatron"]) and report["tensor_parallel"]["gathered"] == []
