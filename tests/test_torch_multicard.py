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


def _global_batch(cfg, step, world):
    dc = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B, n_hosts=world)
    parts = [SyntheticLM(dataclasses.replace(dc, host_id=h)).batch_at(step)
             for h in range(world)]
    return {k: torch.from_numpy(np.concatenate([p[k] for p in parts])).long()
            for k in parts[0]}


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
