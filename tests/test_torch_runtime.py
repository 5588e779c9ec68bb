"""The port's training runtime: the data pipeline's copy bit-equal to the
reference's, checkpoints (keep-k, atomic renames, the reference's on-disk
layout read and written by both packages), the trainer's restart (llama3-8b
and, as the reference's own tests, mamba2-130m) and learning on the CPU,
mamba2-130m's compressed training learning as the reference's does, and the
multi-card and HLO features of later slices raising."""

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.configs import get_arch as ref_get_arch
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.models.api import build_model as ref_build_model
from repro.optim.adamw import AdamW as RefAdamW
from repro_torch import interop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataConfig, Pipeline, SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import StepConfig
from repro_torch.models.api import build_model
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


@pytest.mark.parametrize("over", [{}, {"n_hosts": 2, "host_id": 1},
                                  {"seed": 7, "zipf_a": 1.5, "motif_len": 4}])
def test_pipeline_copy_is_bit_equal(over):
    kw = dict(vocab=300, seq_len=24, global_batch=4, **over)
    ours, theirs = SyntheticLM(DataConfig(**kw)), RefSyntheticLM(RefDataConfig(**kw))
    np.testing.assert_array_equal(ours.motifs, theirs.motifs)
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    pipe = Pipeline(DataConfig(**kw), start_step=3)
    try:
        np.testing.assert_array_equal(next(pipe)["tokens"], theirs.batch_at(3)["tokens"])
        assert pipe.state() == {"step": 4}
    finally:
        pipe.close()


def test_checkpoint_atomic_keepk(tmp_path):
    cm = CheckpointManager(tmp_path, keep=2)
    state = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)},
             "layers": [{"w": torch.full((2,), float(i))} for i in range(3)]}
    for s in (10, 20, 30):
        cm.save(s, state, meta={"x": s})
    assert cm.latest_step() == 30
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_00000020", "step_00000030"]
    assert not list(tmp_path.glob(".tmp_*")), "no partial writes left behind"
    with np.load(tmp_path / "step_00000030" / "arrays.npz") as npz:
        assert sorted(npz.files) == ["a", "b/c", "layers/w"]
        assert npz["layers/w"].shape == (3, 2)  # stacked as the reference stacks
    restored, meta = cm.restore(state)
    assert torch.equal(restored["a"], state["a"]) and meta == {"step": 30, "x": 30}
    assert [float(layer["w"][0]) for layer in restored["layers"]] == [0.0, 1.0, 2.0]
    # a save interrupted before its rename leaves the latest checkpoint intact
    (tmp_path / ".tmp_40").mkdir()
    assert cm.latest_step() == 30
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(state)


def _states(arch="llama3-8b"):
    """The reference's and the port's trainer state from the same
    parameters and a non-trivial AdamW state (bfloat16 parameters)."""
    ref_cfg = ref_get_arch(arch).reduced()
    cfg = get_arch(arch).reduced()
    ref_params = ref_build_model(ref_cfg).init(jax.random.key(0))
    ref_opt = RefAdamW()
    st = ref_opt.init(ref_params)
    g = jax.tree_util.tree_map(lambda x: (x * 0.5).astype(x.dtype), ref_params)
    _, st, _ = ref_opt.update(g, st, ref_params)
    net = interop.model_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, ref_params),
                                   device="cpu")
    np_st = {"step": np.asarray(st.step), "mu": jax.tree_util.tree_map(np.asarray, st.mu),
             "nu": jax.tree_util.tree_map(np.asarray, st.nu)}
    port_st = interop.adamw_state_from_numpy(np_st, net, device="cpu")
    return ({"params": ref_params, "opt": st._asdict()},
            {"params": net, "opt": port_st._asdict()})


def _assert_same(ref_tree, port_tree):
    ours = {"params": interop.model_to_numpy(port_tree["params"]),
            "opt": {"step": np.asarray(port_tree["opt"]["step"]),
                    "mu": interop.model_to_numpy(port_tree["opt"]["mu"]),
                    "nu": interop.model_to_numpy(port_tree["opt"]["nu"])}}
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(ours))
    for path, leaf in flat:
        x = ours
        for p in path:
            x = x[p.key]
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(leaf, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    ref_state, port_state = _states()
    CheckpointManager(tmp_path).save(5, port_state, meta={"pipeline": {"step": 5}})
    restored, meta = RefCheckpointManager(tmp_path).restore(ref_state)
    assert meta == {"step": 5, "pipeline": {"step": 5}}
    _assert_same(restored, port_state)
    assert restored["params"]["blocks"]["attn"]["wq"].dtype == jax.numpy.bfloat16


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref_state, port_state = _states()
    RefCheckpointManager(tmp_path).save(7, ref_state)
    restored, meta = CheckpointManager(tmp_path).restore(port_state)
    assert meta["step"] == 7
    assert restored["params"]["blocks"][0]["attn"]["wq"].dtype == torch.bfloat16
    assert restored["opt"]["mu"]["blocks"][1]["norm1"].dtype == torch.float32
    _assert_same(ref_state, restored)


def _data_cfg(cfg, batch=4, seq=32):
    return DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch)


def test_trainer_checkpoint_restart(tmp_path):
    """6 steps, then a restart from the step-6 checkpoint to 9: the three
    restarted steps' losses equal those of an uninterrupted 9-step run bit
    for bit (the restored state is the saved one, exactly)."""
    cfg = get_arch("llama3-8b").reduced()
    model = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=20)
    tc = TrainerConfig(total_steps=6, checkpoint_every=3)
    out1 = Trainer(model, opt, None, _data_cfg(cfg), StepConfig(), tc,
                   tmp_path / "a").run(resume=False)
    assert out1["last_step"] == 6 and np.isfinite(out1["losses"]).all()
    tc2 = TrainerConfig(total_steps=9, checkpoint_every=3)
    tr2 = Trainer(model, opt, None, _data_cfg(cfg), StepConfig(), tc2, tmp_path / "a")
    out2 = tr2.run(resume=True)
    assert out2["stats"]["restarts"] == 1 and out2["last_step"] == 9
    assert len(out2["losses"]) == 3, "only the post-restore steps run"
    meta = json.loads((tmp_path / "a" / "step_00000009" / "meta.json").read_text())
    assert meta["pipeline"] == {"step": 9}
    whole = Trainer(model, opt, None, _data_cfg(cfg), StepConfig(), tc2,
                    tmp_path / "b").run(resume=False)
    assert whole["losses"][:6] == out1["losses"]
    assert whole["losses"][6:] == out2["losses"]
    for p, q in zip(tree_util.leaves(whole["params"]), tree_util.leaves(out2["params"])):
        assert torch.equal(p, q)


def test_trainer_checkpoint_restart_ssm(tmp_path):
    """The reference's restart test on its model (``tests/test_runtime.py``:
    mamba2-130m reduced, 6 steps with a checkpoint every 3, then a restart
    to 9), with the port's check that the restarted steps are those of an
    uninterrupted 9-step run, bit for bit."""
    cfg = get_arch("mamba2-130m").reduced()
    model = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-3, warmup_steps=2, total_steps=20)
    tc = TrainerConfig(total_steps=6, checkpoint_every=3, n_pods=1, devices_per_pod=1)
    out1 = Trainer(model, opt, None, _data_cfg(cfg), StepConfig(), tc,
                   tmp_path / "a").run(resume=False)
    assert out1["last_step"] == 6 and np.isfinite(out1["losses"]).all()
    tc2 = TrainerConfig(total_steps=9, checkpoint_every=3, n_pods=1, devices_per_pod=1)
    out2 = Trainer(model, opt, None, _data_cfg(cfg), StepConfig(), tc2,
                   tmp_path / "a").run(resume=True)
    assert out2["stats"]["restarts"] == 1 and out2["last_step"] == 9
    assert len(out2["losses"]) == 3, "only the post-restore steps run"
    whole = Trainer(model, opt, None, _data_cfg(cfg), StepConfig(), tc2,
                    tmp_path / "b").run(resume=False)
    assert whole["losses"] == out1["losses"] + out2["losses"]


def test_compressed_training_still_learns(tmp_path):
    """The reference's test on mamba2-130m reduced: 25 steps with int8
    gradient compression, the last five losses below the first five."""
    cfg = get_arch("mamba2-130m").reduced()
    model = build_model(cfg, device="cpu")
    opt = AdamW(lr=3e-3, warmup_steps=5, total_steps=40)
    tc = TrainerConfig(total_steps=25, checkpoint_every=100)
    out = Trainer(model, opt, None, _data_cfg(cfg, batch=8, seq=64),
                  StepConfig(compression="int8"), tc, tmp_path).run(resume=False)
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])


def test_trainer_loss_decreases(tmp_path):
    cfg = dataclasses.replace(get_arch("internvl2-1b").reduced(), family="dense",
                              frontend="", frontend_tokens=0, name="tiny-dense")
    model = build_model(cfg, device="cpu")
    opt = AdamW(lr=1e-2, warmup_steps=5, total_steps=60, grad_clip=1.0)
    tc = TrainerConfig(total_steps=40, checkpoint_every=100, log_every=100)
    out = Trainer(model, opt, None, _data_cfg(cfg, batch=8, seq=64), StepConfig(), tc,
                  tmp_path).run(resume=False)
    first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last < first - 0.2, f"no learning: {first:.3f} -> {last:.3f}"


def test_train_cli_defaults(tmp_path, monkeypatch, capsys):
    """The launcher's defaults train (llama3-8b) and checkpoint inside the
    checkout, one directory per configuration, so runs of two checkouts or
    two configurations never resume from each other's checkpoints."""
    root = pathlib.Path(__file__).resolve().parents[1]
    assert train_cli._CKPT_ROOT == root / "build" / "ckpt"
    monkeypatch.setattr(train_cli, "_CKPT_ROOT", tmp_path)
    argv = ["--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"]
    train_cli.main(argv)
    report = json.loads(capsys.readouterr().out)
    assert report["arch"] == "llama3-8b-reduced" and report["steps"] == 2
    assert np.isfinite(report["loss_last"])
    assert (tmp_path / "llama3-8b-reduced" / "step_00000002").is_dir()
    argv[1] = "3"
    train_cli.main(argv)  # resumes from step 2 in the same directory
    assert json.loads(capsys.readouterr().out)["steps"] == 3
    assert sorted(p.name for p in (tmp_path / "llama3-8b-reduced").iterdir()) == [
        "step_00000002", "step_00000003"]


def test_train_cli_trains_the_ssm_family(tmp_path, capsys):
    """``--arch mamba2-130m`` trains (the SSD chunk scan's backward)."""
    train_cli.main(["--arch", "mamba2-130m", "--steps", "2", "--batch", "2", "--seq",
                    "16", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    report = json.loads(capsys.readouterr().out)
    assert report["arch"] == "mamba2-130m-reduced" and report["steps"] == 2
    assert np.isfinite(report["loss_last"])


def test_later_slices_raise(tmp_path):
    """What the dry-run slice lifted now runs, as the reference's does: a
    Trainer on a mesh with a model axis builds its FSDP × TP step, and
    ``extract_traffic`` on one host gives the reference's (1, 1) matrix
    and collective summary (no collective on one device).  A decode step
    passes ``check_executable`` on that mesh too."""
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
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.parallel.sharding import Mesh, check_executable

    cfg = get_arch("llama3-8b").reduced()
    model = build_model(cfg, device="cpu")
    tp = Trainer(model, AdamW(), Mesh((1, 2), ("data", "model")), _data_cfg(cfg),
                 StepConfig(), TrainerConfig(), tmp_path / "tp")
    assert {p.mode for p in tp._step_fn.plans} == {"data", "megatron"}
    check_executable(tp.mesh, "decode")  # decode under tensor parallelism

    rcfg = ref_get_arch("llama3-8b").reduced()
    rmodel, rmesh, ropt = ref_build_model(rcfg), ref_host_mesh(), RefAdamW()
    dc = dict(vocab=cfg.vocab, seq_len=16, global_batch=2)
    rtr = RefTrainer(rmodel, ropt, rmesh, RefDataConfig(**dc), RefStepConfig(),
                     RefTrainerConfig(total_steps=1), tmp_path / "ref")
    with ref_use_mesh(rmesh):
        rparams = rmodel.init(jax.random.key(0))
        want = rtr.extract_traffic(rparams, ropt.init(rparams),
                                   RefSyntheticLM(RefDataConfig(**dc)).batch_at(0))
    tr = Trainer(model, AdamW(), None, _data_cfg(cfg), StepConfig(), TrainerConfig(),
                 tmp_path / "none")
    params = model.init(0)
    tm = tr.extract_traffic(params, AdamW().init(params),
                            SyntheticLM(_data_cfg(cfg)).batch_at(0))
    assert tm.shape == (1, 1) and np.array_equal(tm, want)
    assert tr.collectives == rtr.collectives and tr.pod_tm is tm


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m"])
def test_one_rank_mesh_trains_like_no_mesh(tmp_path, arch):
    """``Trainer(mesh=make_host_mesh())`` in one process (no process group:
    a mesh of one rank, every collective of the FSDP step the identity):
    losses bit-equal to ``mesh=None``'s, the checkpoint's meta records the
    mesh's names and sizes, and ``remesh`` onto another one-rank mesh keeps
    the logical state bit for bit (the reference's
    ``tests/test_runtime.py:125-142``)."""
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_arch(arch).reduced()
    model = build_model(cfg, device="cpu")
    runs = {}
    for name, mesh in (("none", None), ("mesh", make_host_mesh())):
        tr = Trainer(model, AdamW(lr=3e-3, warmup_steps=1), mesh, _data_cfg(cfg),
                     StepConfig(), TrainerConfig(total_steps=3, checkpoint_every=10),
                     tmp_path / name)
        runs[name] = (tr, tr.run(resume=False))
    assert runs["mesh"][1]["losses"] == runs["none"][1]["losses"]
    meta = json.loads((tmp_path / "mesh" / "step_00000003" / "meta.json").read_text())
    assert meta["mesh"] == {"data": 1, "model": 1}
    tr, out = runs["mesh"]
    before = [x.clone() for x in tree_util.leaves(out["params"])]
    params, opt_state = tr.remesh(make_host_mesh(), out["params"], out["opt_state"])
    assert tr.stats["remesh_events"] == 1
    assert all(torch.equal(a, b) for a, b in zip(before, tree_util.leaves(params)))
    assert int(opt_state.step) == 3
