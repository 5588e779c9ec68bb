"""Training launcher — the counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 50 \
        [--batch 8] [--seq 128] [--microbatches 1] \
        [--compression none|topk|int8] [--ckpt-dir DIR] [--full] [--device cuda] \
        [--world-size N] [--backend nccl|gloo] [--model-axis M]

Trains the architecture's ``reduced()`` variant unless ``--full``, on the
mesh of :func:`repro_torch.launch.mesh.make_host_mesh` through
:class:`repro_torch.runtime.trainer.Trainer` (FSDP) on the synthetic token
pipeline; prints the run report as JSON.  On CUDA it starts one process per
visible card (``--world-size`` to use fewer), each on its own card, joined
by NCCL; ``--device cpu`` runs the kernels' plain versions in one process,
or in ``--world-size`` processes joined by ``gloo``.  One process trains on
the host mesh of one rank, in this process.  The run resumes from the
latest checkpoint in ``--ckpt-dir``, by default ``build/ckpt/<config name>``
in the checkout (one directory a configuration).  ``--model-axis M`` lays
the ranks out as a (world / M) × M (data, model) mesh: tensor parallelism
over the model axis (FSDP × TP); the report then says which leaves ran
Megatron and which were gathered whole (``tensor_parallel``).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import queue
import socket
import time
import traceback

import numpy as np

__all__ = ["main", "run_ranks"]

_CKPT_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "ckpt"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, backend, port, results, args):
    import torch
    import torch.distributed as dist

    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn, world_size: int, *args, backend: str = "nccl",
              timeout: float = 1800.0) -> list:
    """``fn(rank, world_size, *args)`` in ``world_size`` new processes, one
    rank each of a process group over ``tcp://localhost`` (``nccl``: rank
    ``r`` on card ``r``; ``gloo`` on the CPU).  Returns the ranks' results
    in rank order.  ``fn`` and its results must pickle (``fn`` a function at
    a module's top level).  A rank that raises, or a run past ``timeout``
    seconds, stops every rank and raises ``RuntimeError``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, backend, port, results, args))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failed, done = [None] * world_size, None, set()
    deadline = time.monotonic() + timeout
    try:
        while len(done) < world_size and failed is None:
            try:
                rank, ok, value = results.get(timeout=5.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:  # died before it could report (at start-up, say)
                    failed = f"ranks {dead} of {world_size} exited without a result"
                elif time.monotonic() > deadline:
                    failed = f"{world_size} ranks ran past {timeout} s"
                continue
            if not ok:
                failed = f"rank {rank} of {world_size} failed:\n{value}"
            out[rank] = value
            done.add(rank)
    finally:
        for p in procs:
            if failed is not None and p.is_alive():
                p.terminate()
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if failed is not None:
        raise RuntimeError(failed)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return out


def _train(args, device, ckpt_dir) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device)
    mesh = make_host_mesh(model_axis=args.model_axis)
    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         n_pods=1, devices_per_pod=mesh.size)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    trainer = Trainer(model, opt, mesh, data_cfg,
                      StepConfig(microbatches=args.microbatches,
                                 compression=args.compression),
                      tcfg, ckpt_dir or _CKPT_ROOT / cfg.name)
    trainer.install_signal_handlers()
    out = trainer.run()
    losses = out["losses"]
    report = {
        "arch": cfg.name, "steps": out["last_step"],
        "loss_first": float(np.mean(losses[:5])) if losses else None,
        "loss_last": float(np.mean(losses[-5:])) if losses else None,
        "mean_step_seconds": float(np.mean(out["stats"]["step_times"])),
        "straggler_events": out["stats"]["straggler_events"],
        "preempted": out["preempted"],
        "device": str(model.device),
        "mesh": dict(mesh.shape),
    }
    if mesh.shape["model"] > 1:
        from repro_torch.launch.steps import tp_report

        report["tensor_parallel"] = tp_report(model, trainer._step_fn.plans)
    return report


def _train_rank(rank, world, args, device_type, ckpt_dir):
    return _train(args, f"cuda:{rank}" if device_type == "cuda" else device_type,
                  ckpt_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", default="none")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: build/ckpt/<config name>)")
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--full", action="store_true",
                    help="use the full config (needs the card's memory)")
    ap.add_argument("--report", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--world-size", type=int, default=None,
                    help="ranks (default: every visible card on CUDA, 1 on the CPU)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on CUDA, gloo on the CPU)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks on the mesh's model axis (tensor parallelism)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.world_size is not None:
        world = args.world_size
    else:
        import torch

        world = torch.cuda.device_count() if dev.type == "cuda" else 1
    if world > 1:
        backend = args.backend or ("nccl" if dev.type == "cuda" else "gloo")
        report = run_ranks(_train_rank, world, args, dev.type, args.ckpt_dir,
                           backend=backend)[0]
    else:
        report = _train(args, dev, args.ckpt_dir)
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
