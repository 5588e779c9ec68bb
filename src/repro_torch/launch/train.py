"""Training launcher — the counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --steps 50 \
        [--batch 8] [--seq 128] [--microbatches 1] \
        [--compression none|topk|int8] [--ckpt-dir DIR] [--full] [--device cuda]

Trains the architecture's ``reduced()`` variant unless ``--full``, on the
CUDA card unless ``--device`` names another (``--device cpu`` runs the
kernels' plain versions), through :class:`repro_torch.runtime.trainer.Trainer`
on the synthetic token pipeline; prints the run report as JSON.  The run
resumes from the latest checkpoint in ``--ckpt-dir``, by default
``build/ckpt/<config name>`` in the checkout (one directory a
configuration).  The reference's report also carries the step's pod
traffic matrix from its HLO; that extraction is a later slice of the port
(ROADMAP 2.9.4).
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np

__all__ = ["main"]

_CKPT_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "ckpt"


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
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.api import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, args.device)
    opt = AdamW(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                total_steps=args.steps)
    tcfg = TrainerConfig(total_steps=args.steps,
                         checkpoint_every=args.checkpoint_every,
                         n_pods=1, devices_per_pod=1)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    trainer = Trainer(model, opt, None, data_cfg,
                      StepConfig(microbatches=args.microbatches,
                                 compression=args.compression),
                      tcfg, args.ckpt_dir or _CKPT_ROOT / cfg.name)
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
    }
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
