"""Fault-tolerant training runtime — the counterpart of
``repro/runtime/trainer.py`` on one card.

Kept from the reference:
  * **checkpoint/restart** — periodic atomic checkpoints in the reference's
    layout; ``run`` resumes from the latest one (step, parameters, optimizer
    state and the data pipeline's position);
  * **preemption handling** — SIGTERM/SIGINT set a "save at the next step
    boundary, then exit cleanly" flag;
  * **straggler detection** — an EWMA of the step's wall time and its
    variance; a step slower than ``mean + straggler_sigma·std`` adds to a
    counter.

``mesh`` keeps its place in the signature and takes only ``None``: sharding
over several cards (and so ``remesh``) is the multi-card slice (ROADMAP
2.3).  ``extract_traffic`` projects a compiled step's collectives through
the HLO tools, a later slice too (ROADMAP 2.9.4).
"""

from __future__ import annotations

import dataclasses
import signal
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import synchronize
from repro_torch.launch.steps import StepConfig, make_train_step
from repro_torch.models.api import Model
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW, AdamWState

__all__ = ["TrainerConfig", "Trainer"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_sigma: float = 3.0
    ema_alpha: float = 0.1
    devices_per_pod: int = 256
    n_pods: int = 1


def _check_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "Trainer: a device mesh (training over several cards) is a later "
            "slice of the port (ROADMAP 2.3); pass mesh=None")


class Trainer:
    def __init__(self, model: Model, opt: AdamW, mesh, data_cfg: DataConfig,
                 step_cfg: StepConfig, tcfg: TrainerConfig, ckpt_dir):
        _check_mesh(mesh)
        self.model = model
        self.opt = opt
        self.mesh = mesh
        self.data_cfg = data_cfg
        self.step_cfg = step_cfg
        self.tcfg = tcfg
        self.ckpt = CheckpointManager(ckpt_dir)
        self._preempted = False
        self.stats = {"straggler_events": 0, "restarts": 0, "remesh_events": 0,
                      "step_times": []}
        self.pod_tm = None
        self.collectives = None
        self._step_fn = make_train_step(model, opt, step_cfg)

    def remesh(self, new_mesh, params, opt_state):
        raise NotImplementedError(
            "Trainer.remesh: elastic re-scaling over a device mesh is a later "
            "slice of the port (ROADMAP 2.3)")

    # ---- preemption --------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def extract_traffic(self, params, opt_state, batch):
        raise NotImplementedError(
            "Trainer.extract_traffic: projecting the step's collectives onto a "
            "pod traffic matrix needs the HLO tools, a later slice of the port "
            "(ROADMAP 2.9.4: the dry-run and HLO tools)")

    # ---- main loop -----------------------------------------------------------
    def _device_batch(self, batch: dict) -> dict:
        dev = self.model.device
        return {k: torch.from_numpy(v).to(device=dev, dtype=torch.int64)
                for k, v in batch.items()}

    def run(self, resume: bool = True):
        params = self.model.init(0)
        params.requires_grad_(True)
        opt_state = self.opt.init(params)
        start = 0
        if resume and self.ckpt.latest_step() is not None:
            opt_state, meta = self._restore(params, opt_state)
            start = meta["step"]
            self.stats["restarts"] += 1
        pipe = Pipeline(self.data_cfg, start_step=start)

        ema_t, ema_v = None, 0.0
        losses = []
        step = start
        try:
            for step in range(start, self.tcfg.total_steps):
                batch = self._device_batch(next(pipe))
                synchronize(self.model.device)
                t0 = time.perf_counter()
                params, opt_state, metrics = self._step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])  # waits for the step
                dt = time.perf_counter() - t0
                self.stats["step_times"].append(dt)
                losses.append(loss)

                # straggler detection (EWMA z-score on step time)
                if ema_t is None:
                    ema_t = dt
                else:
                    a = self.tcfg.ema_alpha
                    ema_v = (1 - a) * (ema_v + a * (dt - ema_t) ** 2)
                    ema_t = (1 - a) * ema_t + a * dt
                    if dt > ema_t + self.tcfg.straggler_sigma * (ema_v ** 0.5 + 1e-9):
                        self.stats["straggler_events"] += 1

                done = step + 1
                if done % self.tcfg.checkpoint_every == 0 or self._preempted \
                        or done == self.tcfg.total_steps:
                    self._save(done, params, opt_state, pipe)
                if self._preempted:
                    break
        finally:
            pipe.close()
        return {"params": params, "opt_state": opt_state, "losses": losses,
                "last_step": step + 1, "stats": self.stats,
                "preempted": self._preempted}

    # ---- checkpoint plumbing ---------------------------------------------------
    def _save(self, step, params, opt_state, pipe):
        self.ckpt.save(step, {"params": params, "opt": opt_state._asdict()},
                       meta={"pipeline": pipe.state(), "mesh": None})

    @torch.no_grad()
    def _restore(self, params, opt_state):
        """Read the latest checkpoint into ``params`` (in place) and return
        (the optimizer state, meta)."""
        state, meta = self.ckpt.restore({"params": params, "opt": opt_state._asdict()})
        for p, x in zip(tree_util.leaves(params), tree_util.leaves(state["params"])):
            p.copy_(x)
        return AdamWState(**state["opt"]), meta
