"""Fault-tolerant training runtime — the counterpart of
``repro/runtime/trainer.py``, on one card or on a mesh of them.

Kept from the reference:
  * **checkpoint/restart** — periodic atomic checkpoints in the reference's
    layout; ``run`` resumes from the latest one (step, parameters, optimizer
    state and the data pipeline's position);
  * **preemption handling** — SIGTERM/SIGINT set a "save at the next step
    boundary, then exit cleanly" flag;
  * **straggler detection** — an EWMA of the step's wall time and its
    variance; a step slower than ``mean + straggler_sigma·std`` adds to a
    counter.

  * **elastic re-scaling** — ``remesh()`` rebuilds the step on a new mesh
    (a sub-group of the ranks, say) and reshards the live state onto it
    through its logical arrays;
  * **Gemini integration** — ``extract_traffic`` runs one step on ``meta``
    stand-ins of the state on a virtual copy of the mesh, records the
    collectives the step issues (:mod:`repro_torch.runtime.hlo_traffic`)
    and projects them onto the pod-level traffic matrix handed to the
    Gemini controller.

``mesh`` is ``None`` (one card, unsharded) or a mesh of ranks
(:func:`repro_torch.launch.mesh.make_host_mesh`, one process per card):
FSDP × TP, each rank holding its tile of the parameters and of AdamW's
moments (:func:`repro_torch.launch.steps.make_train_step`) and reading the
slice of the global batch of its index over the dp axes (the pipeline's
host sharding, ``n_hosts``/``host_id`` = the dp size and index: ranks that
differ only in their model index read the same slice).  A fresh run on a
mesh draws its tiles straight from the seed
(:func:`repro_torch.launch.steps.init_tiles`): no rank holds the whole
model, so a model no card holds trains on the cards that hold its tiles.
Checkpoints hold the logical state, so any mesh restores them.
"""

from __future__ import annotations

import dataclasses
import signal
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import synchronize
from repro_torch.launch.steps import StepConfig, init_tiles, make_train_step, module_like
from repro_torch.models.api import Model
from repro_torch.optim import tree as tree_util
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.parallel.sharding import (Mesh, axis_index, batch_axes,
                                           check_executable, gather_tensor,
                                           param_shardings, shard_tensor, use_mesh)
from repro_torch.runtime.hlo_traffic import (collective_summary, pod_traffic_matrix,
                                             record_collectives)

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


class Trainer:
    def __init__(self, model: Model, opt: AdamW, mesh, data_cfg: DataConfig,
                 step_cfg: StepConfig, tcfg: TrainerConfig, ckpt_dir):
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
        self.collective_ops = None
        self._build()

    # ---- construction / elastic re-mesh -----------------------------------
    def _build(self):
        self._shardings = None
        if self.mesh is not None:
            check_executable(self.mesh, "train")
            with use_mesh(self.mesh):
                self._shardings = param_shardings(self.mesh, self.model.param_shapes())
        self._step_fn = make_train_step(self.model, self.opt, self.step_cfg, self.mesh)

    def state_shardings(self):
        """The shardings of ``{"params", "opt"}`` (the checkpoint's state) on
        the trainer's mesh, ``None`` without one."""
        if self._shardings is None:
            return None
        return {"params": self._shardings,
                "opt": {"step": None, "mu": self._shardings, "nu": self._shardings}}

    def shard(self, params, opt_state=None):
        """This rank's shards of the logical ``params`` and ``opt_state``
        (``None``: fresh moments of the shards' shapes)."""
        sh = tree_util.leaves_of(self._shardings)

        def cut(tree):
            return [shard_tensor(x, s) for x, s in zip(tree_util.leaves(tree), sh)]

        shards = module_like(params, cut(params))
        if opt_state is None:
            return shards, self.opt.init(shards)
        return shards, AdamWState(
            step=opt_state.step,
            mu=tree_util.unflatten(opt_state.mu, cut(opt_state.mu)),
            nu=tree_util.unflatten(opt_state.nu, cut(opt_state.nu)))

    def logical(self, params, opt_state):
        """The logical (whole) ``params`` and ``opt_state`` on every rank of
        the trainer's mesh (an all-gather: every rank calls it)."""
        if self._shardings is None:
            return params, opt_state
        sh = tree_util.leaves_of(self._shardings)

        def whole(tree):
            return [gather_tensor(x, s) for x, s in zip(tree_util.leaves(tree), sh)]

        return module_like(params, whole(params)), AdamWState(
            step=opt_state.step,
            mu=tree_util.unflatten(opt_state.mu, whole(opt_state.mu)),
            nu=tree_util.unflatten(opt_state.nu, whole(opt_state.nu)))

    def remesh(self, new_mesh, params, opt_state):
        """Elastic re-scale: rebuild the step on ``new_mesh`` and reshard the
        live state onto it through its logical arrays.  Every rank of the old
        mesh calls this; a rank outside the new one gets ``(None, None)``
        and takes no further step."""
        params, opt_state = self.logical(params, opt_state)
        self.mesh = new_mesh
        self.stats["remesh_events"] += 1
        self._build()
        if new_mesh is None:
            return params, opt_state
        if new_mesh.rank_index is None:
            return None, None
        return self.shard(params, opt_state)

    def data_config(self) -> DataConfig:
        """The pipeline's configuration: the slice of the batch of this
        rank's index over the dp axes."""
        if self.mesh is None:
            return self.data_cfg
        axes = batch_axes(self.mesh)
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return dataclasses.replace(self.data_cfg, n_hosts=n,
                                   host_id=axis_index(self.mesh, axes))

    # ---- preemption --------------------------------------------------------
    def install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # ---- Gemini traffic extraction ------------------------------------------
    def extract_traffic(self, params, opt_state, batch):
        """The pod-level traffic matrix of one step: bytes crossing each pod
        pair, from the collectives the step issues.  The step runs on
        ``meta`` stand-ins of ``params``, ``opt_state`` (this rank's tiles on
        a mesh) and ``batch`` (this rank's slice; numpy or tensors), on a
        virtual copy of the trainer's mesh (a one-rank mesh without one),
        under :func:`~repro_torch.runtime.hlo_traffic.record_collectives`;
        the real state is not touched.  Sets ``self.collective_ops`` to the
        ops, ``self.collectives`` to their summary, and returns ``pod_traffic_matrix(ops,
        devices_per_pod, max(n_pods, 1))``, as the reference does."""
        mesh = (Mesh((1, 1), ("data", "model")) if self.mesh is None
                else self.mesh.virtual_copy())
        model = Model(self.model.cfg, torch.device("meta"))

        def meta(x):
            x = torch.as_tensor(x)
            return torch.empty(x.shape, dtype=x.dtype, device="meta")

        shards = module_like(params, [meta(x) for x in tree_util.leaves(params)])
        state = AdamWState(
            step=meta(opt_state.step),
            mu=tree_util.unflatten(opt_state.mu, [meta(x) for x in
                                                  tree_util.leaves(opt_state.mu)]),
            nu=tree_util.unflatten(opt_state.nu, [meta(x) for x in
                                                  tree_util.leaves(opt_state.nu)]))
        step = make_train_step(model, self.opt, self.step_cfg, mesh)

        def meta_input(v):  # token ids as int64; frames and patches as they are
            v = torch.as_tensor(v)
            return meta(v if v.is_floating_point() else v.long())

        with record_collectives() as ops:
            step(shards, state, {k: meta_input(v) for k, v in batch.items()})
        self.collective_ops = ops
        self.collectives = collective_summary(ops)
        self.pod_tm = pod_traffic_matrix(
            ops, self.tcfg.devices_per_pod, max(self.tcfg.n_pods, 1))
        return self.pod_tm

    # ---- main loop -----------------------------------------------------------
    def _device_batch(self, batch: dict) -> dict:
        dev = self.model.device
        return {k: torch.from_numpy(v).to(device=dev, dtype=torch.int64)
                for k, v in batch.items()}

    def run(self, resume: bool = True):
        if self.mesh is not None and self.mesh.rank_index is None:
            raise ValueError("Trainer.run: this rank is not one of the mesh's "
                             f"({self.mesh})")
        if self.mesh is not None:  # every rank draws the same weights, keeps its tiles
            params = init_tiles(self.model, tree_util.leaves_of(self._shardings))
        else:
            params = self.model.init(0)
            params.requires_grad_(True)
        opt_state = self.opt.init(params)
        start = 0
        if resume and self.ckpt.latest_step() is not None:
            opt_state, meta = self._restore(params, opt_state)
            start = meta["step"]
            self.stats["restarts"] += 1
        pipe = Pipeline(self.data_config(), start_step=start)

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
        mesh = None if self.mesh is None else dict(self.mesh.shape)
        self.ckpt.save(step, {"params": params, "opt": opt_state._asdict()},
                       meta={"pipeline": pipe.state(), "mesh": mesh},
                       shardings=self.state_shardings())

    @torch.no_grad()
    def _restore(self, params, opt_state):
        """Read the latest checkpoint into ``params`` (in place; this rank's
        shards on a mesh) and return (the optimizer state, meta)."""
        state, meta = self.ckpt.restore({"params": params, "opt": opt_state._asdict()},
                                        shardings=self.state_shardings())
        for p, x in zip(tree_util.leaves(params), tree_util.leaves(state["params"])):
            p.copy_(x)
        return AdamWState(**state["opt"]), meta
