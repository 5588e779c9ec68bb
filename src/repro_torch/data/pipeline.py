"""Deterministic, resumable, sharded token pipeline — a copy of
``repro/data/pipeline.py`` (numpy only; ``tests/test_torch_runtime.py`` holds
its batches bit-equal to the reference's).  Batches are numpy arrays; the
trainer moves them to the device.

Design goals (scaled from what a 1000-node fleet needs):
  * **Determinism**: batch at step ``s`` is a pure function of (seed, s) —
    restarts and elastic re-scaling replay identical data without coordination.
  * **Host sharding**: each host materializes only its slice of the global
    batch (``host_id / n_hosts``); on one CPU host this degenerates to the
    full batch.
  * **Resumability**: pipeline state is just the step counter — checkpointed
    with the model.
  * **Prefetch**: a background thread keeps ``prefetch`` batches ready.

The source is a synthetic LM mixture (Zipf unigram + repeated n-gram motifs
so a ~100M model shows a real learning curve), standing in for a tokenized
corpus reader with the same interface.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "Pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 64


class SyntheticLM:
    """Deterministic synthetic corpus: Zipf unigrams + learnable motifs."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        self.motifs = base.integers(
            0, cfg.vocab, size=(cfg.n_motifs, cfg.motif_len))

    def batch_at(self, step: int) -> dict:
        """The (host-local) batch for a global step — pure function of step."""
        cfg = self.cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global batch must divide across hosts")
        local = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        # Zipf-ish unigram stream
        u = rng.random((local, cfg.seq_len + 1))
        toks = np.minimum(
            (cfg.vocab * u ** cfg.zipf_a).astype(np.int64), cfg.vocab - 1)
        # splice in motifs (predictable structure for the model to learn)
        n_splice = max(1, cfg.seq_len // (2 * cfg.motif_len))
        for b in range(local):
            for _ in range(n_splice):
                m = self.motifs[rng.integers(cfg.n_motifs)]
                at = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len)
                toks[b, at : at + cfg.motif_len] = m
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class Pipeline:
    """Prefetching iterator over SyntheticLM with checkpointable state."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2):
        self.source = SyntheticLM(cfg)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            batch = self.source.batch_at(self._next_to_produce)
            step = self._next_to_produce
            self._next_to_produce += 1
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self) -> dict:
        step, batch = self._q.get()
        assert step == self.step, "pipeline out of sync with training step"
        self.step += 1
        return batch

    def state(self) -> dict:
        return {"step": self.step}

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
