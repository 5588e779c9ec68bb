"""Versioned body/knob table for the kernel autotuner — the counterpart of
``repro/kernels/autotune/table.py``.

The reference's Pallas wrappers and PDHG solver consult one lookup for their
tile sizes (``bt``/``be``/``bc``) and solver knobs (``dual_topk``,
``fleet_batch_quantum``).  Here the knob is the same PDHG ``dual_topk``, and
the counterpart of a tile is the *body* a CUDA entry of kernels #1-#6 takes:
each entry picks one by its own shape cut (``linkload_single_fits``,
``queueloss_single_fits``, ``queueloss_fleet_fits``), which is the table's
default ``"auto"``, and the table may name another body for a shape bucket
(:data:`BODIES`).  Entries are keyed per (kernel family, backend, device
kind, problem-shape bucket) and merged from two layers:

  1. **committed defaults** shipped with the package
     (``repro_torch/kernels/autotune/defaults/<device-kind>.json``), from a
     tuning run on that card; and
  2. a **user cache** (``~/.cache/repro-autotune/torch_table_v<N>.json``,
     override the directory with ``REPRO_AUTOTUNE_CACHE``) written by
     :mod:`repro_torch.kernels.autotune.tuner`, whose entries shadow the
     committed ones key by key.  It is a file of its own beside the
     reference's ``table_v<N>.json``: the two packages never read each
     other's entries.

Every write goes through an atomic tmp-file replace, and any ``OSError``
(read-only home, cache directory shadowed by a file) degrades the table to
memory only: it is a performance hint, never a correctness dependency.  Set
``REPRO_AUTOTUNE=0`` to ignore it and run on the defaults.

Correctness contract: a body entry is recorded only if the tuner found its
outputs bit-identical to the default body's on that shape, so consulting the
table never changes a metric; a ``dual_topk`` entry only if every element's
u* stayed within 2·tol of the default's.
"""

from __future__ import annotations

import functools
import json
import os
import pathlib
import tempfile
import threading

import torch

__all__ = [
    "TABLE_VERSION", "DEFAULT_TILES", "DEFAULT_SOLVER_KNOBS", "BODIES",
    "device_kind", "shape_bucket", "tile_key", "solver_key",
    "TuneTable", "get_table", "reset_table",
    "resolve_tiles", "body_for", "solver_knobs", "pad_to", "shrink_bt",
    "enabled",
]

# bump when the key schema or entry layout changes: old on-disk caches are
# ignored (they keep their own versioned filename) rather than misread
TABLE_VERSION = 1

# "auto": the body the CUDA entry picks by its own shape cut
DEFAULT_TILES = {"body": "auto"}
DEFAULT_SOLVER_KNOBS = {"dual_topk": 128, "fleet_batch_quantum": 16}

# the bodies each kernel family can launch on the card: the link-load
# entries' staged body (a CTA a pair) and batched body (a CTA per 8-row
# T-tile); the queue-loss entries' 8-CTA cluster (one block), fleet body (a
# CTA a pair) and E-tiled body with its partials pass
BODIES = {
    "linkload": ("staged", "batched"),
    "linkload_batched": ("staged", "batched"),
    "linkload_fleet": ("staged", "batched"),
    "queueloss": ("cluster", "fleet", "etiled"),
    "queueloss_batched": ("fleet", "etiled"),
    "queueloss_fleet": ("fleet", "etiled"),
}

_DEFAULTS_DIR = pathlib.Path(__file__).resolve().parent / "defaults"
# bumped by every put and reset: the wrappers' cached lookups expire with it
_generation = 0


def enabled() -> bool:
    """Table lookups are on unless ``REPRO_AUTOTUNE=0`` pins the defaults."""
    return os.environ.get("REPRO_AUTOTUNE", "1") != "0"


def device_kind(device=None) -> str:
    """Sanitized kind of ``device`` (``None`` = CUDA): the CUDA device's
    name, lower-cased with every run of other characters a hyphen
    ("nvidia-h100-80gb-hbm3"), or "cpu"."""
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    kind = torch.cuda.get_device_name(dev)
    return "".join(c if c.isalnum() else "-" for c in kind.lower()).strip("-")


def shape_bucket(n: int) -> int:
    """Next power of two ≥ max(n, 8) — nearby problem sizes share one entry
    (and one tuning run) instead of fragmenting the table per exact shape."""
    b = 8
    while b < n:
        b *= 2
    return b


def tile_key(family: str, backend: str, t: int, c: int, e: int,
             device=None) -> str:
    """Table key for one kernel family's body on ``device``; ``backend`` is
    "cuda" (the kernels) or "plain" (their plain versions on the CPU)."""
    return (f"{family}/{backend}/{device_kind(device)}/"
            f"t{shape_bucket(t)}-c{shape_bucket(c)}-e{shape_bucket(e)}")


def solver_key(v: int, m: int, device=None) -> str:
    """Table key for the PDHG knobs of a (pods, critical-TMs) solver shape."""
    return f"pdhg/{device_kind(device)}/v{shape_bucket(v)}-m{shape_bucket(m)}"


def _cache_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro-autotune"


def _cache_file() -> pathlib.Path:
    return _cache_dir() / f"torch_table_v{TABLE_VERSION}.json"


class TuneTable:
    """Merged committed-defaults + user-cache table with write-through."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict[str, dict] = {}
        self._persist_ok = True
        self._load()

    def _load(self):
        # every committed file (the keys carry their device kind), then the
        # user cache over them
        for path in (*sorted(_DEFAULTS_DIR.glob("*.json")), _cache_file()):
            try:
                self._entries.update(json.loads(path.read_text()))
            except (OSError, ValueError):
                continue

    def get(self, key: str) -> dict | None:
        with self._lock:
            return self._entries.get(key)

    def put(self, key: str, entry: dict, persist: bool = True):
        global _generation
        with self._lock:
            self._entries[key] = dict(entry)
            _generation += 1
            if persist and self._persist_ok:
                self._write()

    def _write(self):
        """Atomic write-through of the entries; any filesystem trouble
        permanently degrades this table to in-memory-only."""
        try:
            cache = _cache_file()
            cache.parent.mkdir(parents=True, exist_ok=True)
            merged: dict = {}
            try:
                merged = json.loads(cache.read_text())
            except (OSError, ValueError):
                pass
            merged.update(self._entries)
            fd, tmp = tempfile.mkstemp(dir=str(cache.parent), suffix=".tmp")
            with os.fdopen(fd, "w") as fh:
                json.dump(merged, fh, indent=1, sort_keys=True)
            os.replace(tmp, cache)
        except OSError:
            self._persist_ok = False

    def entries(self) -> dict:
        with self._lock:
            return dict(self._entries)


_TABLE: TuneTable | None = None
_TABLE_LOCK = threading.Lock()


def get_table() -> TuneTable:
    global _TABLE
    with _TABLE_LOCK:
        if _TABLE is None:
            _TABLE = TuneTable()
        return _TABLE


def reset_table():
    """Drop the singleton (tests repoint ``REPRO_AUTOTUNE_CACHE`` mid-process)."""
    global _TABLE, _generation
    with _TABLE_LOCK:
        _TABLE = None
        _generation += 1


def resolve_tiles(family: str, t: int, c: int, e: int, backend: str = "cuda",
                  body: str | None = None, device=None) -> str:
    """The body of ``family`` at (t, c, e) on ``device``: ``body`` if given
    (a pin), else the table's entry, else "auto" (the entry's own cut)."""
    if body is not None:
        return body
    if enabled():
        entry = get_table().get(tile_key(family, backend, t, c, e, device))
        if entry is not None:
            return str(entry["body"])
    return DEFAULT_TILES["body"]


def body_for(family: str, t: int, c: int, e: int, device) -> str:
    """:func:`resolve_tiles` for a kernel wrapper's launch on the CUDA
    ``device``: one lookup per (shape, table state), cached, so a launch
    pays a dictionary hit and no key formatting."""
    return _body_for(family, t, c, e, device.index, _generation, enabled())


@functools.lru_cache(maxsize=4096)
def _body_for(family, t, c, e, index, generation, on) -> str:
    if not on:
        return DEFAULT_TILES["body"]
    return resolve_tiles(family, t, c, e, device=torch.device("cuda", index))


def solver_knobs(v: int, m: int, device=None) -> dict:
    """PDHG ``dual_topk`` / ``fleet_batch_quantum`` for a solver shape on
    ``device``."""
    out = dict(DEFAULT_SOLVER_KNOBS)
    if enabled():
        entry = get_table().get(solver_key(v, m, device))
        if entry is not None:
            out.update({k: int(entry[k]) for k in out if k in entry})
    return out


# ---- shared tile-geometry helpers (copies of the reference's) ---------------


def pad_to(x, axis: int, mult: int):
    """Zero-pad ``x`` along ``axis`` to the next multiple of ``mult``."""
    import numpy as np

    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x
    width = [(0, 0)] * x.ndim
    width[axis] = (0, pad)
    return np.pad(x, width)


def shrink_bt(bt: int, t: int) -> int:
    """Clamp the time-tile to the (8-aligned) block length: transition drain
    stages and tiny sweeps score blocks of a handful of rows, where a fixed
    128-row tile would be almost entirely padding."""
    return max(8, min(bt, -(-t // 8) * 8))
