"""Collective accounting: per-collective wire bytes, mesh-axis attribution,
and pod-level traffic-matrix extraction — the counterpart of
``repro/runtime/hlo_traffic.py``.

This is the bridge between the training step and Gemini's core: the same
list of collectives feeds (a) the roofline collective term and (b) the
inter-pod traffic matrix handed to the Gemini controller (per-pod-pair bytes
per step).  The reference reads its collectives from a compiled step's HLO
text; the port has no HLO, and its step issues its collectives by hand
(:mod:`repro_torch.parallel.sharding`), each of which appends one
:class:`CollectiveOp` to every list that :func:`record_collectives` has
open.  The accounting below is the reference's, arithmetic unchanged.

Accounting (ring algorithms, per-chip wire bytes for a group of size g and
result payload of ``size`` bytes):
  all-gather        size · (g-1)/g        (result is the gathered buffer)
  all-reduce        2 · size · (g-1)/g
  reduce-scatter    size · (g-1)          (result is the scattered shard)
  all-to-all        size · (g-1)/g
  collective-permute size
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

__all__ = ["CollectiveOp", "collective_summary", "pod_traffic_matrix",
           "record_collectives", "record", "DTYPE_NAMES"]

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    groups: list  # list of lists of device ids (may be empty if unparsed)
    dtype: str = ""  # the result's element type, in HLO's names ("f32", "bf16")

    def wire_bytes_per_chip(self) -> float:
        g = max(self.group_size, 1)
        s = float(self.result_bytes)
        if g <= 1:
            return 0.0
        if self.kind == "all-gather":
            return s * (g - 1) / g
        if self.kind == "all-reduce":
            return 2.0 * s * (g - 1) / g
        if self.kind == "reduce-scatter":
            return s * (g - 1)
        if self.kind == "all-to-all":
            return s * (g - 1) / g
        return s  # collective-permute


def collective_summary(ops: list) -> dict:
    out: dict = {k: {"count": 0, "result_bytes": 0, "wire_bytes_per_chip": 0.0}
                 for k in _COLLECTIVES}
    for op in ops:
        d = out[op.kind]
        d["count"] += 1
        d["result_bytes"] += op.result_bytes
        d["wire_bytes_per_chip"] += op.wire_bytes_per_chip()
    out["total_wire_bytes_per_chip"] = sum(
        out[k]["wire_bytes_per_chip"] for k in _COLLECTIVES)
    return out


def pod_traffic_matrix(ops: list, devices_per_pod: int, n_pods: int) -> np.ndarray:
    """Project collectives onto a pod-level TM (bytes crossing each pod pair
    per step).  For a group spanning several pods, ring accounting sends each
    pod-cut ``payload/g_pods`` bytes each way per gathered/reduced buffer;
    we attribute uniformly across the pod pairs the group spans.
    """
    tm = np.zeros((n_pods, n_pods))
    for op in ops:
        if not op.groups:
            continue
        for grp in op.groups:
            pods = sorted({d // devices_per_pod for d in grp})
            if len(pods) < 2:
                continue
            per_chip = op.wire_bytes_per_chip()
            chips_per_pod = max(len(grp) // len(pods), 1)
            # bytes leaving each pod ≈ per_chip · chips_in_pod · (frac outside)
            frac_out = (len(pods) - 1) / len(pods)
            pod_bytes = per_chip * chips_per_pod * frac_out
            share = pod_bytes / (len(pods) - 1)
            for i in pods:
                for j in pods:
                    if i != j:
                        tm[i, j] += share
    return tm


# ---- the port's collectives, recorded as they are issued ---------------------

# torch dtype name -> HLO element type (the keys of ``_DTYPE_BYTES``)
DTYPE_NAMES = {
    "bool": "pred", "int8": "s8", "uint8": "u8", "int16": "s16", "uint16": "u16",
    "bfloat16": "bf16", "float16": "f16", "int32": "s32", "uint32": "u32",
    "float32": "f32", "int64": "s64", "uint64": "u64", "float64": "f64",
    "complex64": "c64", "complex128": "c128", "float8_e4m3fn": "f8e4m3fn",
    "float8_e5m2": "f8e5m2",
}

_OPEN: list = []  # the lists of the open ``record_collectives`` contexts


@contextlib.contextmanager
def record_collectives():
    """Collect every collective the port issues inside the block: yields a
    list to which each appends one :class:`CollectiveOp` (its kind, its
    result's bytes and element type, and its replica groups as global
    device ids: a device's row-major index in its mesh).  Contexts nest;
    each open one receives every op."""
    ops: list = []
    _OPEN.append(ops)
    try:
        yield ops
    finally:
        _OPEN.remove(ops)


def record(kind: str, numel: int, dtype: str, groups) -> None:
    """Append one collective to every open record: ``numel`` elements of
    the result, of torch dtype name ``dtype``, over ``groups`` (a (G, S)
    array or list of device-id lists)."""
    if not _OPEN:
        return
    if kind not in _COLLECTIVES:
        raise ValueError(f"unknown collective {kind!r}")
    name = DTYPE_NAMES[dtype]
    groups = [list(map(int, g)) for g in groups]
    op = CollectiveOp(kind=kind, result_bytes=int(numel) * _DTYPE_BYTES[name],
                      group_size=max(len(g) for g in groups), groups=groups,
                      dtype=name)
    for ops in _OPEN:
        ops.append(op)
