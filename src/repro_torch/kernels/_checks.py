"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

__all__ = ["placement", "PLAIN_DEVICES"]

# devices on which a wrapper runs its kernel's plain version: the CPU (the
# values), and ``meta`` (shapes alone: the dry run's virtual mesh)
PLAIN_DEVICES = ("cpu", "meta")


def placement(name: str, dtypes=(torch.float32,), **tensors) -> torch.device:
    """The one device all ``tensors`` lie on, after checking that the kernel
    takes them: contiguous, of one of ``dtypes`` (float32 unless the kernel
    says otherwise), all on the CPU, all on ``meta`` or all on one CUDA
    device.  Raises
    ``ValueError`` otherwise (a wrapper never copies or casts)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in PLAIN_DEVICES + ("cuda",):
        raise ValueError(f"{name}: unsupported device {dev}")
    for arg, t in tensors.items():
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: {arg} must be one of {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev
