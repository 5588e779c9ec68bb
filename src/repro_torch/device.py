"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` argument and threads it down to
the tensors it makes; there is no global device state.  ``None`` means the
CUDA device.  There is no fallback: without a card the call raises, and the
caller has to ask for the CPU by name (the tests do).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fleet_rows", "resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """The device a call runs on: ``"cuda"`` unless the caller names another.

    Raises ``RuntimeError`` for a CUDA device when
    ``torch.cuda.is_available()`` is False.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work, so a host clock read after it is true."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fleet_rows(x, rows, backend: str, device=None):
    """A fleet kernel's ``(F, ...)`` operand from the ``(J, ...)`` entries of
    the host array ``x``: row ``r`` is entry ``rows[r]`` (``None``: F = J).

    On ``"torch"`` the J entries go to ``device`` once, in float32, and the
    rows are gathered there; on a host backend they are gathered in numpy.
    """
    if backend != "torch":
        return x if rows is None else np.asarray(x)[rows]
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        resolve_device(device))
    if rows is None:
        return t
    return t[torch.as_tensor(np.asarray(rows, np.int64), device=t.device)]
