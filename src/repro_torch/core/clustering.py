"""Critical traffic matrices via clustering (paper §4.3) — the counterpart of
``repro/core/clustering.py``.

Gemini abstracts an aggregation window's TMs into ``k`` *critical TMs*:
k-means cluster the TMs, then take the element-wise maximum of each cluster.
The farthest-point seeding is the reference's numpy code, unchanged; the
Lloyd iterations run as PyTorch ops on the device.

The reference runs its Lloyd iterations in JAX's default float type (float32,
or float64 with x64 mode on).  Near-tie assignments flip between the two, and
the critical TMs with them, so :func:`kmeans` takes the dtype explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["critical_tms", "kmeans", "hull_contains"]


def _kmeans_body(x: torch.Tensor, init: torch.Tensor, k: int, iters: int):
    """Lloyd iterations; returns (centroids, assignment)."""
    cents = init
    for _ in range(iters):
        d2 = ((x[:, None, :] - cents[None, :, :]) ** 2).sum(-1)  # (T, k)
        assign = torch.argmin(d2, dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)  # (T, k)
        counts = onehot.sum(0)  # (k,)
        sums = onehot.T @ x  # (k, C)
        cents = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1), cents)
    d2 = ((x[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    return cents, torch.argmin(d2, dim=1)


def kmeans(x: np.ndarray, k: int, iters: int = 25, seed: int = 0,
           dtype: torch.dtype = torch.float32, device=None):
    """k-means with greedy farthest-point init. Returns (centroids, assign)
    as numpy arrays."""
    dev = resolve_device(device)
    x = np.asarray(x, dtype=np.float64)
    t = x.shape[0]
    k = min(k, t)
    rng = np.random.default_rng(seed)
    # farthest-point (k-means++ flavoured, deterministic given seed)
    first = int(rng.integers(t))
    centers = [first]
    d2 = ((x - x[first]) ** 2).sum(-1)
    for _ in range(k - 1):
        nxt = int(np.argmax(d2))
        centers.append(nxt)
        d2 = np.minimum(d2, ((x - x[nxt]) ** 2).sum(-1))
    xt = torch.from_numpy(x).to(device=dev, dtype=dtype)
    cents, assign = _kmeans_body(xt, xt[centers], k, iters)
    return cents.cpu().numpy(), assign.cpu().numpy()


def critical_tms(demand: np.ndarray, k: int = 12, iters: int = 25,
                 seed: int = 0, dtype: torch.dtype = torch.float32,
                 device=None) -> np.ndarray:
    """Compute ``k`` critical TMs (element-wise cluster maxima) of a (T, C)
    window.  Returns ``(k', C)`` with ``k' ≤ k`` (empty clusters dropped,
    duplicate criticals merged)."""
    demand = np.asarray(demand, dtype=np.float64)
    if demand.ndim != 2 or demand.shape[0] == 0:
        raise ValueError("demand must be a non-empty (T, C) array")
    k = max(1, min(k, demand.shape[0]))
    if k == 1:
        return demand.max(axis=0, keepdims=True)
    _, assign = kmeans(demand, k, iters, seed, dtype=dtype, device=device)
    crit = []
    for c in range(k):
        m = assign == c
        if m.any():
            crit.append(demand[m].max(axis=0))
    crit = np.unique(np.asarray(crit), axis=0)
    return crit


def hull_contains(critical: np.ndarray, tm: np.ndarray) -> bool:
    """True if ``tm`` is element-wise dominated by the element-wise max of the
    critical TMs — the (sufficient) containment property the model guarantees
    for every TM of its own window."""
    return bool((tm <= critical.max(axis=0) + 1e-9).all())
