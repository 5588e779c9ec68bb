"""Incremental rolling prediction window over streamed TM intervals — a copy
of ``repro/serve/window.py`` (host-side ingest, numpy).

The offline engines slice ``trace.demand[start - agg : start]`` per epoch —
fine when the whole trace sits in memory, wrong shape for a long-running
service where intervals arrive one at a time and the history is unbounded.

:class:`RollingWindow` keeps exactly the last ``capacity`` intervals in a
preallocated ``(capacity, C)`` ring buffer:

* :meth:`push` is O(C) per interval — one row write plus a running-sum
  update — independent of the window length.  No reallocation, no shifting.
* A running element-wise sum is maintained incrementally (add the new row,
  subtract the evicted one) so the window mean is O(C) at any time; the sum
  is recomputed exactly every ``capacity`` pushes, bounding float drift to
  one window's worth of cancellation error (equality with a fresh recompute
  is test-enforced at 1e-9).
* :meth:`view` materializes the window in chronological order only when a
  re-plan needs it (once per routing epoch, not per interval); when the ring
  has not wrapped yet the view is a zero-copy slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["RollingWindow"]


class RollingWindow:
    """Fixed-capacity chronological window of (C,) demand rows."""

    def __init__(self, capacity: int, n_commodities: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._buf = np.zeros((self.capacity, int(n_commodities)), np.float64)
        self._sum = np.zeros(int(n_commodities), np.float64)
        self._next = 0  # ring slot the next push writes
        self._count = 0  # rows currently held (== capacity once full)
        self._pushes = 0  # total pushes (drives the periodic exact refresh)

    def __len__(self) -> int:
        return self._count

    @property
    def full(self) -> bool:
        return self._count == self.capacity

    def push(self, row: np.ndarray) -> None:
        """Append one interval, evicting the oldest when full.  O(C)."""
        row = np.asarray(row, np.float64)
        if row.shape != (self._buf.shape[1],):
            raise ValueError(
                f"row must be ({self._buf.shape[1]},); got {row.shape}")
        if self._count == self.capacity:  # evict before overwrite
            self._sum -= self._buf[self._next]
        else:
            self._count += 1
        self._buf[self._next] = row
        self._sum += row
        self._next = (self._next + 1) % self.capacity
        self._pushes += 1
        if self._pushes % self.capacity == 0:  # bound running-sum fp drift
            self._sum = self._buf[: self._count].sum(axis=0)

    def view(self) -> np.ndarray:
        """The window in chronological order, oldest first.

        Zero-copy while the ring has not wrapped; one concatenation (the
        unavoidable copy) afterwards.  Callers must not mutate the result.
        """
        if self._count < self.capacity:
            return self._buf[: self._count]
        if self._next == 0:
            return self._buf
        return np.concatenate([self._buf[self._next:], self._buf[: self._next]])

    def mean(self) -> np.ndarray:
        """Element-wise window mean from the running sum.  O(C)."""
        return self._sum / max(self._count, 1)
