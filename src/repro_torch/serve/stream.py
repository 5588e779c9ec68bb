"""TM interval streams: the ingest side of the online controller — a copy of
``repro/serve/stream.py`` with its imports rewritten.

A :class:`TMStream` presents traffic-matrix intervals one at a time, with the
measurement cadence and pod count the controller needs to derive its epoch
arithmetic.  The replay constructor (:meth:`TMStream.from_trace`) wraps a
recorded :class:`~repro_torch.core.traffic.Trace` — the path the parity
tests and ``chip_smoke.py`` drive — but any ``(T, C)``-row iterable works,
so a live deployment can back a stream with an SNMP collector instead.

Replay can optionally be *paced* (``rate``: stream-seconds per real second)
to exercise the controller at production cadence; the default replays as fast
as the consumer accepts, which is what throughput benchmarking wants.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Iterator

import numpy as np

from repro_torch.core.traffic import Trace

__all__ = ["TMStream", "stream_fleet_fabric"]


@dataclasses.dataclass
class TMStream:
    """An iterator of per-interval TM rows plus the stream's metadata.

    ``interval_minutes`` and ``n_pods`` play the role ``Trace`` plays offline:
    the controller derives its aggregation window and reconfiguration periods
    from the cadence, and validates row width against the pod count.
    """

    name: str
    intervals: Iterator  # yields (C,) demand rows in chronological order
    interval_minutes: float
    n_pods: int

    @property
    def n_commodities(self) -> int:
        return self.n_pods * (self.n_pods - 1)

    def intervals_per_day(self) -> int:
        return int(round(24 * 60 / self.interval_minutes))

    def __iter__(self):
        return iter(self.intervals)

    @classmethod
    def from_trace(cls, trace: Trace, rate: float | None = None) -> "TMStream":
        """Replay a recorded trace as a stream.

        ``rate`` paces the replay: stream-seconds of trace time emitted per
        wall-clock second (e.g. ``rate=900`` replays 15-minute intervals once
        per second).  ``None`` (default) replays as fast as the consumer
        pulls — the benchmarking mode, where sustained intervals/sec is the
        measurement.
        """
        rows = iter(np.asarray(trace.demand))
        if rate is not None:
            rows = _paced(rows, trace.interval_minutes * 60.0 / rate)
        return cls(name=trace.name, intervals=rows,
                   interval_minutes=trace.interval_minutes,
                   n_pods=trace.n_pods)


def _paced(rows, period_s: float):
    """Emit ``rows`` at one per ``period_s`` wall-clock seconds (no drift:
    sleeps target the schedule, not the previous emission)."""
    t0 = time.perf_counter()
    for i, row in enumerate(rows):
        due = t0 + i * period_s
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        yield row


def stream_fleet_fabric(fabric_index: int = 0, days: float = 9.0,
                        interval_minutes: float = 120.0, seed: int = 0,
                        rate: float | None = None):
    """Convenience source: ``(spec, fabric, stream, trace)`` for one synthetic
    fleet fabric (the port's copy, :mod:`repro_torch.core.fleet`).  The
    underlying trace rides along so callers can run the offline engines on
    the identical demand — the replay-parity setup."""
    from repro_torch.core.fleet import FLEET_SPECS, make_fabric, make_trace

    spec = FLEET_SPECS[fabric_index]
    fabric = make_fabric(spec, seed)
    trace = make_trace(spec, fabric, days=days,
                       interval_minutes=interval_minutes, seed=seed)
    return spec, fabric, TMStream.from_trace(trace, rate=rate), trace
