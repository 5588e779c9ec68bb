"""In-process structured tracing: spans, events, counters, phase accounting.

The controller stack runs the same logical phases everywhere — plan the
sweep, solve routing, score intervals, evaluate transitions — but until this
module the only timing signal was a handful of ad-hoc ``perf_counter`` pairs
scattered across the engines.  This is the single replacement:

* :func:`span` — a nestable, thread-safe tracing context manager.  Disabled
  (the default) it returns a module-level no-op singleton: no allocation, no
  recording, one flag check — safe to leave in hot host-side paths.  Enabled
  (:func:`enable`), every span lands in an in-process ring buffer as a
  Chrome-``trace_event``-compatible complete event.
* :func:`timed` — like :func:`span` but *always* measures wall time (two
  ``perf_counter_ns`` calls) and exposes ``.seconds`` after exit, recording a
  trace event only when tracing is enabled.  This is what replaces the
  engines' ``t0 = time.perf_counter()`` pairs: the measurement the code needs
  stays unconditional, the trace stream rides along for free.
* :class:`PhaseTimes` — a per-sweep accumulator of ``timed`` sections keyed
  by phase name (``plan`` / ``anchor`` / ``solve`` / ``score`` /
  ``transition``), the source of ``ControllerResult.stage_times``.
* :func:`event` / :func:`counter` — instant events and counter samples for
  controller decisions (topology updates, skips, strategy choices).

The buffer exports as JSONL (:func:`export_jsonl`, one event per line — the
``repro.obs.report`` CLI input) and as Chrome ``trace_event`` JSON
(:func:`export_chrome_trace`, loadable in ``chrome://tracing`` / Perfetto).

Tracing never touches device computation: nothing here is jit-traced, and the
solvers' telemetry is carried on their ordinary outputs — enabling tracing
leaves every numeric result bit-identical (test-enforced).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

__all__ = [
    "enable", "disable", "enabled", "clear", "capacity", "dropped", "span",
    "timed", "event", "counter", "events", "PhaseTimes", "export_jsonl",
    "export_chrome_trace", "read_jsonl", "chrome_trace_events",
]

_DEFAULT_CAPACITY = 65536

_enabled = False
_events: deque = deque(maxlen=_DEFAULT_CAPACITY)  # ring buffer of tuples
_dropped = 0  # events evicted from the full ring buffer since last clear
_tls = threading.local()  # per-thread span nesting depth


def enable(capacity: int | None = None) -> None:
    """Turn tracing on (optionally resizing the ring buffer, which clears it)."""
    global _enabled, _events, _dropped
    if capacity is not None and capacity != _events.maxlen:
        _events = deque(maxlen=capacity)
        _dropped = 0
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    global _dropped
    _events.clear()
    _dropped = 0


def capacity() -> int:
    return _events.maxlen or 0


def dropped() -> int:
    """Events silently evicted because the ring buffer was full.

    A nonzero count means the exported trace is missing its *oldest* events —
    raise the capacity (``enable(capacity=...)``) or export more often.  The
    count rides along in JSONL exports as a ``ph: "M"`` meta record, which
    the ``repro.obs.report`` CLI surfaces as a warning.
    """
    return _dropped


def _append(item: tuple) -> None:
    global _dropped
    if len(_events) == _events.maxlen:
        _dropped += 1
    # deque.append is atomic under the GIL: thread-safe without a lock
    _events.append(item)


def _depth() -> int:
    return getattr(_tls, "depth", 0)


class _NoopSpan:
    """Shared do-nothing span: the disabled fast path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("name", "args", "t0", "depth")

    def __init__(self, name: str, args):
        self.name = name
        self.args = args

    def __enter__(self):
        d = _depth()
        _tls.depth = d + 1
        self.depth = d
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        _tls.depth = self.depth
        _append(("X", self.name, self.t0, dur,
                 threading.get_ident(), self.depth, self.args))
        return False


def span(name: str, **attrs):
    """Trace a code section.  No-op singleton when tracing is disabled."""
    if not _enabled:
        return _NOOP
    return _Span(name, attrs or None)


class _Timed:
    """Always-measuring section: ``.seconds`` is valid after exit; a trace
    event is recorded only when tracing was enabled at entry."""

    __slots__ = ("name", "args", "t0", "seconds", "depth", "_rec", "_acc",
                 "_key")

    def __init__(self, name: str, args, acc=None, key=None):
        self.name = name
        self.args = args
        self.seconds = 0.0
        self._rec = _enabled
        self._acc = acc
        self._key = key

    def __enter__(self):
        if self._rec:
            d = _depth()
            _tls.depth = d + 1
            self.depth = d
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter_ns() - self.t0
        self.seconds = dur * 1e-9
        if self._rec:
            _tls.depth = self.depth
            _append(("X", self.name, self.t0, dur,
                     threading.get_ident(), self.depth, self.args))
        if self._acc is not None:
            self._acc.add(self._key, self.seconds)
        return False


def timed(name: str, **attrs) -> _Timed:
    """Measure a section's wall time unconditionally (``with timed(...) as t``,
    then ``t.seconds``), tracing it when enabled."""
    return _Timed(name, attrs or None)


class PhaseTimes:
    """Accumulates wall time per controller phase.

    ``phases("solve")`` is a context manager that adds its elapsed seconds to
    ``times["solve"]`` (and emits a ``phase.solve`` span when tracing is on);
    ``phases.add("anchor", s)`` folds in externally measured chunks.  The
    engines share the phase-key schema ``plan`` / ``anchor`` / ``solve`` /
    ``score`` / ``transition``.
    """

    __slots__ = ("_t",)

    def __init__(self):
        self._t: dict = {}

    def __call__(self, key: str, name: str | None = None) -> _Timed:
        return _Timed(name or f"phase.{key}", None, acc=self, key=key)

    def add(self, key: str, seconds: float) -> None:
        self._t[key] = self._t.get(key, 0.0) + float(seconds)

    @property
    def times(self) -> dict:
        """Phase → seconds, rounded for JSON friendliness."""
        return {k: round(v, 6) for k, v in self._t.items()}


def event(name: str, **attrs) -> None:
    """Record an instant event (e.g. a controller decision)."""
    if not _enabled:
        return
    _append(("i", name, time.perf_counter_ns(), 0,
             threading.get_ident(), _depth(), attrs or None))


def counter(name: str, value: float) -> None:
    """Record a counter sample (rendered as a counter track in Perfetto)."""
    if not _enabled:
        return
    _append(("C", name, time.perf_counter_ns(), 0,
             threading.get_ident(), 0, {"value": float(value)}))


def events() -> list:
    """Snapshot of the ring buffer as JSONL-shaped record dicts."""
    out = []
    for ph, name, t0, dur, tid, depth, args in list(_events):
        rec = {"ph": ph, "name": name, "ts_us": t0 / 1000.0,
               "dur_us": dur / 1000.0, "tid": tid, "depth": depth}
        if args:
            rec["args"] = args
        out.append(rec)
    return out


def export_jsonl(path=None) -> str:
    """Serialize the buffer as JSONL (one event object per line).

    When events were dropped (ring buffer overflow), a leading ``ph: "M"``
    meta record carries the count so downstream tooling knows the trace is
    incomplete."""
    recs = events()
    if _dropped:
        recs.insert(0, {"ph": "M", "name": "trace.dropped", "ts_us": 0.0,
                        "dur_us": 0.0, "tid": 0, "depth": 0,
                        "args": {"count": _dropped}})
    lines = [json.dumps(rec, default=str) for rec in recs]
    text = "\n".join(lines) + ("\n" if lines else "")
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text)
    return text


def read_jsonl(path) -> list:
    """Load a JSONL trace back into record dicts (the export round-trip)."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def chrome_trace_events(records=None) -> list:
    """Records → Chrome ``trace_event`` array entries."""
    recs = events() if records is None else records
    pid = os.getpid()
    out = []
    for r in recs:
        if r["ph"] == "M":  # repro meta records (e.g. trace.dropped) are not
            continue  # Chrome metadata events — keep them out of the viewer
        ev = {"ph": r["ph"], "name": r["name"], "cat": "repro", "pid": pid,
              "tid": r["tid"], "ts": r["ts_us"]}
        if r["ph"] == "X":
            ev["dur"] = r["dur_us"]
        elif r["ph"] == "i":
            ev["s"] = "t"  # thread-scoped instant
        if r.get("args"):
            ev["args"] = r["args"]
        out.append(ev)
    return out


def export_chrome_trace(path=None, records=None) -> dict:
    """Serialize as Chrome ``trace_event`` JSON (``chrome://tracing`` /
    Perfetto's legacy-JSON loader).  ``records`` defaults to the live buffer,
    or pass :func:`read_jsonl` output to convert a saved JSONL trace."""
    doc = {"traceEvents": chrome_trace_events(records),
           "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc
