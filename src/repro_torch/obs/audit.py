"""Decision audit log: every controller decision with its full input vector
— a copy of ``repro/obs/audit.py`` with its imports rewritten.

Gemini is a monitoring-driven controller: §4.6 decides *when* to reconfigure
(benefit vs disruption, hysteresis, contingency blends) and *which* strategy
to deploy (the operator objective over simulated summaries).  Telemetry that
only records the outcome ("skipped") is useless for operating the system —
what matters is *why*, with enough recorded state to re-derive the decision
offline.  This module is that record:

* :func:`record` appends a structured entry — decision kind, every input the
  decision function consumed, the outcome, and a reason tag — to an
  in-process log.  Disabled (the default) it is a single flag check;
  enabling it changes no numeric code path (same contract as
  :mod:`.trace` / :mod:`.metrics`, test-enforced).
* The log exports as JSONL (:func:`export_jsonl` / :func:`read_jsonl`) —
  one decision per line (the reference's ``obs.health`` reads it).
* Entries are **replayable**: :func:`replay` re-executes the recorded
  decision function (`should_reconfigure`, `pick_best`) from the recorded
  inputs alone, and :func:`verify` checks a whole log reproduces its recorded
  outcomes — the guarantee that the log really carries the full input vector,
  and the offline what-if substrate (edit an input, replay the decision).

Recorded kinds and their input vectors:

* ``should_reconfigure`` — benefit, disruption, hysteresis, the contingency
  blend terms (weight, worst-case benefit/disruption) from
  the failures package, decision, and the veto/apply reason.
* ``pick_best`` — objective, cushion, contingency weight, the per-strategy
  objective values consumed (p99.9 MLU/ALU/loss + ``cont_*`` worst-case
  keys), the chosen strategy with its objective value, and the runner-up
  (the choice if the winner were removed) with its objective value.
"""

from __future__ import annotations

import json
import threading

__all__ = ["enable", "disable", "enabled", "clear", "record", "records",
           "export_jsonl", "read_jsonl", "replay", "verify"]

_enabled = False
_lock = threading.Lock()
_records: list = []
_seq = 0


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    global _seq
    with _lock:
        _records.clear()
        _seq = 0


def record(kind: str, **fields) -> None:
    """Append one decision entry (``seq`` stamps arrival order)."""
    global _seq
    if not _enabled:
        return
    with _lock:
        _records.append({"kind": kind, "seq": _seq, **fields})
        _seq += 1


def records() -> list:
    with _lock:
        return list(_records)


def export_jsonl(path=None) -> str:
    """Serialize the log as JSONL (one decision object per line)."""
    lines = [json.dumps(rec, default=str) for rec in records()]
    text = "\n".join(lines) + ("\n" if lines else "")
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text)
    return text


def read_jsonl(path) -> list:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class _suspended:
    """Recording off for the duration — replaying a decision must not append
    a fresh audit entry (or bump decision counters) for the re-executed
    decision."""

    def __enter__(self):
        from repro_torch.obs import metrics

        global _enabled
        self._was = _enabled
        self._metrics_was = metrics.enabled()
        _enabled = False
        metrics.disable()
        return self

    def __exit__(self, *exc):
        from repro_torch.obs import metrics

        global _enabled
        _enabled = self._was
        if self._metrics_was:
            metrics.enable()
        return False


def replay(rec: dict):
    """Re-execute a recorded decision from its recorded inputs.

    Returns the recomputed outcome: a bool for ``should_reconfigure``, the
    chosen strategy name for ``pick_best``.  Raises ``ValueError`` on an
    unknown kind.
    """
    kind = rec.get("kind")
    if kind == "should_reconfigure":
        from repro_torch.transition.config import should_reconfigure

        with _suspended():
            return should_reconfigure(
                rec["benefit"], rec["disruption"], rec["hysteresis"],
                contingency_weight=rec.get("contingency_weight"),
                benefit_worst=rec.get("benefit_worst"),
                disruption_worst=rec.get("disruption_worst"))
    if kind == "pick_best":
        from repro_torch.core.predictor import pick_best

        with _suspended():
            return pick_best(
                rec["per_strategy"], rec["cushion"],
                objective=rec["objective"],
                contingency_weight=rec.get("contingency_weight"))
    raise ValueError(f"cannot replay audit record of kind {kind!r}")


_OUTCOME_KEY = {"should_reconfigure": "decision", "pick_best": "chosen"}


def verify(recs: list) -> list:
    """Replay every replayable record; return human-readable mismatches.

    An empty return means the log is self-consistent: each recorded input
    vector re-derives its recorded outcome (the replayability guarantee the
    tests enforce on exported logs after a JSONL round-trip).
    """
    problems = []
    for rec in recs:
        key = _OUTCOME_KEY.get(rec.get("kind"))
        if key is None:
            continue
        got = replay(rec)
        want = rec.get(key)
        if got != want:
            problems.append(
                f"seq {rec.get('seq')}: {rec['kind']} replayed to {got!r}, "
                f"recorded {want!r}")
    return problems
