"""Port vs reference: the observability CLIs — ``repro_torch.obs.report``
(per-span self/cumulative time and percentiles of a JSONL trace) and
``repro_torch.obs.health`` (the per-fabric and fleet health table from
metric snapshots and decision-audit logs).

Both are framework-free copies, so the contract is exact: on the same
records, snapshots and audit logs the port's summaries, reports and rendered
tables equal the reference's, and the CLIs give the same exit codes.  The
snapshots come from a controller run of each package with metrics and the
audit on (the port's on the CPU): a gated Gemini sweep (daily topology
updates through the instantaneous §4.6 gate) with failure contingencies,
whose ``failures.*`` gauges ride in the snapshot.
"""

import dataclasses
import json
import time

import jax
import pytest
import torch

from repro import obs as ref_obs
from repro.core import (ControllerConfig, FailureConfig, SolverConfig,
                        Strategy, TransitionConfig, run_controller)
from repro.core.fleet import FLEET_SPECS, make_fabric, make_trace
from repro.obs import audit as ref_audit
from repro.obs import health as ref_health
from repro.obs import metrics as ref_metrics
from repro.obs import report as ref_report
from repro_torch import interop
from repro_torch import obs
from repro_torch.core import run_controller as port_run_controller
from repro_torch.obs import audit, health, metrics, report

torch.set_num_threads(1)

GEMINI = Strategy(nonuniform=True, hedging=True)
GATE_CC = ControllerConfig(
    routing_interval_hours=24.0, topology_interval_days=1.0,
    aggregation_days=2.0, k_critical=4,
    transition=TransitionConfig(n_panels=4, stage_intervals=1,
                                instantaneous=True),
    failures=FailureConfig(n_scenarios=4, p_link=0.1))
SC = SolverConfig(stage1_method="scaled")
SLOS = [("mlu", 1.0), ("mlu", 0.0), ("stretch", 1.2)]
KMEANS_DTYPE = "float64" if jax.config.jax_enable_x64 else "float32"


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with all obs layers of both packages off
    and clean."""
    mods = (obs, metrics, audit, ref_obs, ref_metrics, ref_audit)
    for mod in mods:
        mod.disable()
        mod.clear()
    yield
    for mod in mods:
        mod.disable()
        mod.clear()


# ---- report -----------------------------------------------------------------

RECS = [
    {"ph": "X", "name": "outer", "ts_us": 0.0, "dur_us": 100000.0,
     "tid": 1, "depth": 0},
    {"ph": "X", "name": "inner", "ts_us": 10000.0, "dur_us": 30000.0,
     "tid": 1, "depth": 1},
    {"ph": "X", "name": "inner", "ts_us": 50000.0, "dur_us": 20000.0,
     "tid": 1, "depth": 1},
    {"ph": "X", "name": "other", "ts_us": 0.0, "dur_us": 5000.0, "tid": 2,
     "depth": 0},
    {"ph": "i", "name": "ev", "ts_us": 5.0, "dur_us": 0.0, "tid": 1,
     "depth": 1},
]


def test_report_summarize_matches_reference():
    rows = report.summarize(RECS)
    assert rows == ref_report.summarize(RECS)
    by = {r["name"]: r for r in rows}
    assert by["outer"]["self_ms"] == pytest.approx(50.0)
    assert by["inner"]["count"] == 2
    assert report.format_table(rows) == ref_report.format_table(rows)


def _trace_file(tmp_path, capacity=65536, n_extra=0):
    obs.enable(capacity=capacity)
    obs.clear()
    with obs.span("outer", fabric="F1"):
        with obs.span("inner"):
            time.sleep(0.002)
        obs.event("decision", applied=True)
    obs.counter("queue", 3.0)
    for i in range(n_extra):
        with obs.span(f"s{i}"):
            pass
    path = tmp_path / "t.jsonl"
    obs.export_jsonl(path)
    obs.disable()
    obs.enable(capacity=65536)  # restore the default capacity
    obs.disable()
    return path


def test_report_cli_matches_reference(tmp_path, capsys):
    path = _trace_file(tmp_path)
    outs = []
    for main in (report.main, ref_report.main):
        chrome = tmp_path / "t.chrome.json"
        assert main([str(path), "--chrome", str(chrome)]) == 0
        table = capsys.readouterr().out
        assert json.loads(chrome.read_text())["traceEvents"]
        assert main([str(path), "--json"]) == 0
        outs.append((table, json.loads(capsys.readouterr().out)))
    assert outs[0] == outs[1]
    assert "outer" in outs[0][0] and outs[0][1]["n_events"] == 4


def test_report_cli_warns_of_dropped_events(tmp_path, capsys):
    path = _trace_file(tmp_path, capacity=8, n_extra=20)
    for main in (report.main, ref_report.main):
        assert main([str(path), "--json"]) == 0
        captured = capsys.readouterr()
        assert json.loads(captured.out)["n_dropped"] > 0
        assert "events were dropped" in captured.err


# ---- health -----------------------------------------------------------------

@pytest.fixture(scope="module")
def snapshots():
    """(snapshot, audit records) of the port's and the reference's gated
    sweep with contingencies, metrics and audit on."""
    spec = FLEET_SPECS[0]
    fab = make_fabric(spec)
    trace = make_trace(spec, fab, days=6.0, interval_minutes=240.0)
    out = {}
    for name in ("port", "ref"):
        mets, aud = (metrics, audit) if name == "port" else (ref_metrics,
                                                             ref_audit)
        mets.enable()
        mets.clear()
        aud.enable()
        aud.clear()
        try:
            if name == "port":
                cc = dataclasses.replace(
                    interop.controller_config_from_dict(
                        dataclasses.asdict(GATE_CC)),
                    kmeans_dtype=KMEANS_DTYPE)
                res = port_run_controller(
                    interop.fabric_from_numpy(fab.name, fab.radix, fab.speed),
                    interop.trace_from_numpy(trace.name, trace.demand,
                                             trace.interval_minutes,
                                             trace.n_pods),
                    GEMINI, cc,
                    interop.solver_config_from_dict(dataclasses.asdict(SC)),
                    device="cpu")
            else:
                res = run_controller(fab, trace, GEMINI, GATE_CC, SC)
            out[name] = (res, mets.snapshot(), aud.records())
        finally:
            mets.disable()
            mets.clear()
            aud.disable()
            aud.clear()
    return out


@pytest.mark.parametrize("source", ["port", "ref"])
def test_health_report_matches_reference(snapshots, source):
    res, snap, recs = snapshots[source]
    assert res.transition_log, "the gate must evaluate transitions"
    rep = health.health_report(snap, recs, slos=SLOS)
    assert rep == ref_health.health_report(snap, recs, slos=SLOS)
    assert health.format_report(rep) == ref_health.format_report(rep)
    [row] = rep["fabrics"]
    assert row["n_intervals"] == res.metrics.mlu.shape[0]
    d = row["decisions"]
    assert d["applied"] == res.n_topology_updates
    assert d["skipped"] == res.n_skipped_topology
    assert row["slo_burn"]["mlu>0"] == pytest.approx(1.0)
    gauges = {g["name"] for g in snap["gauges"]}
    assert "failures.cont_worst_p999_mlu" in gauges


def test_port_snapshot_matches_reference_snapshot(snapshots):
    """The port's sweep records what the reference's records: the same
    metric series, the same decisions, the same health table shape."""
    _, snap, recs = snapshots["port"]
    _, ref_snap, ref_recs = snapshots["ref"]
    for kind in ("counters", "gauges", "histograms"):
        assert sorted((m["name"], json.dumps(m["labels"], sort_keys=True))
                      for m in snap[kind]) == \
            sorted((m["name"], json.dumps(m["labels"], sort_keys=True))
                   for m in ref_snap[kind]), kind
    assert [r["kind"] for r in recs] == [r["kind"] for r in ref_recs]
    rep, ref_rep = (health.health_report(s, r, slos=SLOS)
                    for s, r in ((snap, recs), (ref_snap, ref_recs)))
    assert rep["fabrics"][0]["decisions"] == ref_rep["fabrics"][0]["decisions"]


def test_health_cli_matches_reference(snapshots, tmp_path, capsys):
    _, snap, recs = snapshots["port"]
    art = tmp_path / "BENCH_x.json"  # bench-artifact style input
    art.write_text(json.dumps({"rows": [], "_metrics": snap, "_audit": recs}))
    plain = tmp_path / "snap.json"  # plain-snapshot style input
    metrics.export_json(plain, snap)
    aud = tmp_path / "audit.jsonl"
    with open(aud, "w") as fh:
        for r in recs:
            fh.write(json.dumps(r) + "\n")
    runs = [[str(art), "--slo", "mlu=1.0", "--verify-audit"],
            [str(art), str(plain), "--audit", str(aud)],
            [str(art), "--json"]]
    outs = []
    for main in (health.main, ref_health.main):
        got = []
        for argv in runs:
            assert main(argv) == 0
            got.append(capsys.readouterr().out)
        outs.append(got)
    assert outs[0] == outs[1]
    assert "FLEET" in outs[0][0] and "burn(mlu>1)" in outs[0][0]
    merged, merged_recs = health.load_inputs([str(art), str(plain)],
                                             [str(aud)])
    assert len(merged_recs) == 2 * len(recs)
    assert merged == ref_health.load_inputs([str(art), str(plain)],
                                            [str(aud)])[0]
    # --verify-audit fails on a tampered artifact, in both packages
    bad = json.loads(art.read_text())
    gate = [r for r in bad["_audit"] if r["kind"] == "should_reconfigure"]
    assert gate
    gate[0]["decision"] = not gate[0]["decision"]
    art.write_text(json.dumps(bad))
    for main in (health.main, ref_health.main):
        assert main([str(art), "--verify-audit"]) == 1
        assert "AUDIT MISMATCH" in capsys.readouterr().out


def test_health_cli_rejects_non_snapshot_input(tmp_path):
    bogus = tmp_path / "x.json"
    bogus.write_text(json.dumps({"rows": []}))
    with pytest.raises(ValueError, match="neither a metrics snapshot"):
        health.load_inputs([str(bogus)])
    with pytest.raises(ValueError, match="metric=target"):
        health._parse_slos(["mlu"])
