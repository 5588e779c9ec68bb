"""The port's autotune table and tuner against the contracts of
``tests/test_autotune.py``: shape buckets and ``shrink_bt``, the fallback to
the defaults, the ``REPRO_AUTOTUNE=0`` kill switch, a certified winner that
a separate process resolves from the shared cache, an unwritable cache that
degrades to memory, and body choice never changing an output; plus PDHG's
``dual_topk`` from the table and the solver tuner's convergence gate.  On
the CPU every kernel family has one body (its plain version); the card's
bodies are held in ``tests/test_torch_gpu.py``.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.kernels.autotune as ref_autotune
from repro_torch.core.engine import routing_solver_for
from repro_torch.core.fleet import FLEET_SPECS, make_fabric
from repro_torch.core.pdhg import TorchRoutingSolver
from repro_torch.kernels.autotune import (DEFAULT_SOLVER_KNOBS, DEFAULT_TILES,
                                          get_table, reset_table, resolve_tiles,
                                          shape_bucket, shrink_bt, solver_key,
                                          solver_knobs, tile_candidates,
                                          tile_key, tune_solver, tune_tiles)
from repro_torch.kernels.autotune import table as port_table
from repro_torch.kernels.linkload import ops as ll
from repro_torch.kernels.queueloss import ops as ql

torch.set_num_threads(1)
SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    """Point the table at a private empty cache and drop the singleton."""
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "cache"))
    reset_table()
    yield tmp_path / "cache"
    reset_table()


def _inputs(t=48, c=24, e=24, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(np.asarray(x, np.float32)) for x in (
        rng.gamma(2.0, 10.0, (t, c)), rng.random((c, e)),
        rng.uniform(100.0, 900.0, e), rng.uniform(5.0, 50.0, e)))


def test_shape_bucket_and_shrink_match_reference():
    assert [shape_bucket(n) for n in (1, 8, 9, 100, 128, 129)] == \
        [8, 8, 16, 128, 128, 256]
    assert shrink_bt(128, 3) == 8
    assert shrink_bt(128, 500) == 128
    assert shrink_bt(512, 500) == 504
    for n in range(1, 600, 7):
        assert shape_bucket(n) == ref_autotune.shape_bucket(n)
        assert shrink_bt(128, n) == ref_autotune.shrink_bt(128, n)
    x = np.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(port_table.pad_to(x, 0, 4),
                                  ref_autotune.pad_to(x, 0, 4))
    # the same key schema as the reference's, device kind included
    assert solver_key(12, 12, "cpu") == ref_autotune.solver_key(12, 12)
    assert tile_key("linkload", "pallas", 96, 56, 56, "cpu") == \
        ref_autotune.tile_key("linkload", "pallas", 96, 56, 56)
    assert DEFAULT_SOLVER_KNOBS == ref_autotune.DEFAULT_SOLVER_KNOBS


def test_resolve_falls_back_to_defaults(tmp_cache):
    """Unknown (family, shape) → the entry's own cut; explicit args pin."""
    assert resolve_tiles("nosuchfamily", 512, 132, 132, device="cpu") == \
        DEFAULT_TILES["body"]
    assert resolve_tiles("nosuchfamily", 512, 132, 132, body="batched",
                         device="cpu") == "batched"
    assert solver_knobs(99, 99, "cpu") == DEFAULT_SOLVER_KNOBS


def test_kill_switch_ignores_table(tmp_cache, monkeypatch):
    get_table().put(tile_key("linkload", "cuda", 48, 24, 24, "cpu"),
                    {"body": "batched"}, persist=False)
    get_table().put(solver_key(6, 4, "cpu"), {"dual_topk": 32}, persist=False)
    assert resolve_tiles("linkload", 48, 24, 24, device="cpu") == "batched"
    assert solver_knobs(6, 4, "cpu")["dual_topk"] == 32
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert resolve_tiles("linkload", 48, 24, 24, device="cpu") == "auto"
    assert solver_knobs(6, 4, "cpu") == DEFAULT_SOLVER_KNOBS


def test_tuner_records_certified_winner_and_cache_is_shared(tmp_cache):
    """A tuning run records a bit-identity-certified entry that
    ``resolve_tiles`` then serves, persists it in the port's own cache file,
    and a separate process pointed at the same cache resolves it."""
    entry = tune_tiles("linkload", 48, 24, 24, reps=1, device="cpu")
    assert entry["bit_identical"] is True and entry["body"] == "plain"
    assert entry["tuned_s"] > 0 and entry["default_s"] > 0
    assert resolve_tiles("linkload", 48, 24, 24, backend="plain",
                         device="cpu") == "plain"
    # nearby shapes share the bucket (and therefore the entry)
    assert resolve_tiles("linkload", 40, 20, 20, backend="plain",
                         device="cpu") == "plain"
    files = sorted(p.name for p in tmp_cache.iterdir())
    assert files == ["torch_table_v1.json"]  # never the reference's file
    assert tile_key("linkload", "plain", 48, 24, 24, "cpu") in \
        json.loads((tmp_cache / files[0]).read_text())
    script = textwrap.dedent("""
        from repro_torch.kernels.autotune import resolve_tiles, solver_knobs
        print(resolve_tiles("linkload", 48, 24, 24, backend="plain",
                            device="cpu"), solver_knobs(6, 4, "cpu"))
    """)
    get_table().put(solver_key(6, 4, "cpu"), {"dual_topk": 64,
                                              "fleet_batch_quantum": 16})
    env = dict(os.environ, REPRO_AUTOTUNE_CACHE=str(tmp_cache),
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", script], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[0] == "plain"
    assert "'dual_topk': 64" in r.stdout
    # the reference's table, on the same directory, does not read them
    ref_autotune.reset_table()
    try:
        assert ref_autotune.solver_knobs(6, 4) == ref_autotune.DEFAULT_SOLVER_KNOBS
    finally:
        ref_autotune.reset_table()


def test_unwritable_cache_degrades_to_memory(tmp_path, monkeypatch):
    """Cache dir shadowed by a regular file: writes degrade permanently to
    in-memory, lookups keep working, nothing raises."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(blocker / "cache"))
    reset_table()
    try:
        table = get_table()
        table.put("some/key", {"body": "staged"}, persist=True)
        assert table._persist_ok is False
        assert table.get("some/key") == {"body": "staged"}
        assert resolve_tiles("nosuchfamily", 48, 24, 24, device="cpu") == "auto"
        entry = tune_tiles("queueloss", 48, 24, 24, reps=1, device="cpu")
        assert entry["body"] == "plain"
    finally:
        reset_table()


@pytest.mark.parametrize("family", ["linkload", "queueloss"])
def test_body_choice_never_changes_outputs(tmp_cache, family):
    """On the CPU every body pin and every table entry runs the one plain
    version: the outputs never move a bit, and the tuner records it."""
    d, w, cap, buf = _inputs()
    if family == "linkload":
        def call(**kw):
            return ll.linkload(d, w, 1.0 / cap, 0.8, **kw)
    else:
        def call(**kw):
            return ql.queueloss(d, w, cap, buf, 0.05, **kw)
    ref = call()
    assert tile_candidates(family, 48, 24, 24, "cpu") == ["plain"]
    entry = tune_tiles(family, 48, 24, 24, reps=1, device="cpu")
    get_table().put(tile_key(family, "cuda", 48, 24, 24, "cpu"),
                    {"body": "batched"}, persist=False)
    for kw in ({}, {"body": entry["body"]}, {"body": "staged"},
               {"body": "etiled"}):
        for a, b in zip(ref, call(**kw)):
            assert torch.equal(a, b)


def test_pdhg_dual_topk_comes_from_the_table(tmp_cache, monkeypatch):
    """``TorchRoutingSolver(dual_topk=None)`` and the engines' shared solver
    take the table's knob for their (pods, m) shape; an explicit value pins;
    ``REPRO_AUTOTUNE=0`` gives 128."""
    fab = make_fabric(FLEET_SPECS[16])  # F17, 6 pods: the 8-pod bucket
    assert TorchRoutingSolver(fab, 4, device="cpu").dual_topk == 128
    get_table().put(solver_key(fab.n_pods, 4, "cpu"),
                    {"dual_topk": 32, "fleet_batch_quantum": 16}, persist=False)
    assert TorchRoutingSolver(fab, 4, device="cpu").dual_topk == 32
    assert TorchRoutingSolver(fab, 4, dual_topk=64, device="cpu").dual_topk == 64
    assert routing_solver_for(fab, 4, 100, 1e-2, device="cpu").dual_topk == 32
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    assert TorchRoutingSolver(fab, 4, device="cpu").dual_topk == 128
    assert routing_solver_for(fab, 4, 100, 1e-2, device="cpu").dual_topk == 128


def test_tune_solver_gates_on_convergence(tmp_cache, monkeypatch):
    """A candidate whose u* leaves 2·tol of the default's is rejected,
    however fast; the quantum is recorded as its default; a fresh solver
    resolves the recorded knob."""
    fab = make_fabric(FLEET_SPECS[16])
    core = TorchRoutingSolver._mlu_core
    tol = 1e-2

    def skewed(self, *args):
        f, u, *rest = core(self, *args)
        return (f, u * (1.0 + 3.0 * tol) if self.dual_topk == 32 else u, *rest)

    monkeypatch.setattr(TorchRoutingSolver, "_mlu_core", skewed)
    entry = tune_solver(fab, 2, reps=1, batch=2, device="cpu", max_iters=200,
                        tol=tol, candidates=(32, 64))
    assert entry["rejected"] == [32] and "32" not in entry["candidate_s"]
    assert entry["dual_topk"] in (64, 128)
    assert entry["fleet_batch_quantum"] == DEFAULT_SOLVER_KNOBS["fleet_batch_quantum"]
    assert solver_knobs(fab.n_pods, 2, "cpu")["dual_topk"] == entry["dual_topk"]
    assert TorchRoutingSolver(fab, 2, device="cpu").dual_topk == entry["dual_topk"]


def test_autotune_cli_runs_on_the_card(monkeypatch):
    """``python -m repro_torch.kernels.autotune`` takes the reference's
    ``--tiny`` / ``--reps`` and runs on the CUDA device: without a card it
    raises instead of tuning the CPU."""
    from repro_torch.kernels.autotune import __main__ as cli

    assert set(cli.SHAPES) >= {"tiny", "bench"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--tiny", "--reps", "1"])
    with pytest.raises(SystemExit):
        cli.main(["--no-such-flag"])


def test_committed_h100_defaults_are_certified():
    """The committed H100 entries come from a tuning run on the card: every
    body entry certified bit-identical and launchable by its family, every
    PDHG entry the default 128 or a candidate that met the gate and was
    faster; none of them is read on another device."""
    path = port_table._DEFAULTS_DIR / "nvidia-h100-80gb-hbm3.json"
    entries = json.loads(path.read_text())
    assert entries and all("/nvidia-h100-80gb-hbm3/" in k for k in entries)
    for key, entry in entries.items():
        if key.startswith("pdhg/"):
            k = entry["dual_topk"]
            assert k == DEFAULT_SOLVER_KNOBS["dual_topk"] or (
                str(k) in entry["candidate_s"] and entry["tuned_s"] < entry["default_s"])
            assert entry["fleet_batch_quantum"] == DEFAULT_SOLVER_KNOBS["fleet_batch_quantum"]
        else:
            family = key.split("/")[0]
            assert entry["bit_identical"] is True
            assert entry["body"] in ("auto", *port_table.BODIES[family])
    assert list(port_table.TuneTable().entries()) >= list(entries)
    assert solver_knobs(12, 12, "cpu") == DEFAULT_SOLVER_KNOBS
