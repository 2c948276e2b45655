"""A whole run of each cell on the CPU at a small size, past the look for a
card: correct on the program, not correct on the control and on each fault
planted in the timed path.  The runs on the card are in
``test_portbench_card.py``."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from repro_torch.core import intersect as its
from repro_torch.index import batch as batch_lib
from repro_torch.index import engine

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"n_docs": 1 << 16, "n_queries": 48}
MIX = {"batch_size": 16, "pool_ints": 1 << 22, "warm_queries": 8,
       "trace_queries": 8, "stack_queries": 4}
ALL = {**MIX, "check_share": 1.0}     # the faults: every answer checked
CELLS = [w["name"] for w in run.load_json(ROOT / "BENCHMARK.json")["workloads"]]


TINY = {2: (50.0, [200, 600]), 3: (50.0, [200, 400, 800])}


def _run(cell, seed=2**31 + 5, trace=False, mix=MIX, **kw):
    return run.run_cell(cell, seed, 0.2, trace, devices=["cpu"],
                        overrides=SMALL, traffic_overrides=mix, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    out = _run(cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    names = {m["name"] for m in run.cell_metrics(cell, False)}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_traced_run_reports_counters():
    bulk = _run("cw09b-bp128-b16.bulk", trace=True)
    assert bulk["correct"]
    assert bulk["metrics"]["batch.dispatches_per_batch"]["value"] >= 1
    assert "pipeline.host_ms_per_query" in bulk["metrics"]
    seq = _run("cw09b-bp128-b16.seq", trace=True)
    assert seq["metrics"]["engine.decoded_ints_per_query"]["value"] > 0
    for out in (bulk, seq):
        assert out["metrics"]["index.bytes_per_posting"]["value"] > 0
        # the window, the plain slice and the Python-traced slice
        assert out["attempted"] == out["notes"]["window_queries"] + 8 + 4


def test_control_comes_out_not_correct():
    """The float32 control on a 50M-document universe, at a size a test
    holds (a small table of list lengths)."""
    out = run.run_cell("cw09b-bp128-b16.seq", 3, 0.1, False, devices=["cpu"],
                       control=True, traffic_overrides=MIX,
                       overrides={"n_queries": 24, "table": TINY})
    assert not out["correct"] and out["checks"]["wrong_answers"]["value"] > 0


def _altered(results):
    """An answer altered where it is produced: one id dropped."""
    out = list(results)
    for i, r in enumerate(out):
        if r.count:
            out[i] = engine.QueryResult(count=r.count, docs=r.docs[1:])
            break
    return out


FAULTS = {
    "answer_altered": lambda mp: mp.setattr(
        batch_lib, "collect_batch",
        lambda p, _f=batch_lib.collect_batch: _altered(_f(p))),
    "half_the_batch_left_out": lambda mp: mp.setattr(
        batch_lib, "collect_batch",
        lambda p, _f=batch_lib.collect_batch: _f(p)[: p.n_queries // 2]),
    "state_unchanged": lambda mp: mp.setattr(
        batch_lib.ops, "intersect_fold_batch",
        lambda r, valid, folds, active: valid),
}
SEQ_FAULTS = {
    "answer_altered": lambda mp: mp.setattr(
        engine, "query",
        lambda *a, _f=engine.query, **k: _altered([_f(*a, **k)])[0]),
    "state_unchanged": lambda mp: mp.setattr(
        engine.its, "compact", lambda r, mask: (r, int((r != its.SENTINEL).sum()))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_bulk_fault_comes_out_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run("cw09b-bp128-b16.bulk", mix=ALL)
    assert not out["correct"], fault


@pytest.mark.parametrize("fault", sorted(SEQ_FAULTS))
def test_seq_fault_comes_out_not_correct(fault, monkeypatch):
    SEQ_FAULTS[fault](monkeypatch)
    out = _run("cw09b-bp128-b16.seq", mix=ALL)
    assert not out["correct"], fault


def test_no_card_no_result(capsys):
    if run.main.__module__ and __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    a run fails and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from portbench import run; "
            "print(run.run_cell('cw09b-bp128-b16.seq', 1, 0.1, False, "
            "devices=['cpu'], overrides={'n_docs': 4096, "
            "'n_queries': 4}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "repro_torch" in proc.stderr
