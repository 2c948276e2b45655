"""The resident pool's metrics in traced CPU runs of the bulk cells, and the
bounded warm-up of the ``bulk-bounded`` mix."""

import signal
import time
from pathlib import Path

import pytest

from portbench import run
from portbench.modes import pipelined_bounded

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"n_docs": 1 << 16, "n_queries": 48}
MIX = {"batch_size": 16, "pool_ints": 1 << 22, "warm_queries": 8,
       "trace_queries": 8, "stack_queries": 4}
POOL = ("pool.hit_share", "pool.staged_ints_per_query",
        "pool.arena_ms_per_query")


def _run(cell, seed=2**31 + 7, trace=False, mix=MIX):
    return run.run_cell(cell, seed, 0.2, trace, devices=["cpu"],
                        overrides=SMALL, traffic_overrides=mix)


def _listed(cell) -> set:
    """The cell's traced metrics that a CPU run reads (no device trace)."""
    return {m["name"] for m in run.cell_metrics(cell, True)
            if m["source"] != "device_trace"}


@pytest.mark.parametrize("cell", ["cw09b-bp128d4-b0.bulk",
                                  "cw09b-fastpfor-b0.bulk"])
def test_traced_b0_runs_report_the_pool_metrics(cell):
    """A traced run of a B=0 bulk cell reports the resident pool's three
    metrics and the misses' decoded ints, and every metric the cell lists
    but those of the device's trace.  The pool is cut so that its arenas
    outgrow it and lookups miss, as they do at the cells' size."""
    out = _run(cell, trace=True, mix={**MIX, "pool_ints": 1 << 18})
    assert out["correct"]
    assert set(POOL) | {"engine.decoded_ints_per_query"} <= _listed(cell)
    assert _listed(cell) <= set(out["metrics"])
    assert 0 <= out["metrics"]["pool.hit_share"]["value"] < 100
    assert all(out["metrics"][m]["value"] >= 0 for m in POOL)
    assert out["metrics"]["engine.decoded_ints_per_query"]["value"] > 0


def test_traced_b16_run_reads_an_always_hit_pool():
    """On the B=16 bulk cell, whose lists all fit the pool, the window's
    lookups all hit, nothing is staged and no arena row is written."""
    bulk = _run("cw09b-bp128-b16.bulk", trace=True)
    assert bulk["correct"]
    assert bulk["metrics"]["pool.hit_share"]["value"] == 100
    assert bulk["metrics"]["pool.staged_ints_per_query"]["value"] == 0
    assert bulk["metrics"]["pool.arena_ms_per_query"]["value"] == 0


def test_bounded_raises_past_its_limit_and_leaves_no_timer():
    with pytest.raises(TimeoutError, match="warm_limit_s"):
        with pipelined_bounded.bounded(0.05):
            t = time.monotonic()
            while time.monotonic() - t < 5:
                pass
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    with pipelined_bounded.bounded(60):
        pass
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_bounded_warm_up_is_not_timed_on_the_cpu():
    """On the CPU the warm-up runs unbounded, whatever ``warm_limit_s``
    says, and leaves no timer behind."""
    out = _run("cw09b-fastpfor-b0.bulk", mix={**MIX, "warm_limit_s": 1e-3})
    assert out["correct"]
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
