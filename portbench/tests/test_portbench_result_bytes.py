"""The reader of the program's result-copy counter
(``metrics/batch.result_bytes_per_query``) on a hand-made window, on a
window of a program that keeps no such counter, and in a traced run of the
bulk cell on the CPU at a small size."""

import pytest

from portbench import run
from portbench.window import Window

NAME = "batch.result_bytes_per_query"
SMALL = {"n_docs": 1 << 16, "n_queries": 48}
MIX = {"batch_size": 16, "pool_ints": 1 << 22, "warm_queries": 8,
       "trace_queries": 8, "stack_queries": 4}


def _window(stats) -> Window:
    return Window(sent=[(0, 1)] * 4, n_answered=4, kept=[], seconds=1.0,
                  latencies_s=[], stats=stats, timings=None, batches=1,
                  launches=8)


def test_reader_on_a_hand_made_window():
    w = _window({"result_bytes": 6 * 65537 * 4, "n_dispatches": 6})
    assert run.read_metric(NAME, {"window": w}) == pytest.approx(
        6 * 65537 * 4 / 4)


@pytest.mark.parametrize("stats", [{"n_dispatches": 6}, None])
def test_reader_finds_nothing_in_an_older_program(stats):
    """A program without the counter: no value, no error."""
    assert run.read_metric(NAME, {"window": _window(stats)}) is None


def test_traced_bulk_run_reports_result_bytes():
    out = run.run_cell("cw09b-bp128-b16.bulk", 2**31 + 13, 0.2, True,
                       devices=["cpu"], overrides=SMALL,
                       traffic_overrides=MIX)
    assert out["correct"]
    assert out["metrics"][NAME]["value"] > 0
    assert out["metrics"][NAME]["unit"] == "B"
