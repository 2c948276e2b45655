"""The readers of the program's spans and sync counter
(``metrics/batch.*_ms_per_query``, ``metrics/engine.*_ms_per_query``,
``metrics/engine.syncs_per_query``) on a hand-made window, on a window of
a program that keeps none of them, and in a traced run of each cell on the
CPU at a small size; and an idle gap named by a program span."""

import pytest

from portbench import run, tracing
from portbench.window import Window
from repro_torch.index import pipeline

SMALL = {"n_docs": 1 << 16, "n_queries": 48}
MIX = {"batch_size": 16, "pool_ints": 1 << 22, "warm_queries": 8,
       "trace_queries": 8, "stack_queries": 4}
SPANS = {"engine.decode": 0.02, "engine.fold": 0.03,
         "engine.compact": 0.01, "engine.result": 0.004}
# reader: its value on the hand-made window of 4 answers
WANT = {"batch.wait_ms_per_query": 1e3 * 0.5 / 4,
        "batch.collect_ms_per_query": 1e3 * 0.25 / 4,
        "engine.decode_ms_per_query": 1e3 * 0.02 / 4,
        "engine.fold_ms_per_query": 1e3 * 0.03 / 4,
        "engine.compact_ms_per_query": 1e3 * 0.01 / 4,
        "engine.syncs_per_query": 26 / 4}
CELL_OF = {"batch.wait_ms_per_query": "cw09b-bp128-b16.bulk",
           "batch.collect_ms_per_query": "cw09b-bp128-b16.bulk"}


def _window(stats, timings) -> Window:
    return Window(sent=[(0, 1)] * 4, n_answered=4, kept=[], seconds=1.0,
                  latencies_s=[], stats=stats, timings=timings, batches=1,
                  launches=8)


class _OldTimings:
    """A ``StageTimings`` without the wait and collect split."""
    stage = assemble = dispatch = block = 0.25
    batches = 1


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_hand_made_window(name):
    w = _window({"span_s": dict(SPANS), "span_n": {}, "syncs": 26},
                pipeline.StageTimings(block=0.75, wait=0.5, collect=0.25))
    assert run.read_metric(name, {"window": w}) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_finds_nothing_in_an_older_program(name):
    """A program without the spans or the counter: no value, no error."""
    for w in (_window({"decoded_ints": 5}, _OldTimings()),
              _window(None, None)):
        assert run.read_metric(name, {"window": w}) is None


@pytest.mark.parametrize("cell", ["cw09b-bp128-b16.bulk",
                                  "cw09b-bp128-b16.seq",
                                  "cw09b-fastpfor-b0.seq"])
def test_traced_run_reports_the_new_metrics(cell):
    out = run.run_cell(cell, 2**31 + 11, 0.2, True, devices=["cpu"],
                       overrides=SMALL, traffic_overrides=MIX)
    assert out["correct"]
    new = [n for n in WANT if CELL_OF.get(n, "seq") in cell]
    assert new and all(out["metrics"][n]["value"] > 0 for n in new)


def test_idle_gap_named_by_a_program_span(monkeypatch):
    """A gap over ``collect_batch``'s host work is put down to its span,
    where it said ``python`` before."""
    def ev(name, on_dev, a, b, py=False):
        return (name, on_dev, float(a), float(b), 1, 0 if on_dev else -1, py)

    events = [ev(tracing.SPAN_PREFIX + "stacks", False, 0, 100),
              ev("kernel", True, 0, 40),
              ev("repro_torch/index/batch.py(800): collect_batch", False, 40,
                 100, py=True),
              ev("repro_torch.batch.collect", False, 45, 95)]
    monkeypatch.setattr(tracing, "_trace_events", lambda prof: events)
    gaps = dict(tracing.idle_gaps(None, "stacks"))
    assert gaps == {"index/batch.py(800): collect_batch: "
                    "repro_torch.batch.collect": 60 / 1e6}
