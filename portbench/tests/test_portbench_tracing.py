"""The reduction of a profiled slice: busy time as a union of the device's
events, averaged over the cards, and idle gaps named by what the host ran."""

from portbench import tracing

SPAN = tracing.SPAN_PREFIX


def _ev(name, on_dev, a, b, thread=7, dev=-1, py=False):
    return (name, on_dev, float(a), float(b), thread, dev, py)


def _raw(events):
    """``_events``'s form: without the Python-frame flag."""
    return [e[:6] for e in events]


EVENTS = [
    _ev(SPAN + "stacks", False, 0, 100),
    _ev("aten::add", False, 5, 9),
    _ev("kernel_a", True, 10, 30, dev=0),
    _ev("kernel_b", True, 20, 40, dev=0),      # overlaps kernel_a
    _ev("memcpy", True, 60, 70, dev=0),
    _ev("repro_torch/index/batch.py(10): collect_batch", False, 40, 60,
        thread=1, py=True),
    _ev("<built-in method nonzero>", False, 45, 55, thread=1, py=True),
    _ev("repro_torch/index/engine.py(5): query", False, 70, 100, thread=1,
        py=True),
    _ev("aten::nonzero", False, 80, 90),
]


def test_busy_is_a_union_and_gaps_are_named(monkeypatch):
    monkeypatch.setattr(tracing, "_events", lambda prof: _raw(EVENTS))
    monkeypatch.setattr(tracing, "_trace_events", lambda prof: EVENTS)
    got = tracing.read(None, "stacks")
    assert got["busy_s"] == 40 / 1e6            # 10-40 and 60-70
    assert got["window_s"] == 100 / 1e6
    assert got["device_ops"][0] == ["kernel_a", 20 / 1e6]
    gaps = dict(tracing.idle_gaps(None, "stacks"))
    # 0-10: the span, in aten::add; 40-60: collect_batch in nonzero;
    # 70-100: query in aten::nonzero
    assert gaps == {"stacks: aten::add": 10 / 1e6,
                    "index/batch.py(10): collect_batch: "
                    "<built-in method nonzero>": 20 / 1e6,
                    "index/engine.py(5): query: aten::nonzero": 30 / 1e6}


def test_busy_averages_over_the_cards(monkeypatch):
    two = [_ev(SPAN + "slice", False, 0, 100), _ev("k", True, 0, 50, dev=0),
           _ev("k", True, 0, 30, dev=1)]
    monkeypatch.setattr(tracing, "_events", lambda prof: _raw(two))
    assert tracing.read(None, "slice")["busy_s"] == 40 / 1e6


def test_no_device_event_reads_nothing(monkeypatch):
    one = [_ev(SPAN + "slice", False, 0, 10)]
    monkeypatch.setattr(tracing, "_events", lambda prof: _raw(one))
    monkeypatch.setattr(tracing, "_trace_events", lambda prof: one)
    assert tracing.read(None, "slice") is None
    assert tracing.idle_gaps(None, "slice") is None


def test_chrome_trace_holds_the_program_s_frames():
    """The Python-traced slice's events come from the Chrome trace, where
    every torch version keeps the Python tracer's frames."""
    import numpy as np

    from repro_torch.index import engine

    lists = [np.arange(0, 64, 2), np.arange(0, 64, 3)]
    with tracing.profiled(stacks=True) as prof:
        with tracing.span("stacks"):
            engine.brute_force(lists, [0, 1])
    events = tracing._trace_events(prof)
    assert any(e[0] == SPAN + "stacks" and not e[1] for e in events)
    assert any(e[6] and tracing.PROGRAM + "index/engine.py" in e[0]
               for e in events)
    assert all(len(e) == 7 and e[2] <= e[3] for e in events)
