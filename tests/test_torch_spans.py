"""The port's spans and its sync counter on the two query paths
(``index.source.span``): ``engine.query`` keeps ``stats["span_s"]`` /
``["span_n"]`` and ``stats["syncs"]``, ``execute_pipelined`` splits
``StageTimings.block`` into ``wait`` and ``collect``; off, the helper reads
no clock and calls nothing of the profiler; under a profiler each
span is a ``repro_torch.<name>`` range around its calls.  Both builds the
benchmark runs, on a small corpus made so that every fold path is taken."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.index import builder, engine, pipeline, source

pytestmark = pytest.mark.torch_port

N_DOCS = 1 << 21
ENGINE_SPANS = ("engine.decode", "engine.fold", "engine.compact",
                "engine.result")
# term 0 seeds every query (200 ids: Varint in bp-d1); term 1 (3,000) folds
# by the tiled merge; term 2 (60,000, 7 blocks a part) by the skip probe;
# term 3 (300,000) is a bitmap at B=16 and a skip-probed list at B=0.  All
# four share 48 ids, so every fold of both parts runs.
SIZES = (200, 3000, 60000, 300000)
Q2, Q4 = [0, 2], [0, 1, 2, 3]
# Host waits a part (``stats["syncs"]``):
#   Q2: skip probe 2 + compact 1 + result copy 1                     = 4
#   Q4: tiled merge 3 (torch.isin) + compact 1, skip probe 2 +
#       compact 1, term 3 (bitmap probe 0 or skip probe 2) + compact 1,
#       result copy 1                                  = 9 (B=16), 11 (B=0)
SYNCS = {"bp-d1": {2: 2 * 4, 4: 2 * 9}, "fastpfor-d1": {2: 2 * 4, 4: 2 * 11}}
BUILDS = [("bp-d1", 16), ("fastpfor-d1", 0)]


@pytest.fixture(scope="module")
def postings():
    rng = np.random.default_rng(28)
    shared = rng.choice(N_DOCS, 48, replace=False)
    out = []
    for n in SIZES:
        rest = rng.choice(N_DOCS, n, replace=False)
        out.append(np.unique(np.concatenate([shared, rest])))
    return out


@pytest.fixture(scope="module", params=BUILDS, ids=[b[0] for b in BUILDS])
def built(request, postings):
    codec, B = request.param
    idx = builder.build(postings, N_DOCS, codec_name=codec, B=B, n_parts=2,
                        device="cpu")
    return codec, idx, [Q2, Q4, [1, 2], [0, 1, 3]]


def _truth(postings, q):
    out = postings[q[0]]
    for t in q[1:]:
        out = np.intersect1d(out, postings[t])
    return out


def test_engine_query_fills_the_four_spans(built, postings):
    _, idx, queries = built
    stats = {}
    for q in queries:
        r = engine.query(idx, q, stats=stats)
        assert np.array_equal(r.docs, _truth(postings, q))
    assert set(stats["span_s"]) == set(ENGINE_SPANS)
    assert all(stats["span_s"][k] > 0 for k in ENGINE_SPANS)
    n = stats["span_n"]
    # one resolve a decoded list or a skip probe; each fold is compacted
    assert n["engine.decode"] == (stats["decoded_lists"]
                                  + stats["skip_folds"])
    assert n["engine.fold"] == n["engine.compact"] > 0
    assert stats["skip_folds"] > 0


@pytest.mark.parametrize("q", [Q2, Q4], ids=["2-term", "4-term"])
def test_syncs_is_a_fixed_count(built, q):
    codec, idx, _ = built
    stats = {}
    engine.query(idx, q, stats=stats)
    assert stats["syncs"] == SYNCS[codec][len(q)]


def test_pipelined_splits_block_into_wait_and_collect(built, postings):
    _, idx, queries = built
    tm = pipeline.StageTimings()
    stats = {}
    out = pipeline.execute_pipelined(idx, queries * 4, batch_size=3,
                                     depth=2, stats=stats, timings=tm)
    for q, r in zip(queries * 4, out):
        assert np.array_equal(r.docs, _truth(postings, q))
    assert tm.wait > 0 and tm.collect > 0
    assert tm.stage > 0 and tm.assemble > 0 and tm.dispatch > 0
    # wait and collect are the block's parts: what is left is the spans'
    # own bookkeeping, a few microseconds for each of the 2 spans a chunk
    # and the one of a batch's concatenation
    spans = 2 * stats["n_dispatches"] + 2 * tm.batches
    rest = tm.block - (tm.wait + tm.collect)
    assert 0 <= rest <= spans * 200e-6 + 2e-3, (rest, spans)
    assert set(tm.as_dict()) == {"stage_s", "assemble_s", "dispatch_s",
                                 "block_s", "batches"}


def test_off_reads_no_clock_and_no_profiler(built, monkeypatch):
    _, idx, queries = built

    def boom(*a, **k):
        raise AssertionError("called with the spans off")

    for name in ("perf_counter", "perf_counter_ns"):
        monkeypatch.setattr(time, name, boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    for q in queries:
        engine.query(idx, q)
    pipeline.execute_pipelined(idx, queries, batch_size=2, depth=2)
    with source.span(None, "engine.fold"):
        pass


def _ranges(prof):
    """(name, start_ns, end_ns) of every host event of the profile."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()]


def _inside(events, inner: str, outer: str) -> bool:
    """Every ``inner`` event lies in some ``outer`` range, and there is
    one."""
    outs = [(a, b) for n, a, b in events if n == outer]
    ins = [(a, b) for n, a, b in events if n == inner]
    return bool(ins) and all(any(oa <= a and b <= ob for oa, ob in outs)
                             for a, b in ins)


def _holds(events, outer: str, inner: str) -> bool:
    """Every ``outer`` range holds an ``inner`` event, and there is one."""
    outs = [(a, b) for n, a, b in events if n == outer]
    ins = [(a, b) for n, a, b in events if n == inner]
    return bool(outs) and all(any(oa <= a and b <= ob for a, b in ins)
                              for oa, ob in outs)


def test_profiler_ranges_around_their_calls(built):
    codec, idx, queries = built
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.query(idx, Q4)
    ev = _ranges(prof)
    names = {n for n, _, _ in ev}
    assert {"repro_torch." + s for s in ENGINE_SPANS} <= names
    # the tiled merge folds; each compaction's boolean index
    assert _inside(ev, "aten::isin", "repro_torch.engine.fold")
    assert _holds(ev, "repro_torch.engine.compact", "aten::nonzero")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.execute_pipelined(idx, queries, batch_size=2, depth=2)
    ev = _ranges(prof)
    for inner in ("repro_torch.batch.wait", "repro_torch.batch.collect"):
        assert _inside(ev, inner, "repro_torch.pipeline.block")
    assert {"repro_torch.pipeline.stage", "repro_torch.batch.assemble",
            "repro_torch.batch.dispatch"} <= {n for n, _, _ in ev}


@pytest.mark.parametrize("carrier", ["stats", "timings"])
def test_span_writes_its_carrier(carrier):
    c = {} if carrier == "stats" else pipeline.StageTimings()
    for _ in range(3):
        with source.span(c, "batch.wait"):
            pass
    if carrier == "stats":
        assert c["span_n"] == {"batch.wait": 3}
        assert c["span_s"]["batch.wait"] > 0
    else:
        assert c.wait > 0 and c.block == c.collect == 0
