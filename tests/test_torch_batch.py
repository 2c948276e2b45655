"""The port's batched engine (``repro_torch.index.batch``) against the
reference's ``execute_batch`` and against the sequential engines, on the
corpora of tests/test_engine_batch.py and tests/test_fusion.py (the
single-device, no-pool cases).  Both packages build their index from the
same numpy postings; answers are compared byte for byte, and the scheduler's
counters, fused keys, sticky plans and warmup must agree too."""

import dataclasses

import numpy as np
import pytest

from repro.index import batch as r_batch
from repro.index import builder as r_builder
from repro.index import corpus as r_corpus
from repro.index import engine as r_engine
from repro_torch.index import batch as t_batch
from repro_torch.index import builder as t_builder
from repro_torch.index import engine as t_engine
from repro_torch.launch import serve as t_serve

pytestmark = pytest.mark.torch_port

STAT_KEYS = ("decoded_ints", "decoded_lists", "skip_folds", "n_groups",
             "n_sched_groups", "n_fused_groups", "n_dispatches", "n_items")


def _both(postings, n_docs, codec, B, n_parts):
    ref = r_builder.build(postings, n_docs, codec_name=codec, B=B,
                          n_parts=n_parts)
    port = t_builder.build(postings, n_docs, codec_name=codec, B=B,
                           n_parts=n_parts, device="cpu")
    return ref, port


def _key(k) -> tuple:
    return dataclasses.astuple(k)


def _sigs(stats) -> set:
    return {(s[0], _key(s[1]), *s[2:]) for s in stats.get("signatures", ())}


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.count == b.count
        assert a.docs.dtype == b.docs.dtype
        assert np.array_equal(a.docs, b.docs)


def _assert_same_stats(t_stats, r_stats):
    for k in STAT_KEYS:
        assert t_stats.get(k, 0) == r_stats.get(k, 0), k
    assert _sigs(t_stats) == _sigs(r_stats)


def _compare(ref, port, queries, backend="jax", **kw):
    """Port vs reference execute_batch (answers and counters) vs the port's
    sequential engine; returns the port's stats."""
    r_stats, t_stats = {}, {}
    want = r_batch.execute_batch(ref, queries, backend=backend,
                                 stats=r_stats, **kw)
    got = t_batch.execute_batch(port, queries, stats=t_stats, **kw)
    _assert_same(got, want)
    _assert_same(got, [t_engine.query(port, q, cache=None) for q in queries])
    _assert_same_stats(t_stats, r_stats)
    return t_stats


# --------------------------------------------------------------------------
# tests/test_engine_batch.py's corpus
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_corpus():
    return r_corpus.synthesize(n_docs=1 << 14, n_queries=12, seed=21)


@pytest.mark.parametrize("codec,B,n_parts", [
    ("bp-d1", 0, 1),
    ("fastpfor-d1", 16, 2),
    ("fastpfor-d1", 64, 3),     # all-bitmap groups
    ("varint", 32, 3),
])
@pytest.mark.parametrize("fuse", [False, True])
def test_batched_matches_reference(small_corpus, codec, B, n_parts, fuse):
    ref, port = _both(small_corpus.postings, small_corpus.n_docs, codec, B,
                      n_parts)
    stats = _compare(ref, port, small_corpus.queries, fuse=fuse)
    assert stats["n_items"] > 0


def test_batched_with_cache_matches_reference(small_corpus):
    ref, port = _both(small_corpus.postings, small_corpus.n_docs,
                      "fastpfor-d1", 16, 2)
    r_cache = r_engine.DecodeCache(capacity_ints=1 << 24)
    t_cache = t_engine.DecodeCache(capacity_ints=1 << 24)
    for _ in range(2):                   # second pass served from cache
        r_stats, t_stats = {}, {}
        want = r_batch.execute_batch(ref, small_corpus.queries,
                                     cache=r_cache, stats=r_stats)
        got = t_batch.execute_batch(port, small_corpus.queries,
                                    cache=t_cache, stats=t_stats)
        _assert_same(got, want)
        _assert_same_stats(t_stats, r_stats)
    assert (t_cache.hits, t_cache.misses) == (r_cache.hits, r_cache.misses)


def test_batched_respects_max_group_size(small_corpus):
    ref, port = _both(small_corpus.postings, small_corpus.n_docs,
                      "fastpfor-d1", 16, 2)
    stats = _compare(ref, port, small_corpus.queries, max_group_size=1,
                     fuse=False)
    assert stats["n_dispatches"] == stats["n_items"]


def test_batched_matches_reference_pallas_interpret(small_corpus):
    """The reference's backend="pallas" program (its megakernels in
    interpret mode) gives the port's answers."""
    ref, port = _both(small_corpus.postings, small_corpus.n_docs,
                      "fastpfor-d1", 16, 2)
    queries = small_corpus.queries[:6]
    want = r_batch.execute_batch(ref, queries, backend="pallas")
    _assert_same(t_batch.execute_batch(port, queries), want)


def test_batched_no_skip_matches_reference(small_corpus):
    ref, port = _both(small_corpus.postings, small_corpus.n_docs, "bp-d1",
                      0, 1)
    _compare(ref, port, small_corpus.queries, skip=False)


# --------------------------------------------------------------------------
# tests/test_fusion.py's corpora
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def uniform():
    corpus = r_corpus.synthesize(n_docs=1 << 14, n_queries=10, seed=33)
    return (*_both(corpus.postings, corpus.n_docs, "fastpfor-d1", 16, 2),
            corpus.queries)


@pytest.fixture(scope="module")
def skewed():
    # tiny first term, very long second term: packed folds through K5
    n_docs = 1 << 16
    table = {2: (100.0, [0.8 * (1 << 18) / n_docs,
                         38000.0 * (1 << 18) / n_docs])}
    corpus = r_corpus.synthesize(n_docs=n_docs, n_queries=4, seed=7,
                                 table=table)
    return (*_both(corpus.postings, corpus.n_docs, "bp8-d1", 0, 1),
            corpus.queries)


@pytest.fixture(scope="module")
def mixed():
    table = {k: r_corpus.TABLE2_CLUEWEB[k] for k in (2, 3, 4, 5)}
    corpus = r_corpus.synthesize(n_docs=1 << 14, n_queries=32, seed=11,
                                 table=table)
    return (*_both(corpus.postings, corpus.n_docs, "fastpfor-d1", 16, 2),
            corpus.queries)


@pytest.mark.parametrize("corpus_kind", ["uniform", "skewed", "mixed"])
@pytest.mark.parametrize("fuse", [False, True])
def test_fusion_corpora_match_reference(request, corpus_kind, fuse):
    ref, port, queries = request.getfixturevalue(corpus_kind)
    stats = _compare(ref, port, queries, fuse=fuse)
    if corpus_kind == "skewed":
        assert stats["skip_folds"] > 0                # K5's path ran


def test_fused_keys_equal_reference(mixed):
    ref, port, queries = mixed
    r_groups = r_batch.schedule(ref, queries)
    t_groups = t_batch.schedule(port, queries)
    assert ({_key(k) for k in t_groups} == {_key(k) for k in r_groups})
    r_fused = r_batch.fuse_groups(r_groups)
    t_fused = t_batch.fuse_groups(t_groups)
    assert len(t_fused) < len(t_groups)
    want = {_key(k): [(it.qi, it.pi) for it in v] for k, v in r_fused.items()}
    got = {_key(k): [(it.qi, it.pi) for it in v] for k, v in t_fused.items()}
    assert got == want


def test_fusion_plan_is_sticky_and_equal_to_reference(mixed):
    ref, port, queries = mixed
    r_plan, t_plan = r_batch.FusionPlan(), t_batch.FusionPlan()
    full = t_batch.fuse_groups(t_batch.schedule(port, queries), plan=t_plan)
    r_batch.fuse_groups(r_batch.schedule(ref, queries), plan=r_plan)
    assert t_batch.plan_covers(t_batch.schedule(port, queries[:3]), t_plan)
    sub = t_batch.fuse_groups(t_batch.schedule(port, queries[:3]),
                              plan=t_plan)
    assert set(sub).issubset(set(full))
    assert t_plan.dims == r_plan.dims
    assert not t_batch.plan_covers(t_batch.schedule(port, queries), None)


def test_fusion_collapses_dispatches(mixed):
    ref, port, queries = mixed
    unfused = _compare(ref, port, queries, fuse=False)
    fused = _compare(ref, port, queries, fuse=True)
    assert fused["n_sched_groups"] == unfused["n_groups"]
    assert fused["n_dispatches"] * 4 <= unfused["n_dispatches"]


def test_fused_empty_batch(uniform):
    _, port, _ = uniform
    assert t_batch.execute_batch(port, [], fuse=True) == []


def test_fused_single_group_batch(uniform):
    ref, port, queries = uniform
    stats = _compare(ref, port, queries[:1], fuse=True)
    assert stats["n_fused_groups"] == stats["n_dispatches"]


def test_fused_all_bitmap_family():
    n_docs = 1 << 12
    rng = np.random.default_rng(5)
    postings = [np.sort(rng.choice(n_docs, n_docs // 4, replace=False))
                for _ in range(3)]
    ref, port = _both(postings, n_docs, "bp-d1", 16, 2)
    assert all(tp.kind == "bitmap" for p in port.parts
               for tp in p.terms.values())
    queries = [[0, 1], [1, 2], [0, 1, 2], [2]]
    for fuse in (False, True):
        stats = _compare(ref, port, queries, fuse=fuse)
    assert stats["n_dispatches"] == 1                 # one bitmap program


# --------------------------------------------------------------------------
# warmup and the program count
# --------------------------------------------------------------------------

def test_warmup_then_steady_state_launches_no_new_program(mixed):
    ref, port, queries = mixed
    plan = t_batch.FusionPlan()
    wu = t_batch.warmup(port, queries, plan=plan, batch_size=8)
    r_wu = r_batch.warmup(ref, queries, plan=r_batch.FusionPlan(),
                          batch_size=8)
    assert wu["n_signatures"] == r_wu["n_signatures"] > 0
    assert wu["passes"] == r_wu["passes"] >= 2
    assert wu["converged"]
    stats: dict = {}
    out = []
    for lo in range(0, len(queries), 8):
        out.extend(t_batch.execute_batch(port, queries[lo: lo + 8],
                                         plan=plan, stats=stats))
    _assert_same(out, [t_engine.query(port, q) for q in queries])
    assert stats["n_compiles"] == 0
    # a shape the warmup never saw counts as a new program
    fresh: dict = {}
    t_batch.execute_batch(port, queries[:8], fuse=False, stats=fresh)
    assert fresh["n_compiles"] > 0


def test_synth_warmup_queries_equal_reference(uniform):
    ref, port, _ = uniform
    qs = t_batch.synth_warmup_queries(port, 8, seed=3)
    assert qs == r_batch.synth_warmup_queries(ref, 8, seed=3)
    assert len(qs) == 8 and all(len(q) >= 1 for q in qs)
    wu = t_batch.warmup(port, None, plan=t_batch.FusionPlan(), batch_size=8)
    assert wu["n_signatures"] > 0


def test_bucket_rows_and_chunk_size_equal_reference(mixed):
    ref, port, queries = mixed
    for b in range(1, 200):
        assert t_batch._bucket_rows(b) == r_batch._bucket_rows(b)
    r_groups = r_batch.fuse_groups(r_batch.schedule(ref, queries))
    t_groups = t_batch.fuse_groups(t_batch.schedule(port, queries))
    r_by = {_key(k): (k, v) for k, v in r_groups.items()}
    for k, v in t_groups.items():
        rk, rv = r_by[_key(k)]
        for cap in (1, 5, 128):
            assert (t_batch._chunk_size(k, v, cap)
                    == r_batch._chunk_size(rk, rv, cap))


# --------------------------------------------------------------------------
# the serve CLI
# --------------------------------------------------------------------------

def test_serve_batch_gives_the_sequential_hits(capsys):
    seq = t_serve.main(["--queries", "12", "--device", "cpu"])
    for flags in (["--warmup"], ["--no-fuse", "--cache"]):
        rep = t_serve.main(["--queries", "12", "--device", "cpu",
                            "--batch", "8", *flags])
        assert rep["hits"] == seq["hits"]
        _assert_same(rep["results"], seq["results"])
    out = capsys.readouterr().out
    assert "paper-index --batch 8 (cpu, fused)" in out
    assert "paper-index --batch 8 (cpu, unfused)" in out
    assert "warmup:" in out
