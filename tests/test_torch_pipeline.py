"""The port's device-resident index and pipelined executor
(``repro_torch.index.source.ResidentPool``, ``index.pipeline``) against the
reference's, case for case with tests/test_pipeline.py: both packages build
from the same numpy postings, answers are compared byte for byte with the
reference's ``execute_batch`` / ``execute_pipelined`` (``backend="jax"``)
and with the port's ``engine.query``; pool ``stats()`` and the scheduler's
counters must equal the reference's."""

import dataclasses

import numpy as np
import pytest

from repro.index import batch as r_batch
from repro.index import builder as r_builder
from repro.index import corpus as r_corpus
from repro.index import engine as r_engine
from repro.index import pipeline as r_pipe
from repro.index import source as r_source
from repro.core import codecs as r_codecs
from repro_torch.core import codecs as t_codecs
from repro_torch.index import batch as t_batch
from repro_torch.index import builder as t_builder
from repro_torch.index import engine as t_engine
from repro_torch.index import pipeline as t_pipe
from repro_torch.index import source as t_source
from repro_torch.launch import serve as t_serve

pytestmark = [pytest.mark.torch_port, pytest.mark.pipeline]

COUNTERS = ("n_dispatches", "n_groups", "n_items", "decoded_ints",
            "decoded_lists", "skip_folds", "resident_hits")


# --------------------------------------------------------------------------
# fixtures: tests/test_pipeline.py's uniform and skewed corpora, both builds
# --------------------------------------------------------------------------

def _both(corpus, codec, B, n_parts):
    ref = r_builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                          B=B, n_parts=n_parts)
    port = t_builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                           B=B, n_parts=n_parts, device="cpu")
    seq = [r_engine.query(ref, q) for q in corpus.queries]
    return ref, port, corpus.queries, seq


@pytest.fixture(scope="module")
def uniform():
    corpus = r_corpus.synthesize(n_docs=1 << 14, n_queries=10, seed=33)
    return _both(corpus, "fastpfor-d1", 16, 2)


@pytest.fixture(scope="module")
def skewed():
    n_docs = 1 << 16
    table = {2: (100.0, [0.8 * (1 << 18) / n_docs,
                         38000.0 * (1 << 18) / n_docs])}
    corpus = r_corpus.synthesize(n_docs=n_docs, n_queries=4, seed=7,
                                 table=table)
    return _both(corpus, "bp8-d1", 0, 1)


def _b0(codec):
    """A ClueWeb09-shaped corpus (shared vocabulary, as the benchmark's
    cells) built with no bitmaps: the long lists stay packed, so pool-mode
    batches gather K5's operands from layout arenas, and FastPFOR's
    patches fill the exception arenas."""
    corpus = r_corpus.synthesize(n_docs=1 << 19, n_queries=24, seed=31,
                                 shared_vocab=True)
    return _both(corpus, codec, 0, 2)


@pytest.fixture(scope="module")
def b0_bp_d4():
    return _b0("bp-d4")


@pytest.fixture(scope="module")
def b0_fastpfor():
    return _b0("fastpfor-d1")


# a pool whose arenas and lists outgrow it part way through a pass of the
# B=0 corpora: it evicts, and later lookups both hit and miss
EVICTING = 1 << 22


def _pools(capacity_ints=1 << 26):
    return (r_source.ResidentPool(capacity_ints=capacity_ints),
            t_source.ResidentPool(capacity_ints=capacity_ints, device="cpu"))


def _assert_identical(results, seq):
    assert len(results) == len(seq)
    for got, want in zip(results, seq):
        assert got.count == want.count
        assert got.docs.dtype == want.docs.dtype
        assert np.array_equal(got.docs, want.docs)      # byte-identical


def _sigs(stats) -> set:
    return {(s[0], dataclasses.astuple(s[1]), *s[2:])
            for s in stats.get("signatures", ())}


def _assert_same_counters(t_stats, r_stats):
    for k in COUNTERS:
        assert t_stats.get(k, 0) == r_stats.get(k, 0), k
    assert _sigs(t_stats) == _sigs(r_stats)


def _assert_same_pool(t_pool, r_pool):
    assert t_pool.stats() == r_pool.stats()


def _batch_both(ref, port, queries, r_pool, t_pool, **kw):
    """One execute_batch in each package: answers and counters equal.
    Returns the port's (answers, counters)."""
    r_stats, t_stats = {}, {}
    want = r_batch.execute_batch(ref, queries, pool=r_pool, stats=r_stats,
                                 **kw)
    got = t_batch.execute_batch(port, queries, pool=t_pool, stats=t_stats,
                                **kw)
    _assert_identical(got, want)
    _assert_same_counters(t_stats, r_stats)
    return got, t_stats


# --------------------------------------------------------------------------
# pool-backed batch execution
# --------------------------------------------------------------------------

def test_pool_batch_matches_sequential(uniform):
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools()
    r_pool.warm(ref)
    t_pool.warm(port)
    _assert_same_pool(t_pool, r_pool)
    got, stats = _batch_both(ref, port, queries, r_pool, t_pool)
    _assert_identical(got, seq)
    assert stats.get("resident_hits", 0) > 0
    _assert_same_pool(t_pool, r_pool)
    # steady state: a second pass decodes nothing at all
    _, stats2 = _batch_both(ref, port, queries, r_pool, t_pool)
    assert stats2.get("decoded_lists", 0) == 0
    _assert_same_pool(t_pool, r_pool)
    _assert_identical([t_engine.query(port, q, pool=t_pool)
                       for q in queries], seq)


def test_pool_composes_with_cache(uniform):
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools()
    r_cache = r_engine.DecodeCache(capacity_ints=1 << 24)
    t_cache = t_engine.DecodeCache(capacity_ints=1 << 24)
    for _ in range(2):
        r_stats, t_stats = {}, {}
        want = r_batch.execute_batch(ref, queries, pool=r_pool,
                                     cache=r_cache, stats=r_stats)
        got = t_batch.execute_batch(port, queries, pool=t_pool,
                                    cache=t_cache, stats=t_stats)
        _assert_identical(got, want)
        _assert_identical(got, seq)
        _assert_same_counters(t_stats, r_stats)
        _assert_same_pool(t_pool, r_pool)
    assert (t_cache.hits, t_cache.misses) == (r_cache.hits, r_cache.misses)


def test_pool_with_cache_hits_takes_the_stacked_path(uniform):
    """Cache hits carry no host copy, so their groups stack the pool's
    padded rows (the non-arena branch, with its pad memos) — as in the
    reference, pad accounting included."""
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools()
    r_cache = r_engine.DecodeCache(capacity_ints=1 << 24)
    t_cache = t_engine.DecodeCache(capacity_ints=1 << 24)
    for _ in range(2):
        want = r_batch.execute_batch(ref, queries, cache=r_cache)
        got = t_batch.execute_batch(port, queries, cache=t_cache)
        _assert_identical(got, want)
    r_stats, t_stats = {}, {}
    want = r_batch.execute_batch(ref, queries, pool=r_pool, cache=r_cache,
                                 stats=r_stats)
    got = t_batch.execute_batch(port, queries, pool=t_pool, cache=t_cache,
                                stats=t_stats)
    _assert_identical(got, want)
    _assert_identical(got, seq)
    _assert_same_counters(t_stats, r_stats)
    _assert_same_pool(t_pool, r_pool)
    assert t_pool.stats()["pad_ints"] > 0


def test_pool_lazy_staging_converges(uniform):
    """Without warm(), the first batch decodes and stages; the second batch
    serves from residency."""
    ref, port, queries, _ = uniform
    r_pool, t_pool = _pools()
    _batch_both(ref, port, queries, r_pool, t_pool)
    staged = t_pool.staged_lists
    assert staged > 0 and staged == r_pool.staged_lists
    _, stats = _batch_both(ref, port, queries, r_pool, t_pool)
    assert t_pool.staged_lists == staged          # nothing new staged
    assert stats.get("decoded_lists", 0) == 0
    _assert_same_pool(t_pool, r_pool)


def test_pool_sequential_engine_matches_reference(uniform):
    """``engine.query(pool=)``: the reference's sequential engine with its
    pool, answer for answer, counters and pool accounting equal."""
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools()
    for _ in range(2):
        r_stats, t_stats = {}, {}
        want = [r_engine.query(ref, q, pool=r_pool, stats=r_stats)
                for q in queries]
        got = [t_engine.query(port, q, pool=t_pool, stats=t_stats)
               for q in queries]
        _assert_identical(got, want)
        _assert_identical(got, seq)
        for k in ("decoded_ints", "decoded_lists", "skip_folds",
                  "resident_hits"):
            assert t_stats.get(k, 0) == r_stats.get(k, 0), k
        _assert_same_pool(t_pool, r_pool)


# --------------------------------------------------------------------------
# pipelined execution: depth × corpus differential matrix
# --------------------------------------------------------------------------

def _pipelined_both(ref, port, queries, depth, batch_size, r_pool=None,
                    t_pool=None, backend="jax"):
    r_stats, t_stats = {}, {}
    want = r_pipe.execute_pipelined(ref, queries, batch_size=batch_size,
                                    depth=depth, backend=backend,
                                    pool=r_pool, stats=r_stats)
    got = t_pipe.execute_pipelined(port, queries, batch_size=batch_size,
                                   depth=depth, pool=t_pool, stats=t_stats)
    _assert_identical(got, want)
    if backend == "jax":
        _assert_same_counters(t_stats, r_stats)
    return got


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_matches_sequential_uniform(uniform, depth):
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools()
    r_pool.warm(ref)
    t_pool.warm(port)
    out = _pipelined_both(ref, port, queries, depth, 4, r_pool, t_pool)
    _assert_identical(out, seq)
    _assert_identical(out, [t_engine.query(port, q) for q in queries])
    _assert_same_pool(t_pool, r_pool)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_matches_sequential_skewed(skewed, depth):
    ref, port, queries, seq = skewed
    out = _pipelined_both(ref, port, queries, depth, 2)
    _assert_identical(out, seq)
    _assert_identical(out, [t_engine.query(port, q) for q in queries])


@pytest.mark.parametrize("depth,corpus,capacity", [
    pytest.param(1, "skewed", 1 << 26, id="1"),
    pytest.param(2, "skewed", 1 << 26, id="2"),
    pytest.param(4, "skewed", 1 << 26, id="4"),
    pytest.param(2, "b0_bp_d4", EVICTING, id="b0-bp-d4-evicting"),
    pytest.param(2, "b0_fastpfor", EVICTING, id="b0-fastpfor-d1-evicting"),
])
def test_pipeline_with_pool_matches_sequential_skewed(request, depth, corpus,
                                                      capacity):
    """The skewed corpus through a warmed pool: packed folds gathered from
    layout arenas (K5's operands) at every depth.  The B=0 corpora run
    through a pool that evicts: rows are rewritten into freed arena slots
    and the arenas grow on the device, and answers, counters and pool
    accounting still equal the reference's and ``engine.query``'s."""
    ref, port, queries, seq = request.getfixturevalue(corpus)
    r_pool, t_pool = _pools(capacity)
    r_pool.warm(ref)
    t_pool.warm(port)
    out = _pipelined_both(ref, port, queries, depth, 2, r_pool, t_pool)
    _assert_identical(out, seq)
    _assert_same_pool(t_pool, r_pool)
    assert t_pool.arena_stats()["arenas"] >= 6       # the layout arenas
    if capacity < 1 << 26:
        assert t_pool.stats()["evicted_lists"] > 0
        assert t_pool.arena_stats()["arena_evictions"] > 0
        assert t_pool.arena_grows() > 0
        _assert_identical(out, [t_engine.query(port, q) for q in queries])
        out = _pipelined_both(ref, port, queries, depth, 2, r_pool, t_pool)
        _assert_identical(out, seq)
        _assert_same_pool(t_pool, r_pool)


def test_pipeline_matches_reference_pallas_interpret(uniform):
    """The reference's backend="pallas" program (its megakernels in
    interpret mode), pipelined over its pool, gives the port's answers."""
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools()
    r_pool.warm(ref)
    t_pool.warm(port)
    out = _pipelined_both(ref, port, queries[:6], 2, 3, r_pool, t_pool,
                          backend="pallas")
    _assert_identical(out, seq[:6])


def test_pipeline_empty_batch(uniform):
    _, port, _, _ = uniform
    assert t_pipe.execute_pipelined(port, [], batch_size=8, depth=2) == []


def test_pipeline_single_query(uniform):
    ref, port, queries, seq = uniform
    for depth in (1, 2, 4):
        out = _pipelined_both(ref, port, [queries[0]], depth, 8)
        _assert_identical(out, seq[:1])


def test_pipeline_depth_one_equals_execute_batch(uniform):
    _, port, queries, _ = uniform
    pool = t_source.ResidentPool(device="cpu")
    pool.warm(port)
    serial = []
    for lo in range(0, len(queries), 4):
        serial.extend(t_batch.execute_batch(port, queries[lo: lo + 4],
                                            pool=pool))
    piped = t_pipe.execute_pipelined(port, queries, batch_size=4, depth=1,
                                     pool=pool)
    _assert_identical(piped, serial)


def test_pipeline_timings_populated(uniform):
    _, port, queries, seq = uniform
    tm = t_pipe.StageTimings()
    out = t_pipe.execute_pipelined(port, queries, batch_size=4, depth=2,
                                   timings=tm)
    _assert_identical(out, seq)
    assert tm.batches == (len(queries) + 3) // 4
    assert tm.stage >= 0 and tm.dispatch > 0 and tm.block >= 0
    assert tm.assemble > 0          # launcher-attributed operand assembly
    assert set(tm.as_dict()) == set(r_pipe.StageTimings().as_dict())


# --------------------------------------------------------------------------
# pool accounting + layout memoization
# --------------------------------------------------------------------------

def test_pool_eviction_accounting(uniform):
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools(2048)                      # tiny: forces churn
    got, _ = _batch_both(ref, port, queries, r_pool, t_pool)
    _assert_identical(got, seq)
    st = t_pool.stats()
    assert st == r_pool.stats()
    assert st["evicted_lists"] > 0
    assert st["resident_lists"] == 1 or st["resident_ints"] <= 2048
    assert st["staged_ints"] - st["evicted_ints"] == st["resident_ints"]


def test_pool_churn_bounds_device_footprint(uniform):
    """Under eviction churn the whole device footprint (store entries, pad
    memos, arena rows) stops growing, and every pass's accounting equals
    the reference's."""
    ref, port, queries, seq = uniform
    r_pool, t_pool = _pools(2048)
    for _ in range(2):
        _batch_both(ref, port, queries, r_pool, t_pool)
        _assert_same_pool(t_pool, r_pool)
    st1 = t_pool.stats()
    assert st1["evicted_lists"] > 0
    for _ in range(3):
        _batch_both(ref, port, queries, r_pool, t_pool)
        _assert_same_pool(t_pool, r_pool)
    st2 = t_pool.stats()
    assert st2["evicted_lists"] > st1["evicted_lists"]
    assert st2["arena_ints"] == st1["arena_ints"]
    assert st2["overhead_ints"] == st1["overhead_ints"]
    assert st2["arena_evictions"] > 0
    assert st2["pad_ints"] == sum(e["pad_ints"]
                                  for e in t_pool._store.values())
    assert st2["staged_ints"] - st2["evicted_ints"] == st2["resident_ints"]
    assert st2["device_ints"] == st2["resident_ints"] + st2["overhead_ints"]


def test_arena_evict_reuses_slots():
    import torch
    a = t_source.RowArena([np.zeros(4, np.int32)], "cpu")
    s1 = a.slot("a", lambda: (torch.ones(4, dtype=torch.int32), 0))
    a.slot("b", lambda: (torch.full((4,), 2, dtype=torch.int32), 0))
    ints0 = a.ints
    assert a.evict("a") == 4
    assert a.evict("missing") == 0
    s3 = a.slot("c", lambda: (torch.full((4,), 3, dtype=torch.int32), 0))
    assert s3 == s1                         # freed slot reused
    assert a.ints == ints0                  # no growth
    assert a.evictions == 1
    buf = a.buffer().numpy()
    assert np.array_equal(buf[s3], np.full(4, 3, np.int32))
    assert buf.shape[0] == 4                # pow2 capacity, identity filler
    assert np.array_equal(a.gather(np.array([[s3, 0]])).numpy(),
                          np.stack([np.full(4, 3), np.zeros(4)])[None])
    builds = a.builds
    a.buffer()
    assert a.builds == builds               # no rows joined: no rebuild


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arena_grown_in_place_equals_the_rebuilt_buffer(seed):
    """A seeded run of misses, hits and evictions through the port's
    ``RowArena`` (rows written into their slots on the device, the
    capacity doubled there) and the reference's (its buffer stacked anew
    from host rows after each change): the same slots, footprint and
    evictions, and every gather of the live slots equal.  Rows come as
    whole device rows and as short device rows with a fill, a number or a
    0-d tensor."""
    import torch
    rng = np.random.default_rng(seed)
    width = 8
    ident = np.full(width, -1, np.int32)
    r_arena = r_source.RowArena([ident])
    t_arena = t_source.RowArena([ident], "cpu")
    live: dict = {}
    for step in range(240):
        if live and rng.random() < 0.3:
            key = list(live)[int(rng.integers(0, len(live)))]
            assert t_arena.evict(key) == r_arena.evict(key) == width
            del live[key]
        else:
            key = int(rng.integers(0, 48))
            n = int(rng.integers(0, width + 1))
            row = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
            fill = int(rng.integers(-3, 3))
            full = np.concatenate([row, np.full(width - n, fill, np.int32)])
            make = (lambda: (torch.from_numpy(full.copy()), 0),
                    lambda: (torch.from_numpy(row.copy()), fill),
                    lambda: (torch.from_numpy(row.copy()),
                             torch.tensor(fill, dtype=torch.int32)))[step % 3]
            assert t_arena.slot(key, make) == r_arena.slot(key, lambda: full)
            live.setdefault(key, full)
        assert t_arena.slots == r_arena.slots
        assert (t_arena.ints, t_arena.evictions) == (r_arena.ints,
                                                      r_arena.evictions)
        if step % 8 == 0 or step == 239:
            idx = np.array([[0] + [t_arena.slots[k] for k in live]],
                           np.int32)
            got = t_arena.gather(idx).numpy()
            assert np.array_equal(got, np.asarray(r_arena.buffer())[idx])
            assert np.array_equal(got[0, 1:].reshape(-1, width),
                                  np.stack([live[k] for k in live])
                                  if live else np.zeros((0, width)))
    assert t_arena.builds == 1 and t_arena.grows >= 5
    assert t_arena.buffer().shape[0] >= len(r_arena.rows_np)


@pytest.mark.parametrize("corpus", ["b0_bp_d4", "b0_fastpfor"])
def test_arena_rows_join_from_device_tensors(request, corpus, monkeypatch):
    """Through a pool that evicts, every arena is uploaded whole once, at
    its creation (its identity rows), and every row after joins by a write
    from a tensor on the pool's device (a decoded list, a bitmap row, a
    payload's layout arrays): no miss, eviction or doubling stacks the
    arena on the host, and no row passes through the host."""
    import torch
    _, port, queries, seq = request.getfixturevalue(corpus)
    rows = []
    write = t_source.RowArena._write

    def spy(self, dst, got, stats):
        rows.append(got[0])
        return write(self, dst, got, stats)

    monkeypatch.setattr(t_source.RowArena, "_write", spy)
    t_pool = t_source.ResidentPool(capacity_ints=EVICTING, device="cpu")
    for _ in range(2):
        out = t_pipe.execute_pipelined(port, queries, batch_size=4, depth=2,
                                       pool=t_pool)
        _assert_identical(out, seq)
    st = t_pool.stats()
    assert st["evicted_lists"] > 0 and st["arena_evictions"] > 0
    assert t_pool.arena_grows() > 0
    assert t_pool.arena_builds() == st["arenas"]
    assert len(rows) >= st["arena_rows"] > 0
    assert all(isinstance(r, torch.Tensor) for r in rows)


def test_pool_counters_in_the_query_stats(b0_fastpfor):
    """``stats`` carries the pool's counters from the first pool-mode
    schedule on: through an evicting pool a pass counts the lookups that
    missed (as the pool's own ``misses`` does), the ints staged and
    written into arenas, the arenas' doublings and the span
    ``pool.arena``; through a warm pool that holds the whole log a pass
    hits on every lookup, stages nothing and grows no arena.  Without a
    pool, none of them is counted."""
    _, port, queries, seq = b0_fastpfor
    pool = t_source.ResidentPool(capacity_ints=EVICTING, device="cpu")
    stats: dict = {}
    out = t_pipe.execute_pipelined(port, queries, batch_size=4, depth=2,
                                   pool=pool, stats=stats)
    _assert_identical(out, seq)
    assert (stats["pool_hits"], stats["pool_misses"]) == (pool.hits,
                                                          pool.misses)
    assert stats["pool_misses"] > 0 and pool.stats()["evicted_lists"] > 0
    assert stats["staged_ints"] > pool.staged_ints > 0
    assert stats["arena_grows"] == pool.arena_grows() > 0
    assert stats["span_n"]["pool.arena"] > 0
    pool = t_source.ResidentPool(device="cpu")
    pool.warm(port)
    for _ in range(2):
        t_pipe.execute_pipelined(port, queries, batch_size=4, depth=2,
                                 pool=pool)
    stats = {}
    out = t_pipe.execute_pipelined(port, queries, batch_size=4, depth=2,
                                   pool=pool, stats=stats)
    _assert_identical(out, seq)
    assert stats["pool_hits"] > 0
    assert stats["pool_misses"] == stats["staged_ints"] == 0
    assert stats["arena_grows"] == 0
    assert "pool.arena" not in stats.get("span_s", {})
    stats = {}
    t_pipe.execute_pipelined(port, queries, batch_size=4, depth=2,
                             stats=stats)
    assert not set(t_source.POOL_COUNTERS) & set(stats)


def test_pool_warm_skips_long_skip_capable_lists(skewed):
    ref, port, queries, seq = skewed
    r_pool, t_pool = _pools()
    r_pool.warm(ref)
    t_pool.warm(port)
    _assert_same_pool(t_pool, r_pool)
    got, stats = _batch_both(ref, port, queries, r_pool, t_pool)
    _assert_identical(got, seq)
    assert stats.get("skip_folds", 0) > 0        # packed path still taken
    _assert_same_pool(t_pool, r_pool)


def test_demoted_geometry_mismatch_stays_out_of_pool():
    rng = np.random.default_rng(0)
    n_docs = 1 << 18
    postings = [
        np.sort(rng.choice(n_docs, 50, replace=False)),      # seed
        np.sort(rng.choice(n_docs, 6000, replace=False)),    # 8-row blocks
        np.sort(rng.choice(n_docs, 40000, replace=False)),   # 32-row blocks
    ]
    ref = r_builder.build(postings, n_docs, codec_name="bp-d1", B=0,
                          n_parts=1)
    port = t_builder.build(postings, n_docs, codec_name="bp-d1", B=0,
                           n_parts=1, device="cpu")
    q = [0, 1, 2]
    seq = r_engine.query(ref, q)
    r_pool, t_pool = _pools()
    r_pool.warm(ref)
    t_pool.warm(port)
    for _ in range(2):
        got, stats = _batch_both(ref, port, [q], r_pool, t_pool)
        _assert_identical(got, [seq])
        assert stats.get("skip_folds", 0) == 1
        assert stats.get("decoded_lists", 0) == 1
        assert (port.parts[0].uid, 1) not in t_pool
        _assert_same_pool(t_pool, r_pool)


def test_layout_precomputed_at_build(skewed):
    _, port, queries, _ = skewed
    stats: dict = {}
    t_engine.query(port, queries[0], stats=stats)
    assert stats.get("layout_misses", 0) == 0
    assert stats.get("layout_hits", 0) > 0


def test_decoded_source_vals_np_consistent(uniform):
    ref, port, _, _ = uniform
    codec = t_codecs.get_codec(port.codec_name)
    pool = t_source.ResidentPool(device="cpu")
    part = port.parts[0]
    tid, tp = next((t, tp) for t, tp in part.terms.items()
                   if tp.kind == "list")
    src = t_source.resolve(part, tid, tp, codec, r_count=None, pool=pool)
    assert src.vals_np is not None
    assert np.array_equal(src.vals.numpy(), src.vals_np)
    r_src = r_source.resolve(ref.parts[0], tid, ref.parts[0].terms[tid],
                             r_codecs.get_codec(ref.codec_name),
                             r_count=None)
    assert np.array_equal(src.vals_np, r_src.vals_np)


def test_group_pad_layout_extends_the_self_layout(skewed):
    """At a group's wider pads a layout is extended from the memoized
    self-padded one on the host; it equals the projection of the payload
    (``bitpack.layout_np``) at those pads, field for field."""
    from repro_torch.core import bitpack as t_bitpack
    _, port, _, _ = skewed
    n = 0
    for part in port.parts:
        for tid, tp in part.terms.items():
            if tp.kind != "list" or not t_bitpack.skip_capable(tp.payload):
                continue
            src = t_source.PackedSource(tp.payload, tp.n, key=(part.uid, tid))
            k, t, e = src.self_pads()
            for pads in ((2 * k, t, e), (k, 2 * t, max(e, 1) * 2),
                         (4 * k, 2 * t, e)):
                got = src.layout(*pads)
                want = t_bitpack.layout_np(tp.payload, *pads)
                for f in ("words", "widths", "offsets", "maxes", "exc_pos",
                          "exc_add"):
                    assert np.array_equal(getattr(got, f),
                                          getattr(want, f)), f
                    assert getattr(got, f).dtype == getattr(want, f).dtype
                n += 1
    assert n > 0


# --------------------------------------------------------------------------
# the serve CLI's resident and pipelined paths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--resident"],
                                   ["--resident", "--batch", "4"],
                                   ["--pipeline", "2"],
                                   ["--pipeline", "2", "--batch", "4",
                                    "--codec", "bitpack"]])
def test_serve_resident_and_pipeline_hits_equal_sequential(flags):
    codec = flags[flags.index("--codec") + 1] if "--codec" in flags \
        else "fastpfor"
    base = ["--queries", "8", "--device", "cpu", "--codec", codec]
    seq = t_serve.main(base)
    rep = t_serve.main(base + [f for f in flags if f not in
                               ("--codec", "bitpack")])
    assert rep["hits"] == seq["hits"]
    for a, b in zip(rep["results"], seq["results"]):
        assert a.count == b.count and np.array_equal(a.docs, b.docs)
    if "--pipeline" in flags:
        assert rep["timings"].batches >= 1
