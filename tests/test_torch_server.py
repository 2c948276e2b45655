"""The port's continuous-batching server (``repro_torch.launch.server``)
against the reference's, case for case with tests/test_server.py, the
three mutable-index cases included: both packages build from the same
numpy postings; the port's served answers must equal the reference's
sequential engine and offline ``execute_batch`` (``backend="jax"``), and,
where the reference's server runs beside it, its deterministic counters.
The port has one backend, so the reference's backend axis becomes the fuse
axis or one case; a ladder case states the port's two rungs beside the
reference's."""

import asyncio
import time

import numpy as np
import pytest

from repro.index import batch as r_batch
from repro.index import builder as r_builder
from repro.index import corpus as r_corpus
from repro.index import engine as r_engine
from repro.index import segments as r_segments
from repro.index import source as r_source
from repro.launch import server as r_server
from repro_torch.index import batch as batch_lib
from repro_torch.index import builder as t_builder
from repro_torch.index import segments
from repro_torch.index import shard as shard_lib
from repro_torch.index import source
from repro_torch.launch import server as server_lib

pytestmark = [pytest.mark.torch_port, pytest.mark.server]

# the counters of ServerMetrics.summary() that do not read a clock
DETERMINISTIC = ("n_done", "n_shed", "queue_depth_hist", "n_flushes",
                 "flush_full", "flush_deadline", "flush_drain",
                 "aligned_flushes", "unaligned_flushes", "n_timeout",
                 "n_errors", "n_faults", "n_retries", "degraded_flushes")
STATS = ("n_dispatches", "n_groups", "n_items", "n_sched_groups",
         "n_fused_groups", "decoded_ints", "skip_folds", "resident_hits")


def _both(corpus):
    ref = r_builder.build(corpus.postings, corpus.n_docs,
                          codec_name="fastpfor-d1", B=16, n_parts=2)
    idx = t_builder.build(corpus.postings, corpus.n_docs,
                          codec_name="fastpfor-d1", B=16, n_parts=2,
                          device="cpu")
    seq = [r_engine.query(ref, q) for q in corpus.queries]
    return ref, idx, corpus.queries, seq


@pytest.fixture(scope="module")
def uniform():
    return _both(r_corpus.synthesize(n_docs=1 << 14, n_queries=10, seed=33))


@pytest.fixture(scope="module")
def mixed():
    table = {k: r_corpus.TABLE2_CLUEWEB[k] for k in (2, 3, 4, 5)}
    return _both(r_corpus.synthesize(n_docs=1 << 14, n_queries=32, seed=11,
                                     table=table))


def _assert_identical(results, seq):
    assert len(results) == len(seq)
    for got, want in zip(results, seq):
        assert got.count == want.count
        assert got.docs.dtype == want.docs.dtype
        assert np.array_equal(got.docs, want.docs)      # byte-identical


def _same_metrics(port, ref):
    a, b = port.metrics.summary(), ref.metrics.summary()
    assert {k: a[k] for k in DETERMINISTIC} == {k: b[k] for k in DETERMINISTIC}
    assert {k: port.stats.get(k, 0) for k in STATS} == \
        {k: ref.stats.get(k, 0) for k in STATS}


# --------------------------------------------------------------------------
# differential: served == offline, {fuse} × {drain, live}
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fuse", [True, False])
def test_server_matches_offline(uniform, fuse):
    ref, idx, queries, seq = uniform
    results, srv = server_lib.serve_open_loop(idx, queries, qps=0.0,
                                              fuse=fuse, max_batch=4)
    want, rsrv = r_server.serve_open_loop(ref, queries, qps=0.0,
                                          backend="jax", fuse=fuse,
                                          max_batch=4)
    assert srv.metrics.n_shed == 0
    _assert_identical(results, seq)
    _assert_identical(results, want)
    _same_metrics(srv, rsrv)


def test_server_live_load_matches_offline(uniform):
    ref, idx, queries, seq = uniform
    results, srv = server_lib.serve_open_loop(
        idx, queries, qps=2000.0, pattern="poisson", seed=3, max_batch=4,
        max_queue=1024, max_wait_ms=1.0)
    assert srv.metrics.n_shed == 0
    _assert_identical(results, seq)
    s = srv.metrics.summary()
    assert s["n_done"] == len(queries)
    assert s["p99_ms"] >= s["p50_ms"] > 0
    assert sum(s["queue_depth_hist"].values()) == len(queries)


@pytest.mark.parametrize("n_shards", [1, 2])
def test_server_sharded_matches_offline(uniform, n_shards):
    _, idx, queries, seq = uniform
    sharded = shard_lib.shard_index(idx, n_shards)
    results, srv = server_lib.serve_open_loop(
        idx, queries, qps=0.0, sharded=sharded, max_batch=4)
    _assert_identical(results, seq)


def test_server_sharded_on_two_cpu_devices(uniform):
    """Shards on two devices run one program each and the collector joins
    their copies (the port's per-device fan-out, on [cpu, cpu])."""
    _, idx, queries, seq = uniform
    sharded = shard_lib.shard_index(idx, 2, devices=["cpu", "cpu"])
    assert len(sharded.devices) == 2
    results, _ = server_lib.serve_open_loop(
        idx, queries, qps=0.0, sharded=sharded, max_batch=4)
    _assert_identical(results, seq)


def test_server_arrival_order_independent(mixed):
    _, idx, queries, seq = mixed
    perm = np.random.default_rng(9).permutation(len(queries))
    shuffled = [queries[i] for i in perm]
    results, _ = server_lib.serve_open_loop(idx, shuffled, qps=0.0,
                                            max_batch=8)
    for out_i, src_i in enumerate(perm):
        _assert_identical([results[out_i]], [seq[src_i]])


def test_server_pool_composes(uniform):
    ref, idx, queries, seq = uniform
    pool = source.ResidentPool(device="cpu")
    pool.warm(idx)
    results, srv = server_lib.serve_open_loop(idx, queries, qps=0.0,
                                              pool=pool, max_batch=4)
    _assert_identical(results, seq)
    assert srv.stats.get("resident_hits", 0) > 0
    rpool = r_source.ResidentPool()
    rpool.warm(ref)
    _, rsrv = r_server.serve_open_loop(ref, queries, qps=0.0, pool=rpool,
                                       max_batch=4)
    _same_metrics(srv, rsrv)
    assert pool.stats() == rpool.stats()


# --------------------------------------------------------------------------
# steady state: a warmed server launches no new program signature
# --------------------------------------------------------------------------

def test_server_steady_state_zero_compiles(mixed):
    _, idx, queries, seq = mixed
    pool = source.ResidentPool(device="cpu")
    pool.warm(idx)
    results, srv = server_lib.serve_open_loop(
        idx, queries, qps=0.0, warmup=True, pool=pool, max_batch=8)
    wu = srv.warm_report
    assert wu["converged"] and wu["n_signatures"] > 0
    assert srv.stats.get("n_compiles", 0) == 0
    _assert_identical(results, seq)
    m = srv.metrics
    assert m.unaligned_flushes == 0
    assert m.aligned_flushes == m.n_flushes > 0
    # a second warm finds every signature launched already
    assert server_lib.warm_server(srv, queries)["n_compiles"] == 0


# --------------------------------------------------------------------------
# loop policies: flush reasons + backpressure
# --------------------------------------------------------------------------

def test_server_drain_mode_flushes_full_batches(mixed):
    ref, idx, queries, seq = mixed              # 32 queries
    results, srv = server_lib.serve_open_loop(idx, queries, qps=0.0,
                                              max_batch=8)
    m = srv.metrics
    assert m.flush_deadline == 0
    assert m.flush_full + m.flush_drain == m.n_flushes == 4
    _assert_identical(results, seq)
    _, rsrv = r_server.serve_open_loop(ref, queries, qps=0.0, max_batch=8)
    _same_metrics(srv, rsrv)


def test_server_deadline_flush_fires(uniform):
    _, idx, queries, seq = uniform
    results, srv = server_lib.serve_open_loop(
        idx, queries, qps=200.0, pattern="uniform", max_batch=32,
        max_wait_ms=0.5, max_queue=64)
    m = srv.metrics
    assert m.flush_full == 0
    assert m.flush_deadline >= 1
    assert srv.metrics.n_shed == 0
    _assert_identical(results, seq)


def test_server_open_loop_times_requests_from_their_schedule(uniform,
                                                             monkeypatch):
    """Open loop, a request is timed from its due time (the sum of the
    gaps before it), not from when the event loop let it in: a launch that
    holds the loop 30 ms makes the arrivals behind it late, their lag is
    recorded, and their latency counts it."""
    _, idx, queries, seq = uniform
    launch = server_lib.ContinuousBatchingServer._launch

    def slow(self, *a, **kw):
        time.sleep(0.03)
        return launch(self, *a, **kw)

    monkeypatch.setattr(server_lib.ContinuousBatchingServer, "_launch", slow)
    gaps = [0.005] * len(queries)
    srv = server_lib.ContinuousBatchingServer(idx, max_batch=2,
                                              max_wait_ms=0.5)
    results = asyncio.run(srv.run(queries, gaps))
    _assert_identical(results, seq)
    t = np.asarray([r.t_arrive for r in srv.requests])
    assert np.allclose(t - t[0], np.cumsum(gaps) - gaps[0], atol=1e-3)
    lag = np.asarray(srv.arrival_lag_s)
    assert len(lag) == len(queries) and lag.max() > 0.02
    lat = np.asarray([r.latency_s for r in srv.requests])
    assert (lat >= lag - 1e-3).all()


def test_server_bounded_queue_sheds(uniform):
    _, idx, queries, seq = uniform
    many = queries * 4
    srv = server_lib.ContinuousBatchingServer(idx, max_batch=4, max_queue=4)
    results = asyncio.run(srv.run(many, [0.0] * len(many)))
    assert srv.metrics.n_shed == len(many) - 4
    served = [r for r in results if r is not None]
    assert len(served) == 4
    _assert_identical(served, seq[:4])
    assert srv.metrics.summary()["n_shed"] == len(many) - 4


# --------------------------------------------------------------------------
# unit: arrival processes, plan_covers, convergence flag, the ladder
# --------------------------------------------------------------------------

def test_arrival_gaps_shapes():
    for args in ((5, 0.0), (0, 100.0), (4, 100.0, "uniform"),
                 (2000, 100.0, "poisson", 1), (16, 100.0, "bursty", 1, 8)):
        assert server_lib.arrival_gaps(*args) == r_server.arrival_gaps(*args)
    assert server_lib.arrival_gaps(4, 100.0, "uniform") == [0.01] * 4
    g = server_lib.arrival_gaps(2000, 100.0, "poisson", seed=1)
    assert all(x >= 0 for x in g) and 0.005 < float(np.mean(g)) < 0.02
    b = server_lib.arrival_gaps(16, 100.0, "bursty", seed=1, burst=8)
    assert all(x == 0.0 for x in b[1:8] + b[9:16])
    with pytest.raises(ValueError):
        server_lib.arrival_gaps(4, 100.0, "sawtooth")


def test_plan_covers_predicate(mixed):
    ref, idx, queries, _ = mixed
    plan, rplan = batch_lib.FusionPlan(), r_batch.FusionPlan()
    groups = batch_lib.schedule(idx, queries)
    rgroups = r_batch.schedule(ref, queries)
    assert not batch_lib.plan_covers(groups, plan)
    assert not batch_lib.plan_covers(groups, None)
    batch_lib.fuse_groups(dict(groups), plan=plan)
    r_batch.fuse_groups(dict(rgroups), plan=rplan)
    assert plan.dims == rplan.dims
    sub = batch_lib.schedule(idx, queries[:3])
    assert batch_lib.plan_covers(sub, plan)
    assert batch_lib.plan_covers(sub, plan) == r_batch.plan_covers(
        r_batch.schedule(ref, queries[:3]), rplan)
    assert batch_lib.plan_covers({}, plan)


def test_warm_to_fixed_point_reports_convergence():
    calls = []

    def never_settles(stats):
        calls.append(1)
        stats.setdefault("signatures", set()).add(len(calls))

    n, passes, converged = batch_lib.warm_to_fixed_point(never_settles,
                                                         max_passes=3)
    assert passes == 3 and not converged and n == 3

    def settles(stats):
        stats.setdefault("signatures", set()).add(1)

    n, passes, converged = batch_lib.warm_to_fixed_point(settles)
    assert converged and n == 1 and passes == 2


def test_ladder_has_the_fused_unfused_rung_only():
    """The port's rungs are the reference's ("jax", True) rungs' fuse
    flags, fused then unfused.  The reference's third rung, pallas → jax,
    swaps the kernels for JAX's library ops; the port has one program (the
    hand kernels on the card, their plain versions on the CPU only), and a
    plain-torch rung on the card would be a hidden fallback, so it has no
    third rung.  Unfused (fuse=False) starts at the bottom."""
    ref = r_server.DegradationLadder("jax", True).levels
    assert ref == [("jax", True), ("jax", False)]
    assert server_lib.DegradationLadder(True).levels == \
        [fuse for _, fuse in ref] == [True, False]
    assert r_server.DegradationLadder("pallas", True).levels[2] == \
        ("jax", False)                           # the rung the port drops
    assert server_lib.DegradationLadder(False).levels == [False]
    srv = server_lib.ContinuousBatchingServer(None, fuse=True)
    assert srv.ladder.levels == [True, False]


# --------------------------------------------------------------------------
# live mutation: a MutableIndex behind the server
# --------------------------------------------------------------------------

def _mutable_setup(n_queries=16, seed=7, n_shards=0):
    corpus = r_corpus.synthesize(n_docs=1 << 13, n_queries=n_queries,
                                 seed=seed)
    kw = dict(codec_name="fastpfor-d1", B=16, n_parts=2, n_shards=n_shards)
    mi = segments.MutableIndex.from_postings(corpus.postings, corpus.n_docs,
                                             device="cpu", **kw)
    rmi = r_segments.MutableIndex.from_postings(corpus.postings,
                                                corpus.n_docs, **kw)
    terms = sorted({t for q in corpus.queries for t in q})
    return mi, rmi, corpus, terms


def test_server_live_mutation_windows_match_offline():
    """Rounds of adds/deletes (the same in both packages) between Poisson
    serving windows: every window's served answers equal the port's and
    the reference's offline ``MutableIndex.execute_batch`` on the
    then-current state, at zero compiles once warmed — across a seal and a
    merge (generation swap) too."""
    mi, rmi, corpus, terms = _mutable_setup()
    stats: dict = {}
    srv = server_lib.ContinuousBatchingServer(
        mutable=mi, max_batch=4, max_wait_ms=1.0, max_queue=1024,
        stats=stats)
    wu = server_lib.warm_server(srv, corpus.queries)
    assert wu["converged"]
    rng = np.random.default_rng(2)

    def mutate(n_adds=20, n_dels=5):
        for _ in range(n_adds):
            k = int(rng.integers(1, min(4, len(terms)) + 1))
            doc = sorted(rng.choice(terms, size=k, replace=False).tolist())
            assert mi.add(doc) == rmi.add(doc)
        for _ in range(n_dels):
            d = int(rng.integers(0, mi.next_doc_id))
            assert mi.delete(d) == rmi.delete(d)

    def window(seed, steady=True):
        stats.pop("n_compiles", None)
        gaps = server_lib.arrival_gaps(len(corpus.queries), 2000.0,
                                       "poisson", seed=seed)
        results = asyncio.run(srv.run(corpus.queries, gaps))
        assert srv.metrics.n_shed == 0
        _assert_identical(results, mi.execute_batch(corpus.queries))
        _assert_identical(results, rmi.execute_batch(corpus.queries,
                                                     backend="jax"))
        if steady:
            assert stats.get("n_compiles", 0) == 0

    mutate()
    window(seed=0, steady=False)
    for r in range(1, 3):
        mutate()
        window(seed=r)
    mutate()
    assert mi.seal() is not None and rmi.seal() is not None
    assert mi.merge(warm_queries=corpus.queries) is True
    assert rmi.merge() is True
    window(seed=99)
    assert mi.counters() == rmi.counters()
    assert mi.counters()["n_merges"] == 1


def test_server_mutations_between_flushes_under_poisson():
    """Mutations injected between flushes (at the server's snapshot seam)
    under Poisson traffic: each flush's answers equal a python set-model
    oracle evaluated at that flush's snapshot."""
    mi, _, corpus, terms = _mutable_setup()
    model = {t: set(corpus.postings[t].tolist()) for t in terms}
    dead: set[int] = set()
    rng = np.random.default_rng(4)
    srv = server_lib.ContinuousBatchingServer(
        mutable=mi, max_batch=4, max_wait_ms=1.0, max_queue=1024, depth=1)
    server_lib.warm_server(srv, corpus.queries)
    muts = iter(range(64))

    def mutate_once():
        if next(muts, None) is None:
            return
        for _ in range(3):
            k = int(rng.integers(1, min(4, len(terms)) + 1))
            doc = sorted(rng.choice(terms, size=k, replace=False).tolist())
            gid = mi.add(doc)
            for t in doc:
                model[t].add(gid)
        d = int(rng.integers(0, mi.next_doc_id))
        mi.delete(d)
        dead.add(d)

    orig_snapshot = srv._snapshot

    def snapshot_with_mutation():
        mutate_once()
        return orig_snapshot()

    srv._snapshot = snapshot_with_mutation

    def oracle(q):
        alive = set.intersection(*[model[t] for t in q]) - dead
        return np.asarray(sorted(alive), dtype=np.int64)

    checked = []
    orig_finalize = mi.finalize

    def checking_finalize(snap, queries, results, max_results=1 << 16):
        out = orig_finalize(snap, queries, results, max_results)
        for q, r in zip(queries, out):
            want = oracle(q)
            assert r.count == want.size, (q, r.count, want.size)
            assert np.array_equal(r.docs, want)
            checked.append(1)
        return out

    mi.finalize = checking_finalize
    try:
        stream = corpus.queries * 3
        gaps = server_lib.arrival_gaps(len(stream), 1500.0, "poisson",
                                       seed=5)
        results = asyncio.run(srv.run(stream, gaps))
    finally:
        mi.finalize = orig_finalize
        srv._snapshot = orig_snapshot
    assert srv.metrics.n_shed == 0
    assert all(r is not None for r in results)
    assert len(checked) == len(stream)
    assert mi.counters()["mutable_docs"] > 0
    assert mi.counters()["tombstones"] > 0


@pytest.mark.parametrize("n_shards", [1, 2])
def test_server_mutable_sharded_matches_offline(n_shards):
    mi, rmi, corpus, terms = _mutable_setup(
        n_queries=10, seed=21, n_shards=0 if n_shards == 1 else n_shards)
    rng = np.random.default_rng(8)
    for _ in range(15):
        k = int(rng.integers(1, min(4, len(terms)) + 1))
        doc = sorted(rng.choice(terms, size=k, replace=False).tolist())
        mi.add(doc)
        rmi.add(doc)
    for _ in range(4):
        d = int(rng.integers(0, mi.next_doc_id))
        mi.delete(d)
        rmi.delete(d)
    results, srv = server_lib.serve_open_loop(
        None, corpus.queries, qps=0.0, mutable=mi, max_batch=4)
    want, rsrv = r_server.serve_open_loop(
        None, corpus.queries, qps=0.0, mutable=rmi, max_batch=4)
    _assert_identical(results, want)
    _same_metrics(srv, rsrv)
    _assert_identical(results, mi.execute_batch(corpus.queries))
    _assert_identical(results, rmi.execute_batch(corpus.queries,
                                                 backend="jax"))
    assert _placeless(mi.stats()) == _placeless(rmi.stats())


def _placeless(stats: dict) -> dict:
    """``MutableIndex.stats()`` less the shards' device names (a torch
    device here, a JAX one in the reference): residency key for key."""
    res = dict(stats["residency"])
    if "shards" in res:
        res["shards"] = [{k: v for k, v in sh.items() if k != "device"}
                         for sh in res["shards"]]
    return {**stats, "residency": res}


# --------------------------------------------------------------------------
# the resolution audit: no request ever goes unresolved
# --------------------------------------------------------------------------

def test_server_every_request_resolves_with_explicit_outcome(uniform):
    _, idx, queries, _ = uniform
    many = queries * 4
    srv = server_lib.ContinuousBatchingServer(
        idx, max_batch=4, max_queue=4, timeout_ms=1e-4)
    results = asyncio.run(srv.run(many, [0.0] * len(many)))
    outs = srv.outcomes()
    assert len(outs) == len(many)
    assert "pending" not in outs
    assert outs.count("shed") == len(many) - 4
    assert outs.count("timeout") == 4
    assert all(r is None for r in results)
    assert all(r is None or r.done.is_set() for r in srv.requests)
    s = srv.metrics.summary()
    assert s["n_timeout"] == 4 and s["n_shed"] == len(many) - 4


def test_server_generous_timeout_serves_everything(uniform):
    _, idx, queries, seq = uniform
    results, srv = server_lib.serve_open_loop(
        idx, queries, qps=0.0, max_batch=4, timeout_ms=60_000.0)
    assert srv.outcomes() == ["done"] * len(queries)
    assert srv.metrics.n_timeout == 0
    _assert_identical(results, seq)


def test_server_cli_check_on_cpu(capsys):
    """``python -m repro_torch.launch.server --device cpu --check``: the
    reference's CLI lines, and the differential line."""
    results, srv = server_lib.main(["--queries", "24", "--qps", "0",
                                    "--batch", "8", "--warmup", "--check",
                                    "--resident", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[server] warmup:" in out
    assert "24 done / 0 shed" in out and "0 compiles" in out
    assert "24 served results byte-identical to offline execute_batch" in out
    assert len(results) == 24
