"""The port's mutable segmented index (``repro_torch.index.segments``)
against the reference's, case for case with tests/test_segments.py and
tests/test_segments_prop.py: the same operations drive a port
``MutableIndex`` (on the CPU) and, where the case allows it, the
reference's beside it; answers must equal a rebuild from scratch through
the reference (``builder.build`` + ``engine.query``) and the reference's
``MutableIndex.execute_batch`` (``backend="jax"``), and ``counters()`` and
``stats()`` must equal the reference's key for key.  The property cases
run through tests/_hypothesis_compat.py; the port has one backend, so the
reference's {backend} × {fuse} × {shards} cells become {fuse} × {shards}."""

import tempfile
import threading

import numpy as np
import pytest

from _hypothesis_compat import HealthCheck, given, settings, st
from repro.index import builder as r_builder
from repro.index import engine as r_engine
from repro.index import segments as r_segments
from repro_torch.index import durability, segments
from repro_torch.launch import faults

pytestmark = [pytest.mark.torch_port, pytest.mark.segments]

V = 8
CODEC = "bp-d1"
B = 16
QUERIES = [[t] for t in range(V)] + [[0, 1], [2, 5], [1, 3, 6], [0, 4, 7]]


def _seed_corpus(n_docs=400, seed=3):
    """Terms 0..3 dense (sealed as bitmaps), 4..7 sparse (packed lists)."""
    rng = np.random.default_rng(seed)
    post = []
    for t in range(V):
        p = 0.5 / (1 + t) if t < 4 else 0.015
        keep = rng.random(n_docs) < p
        post.append(np.flatnonzero(keep).astype(np.int64))
    return post


def _model_from(postings):
    model = {}
    for t, docs in enumerate(postings):
        for d in docs.tolist():
            model.setdefault(int(d), set()).add(t)
    return model


def _oracle(model, n_docs, v=V):
    """The reference's rebuild from scratch of the live corpus."""
    post = [np.asarray(sorted(d for d, ts in model.items() if t in ts),
                       dtype=np.int64) for t in range(v)]
    return r_builder.build(post, max(n_docs, 1), codec_name=CODEC, B=B,
                           n_parts=2)


def _same(a, b):
    assert len(a) == len(b)
    for g, w in zip(a, b):
        assert g.count == w.count
        assert np.array_equal(g.docs, w.docs)
        assert g.docs.dtype == w.docs.dtype == np.int64


def _placeless(stats: dict) -> dict:
    """``stats()`` less the shards' device names (torch against JAX)."""
    res = dict(stats["residency"])
    if "shards" in res:
        res["shards"] = [{k: v for k, v in sh.items() if k != "device"}
                         for sh in res["shards"]]
    return {**stats, "residency": res}


def _assert_identical(mi, model, *, fuse=True, stats=None, rmi=None,
                      queries=QUERIES, v=V):
    got = mi.execute_batch([list(q) for q in queries], fuse=fuse,
                           stats=stats)
    idx = _oracle(model, mi.next_doc_id, v)
    _same(got, [r_engine.query(idx, list(q)) for q in queries])
    if rmi is not None:
        _same(got, rmi.execute_batch([list(q) for q in queries],
                                     backend="jax", fuse=fuse))
        assert mi.counters() == rmi.counters()
        assert _placeless(mi.stats()) == _placeless(rmi.stats())


def _both_from_postings(post, n_docs, **kw):
    return (segments.MutableIndex.from_postings(post, n_docs, device="cpu",
                                                **kw),
            r_segments.MutableIndex.from_postings(post, n_docs, **kw))


def _mutated_index(n_shards=0):
    """Seed corpus → adds → seal → more adds → deletes, in both packages:
    two sealed segments, a live mutable segment and tombstones in both."""
    post = _seed_corpus()
    model = _model_from(post)
    mi, rmi = _both_from_postings(post, 400, codec_name=CODEC, B=B,
                                  n_parts=2, n_shards=n_shards)
    rng = np.random.default_rng(11)
    for _ in range(60):
        terms = sorted(rng.choice(V, size=rng.integers(1, 4),
                                  replace=False).tolist())
        gid = mi.add(terms)
        assert rmi.add(terms) == gid
        model[gid] = set(terms)
    mi.seal()
    rmi.seal()
    for _ in range(25):
        terms = sorted(rng.choice(V, size=rng.integers(1, 4),
                                  replace=False).tolist())
        gid = mi.add(terms)
        rmi.add(terms)
        model[gid] = set(terms)
    for d in rng.choice(sorted(model), size=90, replace=False).tolist():
        mi.delete(int(d))
        rmi.delete(int(d))
        del model[int(d)]
    return mi, rmi, model


# -- basic lifecycle --------------------------------------------------------

def test_mutable_only_matches_oracle():
    mi = segments.MutableIndex(codec_name=CODEC, B=B, n_parts=2,
                               device="cpu")
    rmi = r_segments.MutableIndex(codec_name=CODEC, B=B, n_parts=2)
    model = {}
    rng = np.random.default_rng(0)
    for _ in range(50):
        terms = sorted(rng.choice(V, size=rng.integers(1, 4),
                                  replace=False).tolist())
        model[mi.add(terms)] = set(terms)
        rmi.add(terms)
    _assert_identical(mi, model, rmi=rmi)
    assert mi.counters()["n_segments"] == 0
    assert mi.counters()["mutable_docs"] == 50


def test_seal_then_mutate_matches_oracle():
    mi, rmi, model = _mutated_index()
    c = mi.counters()
    assert c["n_segments"] == 2 and c["mutable_docs"] == 25
    assert c["tombstones"] == 90 and c["n_seals"] == 1
    _assert_identical(mi, model, rmi=rmi)


def test_add_rejects_empty_and_delete_validates():
    mi = segments.MutableIndex(device="cpu")
    with pytest.raises(ValueError):
        mi.add([])
    gid = mi.add([0, 1])
    with pytest.raises(KeyError):
        mi.delete(gid + 1)
    assert mi.delete(gid) is True
    assert mi.delete(gid) is False


def test_seal_empty_is_noop():
    mi = segments.MutableIndex(device="cpu")
    assert mi.seal() is None
    assert mi.generation == 0 and mi.counters()["n_seals"] == 0
    assert mi.counters() == r_segments.MutableIndex().counters()


def test_vocab_growth_new_term_after_seal():
    mi = segments.MutableIndex(codec_name=CODEC, B=B, device="cpu")
    model = {}
    for i in range(30):
        model[mi.add([i % 3])] = {i % 3}
    mi.seal()
    for i in range(10):
        terms = {i % 3, 6}                      # term 6: post-seal vocab
        model[mi.add(sorted(terms))] = terms
    _assert_identical(mi, model, queries=[[6], [0, 6], [5]], v=7)


def test_tombstones_filter_bitmap_and_list_postings():
    mi, rmi, model = _mutated_index()
    view = mi._state[0].view
    kinds = {tp.kind for part in view.parts
             for tp in part.terms.values() if tp.kind != "empty"}
    assert "bitmap" in kinds and "list" in kinds
    _assert_identical(mi, model, fuse=False, rmi=rmi)


def test_delete_changes_no_signatures():
    mi, _, model = _mutated_index()
    wu = mi.warm([list(q) for q in QUERIES])
    assert wu["converged"]
    for d in sorted(model)[:20]:
        mi.delete(int(d))
        del model[int(d)]
    stats = {}
    _assert_identical(mi, model, stats=stats)
    assert stats.get("n_compiles", 0) == 0


# -- merge ------------------------------------------------------------------

def test_merge_compacts_and_matches_oracle():
    mi, rmi, model = _mutated_index()
    assert mi.merge() is True and rmi.merge() is True
    c = mi.counters()
    assert c["n_merges"] == 1 and c["n_segments"] == 1
    _assert_identical(mi, model, rmi=rmi)
    live, rlive = mi.live_postings(), rmi.live_postings()
    for t in range(V):
        want = np.asarray(sorted(d for d, ts in model.items() if t in ts),
                          dtype=np.int64)
        assert np.array_equal(live[t], want)
        assert np.array_equal(live[t], rlive[t])


def test_merge_noop_when_nothing_to_compact():
    mi = segments.MutableIndex.from_postings(_seed_corpus(), 400,
                                             codec_name=CODEC, B=B,
                                             device="cpu")
    assert mi.merge() is False
    assert mi.counters()["n_merges"] == 0


STAGES = ["snapshot", "decode", "build", "stage", "warm", "swap"]


class _Crash(RuntimeError):
    pass


@pytest.mark.parametrize("crash_at", STAGES)
def test_merge_fault_injection_leaves_old_generation(crash_at):
    mi, _, model = _mutated_index()
    gen0 = mi.generation
    before = mi.execute_batch([list(q) for q in QUERIES])

    def hook(stage):
        if stage == crash_at:
            raise _Crash(stage)

    with pytest.raises(_Crash):
        mi.merge(hook=hook)
    assert mi.generation == gen0
    assert mi.counters()["n_merges"] == 0
    _same(mi.execute_batch([list(q) for q in QUERIES]), before)
    _assert_identical(mi, model)
    assert mi.merge() is True
    assert mi.counters()["n_merges"] == 1
    _assert_identical(mi, model)


def test_merge_guard_rejects_concurrent_merge():
    mi, _, model = _mutated_index()
    entered, release = threading.Event(), threading.Event()

    def hook(stage):
        if stage == "decode":
            entered.set()
            release.wait(timeout=30)

    t = mi.merge_async(hook=hook)
    assert entered.wait(timeout=30)
    assert mi.merge() is False
    release.set()
    t.join(timeout=60)
    assert mi.counters()["n_merges"] == 1
    _assert_identical(mi, model)


def test_merge_absorbs_seal_published_mid_merge():
    mi, _, model = _mutated_index()
    late = {}

    def hook(stage):
        if stage == "stage":
            for terms in ([1, 2], [0, 7]):
                late[mi.add(terms)] = set(terms)
            mi.seal()

    assert mi.merge(hook=hook) is True
    model.update(late)
    _assert_identical(mi, model)
    assert mi.counters()["n_segments"] == 2


def test_serving_never_pauses_during_background_merge():
    mi, _, model = _mutated_index()
    mi.warm([list(q) for q in QUERIES])
    gen0 = mi.generation
    mid_merge = threading.Event()

    def hook(stage):
        if stage == "build":
            mid_merge.set()

    t = mi.merge_async(hook=hook)
    assert mid_merge.wait(timeout=60)
    _assert_identical(mi, model)
    t.join(timeout=120)
    assert not t.is_alive()
    assert mi.generation > gen0
    _assert_identical(mi, model)


def test_merge_warm_keeps_zero_compiles_across_swap():
    mi, _, model = _mutated_index()
    queries = [list(q) for q in QUERIES]
    mi.warm(queries)
    assert mi.merge(warm_queries=queries) is True
    stats = {}
    _assert_identical(mi, model, stats=stats)
    assert stats.get("n_compiles", 0) == 0


# -- residency / generations ------------------------------------------------

def test_generation_pool_tag_tracks_gid():
    mi, rmi, _ = _mutated_index()
    gen = mi._state[0]
    assert gen.pool is not None
    assert gen.pool.tag == gen.gid == rmi._state[0].gid
    assert mi.stats()["residency"]["tag"] == gen.gid


def test_seal_carries_resident_buffers_forward():
    mi = segments.MutableIndex.from_postings(_seed_corpus(), 400,
                                             codec_name=CODEC, B=B,
                                             n_parts=2, device="cpu")
    old = mi._state[0]
    old_keys = set(old.pool._store)
    assert old_keys, "seed generation staged nothing"
    for terms in ([0, 1], [2, 3], [4, 5]):
        mi.add(terms)
    mi.seal()
    new = mi._state[0]
    assert new.pool is not old.pool
    assert old_keys <= set(new.pool._store)
    for key in old_keys:                        # the same device tensors
        assert new.pool._store[key]["dev"] is old.pool._store[key]["dev"]


def test_sharded_lifecycle_matches_oracle():
    mi, rmi, model = _mutated_index(n_shards=2)
    assert mi._state[0].sharded is not None
    _assert_identical(mi, model, rmi=rmi)
    assert mi.merge() is True and rmi.merge() is True
    _assert_identical(mi, model, fuse=False, rmi=rmi)


# -- merge_async failure surfacing ------------------------------------------

def test_merge_async_retries_and_clears_error():
    mi, _, model = _mutated_index()
    crashed = []

    def hook(stage):
        if stage == "build" and not crashed:
            crashed.append(1)
            raise _Crash("build")

    t = mi.merge_async(hook=hook, retries=2, retry_backoff_s=0.01)
    t.join(timeout=120)
    assert not t.is_alive()
    c = mi.counters()
    assert c["n_merges"] == 1 and c["merge_failures"] == 1
    assert c["last_merge_error"] is None
    _assert_identical(mi, model)


def test_merge_async_exhausted_retries_surface_error():
    mi, _, model = _mutated_index()

    def hook(stage):
        if stage == "decode":
            raise _Crash("decode stage down")

    t = mi.merge_async(hook=hook, retries=1, retry_backoff_s=0.01)
    t.join(timeout=120)
    c = mi.counters()
    assert c["n_merges"] == 0 and c["merge_failures"] == 2
    assert "_Crash" in c["last_merge_error"]
    assert "decode stage down" in c["last_merge_error"]
    _assert_identical(mi, model)


# --------------------------------------------------------------------------
# property cases (tests/test_segments_prop.py)
# --------------------------------------------------------------------------

PV = 6
PROBES = ([[t] for t in range(PV)]
          + [[0, 1], [2, 3], [1, 4, 5], [0, 1, 2], [3, 5]])
FAULTS = ([("crash", p) for p in faults.CRASH_POINTS]
          + [("torn", p) for p in faults.TEAR_POINTS])


def _term_set():
    return st.lists(st.integers(0, PV - 1), min_size=1, max_size=3,
                    unique=True)


OPS = st.lists(
    st.one_of(
        st.tuples(st.just("add"), _term_set()),
        st.tuples(st.just("add"), _term_set()),
        st.tuples(st.just("add"), _term_set()),
        st.tuples(st.just("delete"), st.integers(0, 1 << 20)),
        st.tuples(st.just("query"), _term_set()),
        st.tuples(st.just("seal"), st.just(0)),
        st.tuples(st.just("merge"), st.just(0)),
    ),
    min_size=5, max_size=30)

OPS_CRASH = st.lists(
    st.one_of(
        st.tuples(st.just("add"), _term_set()),
        st.tuples(st.just("add"), _term_set()),
        st.tuples(st.just("add"), _term_set()),
        st.tuples(st.just("delete"), st.integers(0, 1 << 20)),
        st.tuples(st.just("query"), _term_set()),
        st.tuples(st.just("seal"), st.just(0)),
        st.tuples(st.just("merge"), st.just(0)),
        st.tuples(st.just("crash"), st.integers(0, 1 << 20)),
        st.tuples(st.just("crash"), st.integers(0, 1 << 20)),
    ),
    min_size=6, max_size=24)


def _run_sequence(ops, *, fuse: bool, n_shards: int):
    """One op sequence on a port index and a reference one in lockstep:
    every query point and the final probes equal the reference's rebuild,
    and the final counters equal the reference index's."""
    kw = dict(codec_name=CODEC, B=B, n_parts=2,
              n_shards=0 if n_shards == 1 else n_shards)
    mi = segments.MutableIndex(device="cpu", **kw)
    rmi = r_segments.MutableIndex(**kw)
    model: dict[int, set] = {}
    n_adds = 0
    for op, arg in ops:
        if op == "add":
            gid = mi.add(sorted(arg))
            assert rmi.add(sorted(arg)) == gid
            model[gid] = set(arg)
            n_adds += 1
        elif op == "delete":
            live = sorted(model)
            if live:
                d = live[arg % len(live)]
                assert mi.delete(d) and rmi.delete(d)
                del model[d]
        elif op == "query":
            _assert_identical(mi, model, fuse=fuse, queries=[sorted(arg)],
                              v=PV)
        elif op == "seal":
            mi.seal()
            rmi.seal()
        elif op == "merge":
            assert mi.merge() == rmi.merge()
    _assert_identical(mi, model, fuse=fuse, queries=PROBES, v=PV)
    c = mi.counters()
    assert c == rmi.counters()
    assert c["next_doc_id"] == n_adds


def _run_sequence_durable(ops, *, fuse: bool):
    """The durable variant: a ``crash`` op arms one registered fault, drives
    an aimed burst at it and, if it fired, recovers from the directory and
    goes on with the recovered index; the model keeps acknowledged ops
    only."""
    with tempfile.TemporaryDirectory() as wal_dir:
        injector = faults.FaultInjector(seed=0)
        log = durability.DurableLog(wal_dir, injector=injector)
        mi = segments.MutableIndex(codec_name=CODEC, B=B, n_parts=2,
                                   wal=log, device="cpu")
        model: dict[int, set] = {}
        n_adds = 0
        for op, arg in ops:
            if op == "add":
                model[mi.add(sorted(arg))] = set(arg)
                n_adds += 1
            elif op == "delete":
                live = sorted(model)
                if live:
                    d = live[arg % len(live)]
                    assert mi.delete(d)
                    del model[d]
            elif op == "query":
                _assert_identical(mi, model, fuse=fuse,
                                  queries=[sorted(arg)], v=PV)
            elif op == "seal":
                mi.seal()
            elif op == "merge":
                mi.merge()
            elif op == "crash":
                kind, point = FAULTS[arg % len(FAULTS)]
                injector.arm(kind, point, 1)
                try:
                    for t in range(PV):
                        gid = mi.add([t])
                        model[gid] = {t}
                        n_adds += 1
                    live = sorted(model)
                    victim = live[arg % len(live)]
                    if mi.delete(victim):
                        del model[victim]
                    mi.seal()
                    mi.merge(hook=injector.merge_hook())
                except faults.InjectedCrash:
                    injector.disarm_all()
                    mi = segments.MutableIndex.recover(
                        wal_dir, injector=injector, device="cpu")
                else:
                    injector.disarm_all()
        _assert_identical(mi, model, fuse=fuse, queries=PROBES, v=PV)
        assert mi.counters()["next_doc_id"] == n_adds


@settings(max_examples=15, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=OPS)
def test_op_sequences_differential_primary(ops):
    _run_sequence(ops, fuse=True, n_shards=1)


@pytest.mark.parametrize("fuse,n_shards", [(False, 1), (True, 2), (False, 2)],
                         ids=lambda v: str(v))
@settings(max_examples=5, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=OPS)
def test_op_sequences_differential_matrix(fuse, n_shards, ops):
    _run_sequence(ops, fuse=fuse, n_shards=n_shards)


@pytest.mark.faults
@settings(max_examples=10, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=OPS_CRASH)
def test_op_sequences_crash_recover_primary(ops):
    _run_sequence_durable(ops, fuse=True)


@pytest.mark.faults
@settings(max_examples=4, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=OPS_CRASH)
def test_op_sequences_crash_recover_unfused(ops):
    _run_sequence_durable(ops, fuse=False)


def test_harness_engine_present():
    ran = []

    @given(x=st.integers(0, 3))
    def probe(x):
        ran.append(x)

    probe()
    assert ran, "property engine did not generate examples"
