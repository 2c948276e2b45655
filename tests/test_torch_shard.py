"""The port's sharded fan-out (``repro_torch.index.shard``) against the
reference's, case for case with tests/test_shard.py: sharded answers equal
the reference's ``execute_sharded`` (``backend="jax"``) and the port's
``engine.query`` at shards {1, 2, 4}; the scheduler's counters and every
shard's pool ``stats()`` (all but its device) equal the reference's.  The
CPU is one device, so every shard shares it, as the reference's shards
share its one host device; ``devices=[cpu, cpu]`` runs the per-device
fan-out (one program per device, one dispatch per chunk)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.index import builder as r_builder
from repro.index import corpus as r_corpus
from repro.index import engine as r_engine
from repro.index import shard as r_shard
from repro_torch.index import builder as t_builder
from repro_torch.index import engine as t_engine
from repro_torch.index import shard as t_shard
from repro_torch.index import source as t_source
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import serve as t_serve

pytestmark = [pytest.mark.torch_port, pytest.mark.shard]

SHARD_COUNTS = (1, 2, 4)
COUNTERS = ("n_dispatches", "n_groups", "n_items", "decoded_ints",
            "decoded_lists", "skip_folds", "resident_hits")
CPU2 = [torch.device("cpu")] * 2


def _both(postings, n_docs, codec, B, n_parts, queries):
    ref = r_builder.build(postings, n_docs, codec_name=codec, B=B,
                          n_parts=n_parts)
    port = t_builder.build(postings, n_docs, codec_name=codec, B=B,
                           n_parts=n_parts, device="cpu")
    seq = [r_engine.query(ref, q) for q in queries]
    return ref, port, queries, seq


@pytest.fixture(scope="module")
def uniform():
    """Table-2-shaped corpus with bitmaps and 4 parts (1:1 at 4 shards)."""
    corpus = r_corpus.synthesize(n_docs=1 << 14, n_queries=10, seed=33)
    return _both(corpus.postings, corpus.n_docs, "fastpfor-d1", 16, 4,
                 corpus.queries)


@pytest.fixture(scope="module")
def skewed():
    """Tiny seed + very long second term: packed folds flow through the
    sharded assembly (K5's operands from the shards' layout arenas)."""
    n_docs = 1 << 16
    table = {2: (100.0, [0.8 * (1 << 18) / n_docs,
                         38000.0 * (1 << 18) / n_docs])}
    corpus = r_corpus.synthesize(n_docs=n_docs, n_queries=4, seed=7,
                                 table=table)
    return _both(corpus.postings, corpus.n_docs, "bp8-d1", 0, 4,
                 corpus.queries)


def _assert_identical(results, seq):
    assert len(results) == len(seq)
    for got, want in zip(results, seq):
        assert got.count == want.count
        assert got.docs.dtype == want.docs.dtype
        assert np.array_equal(got.docs, want.docs)      # byte-identical


def _sigs(stats) -> set:
    return {(s[0], dataclasses.astuple(s[1]), *s[2:])
            for s in stats.get("signatures", ())}


def _shard_stats(sharded) -> dict:
    st = sharded.stats()
    return {**st, "n_devices": None, "shards": [
        {k: v for k, v in s.items() if k != "device"} for s in st["shards"]]}


def _sharded_both(ref, port, queries, n_shards, devices=None, **kw):
    """execute_sharded in each package: answers, counters, signatures and
    the placement map's pool accounting equal.  Returns the port's answers
    and counters."""
    r_sh = r_shard.shard_index(ref, n_shards)
    t_sh = t_shard.shard_index(port, n_shards, devices=devices)
    assert _shard_stats(t_sh) == _shard_stats(r_sh)
    r_stats, t_stats = {}, {}
    want = r_shard.execute_sharded(r_sh, queries, stats=r_stats, **kw)
    got = t_shard.execute_sharded(t_sh, queries, stats=t_stats, **kw)
    _assert_identical(got, want)
    for k in COUNTERS:
        assert t_stats.get(k, 0) == r_stats.get(k, 0), k
    assert _sigs(t_stats) == _sigs(r_stats)
    assert _shard_stats(t_sh) == _shard_stats(r_sh)
    return got, t_stats


# --------------------------------------------------------------------------
# sharded == sequential differential matrix
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_matches_sequential_uniform(uniform, n_shards):
    ref, port, queries, seq = uniform
    out, _ = _sharded_both(ref, port, queries, n_shards, batch_size=4,
                           depth=2)
    _assert_identical(out, seq)
    _assert_identical(out, [t_engine.query(port, q) for q in queries])


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_matches_sequential_skewed(skewed, n_shards):
    ref, port, queries, seq = skewed
    out, _ = _sharded_both(ref, port, queries, n_shards, batch_size=2,
                           depth=2)
    _assert_identical(out, seq)
    _assert_identical(out, [t_engine.query(port, q) for q in queries])


@pytest.mark.parametrize("depth", [1, 4])
def test_sharded_matches_at_other_depths(uniform, depth):
    """depth=1 (strictly serial pipeline) and depth=4 — same results."""
    ref, port, queries, seq = uniform
    out, _ = _sharded_both(ref, port, queries, 4, batch_size=4, depth=depth)
    _assert_identical(out, seq)


def test_shards_4_match_shards_1(uniform):
    _, port, queries, _ = uniform
    one = t_shard.execute_sharded(t_shard.shard_index(port, 1), queries,
                                  batch_size=4)
    four = t_shard.execute_sharded(t_shard.shard_index(port, 4), queries,
                                   batch_size=4)
    _assert_identical(four, one)


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("fixture", ["uniform", "skewed"])
def test_per_device_fan_out_on_two_cpu_devices(request, fixture, n_shards):
    """devices=[cpu, cpu]: the multi-device path — each device runs the
    program on its own shards' rows, the chunk counts as one dispatch, and
    the two results join at collect — equal to the reference's one-device
    fan-out, counters and pool accounting included."""
    ref, port, queries, seq = request.getfixturevalue(fixture)
    bs = 4 if fixture == "uniform" else 2
    out, _ = _sharded_both(ref, port, queries, n_shards, devices=CPU2,
                           batch_size=bs, depth=2)
    _assert_identical(out, seq)


def test_per_device_results_stay_apart_until_collect(uniform):
    _, port, queries, seq = uniform
    sharded = t_shard.shard_index(port, 4, devices=CPU2)
    groups = t_shard.batch_lib.schedule(port, queries, pool=sharded.pool_map)
    pending = t_shard.launch_groups_sharded(sharded, groups,
                                            n_queries=len(queries))
    for key, flat, copies in pending.launched:
        assert len(copies) == 2                 # one result per device
        assert sum(h.shape[0] for h, _ in copies) == len(flat)
        assert None in flat or len(flat) % 4 == 0
    _assert_identical(t_shard.batch_lib.collect_batch(pending), seq)


# --------------------------------------------------------------------------
# edges
# --------------------------------------------------------------------------

def test_sharded_empty_batch(uniform):
    _, port, _, _ = uniform
    sharded = t_shard.shard_index(port, 2)
    assert t_shard.execute_sharded(sharded, [], batch_size=8) == []


def test_sharded_single_query(uniform):
    ref, port, queries, seq = uniform
    out, _ = _sharded_both(ref, port, [queries[0]], 4, batch_size=8)
    _assert_identical(out, seq[:1])


def test_single_part_many_shards():
    corpus = r_corpus.synthesize(n_docs=1 << 13, n_queries=6, seed=5)
    ref, port, queries, seq = _both(corpus.postings, corpus.n_docs,
                                    "fastpfor-d1", 16, 1, corpus.queries)
    sharded = t_shard.shard_index(port, 4)
    assert set(sharded.part_shard) == {0}
    out, _ = _sharded_both(ref, port, queries, 4, batch_size=4)
    _assert_identical(out, seq)


def test_empty_part_term():
    rng = np.random.default_rng(3)
    n_docs = 1 << 13
    lo_only = np.sort(rng.choice(n_docs // 4, 300, replace=False))   # part 0
    spread = np.sort(rng.choice(n_docs, 2000, replace=False))
    ref, port, queries, seq = _both([lo_only, spread], n_docs,
                                    "fastpfor-d1", 0, 4, [[0, 1]])
    out, _ = _sharded_both(ref, port, queries, 4, batch_size=2)
    _assert_identical(out, seq)


# --------------------------------------------------------------------------
# placement-map accounting
# --------------------------------------------------------------------------

def test_placement_map_contiguous_cover(uniform):
    ref, port, _, _ = uniform
    for n_shards in SHARD_COUNTS:
        sharded = t_shard.shard_index(port, n_shards, warm=False)
        ps = sharded.part_shard
        assert ps == r_shard.shard_index(ref, n_shards, warm=False).part_shard
        assert len(ps) == len(port.parts)
        assert ps == sorted(ps)
        assert set(ps) <= set(range(n_shards))
        assert ps[0] == 0 and ps[-1] == n_shards - 1 or n_shards == 1


@pytest.mark.parametrize("devices", [None, CPU2])
def test_pools_pinned_to_placement(uniform, devices):
    _, port, _, _ = uniform
    sharded = t_shard.shard_index(port, 4, devices=devices, warm=False)
    assert len(sharded.pools) == 4
    for pool, dev in zip(sharded.pools, sharded.placement):
        assert isinstance(pool, t_source.ResidentPool)
        assert pool.device == dev
    ndev = len(sharded.devices)
    assert ndev == (1 if devices is None else 2)
    per = 4 // ndev
    for s, dev in enumerate(sharded.placement):
        assert dev == sharded.devices[s // per]


def test_warm_stages_per_shard(uniform):
    _, port, queries, seq = uniform
    sharded = t_shard.shard_index(port, 4)
    st = sharded.stats()
    assert st["n_shards"] == 4
    assert [s["parts"] for s in st["shards"]] == [[0], [1], [2], [3]]
    for s in st["shards"]:
        assert s["resident_lists"] > 0
        assert s["resident_ints"] > 0
        assert s["device"] == "cpu"
    pool = sharded.pools[-1]
    key = next(iter(pool._store))
    assert pool._store[key]["dev"].device == sharded.placement[-1]
    t_shard.execute_sharded(sharded, queries, batch_size=4)
    stats: dict = {}
    out = t_shard.execute_sharded(sharded, queries, batch_size=4, stats=stats)
    _assert_identical(out, seq)
    assert stats.get("decoded_lists", 0) == 0


def test_sharded_skip_folds_still_fire(skewed):
    ref, port, queries, seq = skewed
    out, stats = _sharded_both(ref, port, queries, 2, batch_size=2)
    _assert_identical(out, seq)
    assert stats.get("skip_folds", 0) > 0


def test_index_mesh_on_the_cpu():
    assert t_mesh.make_index_mesh(device_type="cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError):
        t_mesh.make_index_mesh(2, device_type="cpu")


def test_sharded_timings_split_assembly_and_launch(uniform):
    _, port, queries, seq = uniform
    tm = t_shard.pipe_lib.StageTimings()
    out = t_shard.execute_sharded(t_shard.shard_index(port, 2), queries,
                                  batch_size=4, timings=tm)
    _assert_identical(out, seq)
    assert tm.batches == 3 and tm.assemble > 0 and tm.dispatch > 0


# --------------------------------------------------------------------------
# the serve CLI's sharded path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shards", ["1", "2", "4"])
def test_serve_shards_hits_equal_sequential(shards):
    base = ["--queries", "8", "--device", "cpu"]
    seq = t_serve.main(base)
    rep = t_serve.main(base + ["--shards", shards])
    assert rep["hits"] == seq["hits"]
    for a, b in zip(rep["results"], seq["results"]):
        assert a.count == b.count and np.array_equal(a.docs, b.docs)
