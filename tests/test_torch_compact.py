"""``compact_rows`` (``kernels/compact_rows.py``), the tail of every batched
svs program, on the CPU: its plain version against ``r[valid]`` cut to the
cap; a thread-by-thread numpy emulation of ``csrc/compact_rows.cu`` (the
tile counts, each tile's offset from its row's earlier counts, warp
ballots, the (round, warp) scan, the tiles' shares of the SENTINEL tail)
against the plain version, with mutations that must fail;
the batched paths that end in it (``execute_batch``,
``execute_pipelined``, ``execute_sharded``) against the reference's
(``backend="jax"``, the same corpus) and ``engine.query`` per query, with
``max_results`` below the answer counts so that the cap engages, 0 and
2**16; and ``chip_smoke.py``'s recorder and timer of the kernel.  The
kernel itself is checked on the card in tests/test_torch_cuda.py."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.index import batch as r_batch
from repro.index import builder as r_builder
from repro.index import pipeline as r_pipe
from repro.index import shard as r_shard
from repro.index import source as r_source
from repro_torch.core import intersect as its
from repro_torch.index import batch, builder, engine, pipeline, shard
from repro_torch.index import corpus as corpus_lib
from repro_torch.index import source
from repro_torch.kernels import compact_rows as kc
from repro_torch.kernels import ops
from repro_torch.launch import kernel_times

pytestmark = pytest.mark.torch_port

SENT = int(its.SENTINEL)
THREADS, WARPS, VEC, ROUNDS = 256, 8, 4, 4
assert kc.TILE == THREADS * VEC * ROUNDS


def _case(seed: int, B: int, M: int, density: float, pad_rows: int = 0):
    """B rows of sorted ids, ``density`` of them valid, then ``pad_rows``
    all-SENTINEL rows with nothing valid (a chunk's Bp > B)."""
    rng = np.random.default_rng(seed)
    r = np.full((B + pad_rows, M), SENT, np.int32)
    valid = np.zeros((B + pad_rows, M), bool)
    for b in range(B):
        n = int(rng.integers(M // 2, M + 1))
        r[b, :n] = np.sort(rng.choice(1 << 28, size=n, replace=False))
        valid[b, :n] = rng.random(n) < density
    return torch.from_numpy(r), torch.from_numpy(valid)


def _want(r, valid, max_results):
    """``r[valid]`` of each row cut to C = min(M, max_results), SENTINEL
    after it, the count in column C."""
    B, M = r.shape
    C = min(M, max_results)
    out = np.full((B, C + 1), SENT, np.int32)
    for b in range(B):
        kept = r[b][valid[b]].numpy()
        out[b, : min(kept.size, C)] = kept[:C]
        out[b, C] = kept.size
    return out


# (B, M, density, max_results, pad rows)
PLAIN_CASES = [
    (3, 256, 0.0, 1 << 16, 0),          # no survivors
    (3, 256, 0.3, 1 << 16, 0),          # survivors ≤ C = M < max_results
    (2, 4096, 0.5, 100, 0),             # survivors > C = max_results < M
    (4, 1000, 1.0, 1000, 2),            # all survive, C = M; pad rows
    (1, 130, 0.9, 7, 1),                # C < survivors, M not a multiple of 4
    (2, 512, 0.2, 0, 0),                # C = 0: only the counts
]


@pytest.mark.parametrize("B,M,density,cap,pad", PLAIN_CASES)
def test_plain_equals_masked_rows_cut_to_the_cap(B, M, density, cap, pad):
    r, valid = _case(B * M + pad, B, M, density, pad)
    got = kc.compact_rows_plain(r, valid, cap)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _want(r, valid, cap))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    r, valid = _case(1, 3, 300, 0.4)
    before = ops.launches()["compact_rows"]
    assert torch.equal(ops.compact_rows(r, valid, 50),
                       kc.compact_rows_plain(r, valid, 50))
    assert ops.launches()["compact_rows"] == before


# --------------------------------------------------------------------------
# the kernel, thread by thread
# --------------------------------------------------------------------------

def _tile_masks(valid: np.ndarray, b: int, t: int, M: int,
                mutate: str | None) -> tuple[np.ndarray, np.ndarray]:
    """(slots, mask) of tile t, indexed (round k, thread, j): slot
    t·TILE + (k·THREADS + tid)·VEC + j, masked past M."""
    k = np.arange(ROUNDS)[:, None, None]
    tid = np.arange(THREADS)[None, :, None]
    j = np.arange(VEC)[None, None, :]
    slots = t * kc.TILE + (k * THREADS + tid) * VEC + j
    if mutate == "thread_major":         # a thread's slots not neighbours
        slots = t * kc.TILE + k * THREADS * VEC + tid + j * THREADS
    inside = slots < M
    mask = np.zeros(slots.shape, bool)
    mask[inside] = valid[b, slots[inside]]
    return slots, mask


def emulate(r, valid, max_results: int, mutate: str | None = None
            ) -> np.ndarray:
    """``count_tiles`` then ``compact_tiles`` in numpy, block by block, the
    blocks of the second launch in reverse order (no block waits on
    another, so any order gives the same rows)."""
    r, valid = r.numpy(), valid.numpy()
    B, M = r.shape
    C = min(M, max_results)
    tiles = -(-M // kc.TILE)
    counts = np.array([[_tile_masks(valid, b, t, M, mutate)[1].sum()
                        for t in range(tiles)] for b in range(B)])
    out = np.full((B, C + 1), 12345, np.int32)    # torch.empty: any content
    for b in reversed(range(B)):
        for t in reversed(range(tiles)):
            slots, mask = _tile_masks(valid, b, t, M, mutate)
            upto = t + 1 if mutate == "own_tile_in_prefix" else t
            excl, total = int(counts[b, :upto].sum()), int(counts[b].sum())
            # three ballots a (round, warp) on the bits of each lane's
            # count: popc(ballot & lanemask_lt) is the exclusive sum of
            # the bit over the lanes before
            c = mask.sum(-1).reshape(ROUNDS, WARPS, 32)
            bits = [(c >> i) & 1 for i in range(3)]
            before = sum((1 << i) * (np.cumsum(x, -1) - x)
                         for i, x in enumerate(bits)).reshape(ROUNDS, THREADS)
            warp_counts = sum((1 << i) * x.sum(-1)
                              for i, x in enumerate(bits)).reshape(32)
            scan = np.concatenate([[0], np.cumsum(warp_counts)[:-1]])
            if excl < C:
                for k, tid in zip(*np.nonzero(mask.any(-1))):
                    p = excl + scan[k * WARPS + tid // 32] + before[k, tid]
                    for j in range(VEC):
                        if mask[k, tid, j]:
                            if p < C:
                                out[b, p] = r[b, slots[k, tid, j]]
                            p += 1
            share = -(-C // tiles)
            lo = t * share if mutate == "tail_from_share" else max(t * share,
                                                                    total)
            out[b, lo: min((t + 1) * share, C)] = SENT
            if t == 0:
                out[b, C] = total
    return out


# (B, M, density, max_results): one tile, many tiles, ragged M, a cap
# inside a tile, a cap of 0
EMULATED = [(3, 128, 0.5, 1 << 16), (2, 4096 * 3 + 100, 1e-3, 1 << 16),
            (1, 4096 * 40, 0.01, 1 << 16), (2, 4096 * 2 + 6, 1.0, 5000),
            (2, 10000, 0.5, 0)]


@pytest.mark.parametrize("B,M,density,cap", EMULATED)
def test_kernel_emulation_equals_plain(B, M, density, cap):
    r, valid = _case(M + B, B, M, density, pad_rows=1)
    want = kc.compact_rows_plain(r, valid, cap).numpy()
    assert np.array_equal(emulate(r, valid, cap), want)


@pytest.mark.parametrize("mutate", ["own_tile_in_prefix", "thread_major",
                                    "tail_from_share"])
def test_kernel_emulation_mutations_fail(mutate):
    r, valid = _case(5, 2, 4096 * 3, 0.3)
    want = kc.compact_rows_plain(r, valid, 1 << 16).numpy()
    assert not np.array_equal(emulate(r, valid, 1 << 16, mutate=mutate),
                              want)


# --------------------------------------------------------------------------
# the batched paths against the reference's and engine.query, with the cap
# engaged
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    """The port's index and the reference's, built from one corpus's numpy
    postings."""
    corpus = corpus_lib.synthesize(n_docs=1 << 15, n_queries=12, seed=29)
    index = builder.build(corpus.postings, corpus.n_docs,
                          codec_name="fastpfor-d1", B=16, n_parts=2,
                          device="cpu")
    ref = r_builder.build(corpus.postings, corpus.n_docs,
                          codec_name="fastpfor-d1", B=16, n_parts=2)
    return index, corpus.queries, ref


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.count == w.count
        assert g.docs.dtype == w.docs.dtype
        assert np.array_equal(g.docs, w.docs)


def _same_as_reference_and_engine(index, queries, got, want, max_results):
    """``got`` equals the reference's answers ``want`` on the same inputs,
    counts included, and (a second witness) the port's ``engine.query``."""
    _same(got, want)
    _same(got, [engine.query(index, q, max_results=max_results)
                for q in queries])


def _a_cap_that_engages(index, queries) -> int:
    counts = sorted(engine.query(index, q).count for q in queries)
    cap = max(counts[len(counts) // 2] // 3, 1)
    assert counts[-1] > cap
    return cap


def _cap(index, queries, cap) -> int:
    return _a_cap_that_engages(index, queries) if cap == "engaged" else cap


CAPS = ["engaged", 0, 1 << 16]


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("resident", [False, True])
def test_execute_batch_equals_engine_query(built, cap, resident):
    index, queries, ref = built
    cap = _cap(index, queries, cap)
    pools = ((source.ResidentPool(device="cpu"), r_source.ResidentPool())
             if resident else (None, None))
    stats = {}
    got = batch.execute_batch(index, queries, max_results=cap,
                              pool=pools[0], stats=stats)
    want = r_batch.execute_batch(ref, queries, backend="jax",
                                 max_results=cap, pool=pools[1])
    _same_as_reference_and_engine(index, queries, got, want, cap)
    assert stats["result_bytes"] > 0


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("depth", [1, 2])
def test_execute_pipelined_equals_engine_query_under_a_cap(built, depth,
                                                           cap):
    index, queries, ref = built
    cap = _cap(index, queries, cap)
    got = pipeline.execute_pipelined(
        index, queries, batch_size=5, depth=depth, max_results=cap,
        pool=source.ResidentPool(device="cpu"))
    want = r_pipe.execute_pipelined(
        ref, queries, batch_size=5, depth=depth, backend="jax",
        max_results=cap, pool=r_source.ResidentPool())
    _same_as_reference_and_engine(index, queries, got, want, cap)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("n_shards,devices", [(2, None),
                                              (2, [torch.device("cpu")] * 2)])
def test_execute_sharded_equals_engine_query_under_a_cap(built, n_shards,
                                                         devices, cap):
    """``launch_groups_sharded``, on one device and fanned out to two."""
    index, queries, ref = built
    cap = _cap(index, queries, cap)
    sharded = shard.shard_index(index, n_shards, devices=devices)
    stats = {}
    got = shard.execute_sharded(sharded, queries, batch_size=4,
                                max_results=cap, stats=stats)
    want = r_shard.execute_sharded(r_shard.shard_index(ref, n_shards),
                                   queries, batch_size=4, backend="jax",
                                   max_results=cap)
    _same_as_reference_and_engine(index, queries, got, want, cap)
    assert stats["result_bytes"] > 0


def test_result_bytes_count_the_compacted_rows(built):
    """``stats["result_bytes"]`` is the bytes of the copies started: an svs
    row of min(M, max_results) + 1 ints, so a cap below M narrows it."""
    index, queries, _ = built
    wide, narrow = {}, {}
    batch.execute_batch(index, queries, stats=wide)
    batch.execute_batch(index, queries, max_results=3, stats=narrow)
    assert 0 < narrow["result_bytes"] < wide["result_bytes"]
    groups = batch.fuse_groups(batch.schedule(index, queries),
                               plan=batch.FusionPlan())
    stats = {}
    pending = batch.launch_groups(groups, n_queries=len(queries),
                                  max_results=3, stats=stats)
    sizes = 0
    for key, chunk, copies in pending.launched:
        host = copies[0][0]
        width = (key.words if key.kind == "bitmap"
                 else min(key.m_bucket, 3)) + 1
        assert host.shape == (batch._bucket_rows(len(chunk)), width)
        sizes += host.numel() * 4
    assert stats["result_bytes"] == sizes


# --------------------------------------------------------------------------
# the smoke's phase 4 on compact_rows
# --------------------------------------------------------------------------

def test_the_main_path_calls_reach_a_recorder_and_its_timer(built,
                                                            monkeypatch):
    """``chip_smoke.py``'s phase-3 recorders replace the kernel modules'
    functions: the batched path's ``compact_rows`` calls (through
    ``ops.compact_rows``) reach its recorder, and its phase-4 timer holds
    the recorded calls to the plain version (the card's clocks are left
    out here)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    index, queries, _ = built
    recorders = chip_smoke.main_path_recorders()
    try:
        batch.execute_batch(index, queries, max_results=5)
    finally:
        for r in recorders:
            r.restore()
    rec = next(r for r in recorders if r.name == "compact_rows")
    assert kc.compact_rows is rec.inner and sum(rec.counts.values()) > 0
    assert chip_smoke.REPLACES["compact_rows"][1] is None
    for name in ("cuda_ms", "graph_ms", "host_us"):
        monkeypatch.setattr(kernel_times, name,
                            lambda fn, *a, **k: (fn(), 0.0)[1])
    for args, kwargs in (rec.best, rec.most_frequent()[1]):
        res = kernel_times.TIMERS["compact_rows"](args, kwargs)
        assert res["max_abs_err"] == 0
        assert 0 < res["bound_ms"] <= res["bound_5b_ms"]
        assert f"C={min(args[0].shape[1], 5)}" in res["shape"]
