"""Differential tests of the port's codec breadth (StreamVByte, the
composite codec, the per-payload codec registry, the storage autotuner)
against the JAX reference, ported from tests/test_codecs_roundtrip.py and
tests/test_fusion.py.  Inputs come from a numpy seed and go to both packages
as numpy; every comparison is exact.  The reference's StreamVByte Pallas
kernel runs in interpret mode; the port's K7 runs as its plain version (CPU
tensors).  The hand kernels are held against the plain versions on the card
in tests/test_torch_cuda.py."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import codecs as r_codecs
from repro.core import composite as r_comp
from repro.core import streamvbyte as r_svb
from repro.core.deltas import MODES
from repro.index import batch as r_batch
from repro.index import builder as r_builder
from repro.index import corpus as r_corpus
from repro.index import engine as r_engine
from repro.kernels import svb_decode as r_kd
from repro_torch.core import codecs as t_codecs
from repro_torch.core import composite as t_comp
from repro_torch.core import streamvbyte as t_svb
from repro_torch.index import batch as t_batch
from repro_torch.index import builder as t_builder
from repro_torch.index import engine as t_engine
from repro_torch.kernels import svb_decode as t_kd

pytestmark = pytest.mark.torch_port

FAMILIES = ["bp", "bp8", "fastpfor", "streamvbyte", "composite"]
DELTA_MODES = [m for m in MODES if m != "none"]
# composite is registered for d1 only, as in the reference
SWEEP = [(f, m) for f in FAMILIES for m in DELTA_MODES
         if f != "composite" or m == "d1"]


def _cases(rng):
    """The reference's adversarial value sets: block/tail/width boundaries."""
    yield "empty", np.zeros(0, np.int64)
    yield "single", np.array([7], np.int64)
    yield "single_zero", np.array([0], np.int64)
    yield "dense_run", np.arange(1000, dtype=np.int64)
    yield "block_exact", np.arange(0, 2048, 2, dtype=np.int64)  # 1024 ints
    yield "block_plus_one", np.arange(0, 2050, 2, dtype=np.int64)
    yield "lane_tail", np.sort(rng.choice(1 << 20, 129, replace=False))
    yield ("extremes_32bit",
           np.array([0, 1, 2**31 - 1, 2**32 - 2, 2**32 - 1], np.int64))
    yield ("wide_gaps",
           np.cumsum(rng.integers(1, 1 << 24, 300)).astype(np.int64))


def _np(x) -> np.ndarray:
    """A port tensor or a reference array as numpy, uint32 as uint32."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _same_payload(ref, port):
    """Field by field over the reference's dataclass: arrays bit for bit
    (int32 tensors viewed as the reference's dtype), scalars equal."""
    if ref is None:
        assert port is None
        return
    assert type(ref).__name__ == type(port).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if dataclasses.is_dataclass(a):
            _same_payload(a, b)
        elif isinstance(b, torch.Tensor) or isinstance(a, np.ndarray) \
                or hasattr(a, "shape"):
            a = np.asarray(a)
            b = _np(b)
            assert a.shape == b.shape, f.name
            assert np.array_equal(a, b.view(a.dtype)), f.name
        else:
            assert a == b, f.name


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


# --------------------------------------------------------------------------
# roundtrip sweep and registry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fam,mode", SWEEP)
def test_roundtrip_sweep(fam, mode):
    """Every family × delta mode × adversarial case: the port's encode equals
    the reference's, and its host and CPU decodes give the values."""
    name = f"{fam}-{mode}"
    rc, tc = r_codecs.get_codec(name), t_codecs.get_codec(name)
    rng = np.random.default_rng(5)
    for label, vals in _cases(rng):
        renc, tenc = rc.encode(vals), tc.encode(vals)
        _same_payload(renc, tenc)
        host = np.asarray(tc.decode_np(tenc))[: len(vals)].astype(np.int64)
        np.testing.assert_array_equal(host, vals, err_msg=f"{name}/{label}")
        np.testing.assert_array_equal(
            host, np.asarray(rc.decode_np(renc))[: len(vals)].astype(np.int64))
        dev = _u32(tc.decode(tenc))[: len(vals)].astype(np.int64)
        np.testing.assert_array_equal(dev, vals, err_msg=f"{name}/{label}")
        assert tc.bits_per_int(tenc) == rc.bits_per_int(renc)


@pytest.mark.parametrize("fam", ["streamvbyte", "composite"])
def test_device_decode_matches_reference(fam):
    """``decode`` (StreamVByte: K7's plain version over the pow2-padded
    operands; composite: K1's plain version + the varint tail) gives the
    reference's ``decode`` output in every position, pads included."""
    rc, tc = r_codecs.get_codec(f"{fam}-d1"), t_codecs.get_codec(f"{fam}-d1")
    rng = np.random.default_rng(9)
    for label, vals in _cases(rng):
        want = np.asarray(rc.decode(rc.encode(vals)))
        got = _u32(tc.decode(tc.encode(vals)))
        np.testing.assert_array_equal(got, want.astype(np.uint32),
                                      err_msg=f"{fam}/{label}")


def test_codec_registry_resolves_new_families():
    x = np.arange(0, 30000, 3)
    assert t_codecs.family_of(t_codecs.get_codec("svb-d2").encode(x)) \
        == "streamvbyte"
    assert t_codecs.family_of(t_codecs.get_codec("composite-d1").encode(x)) \
        == "composite"
    for name in ("streamvbyte-dv", "composite-d1", "varint", "bp8-d4"):
        enc = t_codecs.get_codec(name).encode(x)
        ref = r_codecs.get_codec(name).encode(x)
        assert type(t_codecs.codec_for(enc)).__name__ \
            == type(r_codecs.codec_for(ref)).__name__
    # "auto" resolves to the default family, as in the reference
    assert type(t_codecs.get_codec("auto")).__name__ == "_BPCodec"
    assert t_codecs.get_codec("auto").mode == "d1"
    assert {"streamvbyte-d1", "streamvbyte-dv", "composite-d1"} \
        <= set(t_codecs.ALL_CODECS)


# --------------------------------------------------------------------------
# StreamVByte layout and K7's plain version
# --------------------------------------------------------------------------

def test_streamvbyte_control_stream_layout():
    vals = np.array([3, 300, 70000, 2**25], np.int64)
    sl = t_svb.encode(vals, mode="none")
    codes = [(int(_u32(sl.ctrl)[0, 0]) >> (2 * i)) & 3 for i in range(4)]
    assert codes == [0, 1, 2, 3]
    np.testing.assert_array_equal(t_svb.decode_np(sl)[:4], vals)
    rng = np.random.default_rng(2)
    for mode in MODES:
        for rows in (1, 2, 8):
            for n in (0, 1, 300, 4097):
                v = np.sort(rng.choice(1 << 31, n, replace=False))
                ref = r_svb.encode(v, mode=mode, block_rows=rows)
                port = t_svb.encode(v, mode=mode, block_rows=rows)
                _same_payload(ref, port)
                np.testing.assert_array_equal(t_svb.decode_np(port),
                                              r_svb.decode_np(ref))
                assert t_svb.bits_per_int(port) == r_svb.bits_per_int(ref)


def _svb_operands(seed: int, K: int, rows: int, DW: int):
    """Random K7 operands: every byte length, offsets at 0, inside and at
    the end of the data stream (clamped reads), random seeds."""
    rng = np.random.default_rng(seed)
    ctrl = rng.integers(0, 1 << 32, (K, 8 * rows), dtype=np.uint64)
    data = rng.integers(0, 1 << 32, DW, dtype=np.uint64)
    doffs = rng.integers(0, 4 * DW, K)
    doffs[::2] = 4 * DW - 1 - rng.integers(0, 8, doffs[::2].size)
    doffs[0] = 0
    seeds = rng.integers(0, 1 << 32, K, dtype=np.uint64)
    return (ctrl.astype(np.uint32), data.astype(np.uint32),
            doffs.astype(np.int32), seeds.astype(np.uint32))


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("mode", MODES)
def test_plain_decode_svb_matches_reference_kernel(mode):
    """The port's ``decode_svb`` and ``unpack_svb_blocks`` (CPU) equal the
    reference's jnp ``decode_svb`` and its Pallas kernel (interpret), on
    encoded lists and on random operands, K ≤ 8 blocks."""
    rng = np.random.default_rng(len(mode))
    cases = []
    for rows in (1, 2, 8):
        v = np.sort(rng.choice(1 << 30, 5 * 128 * rows - 17, replace=False))
        sl = r_svb.encode(v, mode=mode, block_rows=rows)
        seeds = np.concatenate([[0], sl.maxes[:-1]]).astype(np.uint32)
        cases.append((rows, (sl.ctrl, sl.data, sl.doffs, seeds)))
        cases.append((rows, _svb_operands(rows, 8 if rows == 1 else 3, rows,
                                          5 if rows == 1 else 300)))
    for rows, ops_ in cases:
        want = np.asarray(r_kd.decode_svb(*ops_, mode=mode, block_rows=rows))
        kern = np.asarray(r_kd.unpack_svb_blocks(*ops_, mode=mode,
                                                 block_rows=rows,
                                                 interpret=True))
        np.testing.assert_array_equal(kern, want)
        targs = [_t(a) for a in ops_]
        np.testing.assert_array_equal(
            _u32(t_kd.decode_svb(*targs, mode, rows)), want)
        np.testing.assert_array_equal(
            _u32(t_kd.unpack_svb_blocks(*targs, mode, rows)), want)


@pytest.mark.parametrize("n", [1, 300, 1024, 4096])
def test_decode_bucketed_matches_reference(n):
    """The pow2-padded decode equals the reference's in every position (pad
    blocks decode the same clamped garbage) for every mode."""
    rng = np.random.default_rng(11)
    vals = np.sort(rng.choice(1 << 28, n, replace=False)).astype(np.int64)
    for mode in DELTA_MODES:
        ref = r_svb.encode(vals, mode=mode)
        port = t_svb.encode(vals, mode=mode)
        want = np.asarray(r_kd.decode_bucketed(ref))
        got = _u32(t_kd.decode_bucketed(port))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[:n].astype(np.int64), vals)
        assert port.bucketed is not None          # padded once, kept


# --------------------------------------------------------------------------
# composite
# --------------------------------------------------------------------------

def test_composite_head_tail_split():
    per = t_comp.DEFAULT_ROWS * 128
    rng = np.random.default_rng(3)
    for n in (per - 1, per, per + 1, 3 * per + 17):
        vals = np.sort(rng.choice(1 << 26, n, replace=False)).astype(np.int64)
        cl = t_comp.encode(vals)
        assert cl.n_head == (n // per) * per
        assert cl.tail.n == n - cl.n_head
        assert cl.padded_n == n
        _same_payload(r_comp.encode(vals), cl)
        np.testing.assert_array_equal(t_comp.decode_np(cl), vals)
        got = t_comp.decode(cl.to("cpu"))
        assert got.shape == (n,) and got.dtype == torch.int32
        np.testing.assert_array_equal(_u32(got).astype(np.int64), vals)


# --------------------------------------------------------------------------
# the storage autotuner
# --------------------------------------------------------------------------

def test_autotune_dispatch_cost_drives_choice():
    cm = t_builder.CostModel.resolve(None)
    rng = np.random.default_rng(0)
    short = np.sort(rng.choice(1 << 18, 100, replace=False))
    long = np.sort(rng.choice(1 << 22, 50000, replace=False))
    name_s, skip_s = t_builder.autotune_choice(short, 1 << 18, cm)
    name_l, skip_l = t_builder.autotune_choice(long, 1 << 22, cm)
    assert name_s in ("varint", "composite-d1") and not skip_s
    assert name_l == "bp-d1" and skip_l
    rcm = r_builder.CostModel.resolve(None)
    for seg, span in ((short, 1 << 18), (long, 1 << 22)):
        assert t_builder.autotune_choice(seg, span, cm) \
            == r_builder.autotune_choice(seg, span, rcm)


def test_autotune_zero_dispatch_table_prefers_composite():
    table = {"decode_ns_per_int": {"bp-d1": 1.0, "bp8-d1": 1.0,
                                   "streamvbyte-d1": 1.1, "varint": 3.0},
             "dispatch_ns_per_list": {},
             "gallop_ns_per_probe": 10.0,
             "space_ns_per_byte": 50.0}
    cm = t_builder.CostModel.resolve(table)
    rng = np.random.default_rng(1)
    seg = np.sort(rng.choice(1 << 22, 1100, replace=False))
    assert t_builder.autotune_choice(seg, 1 << 22, cm) \
        == ("composite-d1", False)
    # every family's byte estimate and cost is the reference's
    assert t_builder._est_bytes(seg) == r_builder._est_bytes(seg)
    rcm = r_builder.CostModel.resolve(table)
    for fam in ("bp", "streamvbyte", "varint", "composite"):
        for n in (100, 1100, 9000):
            assert t_builder._decode_cost(fam, n, cm) \
                == r_builder._decode_cost(fam, n, rcm)
    assert t_builder.list_stats(seg, 1 << 22) \
        == r_builder.list_stats(seg, 1 << 22)


def test_cost_model_resolve_sources(tmp_path):
    table = {"decode_ns_per_int": {"bp-d1": 2.0},
             "dispatch_ns_per_list": {"bp-d1": 5.0},
             "gallop_ns_per_probe": 7.0}
    p = tmp_path / "cost.json"
    p.write_text(json.dumps(table))
    for cm in (t_builder.CostModel.resolve(table),
               t_builder.CostModel.resolve(str(p))):
        assert cm.decode_ns("bp") == 2.0
        assert cm.dispatch_ns("bp") == 5.0
        assert cm.gallop_ns_per_probe == 7.0
    # the default table is the reference's, entry for entry
    assert dataclasses.asdict(t_builder.CostModel.resolve(None)) \
        == dataclasses.asdict(r_builder.CostModel.resolve(None))


def test_skip_ok_false_forces_decoded_path():
    corpus = r_corpus.synthesize(n_docs=1 << 14, n_queries=6, seed=21)
    idx = t_builder.build(corpus.postings, corpus.n_docs,
                          codec_name="bp8-d1", B=0, n_parts=1, device="cpu")
    seq = [t_engine.query(idx, q) for q in corpus.queries]
    for part in idx.parts:            # flip every list off the skip path
        for tp in part.terms.values():
            tp.skip_ok = False
    stats: dict = {}
    out = t_batch.execute_batch(idx, corpus.queries, skip=True, stats=stats)
    for a, b in zip(out, seq):
        assert a.count == b.count and np.array_equal(a.docs, b.docs)
    assert stats.get("skip_folds", 0) == 0
    stats = {}
    for q, b in zip(corpus.queries, seq):
        a = t_engine.query(idx, q, stats=stats)
        assert a.count == b.count and np.array_equal(a.docs, b.docs)
    assert stats.get("skip_folds", 0) == 0


def _corpora():
    uniform = r_corpus.synthesize(n_docs=1 << 14, n_queries=8, seed=33)
    table = {2: (100.0, [0.8, 1500.0])}     # tiny rare + long frequent term
    skewed = r_corpus.synthesize(n_docs=1 << 14, n_queries=8, seed=7,
                                 table=table)
    return {"uniform": uniform, "skewed": skewed}


@pytest.mark.parametrize("profile", ["uniform", "skewed"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_autotuned_build_matches_reference(profile, n_parts):
    """The autotuned port build makes the reference's codec choice and skip
    policy for every (part, term), with equal payloads and equal stats."""
    corpus = _corpora()[profile]
    ref = r_builder.build(corpus.postings, corpus.n_docs, codec_name="auto",
                          B=16, n_parts=n_parts)
    port = t_builder.build(corpus.postings, corpus.n_docs, codec_name="auto",
                           B=16, n_parts=n_parts, device="cpu")
    for rp, tp_ in zip(ref.parts, port.parts):
        assert rp.terms.keys() == tp_.terms.keys()
        for tid, rt in rp.terms.items():
            tt = tp_.terms[tid]
            assert (rt.kind, rt.n, rt.skip_ok) == (tt.kind, tt.n, tt.skip_ok)
            if rt.kind == "list":
                assert r_codecs.family_of(rt.payload) \
                    == t_codecs.family_of(tt.payload)
                _same_payload(rt.payload, tt.payload)
    assert ref.stats() == port.stats()


@pytest.mark.parametrize("profile", ["uniform", "skewed"])
@pytest.mark.parametrize("n_parts", [1, 2])
def test_autotuned_matches_all_bitpack(profile, n_parts):
    corpus = _corpora()[profile]
    auto = t_builder.build(corpus.postings, corpus.n_docs, codec_name="auto",
                           B=16, n_parts=n_parts, device="cpu")
    bp = t_builder.build(corpus.postings, corpus.n_docs, codec_name="bp-d1",
                         B=16, n_parts=n_parts, varint_tail_below=0,
                         device="cpu")
    assert auto.stats()["bytes_per_int"] <= bp.stats()["bytes_per_int"]
    seq = [t_engine.query(bp, q) for q in corpus.queries]
    outs = [[t_engine.query(auto, q) for q in corpus.queries]]
    for fuse in (True, False):
        outs.append(t_batch.execute_batch(
            auto, corpus.queries,
            plan=t_batch.FusionPlan() if fuse else None, fuse=fuse))
    for out in outs:
        for a, b in zip(out, seq):
            assert a.count == b.count
            assert np.array_equal(np.asarray(a.docs), np.asarray(b.docs))


@pytest.mark.parametrize("codec", ["streamvbyte-d1", "composite-d1"])
@pytest.mark.parametrize("tail_below", [0, 1024])
def test_codec_builds_answer_as_reference(codec, tail_below):
    """Single-codec StreamVByte and composite builds: the reference's stats
    and the reference's answers, sequential and batched."""
    corpus = _corpora()["uniform"]
    kw = dict(codec_name=codec, B=16, n_parts=2, varint_tail_below=tail_below)
    ref = r_builder.build(corpus.postings, corpus.n_docs, **kw)
    port = t_builder.build(corpus.postings, corpus.n_docs, device="cpu", **kw)
    assert ref.stats() == port.stats()
    if tail_below == 0:
        assert port.stats()["codec_counts"].get(codec.split("-")[0], 0) > 0
    want = [r_engine.query(ref, q) for q in corpus.queries]
    for out in ([t_engine.query(port, q) for q in corpus.queries],
                t_batch.execute_batch(port, corpus.queries)):
        for a, b in zip(out, want):
            assert a.count == b.count
            assert np.array_equal(np.asarray(a.docs), np.asarray(b.docs))


def test_fused_mixed_codec_families_one_batch():
    """An autotuned index mixes varint/composite/bitpack payloads in one
    batch; SENTINEL padding from the decoded sources stays inert through the
    fused family ceilings (tests/test_fusion.py's case)."""
    n_docs = 1 << 14
    rng = np.random.default_rng(17)
    postings = [np.sort(rng.choice(n_docs, n, replace=False))
                for n in (60, 300, 1100, 5000, 9000)]
    idx = t_builder.build(postings, n_docs, codec_name="auto", B=0,
                          n_parts=1, device="cpu")
    fams = {type(tp.payload).__name__ for p in idx.parts
            for tp in p.terms.values() if tp.kind == "list"}
    assert len(fams) >= 2                       # genuinely mixed families
    queries = [[0, 4], [1, 3], [2, 4], [0, 1, 2], [3, 4], [0, 1, 2, 3, 4]]
    ref = r_builder.build(postings, n_docs, codec_name="auto", B=0, n_parts=1)
    want = r_batch.execute_batch(ref, queries, backend="jax")
    seq = [t_engine.query(idx, q) for q in queries]
    for out in (seq, t_batch.execute_batch(idx, queries, fuse=False),
                t_batch.execute_batch(idx, queries, fuse=True)):
        for a, b in zip(out, want):
            assert a.count == b.count
            assert np.array_equal(np.asarray(a.docs), np.asarray(b.docs))
