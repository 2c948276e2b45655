"""Differential tests of the port's core layer (deltas, bitpack, fastpfor,
varint, bitmap, intersect, codecs, clusterdata) against the JAX reference.
Inputs come from a numpy seed and go to both packages as numpy; every
comparison is exact (uint32 bit patterns via ``.view(np.uint32)``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitmap as r_bm
from repro.core import bitpack as r_bp
from repro.core import deltas as r_dl
from repro.core import fastpfor as r_pf
from repro.core import intersect as r_its
from repro.core import varint as r_vi
from repro.data import clusterdata as r_cd
from repro_torch.core import bitmap as t_bm
from repro_torch.core import bitpack as t_bp
from repro_torch.core import codecs as t_codecs
from repro_torch.core import deltas as t_dl
from repro_torch.core import fastpfor as t_pf
from repro_torch.core import intersect as t_its
from repro_torch.core import varint as t_vi
from repro_torch.data import clusterdata as t_cd

pytestmark = pytest.mark.torch_port

MODES = list(r_dl.MODES)
STRIDE_MODES = [m for m in MODES if m != "none"]
EXTREMES = np.array([0, 1, 2**31 - 1, 2**32 - 2, 2**32 - 1], np.int64)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _same_payload(ref, port):
    assert np.array_equal(np.asarray(ref.flat_words), _u32(port.flat_words))
    assert np.array_equal(np.asarray(ref.widths), port.widths.numpy())
    assert np.array_equal(np.asarray(ref.offsets), port.offsets.numpy())
    assert np.array_equal(np.asarray(ref.maxes), _u32(port.maxes))
    assert (ref.n, ref.mode, ref.block_rows) == (port.n, port.mode,
                                                 port.block_rows)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n", [0, 1, 127, 4096, 4097, 12800])
def test_bitpack_encode_words_and_decode(mode, n):
    rng = np.random.default_rng(n + len(mode))
    x = np.cumsum(rng.integers(1, 100, size=n)).astype(np.int64)
    ref, port = r_bp.encode(x, mode=mode), t_bp.encode(x, mode=mode)
    _same_payload(ref, port)
    assert np.array_equal(_u32(t_bp.decode_bucketed(port)),
                          np.asarray(r_bp.decode_bucketed(ref)))
    assert np.array_equal(t_bp.decode_np(port), x.astype(np.uint32))
    assert t_bp.bits_per_int(port) == r_bp.bits_per_int(ref)


@pytest.mark.parametrize("mode", STRIDE_MODES)
def test_bitpack_block_rows_8_and_wide_values(mode):
    rng = np.random.default_rng(3)
    x = np.sort(rng.choice(2**31 - 2, size=9000, replace=False))
    for rows in (8, 32):
        ref = r_bp.encode(x, mode=mode, block_rows=rows)
        port = t_bp.encode(x, mode=mode, block_rows=rows)
        _same_payload(ref, port)
        assert np.array_equal(_u32(t_bp.decode(port)),
                              np.asarray(r_bp.decode(ref)))


@pytest.mark.parametrize("mode", MODES)
def test_fastpfor_encode_and_decode(mode):
    rng = np.random.default_rng(len(mode))
    gaps = np.where(rng.random(20000) < 0.05, rng.integers(1, 1 << 20, 20000),
                    rng.integers(1, 8, 20000))
    x = np.cumsum(gaps).astype(np.int64)
    ref, port = r_pf.encode(x, mode=mode), t_pf.encode(x, mode=mode)
    _same_payload(ref, port)
    assert np.array_equal(np.asarray(ref.exc_pos), port.exc_pos.numpy())
    assert np.array_equal(np.asarray(ref.exc_add), _u32(port.exc_add))
    assert ref.format_bits == port.format_bits
    assert np.array_equal(_u32(t_pf.decode(port)), np.asarray(r_pf.decode(ref)))
    assert np.array_equal(t_pf.decode_np(port), x.astype(np.uint32))


@pytest.mark.parametrize("mode", ["d1", "none"])
def test_fastpfor_decode_device_wraps_negative_positions(mode):
    """Hand-made exception positions −L, −1, L and −L−1 (L = K·R·128): the
    reference's ``mode="drop"`` patches −L at 0 and −1 at L − 1 and drops
    the other two; the port must do the same."""
    x = np.cumsum(np.random.default_rng(0).integers(1, 50, 1000))
    ref = r_pf.encode(x.astype(np.int64), mode=mode)
    port = t_pf.encode(x.astype(np.int64), mode=mode)
    L = int(ref.widths.shape[0]) * ref.block_rows * 128
    pos = np.array([-L, -1, L, -L - 1], np.int32)
    add = np.array([5, 7, 11, 13], np.uint32)
    seeds = np.concatenate([[0], np.asarray(ref.maxes)[:-1]]).astype(np.uint32)
    want = r_pf.decode_device(ref.flat_words, ref.widths, ref.offsets,
                              jnp.asarray(seeds), jnp.asarray(pos),
                              jnp.asarray(add), mode, ref.block_rows)
    got = t_pf.decode_device(port.flat_words, port.widths, port.offsets,
                             _t(seeds), _t(pos), _t(add), mode,
                             port.block_rows)
    assert np.array_equal(_u32(got), np.asarray(want))
    plain = t_pf.decode_device(port.flat_words, port.widths, port.offsets,
                               _t(seeds), _t(pos[:0]), _t(add[:0]), mode,
                               port.block_rows)
    assert not np.array_equal(_u32(got), _u32(plain))     # the patch landed


@pytest.mark.parametrize("fam", ["bp", "bp8", "fastpfor"])
@pytest.mark.parametrize("mode", STRIDE_MODES)
def test_extremes_32bit_roundtrip(fam, mode):
    """The 2**32−1 extremes: sums wrap mod 2**32 exactly as the reference."""
    c = t_codecs.get_codec(f"{fam}-{mode}")
    enc = c.encode(EXTREMES)
    got = c.decode_np(enc)[: len(EXTREMES)]
    assert np.array_equal(got.astype(np.int64), EXTREMES)
    ref = (r_pf.decode(r_pf.encode(EXTREMES, mode=mode)) if fam == "fastpfor"
           else r_bp.decode(r_bp.encode(EXTREMES, mode=mode,
                                        block_rows=8 if fam == "bp8" else None)))
    assert np.array_equal(_u32(c.decode(enc)), np.asarray(ref))


@pytest.mark.parametrize("mode", MODES)
def test_prefix_sum_wraps_like_reference(mode):
    rng = np.random.default_rng(9)
    d = rng.integers(0, 1 << 32, size=(3, 32, 128), dtype=np.uint64)
    d = d.astype(np.uint32)
    seeds = np.array([0, 2**32 - 1, 12345], np.uint32)
    want = np.asarray(r_dl.prefix_sum(jnp.asarray(d), jnp.asarray(seeds), mode))
    got = t_dl.to_i32(t_dl.prefix_sum(_t(d), _t(seeds), mode))
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("mode", MODES)
def test_encode_deltas_np_matches(mode):
    rng = np.random.default_rng(1)
    blocks = np.sort(rng.integers(0, 2**32, size=2 * 8 * 128)).reshape(2, 8, 128)
    seeds = np.array([0, blocks[0, -1, -1]], np.int64)
    assert np.array_equal(t_dl.encode_deltas_np(blocks, seeds, mode),
                          r_dl.encode_deltas_np(blocks, seeds, mode))


def test_unpack_deltas_matches_reference():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2**32, size=(40, 128), dtype=np.uint64).astype(np.uint32)
    widths = np.array([0, 1, 7, 13, 31, 32, 5], np.int32)
    offsets = np.array([0, 0, 1, 8, 9, 39, 39], np.int32)
    want = np.asarray(r_bp.unpack_deltas(jnp.asarray(words), jnp.asarray(widths),
                                         jnp.asarray(offsets)))
    got = t_bp.unpack_deltas(_t(words), _t(widths), _t(offsets))
    assert np.array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("n", [0, 1, 300, 5000])
def test_varint_matches(n):
    rng = np.random.default_rng(n)
    x = np.cumsum(rng.integers(1, 1 << 20, size=n)).astype(np.int64)
    ref, port = r_vi.encode(x), t_vi.encode(x)
    assert np.array_equal(ref.data, port.data) and ref.n == port.n
    assert np.array_equal(t_vi.decode(port), x)
    assert t_vi.bits_per_int(port) == r_vi.bits_per_int(ref)


def test_layout_pads_and_candidate_ids_match():
    rng = np.random.default_rng(2)
    x = np.cumsum(np.where(rng.random(30000) < 0.05,
                           rng.integers(1, 1 << 16, 30000),
                           rng.integers(1, 9, 30000))).astype(np.int64)
    for ref, port in ((r_bp.encode(x), t_bp.encode(x)),
                      (r_pf.encode(x), t_pf.encode(x))):
        pads = r_bp.self_pads(ref)
        assert t_bp.self_pads(port) == pads
        a = r_bp.layout_np(ref, *[2 * p for p in pads])
        b = t_bp.layout_np(port, *[2 * p for p in pads])
        for f in ("words", "widths", "offsets", "maxes", "exc_pos", "exc_add"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        v = rng.integers(0, int(x[-1]) + 10, 500)
        assert np.array_equal(
            t_bp.candidate_block_ids(b.maxes[: port.num_blocks], v),
            r_bp.candidate_block_ids(np.asarray(ref.maxes), v))


def test_bitmap_ops_match():
    rng = np.random.default_rng(6)
    n_docs = 5000
    a = np.sort(rng.choice(n_docs, 900, replace=False))
    b = np.sort(rng.choice(n_docs, 1200, replace=False))
    wa, wb = r_bm.build_np(a, n_docs), r_bm.build_np(b, n_docs)
    assert np.array_equal(t_bm.build_np(a, n_docs), wa)
    vals = r_its.pad_to(np.sort(rng.choice(n_docs, 300, replace=False)), 512)
    want = np.asarray(r_bm.probe(jnp.asarray(wa), jnp.asarray(vals),
                                 jnp.asarray(vals) != r_its.SENTINEL))
    got = t_bm.probe(_t(wa), _t(vals), _t(vals) != int(t_its.SENTINEL))
    assert np.array_equal(got.numpy(), want)
    both = t_bm.bitmap_and(_t(wa), _t(wb))
    assert t_bm.popcount(both) == int(r_bm.popcount(jnp.asarray(wa & wb)))
    assert np.array_equal(t_bm.extract_np(both.numpy()),
                          r_bm.extract_np(wa & wb))


@pytest.mark.parametrize("m,n", [(100, 150), (300, 20000), (1, 5), (700, 700)])
def test_intersect_paths_match(m, n, rng):
    r = np.sort(rng.choice(1 << 22, m, replace=False))
    f = np.union1d(rng.choice(r, m // 2 + 1), rng.choice(1 << 22, n))
    M, N = r_its.pow2_bucket(len(r)), r_its.pow2_bucket(len(f), floor=1024)
    rp, fp = r_its.pad_to(r, M), r_its.pad_to(f, N)
    jr, jf, tr, tf_ = jnp.asarray(rp), jnp.asarray(fp), _t(rp), _t(fp)
    for got, want in (
            (t_its.intersect_gallop(tr, tf_), r_its.intersect_gallop(jr, jf)),
            (t_its.intersect_tiled(tr, tf_, tile_r=min(128, M)),
             r_its.intersect_tiled(jr, jf, tile_r=min(128, M))),
            (t_its.intersect_auto(tr, tf_, len(r), len(f)),
             r_its.intersect_auto(jr, jf, len(r), len(f)))):
        assert np.array_equal(got.numpy(), np.asarray(want))
    mask = t_its.intersect_gallop(tr, tf_)
    vals, cnt = t_its.compact(tr, mask)
    rv, rc = r_its.compact(jr, jnp.asarray(mask.numpy()))
    assert cnt == int(rc) and np.array_equal(vals.numpy(), np.asarray(rv))


@pytest.mark.parametrize("mode", ["d1", "dm", "dv"])
def test_packed_candidates_match(mode, rng):
    f = np.cumsum(rng.integers(1, 60, 50000)).astype(np.int64)
    r = np.union1d(rng.choice(f, 200), rng.integers(0, int(f[-1]), 200))
    ref, port = r_pf.encode(f, mode=mode), t_pf.encode(f, mode=mode)
    pads = r_bp.self_pads(ref)
    lay = r_bp.layout_np(ref, pads[0], pads[1], max(pads[2], 1))
    blk = r_bp.candidate_block_ids(np.asarray(ref.maxes), r)
    blk = np.concatenate([blk, np.full(r_its.pow2_bucket(len(blk), 8) - len(blk),
                                       pads[0], np.int32)])
    rp = r_its.pad_to(r, r_its.pow2_bucket(len(r)))
    args = (rp, lay.words, lay.widths, lay.offsets, lay.maxes, blk,
            lay.exc_pos, lay.exc_add)
    want = np.asarray(r_its.intersect_packed_candidates(
        *(jnp.asarray(a) for a in args), mode=mode))
    got = t_its.intersect_packed_candidates(*(_t(a) for a in args), mode=mode)
    assert np.array_equal(got.numpy(), want) and want.any()


def test_codec_registry():
    for name in t_codecs.ALL_CODECS:
        assert t_codecs.get_codec(name) is not None
    x = np.arange(0, 30000, 3)
    # the codec-breadth names resolve and round-trip ("auto" is the default
    # family for callers that thread one index-level codec, as in the
    # reference)
    for name in ("streamvbyte-d1", "composite-d1", "auto"):
        c = t_codecs.get_codec(name)
        assert np.array_equal(np.asarray(c.decode_np(c.encode(x)))[: x.size]
                              .astype(np.int64), x)
    assert t_codecs.family_of(t_codecs.get_codec("bp8-d1").encode(x)) == "bp8"
    assert t_codecs.family_of(t_codecs.get_codec("fastpfor-d2").encode(x)) \
        == "fastpfor"


def test_clusterdata_same_seed_same_lists():
    for n, bits in ((1000, 20), (50000, 26)):
        a = r_cd.clusterdata(np.random.default_rng(8), n, bits)
        b = t_cd.clusterdata(np.random.default_rng(8), n, bits)
        assert np.array_equal(a, b)
    ra, fa = r_cd.paired_lists(np.random.default_rng(1), 300, 5000)
    rb, fb = t_cd.paired_lists(np.random.default_rng(1), 300, 5000)
    assert np.array_equal(ra, rb) and np.array_equal(fa, fb)
