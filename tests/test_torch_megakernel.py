"""The port's fold kernels K4 (decoded fold) and K5 (packed fold), by their
plain versions on the CPU, against the reference megakernels in interpret
mode (as tests/test_megakernel.py runs them).  Operands are numpy, made from
a seed with the reference's encoders and layouts, and go to both packages;
every comparison is exact.  The CUDA kernels are held against these plain
versions on the card in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitpack as r_bitpack
from repro.core import fastpfor as r_fastpfor
from repro.core import intersect as r_its
from repro.kernels import megakernel as r_mk
from repro.kernels import ops as r_ops
from repro_torch.index import source as t_source
from repro_torch.kernels import megakernel as t_mk
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch_port

MODES = ["d1", "d2", "d4", "dm", "dv"]
SENT = int(r_its.SENTINEL)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (bool, uint32 or int32) → tensor; uint32 as int32 bit patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def _pair(rng, m, n, overlap=0.3, universe=2**22):
    inter = np.sort(rng.choice(universe, size=max(int(m * overlap), 1),
                               replace=False))
    r = np.union1d(inter, rng.choice(universe, size=m, replace=False))
    f = np.union1d(inter, rng.choice(universe, size=n, replace=False))
    return r.astype(np.int64), f.astype(np.int64)


def _stack(grid, r_rows, *, M=256, k_pad=None, t_pad=None, c_pad=None,
           e_pad=None, bp=None):
    """A (Jp, B) grid of optional payloads → numpy operands (R, pk, active)
    as ``batch._stack_packed`` lays them out; the pads may be raised past
    the payloads to model fused-family ceilings."""
    Jp, B = len(grid), len(grid[0])
    real = [p for row in grid for p in row if p is not None]
    k_pad = k_pad or r_its.pow2_bucket(
        max(p.widths.shape[0] for p in real), floor=1)
    t_pad = t_pad or r_its.pow2_bucket(
        max(int(p.flat_words.shape[0]) for p in real), floor=1)
    E = max(int(getattr(p, "exc_pos", np.zeros(0)).shape[0]) for p in real)
    if e_pad is None:
        e_pad = r_its.pow2_bucket(E, floor=1) if E else 0
    blks = {(j, b): r_bitpack.candidate_block_ids(np.asarray(p.maxes),
                                                  r_rows[b])
            for j, row in enumerate(grid) for b, p in enumerate(row)
            if p is not None}
    c_pad = c_pad or r_its.pow2_bucket(
        max(len(c) for c in blks.values()), floor=t_source.CAND_FLOOR)
    Bp = bp or B
    PW = np.zeros((Jp, Bp, t_pad, 128), np.uint32)
    PWid = np.zeros((Jp, Bp, k_pad), np.int32)
    POf = np.zeros((Jp, Bp, k_pad), np.int32)
    PMx = np.zeros((Jp, Bp, k_pad), np.uint32)
    PBk = np.full((Jp, Bp, c_pad), k_pad, np.int32)
    PEp = np.full((Jp, Bp, e_pad), -1, np.int32)
    PEa = np.zeros((Jp, Bp, e_pad), np.uint32)
    active = np.zeros((Jp, Bp), bool)
    for (j, b), blk in blks.items():
        lay = r_bitpack.layout_np(grid[j][b], k_pad, t_pad, e_pad)
        T, K = lay.words.shape[0], lay.widths.shape[0]
        PW[j, b, :T] = lay.words
        PWid[j, b, :K] = lay.widths
        POf[j, b, :K] = lay.offsets
        PMx[j, b, :K] = lay.maxes
        PBk[j, b] = t_source.pad_block_ids(blk, c_pad, k_pad)
        if e_pad:
            PEp[j, b] = lay.exc_pos
            PEa[j, b] = lay.exc_add
        active[j, b] = True
    R = np.full((Bp, M), SENT, np.int32)
    for b, r in enumerate(r_rows):
        R[b, : len(r)] = r
    return R, (PW, PWid, POf, PMx, PBk, PEp, PEa), active


def _packed_both(R, valid, pk, active, mode, rows):
    """(reference interpret-mode K5, port plain K5, port ops entry) masks."""
    want = np.asarray(r_mk.packed_fold_batched(
        jnp.asarray(R), jnp.asarray(valid), *(jnp.asarray(a) for a in pk),
        jnp.asarray(active), mode=mode, block_rows=rows, interpret=True))
    tpk = [_t(a) for a in pk]
    plain = t_mk.packed_fold_plain(_t(R), _t(valid), *tpk, _t(active),
                                   mode=mode, block_rows=rows)
    via_ops = ops.intersect_packed_fold(_t(R), _t(valid), tuple(tpk),
                                        _t(active), mode=mode,
                                        block_rows=rows)
    return want, plain.numpy(), via_ops.numpy()


def _assert_packed(R, valid, pk, active, mode, rows):
    want, plain, via_ops = _packed_both(R, valid, pk, active, mode, rows)
    assert np.array_equal(plain, want)
    assert np.array_equal(via_ops, want)
    return want


# --------------------------------------------------------------------------
# K5: packed fold
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_packed_fold_matches_reference_all_modes(mode, rng):
    B, Jp = 3, 2
    r_rows, grid = [], [[None] * B for _ in range(Jp)]
    for b in range(B):
        r, f0 = _pair(rng, 150, 90000)
        _, f1 = _pair(rng, 150, 60000)
        grid[0][b] = r_bitpack.encode(f0, mode=mode)
        grid[1][b] = r_bitpack.encode(f1, mode=mode)
        r_rows.append(r[:200])
    R, pk, active = _stack(grid, r_rows)
    assert pk[5].shape[-1] == 0                       # E = 0
    want = _assert_packed(R, R != SENT, pk, active, mode,
                          grid[0][0].block_rows)
    assert want.any() and not want[R != SENT].all()


@pytest.mark.parametrize("rows", [32, 8])
def test_packed_fold_fastpfor_exceptions(rows, rng):
    B = 2
    r_rows, grid = [], [[None] * B]
    for b in range(B):
        r, f = _pair(rng, 150, 150000, universe=2**26)
        pf = r_fastpfor.encode(f, mode="d1", block_rows=rows)
        assert int(pf.exc_pos.shape[0]) > 0
        grid[0][b] = pf
        r_rows.append(r[:200])
    R, pk, active = _stack(grid, r_rows)
    want = _assert_packed(R, R != SENT, pk, active, "d1", rows)
    assert want.any()


def test_packed_fold_block_rows_8_all_modes(rng):
    for mode in MODES:
        r, f = _pair(rng, 120, 40000)
        pl = r_bitpack.encode(f, mode=mode, block_rows=8)
        R, pk, active = _stack([[pl]], [r])
        want = _assert_packed(R, R != SENT, pk, active, mode, 8)
        assert want.any()


def test_packed_fold_sentinel_padding_and_incoming_valid(rng):
    r, f = _pair(rng, 80, 60000)
    pf = r_bitpack.encode(f, mode="d1")
    R, pk, active = _stack([[pf]], [r], M=1024)       # heavy SENTINEL tail
    valid = (R != SENT) & (R % 2 == 0)                # holes: odds dead
    want = _assert_packed(R, valid, pk, active, "d1", pf.block_rows)
    assert not want[0, len(r):].any()
    assert not want[0][R[0] % 2 == 1].any()
    # an incoming valid bit on a SENTINEL slot never survives a fold
    v2 = np.ones_like(valid)
    want2 = _assert_packed(R, v2, pk, active, "d1", pf.block_rows)
    assert not want2[0, len(r):].any()


def test_packed_fold_inactive_empty_and_single_block(rng):
    r, f = _pair(rng, 60, 30000)
    pf = r_bitpack.encode(f, mode="d1")
    evens = 2 * np.sort(rng.choice(2**20, size=3000, replace=False))
    podd = r_bitpack.encode(evens.astype(np.int64), mode="d1")
    tiny = np.sort(rng.choice(2**12, size=500, replace=False))
    ptiny = r_bitpack.encode(tiny.astype(np.int64), mode="d1")
    assert ptiny.num_blocks == 1
    rows = [r, evens[:64] + 1, np.asarray(tiny[:64])]
    grid = [[pf, podd, ptiny], [None, None, None]]    # all-pad second slot
    R, pk, active = _stack(grid, rows)
    assert not active[1].any()
    want = _assert_packed(R, R != SENT, pk, active, "d1", pf.block_rows)
    assert np.array_equal(R[0][want[0]], np.intersect1d(r, f))
    assert not want[1].any()                          # disjoint: empty
    assert np.array_equal(R[2][want[2]], tiny[:64])


def test_packed_fold_family_ceiling_pads(rng):
    """k/t/c/e pads raised past the payload, Bp > B and Jp > 1: equal to the
    reference, and row 0 equal to the tight-pad stack."""
    r, f = _pair(rng, 100, 50000)
    pf = r_fastpfor.encode(f, mode="dm")
    rows = pf.block_rows
    R1, pk1, a1 = _stack([[pf]], [r])
    tight = _assert_packed(R1, R1 != SENT, pk1, a1, "dm", rows)
    k_pad = 4 * r_its.pow2_bucket(pf.widths.shape[0], floor=1)
    t_pad = 2 * r_its.pow2_bucket(int(pf.flat_words.shape[0]), floor=1)
    e_pad = 2 * max(int(pf.exc_pos.shape[0]), 4)
    grid = [[pf, None, None, None], [None] * 4, [None] * 4, [None] * 4]
    R4, pk4, a4 = _stack(grid, [r], k_pad=k_pad, t_pad=t_pad, c_pad=256,
                         e_pad=e_pad, bp=4)
    assert pk4[0].shape[:2] == (4, 4)
    got = _assert_packed(R4, R4 != SENT, pk4, a4, "dm", rows)
    assert np.array_equal(got[0], tight[0])
    assert not got[1:].any()


def test_packed_fold_empty_stack_is_identity(rng):
    r, f = _pair(rng, 60, 30000)
    R, pk, active = _stack([[r_bitpack.encode(f, mode="d1")]], [r])
    pk0 = tuple(a[:0] for a in pk)
    valid = _t((R != SENT) & (R % 3 != 0))
    got = ops.intersect_packed_fold(_t(R), valid, tuple(_t(a) for a in pk0),
                                    _t(active[:0]), mode="d1", block_rows=32)
    assert torch.equal(got, valid)
    got = t_mk.packed_fold_batched(_t(R), valid, *(_t(a) for a in pk0),
                                   _t(active[:0]), mode="d1", block_rows=32)
    assert torch.equal(got, valid)


# --------------------------------------------------------------------------
# K4: decoded fold
# --------------------------------------------------------------------------

def _decoded_case(rng, B, M, N, J, fill=1.0):
    r = np.full((B, M), SENT, np.int32)
    for b in range(B):
        v = np.sort(rng.choice(1 << 20, int(M * fill), replace=False))
        r[b, : v.size] = v
    folds = np.sort(rng.choice(1 << 20, (J, B, N)), axis=-1).astype(np.int32)
    for j in range(J):
        for b in range(B):
            real = r[b][r[b] != SENT]
            folds[j, b, : N // 8] = rng.choice(real, N // 8)
    folds = np.sort(folds, axis=-1)
    folds[:, :, -N // 16:] = SENT                     # SENTINEL tails
    folds = np.sort(folds, axis=-1)
    return r, folds


@pytest.mark.parametrize("B,M,N,J", [(4, 256, 1024, 3), (3, 128, 128, 1),
                                     (2, 384, 4096, 4)])
def test_decoded_fold_matches_reference(rng, B, M, N, J):
    r, folds = _decoded_case(rng, B, M, N, J, fill=0.75)
    act = rng.random((J, B)) < 0.7
    act[0, 0] = True
    act[:, -1] = False                                # a row with no folds
    valid = (r != SENT) & (r % 3 != 0)                # incoming holes
    want = np.asarray(r_mk.decoded_fold_batched(
        jnp.asarray(r), jnp.asarray(valid), jnp.asarray(folds),
        jnp.asarray(act), interpret=True))
    args = (_t(r), _t(valid), _t(folds), _t(act))
    assert np.array_equal(t_mk.decoded_fold_plain(*args).numpy(), want)
    assert np.array_equal(t_mk.decoded_fold_batched(*args).numpy(), want)
    assert np.array_equal(ops.intersect_fold_batch(*args).numpy(), want)
    want_ops = np.asarray(r_ops.intersect_fold_batch(
        jnp.asarray(r), jnp.asarray(valid), jnp.asarray(folds),
        jnp.asarray(act)))
    assert np.array_equal(want_ops, want)
    assert np.array_equal(want[-1], valid[-1])        # inactive row: identity
    assert want.any() and not want[valid].all()


def test_decoded_fold_empty_stack_is_identity(rng):
    r = np.sort(rng.choice(1 << 16, (2, 128), replace=False), axis=1)
    valid = _t(r % 2 == 0)
    empty = torch.zeros((0, 2, 128), dtype=torch.int32)
    none = torch.zeros((0, 2), dtype=torch.bool)
    assert torch.equal(ops.intersect_fold_batch(_t(r), valid, empty, none),
                       valid)
    assert torch.equal(t_mk.decoded_fold_batched(_t(r), valid, empty, none),
                       valid)


def test_cpu_folds_take_the_plain_path_without_counting(rng):
    ops.reset_launches()
    r, folds = _decoded_case(rng, 2, 128, 256, 2)
    act = np.ones((2, 2), bool)
    ops.intersect_fold_batch(_t(r), _t(r != SENT), _t(folds), _t(act))
    assert ops.launches()["decoded_fold_batched"] == 0
    assert ops.launches()["packed_fold_batched"] == 0
