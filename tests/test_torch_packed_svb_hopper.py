"""K3's and K7's Hopper designs, on the CPU: numpy emulations of what the
kernels compute, thread by thread, held against the plain versions and the
reference (the Pallas kernels in interpret mode, or its jnp functions).

- ``k3_fused`` is K3's one launch (csrc/packed_gallop.cu): a warp per (row
  b, candidate slot c).  A pad slot (id < 0 or ≥ Kp) writes nothing, except
  that slot 0 of a row without a real slot writes false over the row.  A
  real slot finds the row's number of real slots L and, in r, the upper
  bounds of hi(c−1), hi(c) and hi(L−1) (hi(c) = maxes[blk[c]]) with 32-ary
  warp searches (``warp_partition``); decodes its block with K1's warp
  decode into its tile, the FastPFOR exceptions of the block added to the
  zeroed tile first; looks up the candidates it owns, hi(c−1) < x ≤ hi(c),
  with the branchless lower bound in the tile; and, before the decode,
  writes false over its chunk of the tail [u, M).  The emulation counts
  the writers of every out[b, i]: each must have exactly one.  The warp
  body is ``_warp_emulation.packed_slot``, which K5's emulation
  (tests/test_torch_fold_hopper.py) shares, as the kernels share
  ``csrc/packed_warp.cuh``.
- ``k7_warp`` is K7's (csrc/svb_decode.cu): a warp a block, lane t owning
  values 4t…4t+3 of each row; lane t reads control byte t, scans the
  four byte lengths' sum across the warp (the row total carries to the next
  row from doffs[k], int32 sums wrapping), the group's data span (G = 1 row,
  or 8) is staged as whole 16-byte chunks inside [0, DW), each value is read
  from the stage where its bytes lie wholly in it and else by the clamped
  word pair, then K1's prefix sum (``prefix_row``).  (The kernel reads a
  lane's staged values through one five-word window, ``svb_lane``: the
  same bytes.)

Mutations must fail the same checks: an owned range off by one at a block
boundary, a pad slot that writes, a dropped byte-offset carry across rows,
a lane mapping off by one, a clamp that reads zeros past DW.  The kernels
themselves are held against the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phase 2."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import intersect_gallop as ref_kg
from repro.kernels import svb_decode as ref_kd
from repro_torch.core import intersect as its
from repro_torch.core import streamvbyte as tsvb
from repro_torch.kernels import _build
from repro_torch.kernels import intersect_gallop as tkg
from repro_torch.kernels import svb_decode as tkd

from _warp_emulation import (I32_MAX, U32, i32 as _i32, packed_slot,
                             prefix_row, shfl_up_scan)
from test_torch_cuda import PACKED_ORDER, fused_case as k3_case

pytestmark = pytest.mark.torch_port

MODES = ["none", "d1", "d2", "d4", "dm", "dv"]
CSRC = Path(tkd.__file__).resolve().parent / "csrc"


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# --------------------------------------------------------------------------
# K3: one launch, a warp per candidate slot
# --------------------------------------------------------------------------

def k3_fused(r, words, widths, offsets, maxes, blk, exc_pos, exc_add,
             mode: str, rows: int, *, mutation: str | None = None):
    """K3's grid on numpy operands → (out (B, M) bool, writers (B, M): how
    many warps wrote each entry).  Each warp runs ``packed_slot``; K3's
    epilogue writes the members over the owned range and false over the
    tail chunk.  ``mutation`` goes to ``packed_slot``."""
    B, M = r.shape
    out = np.zeros((B, M), bool)
    writers = np.zeros((B, M), np.int64)

    def write(b, lo, hi, vals):
        out[b, lo:hi] = vals
        writers[b, lo:hi] += 1

    for b in range(B):
        for c in range(blk.shape[1]):
            w = packed_slot(r[b], words[b], widths[b], offsets[b], maxes[b],
                            blk[b], exc_pos[b], exc_add[b], c, mode, rows,
                            mutation=mutation)
            if w is None:
                continue
            if w.clear_row:
                write(b, 0, M, False)
                continue
            write(b, w.a, w.e, False)
            write(b, w.lo, w.hi, w.member)
    return out, writers


def _check_k3(case, mode: str, rows: int) -> np.ndarray:
    """Emulation ≡ plain ≡ the reference's Pallas kernel (interpret), every
    mask entry written once; returns the mask."""
    got, writers = k3_fused(*(case[k] for k in PACKED_ORDER), mode, rows)
    assert (writers == 1).all(), "an entry with other than one writer"
    plain = its.intersect_packed_batch(*(_t(case[k]) for k in PACKED_ORDER),
                                       mode=mode, block_rows=rows).numpy()
    assert np.array_equal(got, plain)
    want = np.asarray(ref_kg.packed_gallop_batched(
        *(jnp.asarray(case[k]) for k in PACKED_ORDER), mode=mode,
        block_rows=rows, interpret=True))
    assert np.array_equal(got, want)
    assert got[:2].any() and not got[2].any()
    return got


@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
@pytest.mark.parametrize("mode", MODES)
def test_k3_fused_matches_plain_and_reference(mode, codec):
    """C = 8 slots, half of them pads, 32-row blocks; a row of pads only;
    candidates at block maxes, above the last candidate block and
    SENTINEL; FastPFOR exceptions (fastpfor) and E = 0 (bp)."""
    case, rows = k3_case(10 + MODES.index(mode), mode, codec, c_pad=8)
    _check_k3(case, mode, rows)


@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_k3_fused_1024_slots_half_pads(codec):
    """C = 1024 slots (the main path's), 512 of them pads, 8-row blocks."""
    case, rows = k3_case(5, "d1", codec, c_pad=1024, rows=8)
    assert (case["blk"][:2] >= case["widths"].shape[1]).sum(1).tolist() == \
        [512, 512]
    _check_k3(case, "d1", rows)


@pytest.mark.parametrize("mutation", ["range_off_by_one", "pad_writes"])
@pytest.mark.parametrize("codec", ["bp", "fastpfor"])
def test_k3_mutations_fail(codec, mutation):
    case, rows = k3_case(3, "d1", codec, c_pad=8)
    plain = its.intersect_packed_batch(*(_t(case[k]) for k in PACKED_ORDER),
                                       mode="d1", block_rows=rows).numpy()
    got, writers = k3_fused(*(case[k] for k in PACKED_ORDER), "d1", rows,
                            mutation=mutation)
    assert not (np.array_equal(got, plain) and (writers == 1).all())


def test_k3_is_one_launch_without_a_window():
    """K3's C entry launches one kernel and takes no window; K2's gallop and
    the window decode are not in its library."""
    src = (CSRC / "packed_gallop.cu").read_text()
    assert src.count("<<<") == 1
    assert "gallop.cuh" not in src and "packed_decode.cuh" not in src
    assert "window" not in re.search(r"extern \"C\" int repro_packed_gallop\("
                                     r"[^)]*\)", src).group(0)
    assert len(_build.SIGNATURES["repro_packed_gallop"][1]) == 18


# --------------------------------------------------------------------------
# K7: a warp a block
# --------------------------------------------------------------------------

def k7_warp(ctrl, data, doffs, seeds, mode: str, rows: int, *,
            mutation: str | None = None) -> np.ndarray:
    """K7's grid on numpy operands (ctrl (K, 8·rows) and data (DW,) uint32,
    doffs (K,) int32, seeds (K,) uint32) → (K, rows, 128) uint32.
    ``mutation``: "no_offset_carry" starts every row at doffs[k],
    "lane_shift" gives lane t control byte t + 1, "zero_past_end" reads 0
    for a word past DW − 1 where the kernel clamps."""
    K = ctrl.shape[0]
    DW = data.shape[0]
    G = 1 if rows == 1 else 8
    chunks = DW >> 2
    data = data.astype(np.int64)
    cb = np.ascontiguousarray(ctrl).view(np.uint8).reshape(K, rows, 32)
    src = (np.arange(32) + (mutation == "lane_shift")) % 32
    j4 = 2 * np.arange(4)
    out = np.zeros((K, rows, 128), np.uint32)
    for k in range(K):
        pos = int(doffs[k]) & U32
        c = np.full((32, 4), seeds[k], np.uint32)
        for r0 in range(0, rows, G):
            group = range(r0, min(r0 + G, rows))
            start, lens, firsts = pos, [], []
            for r in group:
                ln = ((cb[k, r, src].astype(np.int64)[:, None] >> j4) & 3) + 1
                s = ln.sum(1).astype(np.uint32)
                x = shfl_up_scan(s).astype(np.int64)
                lens.append(ln)
                firsts.append((pos + x - s) & U32)
                if mutation != "no_offset_carry":
                    pos = (pos + int(x[31])) & U32
            s0, span = int(_i32(start)), (pos - start) & U32
            q0, q1 = 0, -1
            if span > 0 and s0 >= 0 and s0 + span - 1 <= I32_MAX:
                q0, q1 = s0 >> 4, min((s0 + span - 1) >> 4, chunks - 1)
            stage = data[4 * q0: 4 * (q1 + 1)] if q1 >= q0 else data[:0]
            for r, ln, first in zip(group, lens, firsts):
                o = _i32(first[:, None] + np.cumsum(ln, 1) - ln)
                word, sh = o >> 2, (o & 3) * 8
                inside = ((o >= 0) & ((o >> 4) >= q0)
                          & (((o + ln - 1) >> 4) <= q1))
                w = np.clip(word - 4 * q0, 0, max(stage.size - 1, 0))
                st = stage if stage.size else np.zeros(1, np.int64)
                lo_in = st[w]
                hi_in = np.where(sh + 8 * ln > 32,
                                 st[np.minimum(w + 1, st.size - 1)], 0)
                lo_out = data[np.clip(word, 0, DW - 1)]
                hi_out = data[np.clip(word + 1, 0, DW - 1)]
                if mutation == "zero_past_end":
                    lo_out = np.where(word > DW - 1, 0, lo_out)
                    hi_out = np.where(word + 1 > DW - 1, 0, hi_out)
                lo = np.where(inside, lo_in, lo_out)
                hi = np.where(inside, hi_in, hi_out)
                v = (lo >> sh) | np.where(sh > 0, (hi << (32 - sh)) & U32, 0)
                mask = np.where(ln >= 4, U32, (1 << (8 * ln)) - 1)
                t = (v & mask).astype(np.uint32)
                vals, step = prefix_row(t, c, mode)
                c = c + step
                out[k, r] = vals.reshape(128)
    return out


def k7_operands(seed: int, rows: int, DW: int):
    """Random K7 operands, 7 blocks: every 2-bit code (byte lengths 1–4);
    data offsets at 0, inside the stream, ending exactly at its last byte,
    running past it, negative, and wrapping int32 past 2**31 − 1."""
    rng = np.random.default_rng(seed)
    K = 7
    ctrl = rng.integers(0, 1 << 32, (K, 8 * rows), dtype=np.uint64
                        ).astype(np.uint32)
    data = rng.integers(1, 1 << 32, DW, dtype=np.uint64).astype(np.uint32)
    codes = (ctrl.view(np.uint8)[..., None] >> (2 * np.arange(4))) & 3
    nbytes = (codes.astype(np.int64) + 1).reshape(K, -1).sum(1)
    doffs = np.array([0, rng.integers(0, max(4 * DW - nbytes[1], 1)),
                      4 * DW - nbytes[2], 4 * DW - nbytes[3] + 5,
                      4 * DW - 3, -7, I32_MAX - 40], np.int64)
    seeds = rng.integers(0, 1 << 32, K, dtype=np.uint64).astype(np.uint32)
    return ctrl, data, doffs.astype(np.int32), seeds


def _svb_cases(mode: str, rows: int) -> list:
    """Random operands (DW a multiple of 4 and not), and encoded lists
    through their pow2-padded operands (pad blocks: code 0, offset 0)."""
    rng = np.random.default_rng(MODES.index(mode) + 10 * rows)
    per_block = rows * 128 * 4
    cases = [k7_operands(rows, rows, 2 * per_block // 4),
             k7_operands(rows + 1, rows, 2 * per_block // 4 + 3)]
    for n in (100, 3 * rows * 128 - 5):
        gaps = (2.0 ** rng.uniform(0, 25 if n <= 128 else 18, n)
                ).astype(np.int64)
        sl = tsvb.encode(np.cumsum(gaps), mode=mode, block_rows=rows)
        ops_ = tkd.bucketed_operands(sl)
        cases.append(tuple(o.numpy().view(np.uint32) if i != 2
                           else o.numpy() for i, o in enumerate(ops_)))
    return cases


def _plain_k7(ctrl, data, doffs, seeds, mode, rows) -> np.ndarray:
    return _u32(tkd.decode_svb(_t(ctrl), _t(data), _t(doffs), _t(seeds),
                               mode, rows))


@pytest.mark.parametrize("rows", [1, 2, 8, 32])
@pytest.mark.parametrize("mode", MODES)
def test_k7_warp_matches_plain_and_reference(mode, rows):
    """Emulation ≡ plain ≡ the reference's jnp decode_svb on every case, and
    its Pallas kernel (interpret) on the first."""
    cases = _svb_cases(mode, rows)
    assert any(c[0].shape[0] & (c[0].shape[0] - 1) == 0
               and c[0].shape[0] > 2 for c in cases[2:])   # pow2 pad blocks
    for i, (ctrl, data, doffs, seeds) in enumerate(cases):
        got = k7_warp(ctrl, data, doffs, seeds, mode, rows)
        assert np.array_equal(got, _plain_k7(ctrl, data, doffs, seeds, mode,
                                             rows))
        ref_args = (jnp.asarray(ctrl), jnp.asarray(data), jnp.asarray(doffs),
                    jnp.asarray(seeds))
        want = np.asarray(ref_kd.decode_svb(*ref_args, mode=mode,
                                            block_rows=rows))
        assert np.array_equal(got, want)
        if i == 0:
            assert np.array_equal(got, np.asarray(ref_kd.unpack_svb_blocks(
                *ref_args, mode=mode, block_rows=rows, interpret=True)))


@pytest.mark.parametrize("rows,mutation", [
    (1, "lane_shift"), (8, "lane_shift"), (2, "no_offset_carry"),
    (32, "no_offset_carry"), (1, "zero_past_end"), (8, "zero_past_end")])
def test_k7_mutations_fail(rows, mutation):
    ctrl, data, doffs, seeds = k7_operands(rows, rows, 2 * rows * 128)
    want = _plain_k7(ctrl, data, doffs, seeds, "d1", rows)
    assert np.array_equal(k7_warp(ctrl, data, doffs, seeds, "d1", rows),
                          want)
    assert not np.array_equal(k7_warp(ctrl, data, doffs, seeds, "d1", rows,
                                      mutation=mutation), want)


def test_k7_has_no_cta_barrier_and_shares_k1s_scan():
    """K7's kernel has no __syncthreads and runs K1's prefix_rows and
    warp_scans (one definition each, in unpack_warp.cuh), not a copy;
    ``svb_decode.WARPS`` is the kernel's kSvbWarps."""
    svb = (CSRC / "svb_decode.cu").read_text()
    warp = (CSRC / "unpack_warp.cuh").read_text()
    assert "__syncthreads(" not in svb and "prefix_row<" not in svb
    assert "prefix_rows<MODE, G>" in svb and "warp_scans(x" in svb
    assert '#include "unpack_warp.cuh"' in svb
    for name in ("prefix_rows", "warp_scans"):
        assert len(re.findall(rf"void {name}\(", warp)) == 1
        assert f"void {name}(" not in svb
    assert "prefix_rows<MODE, kRowGroup>" in warp
    assert int(re.search(r"kSvbWarps = (\d+);", svb).group(1)) == tkd.WARPS


# --------------------------------------------------------------------------
# the lean launch path on the CPU
# --------------------------------------------------------------------------

def test_k3_k7_wrappers_take_the_plain_path_on_cpu_without_counting():
    before = dict(_build.LAUNCHES)
    case, rows = k3_case(1, "d2", "fastpfor", c_pad=8)
    args = [_t(case[k]) for k in PACKED_ORDER]
    assert torch.equal(tkg.packed_gallop_batched(*args, mode="d2",
                                                 block_rows=rows),
                       its.intersect_packed_batch(*args, mode="d2",
                                                  block_rows=rows))
    ops_ = [_t(a) for a in k7_operands(0, 2, 600)]
    assert torch.equal(tkd.unpack_svb_blocks(*ops_, "dm", 2),
                       tkd.decode_svb(*ops_, "dm", 2))
    assert _build.LAUNCHES == before
