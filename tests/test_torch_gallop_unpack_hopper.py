"""K1 and K2's Hopper designs, on the CPU: numpy emulations of what the
kernels compute, thread by thread, held against the plain versions and the
reference (the Pallas kernels in interpret mode, or its jnp functions).

- ``k1_warp`` is K1's warp-per-block decode (csrc/unpack_warp.cuh): CTAs of
  ``bitunpack.WARPS`` warps, warp w of CTA c decodes block c·WARPS + w; the
  block's word rows are staged (each row index clamped to [0, T−1]); lane t
  owns lanes 4t…4t+3 of every row: unpack_lane's shift, mask and spill, four
  local adds, the 5-step ``__shfl_up_sync`` scan of the thread totals, the
  row total from lane 31 as the carry (per phase for d2/d4, lane 127's delta
  for dm, per lane for dv).  The kernel runs the scans of 8 rows at once
  (``kRowGroup``) and adds the carries in row order; that changes when a
  scan runs, not what it adds, so the emulation walks the rows in order.
- ``k2_warp_exit`` is K2's grid (csrc/gallop.cuh): CTAs of 256 threads,
  lanes past M read SENTINEL, a warp whose 32 lanes are all SENTINEL writes
  false before the first round, the others run ``gallop_member``.

Mutations (a dropped row carry, a lane mapping off by one, a warp exit taken
on a warp with one valid lane) must fail the same checks.  The kernels
themselves are held against the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py phase 2."""

import re
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import bitpack as ref_bitpack
from repro.core import deltas as ref_deltas
from repro.core import intersect as ref_its
from repro.kernels import bitunpack as ref_kb
from repro.kernels import intersect_gallop as ref_kg
from repro_torch.core import intersect as its
from repro_torch.kernels import _build
from repro_torch.kernels import bitunpack as tkb
from repro_torch.kernels import intersect_gallop as tkg

from _warp_emulation import prefix_row, unpack4

pytestmark = pytest.mark.torch_port

MODES = ["none", "d1", "d2", "d4", "dm", "dv"]
SENT = int(ref_its.SENTINEL)
W = tkb.WARPS
CSRC = Path(tkb.__file__).resolve().parent / "csrc"


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# --------------------------------------------------------------------------
# K1: the warp-per-block decode
# --------------------------------------------------------------------------

def _warp_block(words, T, offset, b, seed, rows, mode, *, carry, shift):
    """One warp's block: (rows, 128) uint32 values."""
    if not 0 <= b <= 32:
        raise ValueError("the emulation covers the staged widths 0–32")
    nw = (rows * b + 31) >> 5
    stage = words[np.clip(offset + np.arange(nw), 0, T - 1)]
    cols = (np.arange(128) + shift) % 128      # the lanes thread t unpacks
    c = np.full((32, 4), seed, np.uint32)      # c0..c3 of every thread
    out = np.zeros((rows, 128), np.uint32)
    for r in range(rows):
        v, step = prefix_row(unpack4(stage, b, r, cols), c, mode)
        if carry:
            c = c + step
        out[r] = v.reshape(128)                # lane t stores 4t..4t+3
    return out


def k1_warp(words, offsets, widths, seeds, mode: str, rows: int, *,
            warps: int = W, carry: bool = True, shift: int = 0) -> np.ndarray:
    """K1's grid: ceil(K / warps) CTAs, warp w of CTA c decodes block
    c·warps + w (a warp past K leaves).  ``carry=False`` drops the row
    carry; ``shift=1`` maps thread t to lanes 4t+1…4t+4 (wrong kernels)."""
    K = len(widths)
    T = words.shape[0]
    out = np.zeros((K, rows, 128), np.uint32)
    for cta in range(-(-K // warps)):
        for w in range(warps):
            k = cta * warps + w
            if k >= K:
                continue
            out[k] = _warp_block(words, T, int(offsets[k]), int(widths[k]),
                                 np.uint32(seeds[k]), rows, mode,
                                 carry=carry, shift=shift)
    return out


def _blocks(seed: int, widths, rows: int):
    """Blocks packed at ``widths`` (each holding its width's maximum), laid
    out flat as ``bitpack.encode`` lays them out: (words, offsets, widths,
    seeds), numpy uint32/int32."""
    rng = np.random.default_rng(seed)
    widths = np.asarray(widths, np.int32)
    packed = []
    for b in widths:
        d = rng.integers(0, 1 << int(b), size=(rows, 128), dtype=np.uint64)
        d[0, 0] = (1 << int(b)) - 1
        packed.append(ref_bitpack.pack_block_np(d.astype(np.uint32), int(b)))
    words = (np.concatenate(packed) if sum(map(len, packed))
             else np.zeros((1, 128), np.uint32))
    per = [(rows * int(b) + 31) // 32 for b in widths]
    offsets = np.concatenate([[0], np.cumsum(per[:-1])]).astype(np.int32)
    seeds = rng.integers(0, 1 << 32, size=len(widths),
                         dtype=np.uint64).astype(np.uint32)
    return words.astype(np.uint32), offsets, widths, seeds


def _plain(words, offsets, widths, seeds, mode, rows) -> np.ndarray:
    return _u32(tkb.unpack_blocks_plain(_t(words), _t(offsets), _t(widths),
                                        _t(seeds), mode, rows))


def _reference(words, offsets, widths, seeds, mode, rows) -> np.ndarray:
    """The reference's jnp decode (unpack_deltas, then prefix_sum)."""
    return np.asarray(ref_deltas.prefix_sum(ref_bitpack.unpack_deltas(
        jnp.asarray(words), jnp.asarray(widths), jnp.asarray(offsets), rows),
        jnp.asarray(seeds), mode))


def test_warps_mirror_the_kernel():
    """``bitunpack.WARPS`` is the kernel's ``kUnpackWarps``."""
    src = (CSRC / "unpack_warp.cuh").read_text()
    assert int(re.search(r"kUnpackWarps = (\d+);", src).group(1)) == W
    assert 4 <= W <= 8


@pytest.mark.parametrize("rows", [32, 8])
@pytest.mark.parametrize("mode", MODES)
def test_k1_warp_width_sweep_matches_plain_and_reference(mode, rows):
    """Widths 0–32, one block each: emulation ≡ plain ≡ the Pallas kernel in
    interpret mode (32 rows; its padded layout) or the jnp reference (8)."""
    ops_ = _blocks(MODES.index(mode) + rows, np.arange(33), rows)
    got = k1_warp(*ops_, mode, rows)
    assert np.array_equal(got, _plain(*ops_, mode, rows))
    words, offsets, widths, seeds = ops_
    if rows == 32:
        padded = np.zeros((33, 32, 128), np.uint32)
        for k, (o, b) in enumerate(zip(offsets, widths)):
            padded[k, :b] = words[o: o + b]
        want = np.asarray(ref_kb.unpack_blocks(
            jnp.asarray(padded), jnp.asarray(widths), jnp.asarray(seeds),
            mode=mode, interpret=True))
    else:
        want = _reference(*ops_, mode, rows)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("rows", [32, 8])
@pytest.mark.parametrize("K", sorted({1, 3, W - 1, W + 1, 2 * W + 1}))
@pytest.mark.parametrize("mode", MODES)
def test_k1_warp_block_counts_match_plain_and_reference(mode, K, rows):
    """K blocks of random widths 0–32: a CTA with its last warps idle, and
    K past one and two CTAs."""
    rng = np.random.default_rng(100 * K + rows + MODES.index(mode))
    ops_ = _blocks(K + rows, rng.integers(0, 33, K), rows)
    got = k1_warp(*ops_, mode, rows)
    assert np.array_equal(got, _plain(*ops_, mode, rows))
    assert np.array_equal(got, _reference(*ops_, mode, rows))


@pytest.mark.parametrize("mode", MODES)
def test_k1_warp_clamped_last_word_reads(mode):
    """Blocks whose word rows run past T (and one before row 0) read the
    clamped rows T − 1 (and 0), as unpack_lane and unpack_deltas do."""
    rows = 32
    words, _, _, _ = _blocks(9, [5, 17, 32], rows)
    T = words.shape[0]
    offsets = np.array([T - 3, T - 1, -2, T - 20, 0], np.int32)
    widths = np.array([17, 32, 9, 31, 0], np.int32)
    seeds = np.array([7, 0xFFFFFFF0, 1, 2**31, 5], np.uint32)
    ops_ = (words, offsets, widths, seeds)
    got = k1_warp(*ops_, mode, rows)
    assert np.array_equal(got, _plain(*ops_, mode, rows))
    assert np.array_equal(got, _reference(*ops_, mode, rows))


@pytest.mark.parametrize("mode,mutation", [
    *((m, "lane_shift") for m in MODES),
    *((m, "no_carry") for m in MODES if m != "none")])   # none carries nothing
def test_k1_mutations_fail(mode, mutation):
    """A dropped row carry and a lane mapping off by one differ from the
    plain version on the width sweep."""
    ops_ = _blocks(3, np.arange(33), 32)
    kw = {"carry": False} if mutation == "no_carry" else {"shift": 1}
    assert not np.array_equal(k1_warp(*ops_, mode, 32, **kw),
                              _plain(*ops_, mode, 32))


# --------------------------------------------------------------------------
# K2: the SENTINEL-warp exit
# --------------------------------------------------------------------------

def _gallop_member(f: np.ndarray, x: np.ndarray) -> np.ndarray:
    """``gallop_member`` for a warp's lanes x."""
    N = f.shape[0]
    lo = np.full(x.shape, -1, np.int64)
    for k in range((N - 1).bit_length() - 1, -1, -1):
        probe = lo + (1 << k)
        v = f[np.minimum(probe, N - 1)]
        lo = np.where((probe < N) & (v < x), probe, lo)
    return (f[np.minimum(lo + 1, N - 1)] == x) & (x != SENT)


def k2_warp_exit(r: np.ndarray, f: np.ndarray, *,
                 exit_at_one: bool = False) -> np.ndarray:
    """K2's grid on r (B, M), f (B, N) → (B, M) bool.  ``exit_at_one`` also
    lets a warp with a single valid lane leave (a wrong kernel)."""
    B, M = r.shape
    threads = -(-M // 256) * 256
    out = np.zeros((B, M), bool)
    for b in range(B):
        x = np.full(threads, SENT, np.int64)
        x[:M] = r[b]
        for w0 in range(0, threads, 32):
            lanes = x[w0: w0 + 32]
            valid = int((lanes != SENT).sum())
            if valid == 0 or (exit_at_one and valid == 1):
                continue                      # false already, no round run
            n = max(0, min(32, M - w0))
            out[b, w0: w0 + n] = _gallop_member(f[b].astype(np.int64),
                                                lanes)[:n]
    return out


def _gallop_row(rng, M: int, N: int, kind: str) -> tuple:
    """One (r, f) row: f sorted and SENTINEL-padded to N; r by ``kind``."""
    f = np.full(N, SENT, np.int32)
    fv = np.sort(rng.choice(1 << 20, size=max(N // 2, 1), replace=False))
    f[: fv.size] = fv
    r = np.full(M, SENT, np.int32)
    if kind == "all_sentinel":
        return r, f
    hits = rng.choice(fv, size=min(fv.size, M // 4 + 1))
    misses = rng.integers(0, 1 << 20, M // 4 + 1)
    vals = np.union1d(hits, misses)[: M // 2]
    if kind == "compact":               # its.compact: a valid prefix
        r[: vals.size] = vals
    elif kind == "holes":               # SENTINEL lanes between valid ones
        pos = np.sort(rng.choice(M, size=vals.size, replace=False))
        r[pos] = vals
    elif kind == "unsorted":
        r[: vals.size] = rng.permutation(vals)
    elif kind == "lone":                # one valid lane a warp: a member
        for w0 in range(0, M, 32):
            r[min(w0 + 17, M - 1)] = fv[(w0 // 32) % fv.size]
    elif kind == "tail_one":            # a valid prefix of 5 warps and a lane
        r[: 161] = fv[: 161]
    return r, f


K2_CASES = [  # M, N, kind: M not a multiple of 32, N = 1, N not a power of
    (1000, 4096, "compact"),        # two, all-SENTINEL r, whole SENTINEL
    (777, 1000, "holes"),           # warps after a valid prefix, one valid
    (512, 3001, "unsorted"),        # lane in a warp
    (300, 1, "compact"),
    (130, 1, "all_sentinel"),
    (1024, 1 << 12, "all_sentinel"),
    (4096, 1 << 14, "compact"),
    (333, 2048, "lone"),
    (1000, 4096, "tail_one"),
]


@pytest.mark.parametrize("M,N,kind", K2_CASES)
def test_k2_warp_exit_matches_plain_and_reference(M, N, kind):
    rng = np.random.default_rng(M + N)
    rows = [_gallop_row(rng, M, N, kind) for _ in range(2)]
    r = np.stack([a for a, _ in rows])
    f = np.stack([b for _, b in rows])
    got = k2_warp_exit(r, f)
    assert np.array_equal(got, its.intersect_gallop(_t(r), _t(f)).numpy())
    for b in range(2):
        assert np.array_equal(got[b], np.asarray(ref_its.intersect_gallop(
            jnp.asarray(r[b]), jnp.asarray(f[b]))))
    if M % 128 == 0 and N & (N - 1) == 0:
        assert np.array_equal(got, np.asarray(ref_kg.gallop_tiles_batched(
            jnp.asarray(r), jnp.asarray(f), interpret=True)))
    if kind not in ("all_sentinel",):
        assert got.any()


@pytest.mark.parametrize("M,N,kind", [(333, 2048, "lone"),
                                      (1000, 4096, "tail_one")])
def test_k2_exit_on_one_valid_lane_fails(M, N, kind):
    rng = np.random.default_rng(M + N)
    rows = [_gallop_row(rng, M, N, kind) for _ in range(2)]
    r = np.stack([a for a, _ in rows])
    f = np.stack([b for _, b in rows])
    want = its.intersect_gallop(_t(r), _t(f)).numpy()
    assert np.array_equal(k2_warp_exit(r, f), want)
    assert not np.array_equal(k2_warp_exit(r, f, exit_at_one=True), want)


def test_k2_compacted_buffer_is_mostly_sentinel_warps():
    """What the exit buys on the engine's buffers: after ``its.compact`` the
    valid candidates sit in front, so every warp past them leaves."""
    rng = np.random.default_rng(0)
    vals = torch.from_numpy(np.sort(rng.choice(1 << 20, 4096, replace=False))
                            .astype(np.int32))
    keep = torch.from_numpy(rng.random(4096) < 0.1)
    r, n = its.compact(vals, keep)
    warps = (r.numpy().reshape(-1, 32) != SENT).any(1)
    assert int(warps.sum()) == -(-n // 32)
    assert not warps[-(-n // 32):].any()


# --------------------------------------------------------------------------
# the lean launch path's probe on the CPU
# --------------------------------------------------------------------------

def test_kernel_device_on_cpu_and_mixed_devices():
    r = torch.zeros(128, dtype=torch.int32)
    assert _build.kernel_device(r, r) == -1
    assert _build.kernel_path(r, r) is False
    with pytest.raises(RuntimeError):
        _build.kernel_device(torch.zeros(4, device="meta"))
    with pytest.raises(ValueError):
        _build.kernel_device(r, torch.zeros(4, device="meta"))


def test_lean_wrappers_take_the_plain_path_on_cpu_without_counting():
    before = dict(_build.LAUNCHES)
    rng = np.random.default_rng(1)
    r, f = _gallop_row(rng, 500, 777, "holes")
    assert torch.equal(tkg.gallop_tiles(_t(r), _t(f)),
                       its.intersect_gallop(_t(r), _t(f)))
    assert torch.equal(tkg.gallop_tiles_batched(_t(r)[None], _t(f)[None]),
                       its.intersect_gallop(_t(r)[None], _t(f)[None]))
    ops_ = [_t(a) for a in _blocks(2, [3, 0, 32], 8)]
    assert torch.equal(tkb.unpack_blocks(*ops_, "d2", 8),
                       tkb.unpack_blocks_plain(*ops_, "d2", 8))
    assert _build.LAUNCHES == before
