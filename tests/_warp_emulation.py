"""Numpy emulations of the warp-level pieces of the port's Hopper kernels,
thread by thread, shared by tests/test_torch_gallop_unpack_hopper.py (K1,
K2), tests/test_torch_packed_svb_hopper.py (K3, K7) and
tests/test_torch_fold_hopper.py (K5).

A warp's 32 lanes are the rows of a (32, 4) uint32 array: thread t holds
lanes 4t…4t+3 of a 128-lane row, as in ``csrc/unpack_warp.cuh``.
``packed_slot`` is the warp body that K3 and K5 share
(``csrc/packed_warp.cuh``), up to the epilogue, which each kernel's
emulation applies."""

from typing import NamedTuple

import numpy as np

SENT = 2**31 - 1
I32_MIN, I32_MAX = -2**31, 2**31 - 1
U32 = 0xFFFFFFFF


def i32(a) -> np.ndarray:
    """uint32 or int64 values as the int32 they are, held in int64."""
    a = np.asarray(a, np.int64) & U32
    return np.where(a >= 2**31, a - 2**32, a)


def shfl_up_scan(x: np.ndarray) -> np.ndarray:
    """The kernels' ``warp_scans``: 5 steps of ``__shfl_up_sync``, lane i
    adding lane i − off's value where i ≥ off (uint32, wrapping)."""
    x = x.copy()
    for off in (1, 2, 4, 8, 16):
        y = np.zeros_like(x)
        y[off:] = x[:-off]
        x = x + y
    return x


def unpack4(stage, b: int, r: int, cols: np.ndarray) -> np.ndarray:
    """``unpack4``: the (32, 4) deltas of row r, thread t's four lanes in row
    t, from the staged word rows (widths 0–32)."""
    if b == 0:
        return np.zeros((32, 4), np.uint32)
    start = r * b
    w, sh = start >> 5, np.uint32(start & 31)
    v = stage[w][cols] >> sh
    if int(sh) + b > 32:                       # the value spills: word w + 1
        v = v | (stage[w + 1][cols] << np.uint32((32 - int(sh)) & 31))
    mask = np.uint32(0xFFFFFFFF if b >= 32 else (1 << b) - 1)
    return (v & mask).reshape(32, 4)


def prefix_row(t: np.ndarray, c: np.ndarray, mode: str) -> tuple:
    """``prefix_rows`` for one row: t (32, 4) deltas, c (32, 4) the carries
    c0…c3 of every thread → (the row's (32, 4) values, what the carries
    grow by).  The kernels run the scans of a group of rows at once and add
    the carries in row order; that changes when a scan runs, not what it
    adds, so an emulation walks the rows in order."""
    step = np.zeros((32, 4), np.uint32)
    if mode == "none":
        v = t
    elif mode == "dv":
        step = t
        v = c + t
    elif mode == "dm":
        v = t + c[:, :1]
        step[:, 0] = t[31, 3]                  # lane 127's delta
    elif mode == "d1":
        s = np.cumsum(t, axis=1, dtype=np.uint32)
        x = shfl_up_scan(s[:, 3])
        v = (c[:, 0] + (x - s[:, 3]))[:, None] + s
        step[:, 0] = x[31]
    elif mode == "d2":                         # phases 0, 1, 0, 1
        a, e = t[:, 0] + t[:, 2], t[:, 1] + t[:, 3]
        xa, xe = shfl_up_scan(a), shfl_up_scan(e)
        ba, be = c[:, 0] + (xa - a), c[:, 1] + (xe - e)
        v = np.stack([ba + t[:, 0], be + t[:, 1], ba + a, be + e], 1)
        step[:, 0], step[:, 1] = xa[31], xe[31]
    else:                                      # d4: phases 0, 1, 2, 3
        x = np.stack([shfl_up_scan(t[:, p]) for p in range(4)], 1)
        v = c + x
        step[:] = x[31]
    return v, step


def warp_partition(n: int, before) -> int:
    """``warp_partition`` (csrc/packed_gallop.cu) for one search: the first
    j in [0, n) where ``before`` fails, ``before`` taking an array of
    indices and holding on a prefix.  Each round lane i probes
    pos + (i + 1)·step − 1 of the open interval [pos, hi), step =
    ⌈(hi − pos) / 32⌉, and the ballot's count k narrows it to
    [pos + k·step, pos + (k + 1)·step − 1)."""
    lanes = np.arange(32)
    pos, hi = 0, n
    while hi > pos:
        step = (hi - pos + 31) >> 5
        p = pos + (lanes + 1) * step - 1
        t = (p < hi) & before(np.minimum(p, n - 1))
        k = int(t.sum())
        assert t[:k].all() and not t[k:].any(), "ballot is not a prefix"
        pos, hi = pos + k * step, min(pos + (k + 1) * step - 1, hi)
    return pos


def decode_tile(words, offset: int, b: int, seed, rows: int, mode: str,
                patch) -> np.ndarray:
    """``decode_staged_block`` into a warp's tile: (rows, 128) uint32;
    ``patch`` (rows, 128) deltas added before the prefix sum, or None."""
    if not 0 <= b <= 32:
        raise ValueError("the emulation covers the staged widths 0–32")
    T = words.shape[0]
    stage = words[np.clip(offset + np.arange((rows * b + 31) >> 5), 0, T - 1)]
    cols = np.arange(128)
    c = np.full((32, 4), seed, np.uint32)
    out = np.zeros((rows, 128), np.uint32)
    for r in range(rows):
        t = unpack4(stage, b, r, cols)
        if patch is not None:
            t = t + patch[r].reshape(32, 4)
        v, step = prefix_row(t, c, mode)
        c = c + step
        out[r] = v.reshape(128)
    return out


class SlotWork(NamedTuple):
    """What ``packed_slot`` leaves to the epilogue: ``clear_row`` (a pad slot
    that clears the whole row), else the owned range [lo, hi), each owned
    candidate's ``member`` flag, and the tail chunk [a, e)."""
    clear_row: bool
    lo: int = 0
    hi: int = 0
    member: np.ndarray = np.zeros(0, bool)
    a: int = 0
    e: int = 0


def packed_slot(rb, words, widths, offsets, maxes, blk, exc_pos, exc_add,
                c: int, mode: str, rows: int, *,
                mutation: str | None = None) -> SlotWork | None:
    """``packed_slot`` (csrc/packed_warp.cuh) of slot c of one row: rb (M,)
    the row's candidates; words (Tp, 128), widths/offsets/maxes (Kp,),
    blk (C,), exc_pos/exc_add (E,) its list.  None for a pad slot that
    writes nothing.  ``mutation``: "range_off_by_one" finds the owned ranges
    with lower bounds (x = hi(c) goes to slot c + 1), "pad_writes" lets
    every pad slot clear its row."""
    M = rb.shape[0]
    C, Kp, E = blk.shape[0], widths.shape[0], exc_pos.shape[0]
    per = rows * 128
    rb = rb.astype(np.int64)
    mx = i32(maxes)
    ids = blk.astype(np.int64)
    real = (ids >= 0) & (ids < Kp)
    if not real[c]:
        if c == 0 or mutation == "pad_writes":
            return SlotWork(True)
        return None
    bid = int(ids[c])
    L = warp_partition(C, lambda j: real[j])
    assert L == (C if real.all() else int(np.argmin(real)))
    last = max(L, 1) - 1
    keys = [mx[ids[c - 1]] if c > 0 else I32_MIN, mx[bid],
            mx[ids[last]] if real[last] else I32_MAX]
    side = "left" if mutation == "range_off_by_one" else "right"
    ub = [warp_partition(M, (lambda j, k=k: rb[j] < k) if side == "left"
                         else (lambda j, k=k: rb[j] <= k)) for k in keys]
    assert ub == [int(np.searchsorted(rb, k, side)) for k in keys]
    s_lo, s_hi, u = (ub[0] if c > 0 else 0), ub[1], ub[2]
    nl = max(L, 1)                         # the tail chunk, before the decode
    share = ((M - u + nl - 1) // nl + 15) & ~15
    a = u + c * share
    seed = np.uint32(maxes[bid - 1]) if bid > 0 else np.uint32(0)
    patch = None
    if E > 0:
        ep = exc_pos.astype(np.int64)
        lo_pos = bid * per
        f0, f1 = (warp_partition(E, lambda j, k=k: (ep[j] >= 0) & (ep[j] < k))
                  for k in (lo_pos, lo_pos + per))
        if f1 > f0:
            patch = np.zeros(per, np.uint32)
            np.add.at(patch, ep[f0:f1] - lo_pos,
                      exc_add[f0:f1].astype(np.uint32))
            patch = patch.reshape(rows, 128)
    tile = i32(decode_tile(words, int(offsets[bid]), int(widths[bid]), seed,
                           rows, mode, patch).reshape(-1))
    x = rb[s_lo:s_hi]                      # lanes 32 at a time, independent
    lo = np.full(x.shape, -1, np.int64)
    for k in range((per - 1).bit_length() - 1, -1, -1):
        probe = lo + (1 << k)
        lo = np.where((probe < per) & (tile[np.minimum(probe, per - 1)] < x),
                      probe, lo)
    member = (tile[np.minimum(lo + 1, per - 1)] == x) & (x != SENT)
    return SlotWork(False, s_lo, max(s_hi, s_lo), member, min(a, M),
                    min(a + share, M))
