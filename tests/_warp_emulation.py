"""Numpy emulations of the warp-level pieces of the port's Hopper kernels,
thread by thread, shared by tests/test_torch_gallop_unpack_hopper.py (K1,
K2) and tests/test_torch_packed_svb_hopper.py (K3, K7).

A warp's 32 lanes are the rows of a (32, 4) uint32 array: thread t holds
lanes 4t…4t+3 of a 128-lane row, as in ``csrc/unpack_warp.cuh``."""

import numpy as np


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
