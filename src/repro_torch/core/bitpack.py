"""Block bit packing for sorted 32-bit integers (paper §3, S4-BP128).

Port of ``src/repro/core/bitpack.py``.  A block is ROWS×128 integers viewed
as a (ROWS, 128) tile; lane ``l`` packs its ROWS integers vertically into
``b`` 32-bit words, so a block packs to a (b, 128) tile, and blocks
concatenate into one flat (T, 128) word array with per-block row offsets.

Host encode is numpy and emits the reference's words bit for bit.  Tensors
hold uint32 words and maxes as int32 bit patterns (``deltas.to_i32``).
Full decodes go through ``kernels.bitunpack.unpack_blocks``: the integrated
unpack + prefix sum (paper Algorithm 1), a hand-written kernel on the card
and ``unpack_deltas`` + ``deltas.prefix_sum`` on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import deltas as deltas_lib
from repro_torch.core.deltas import U32_MASK, to_u32

LANES = 128
DEFAULT_ROWS = 32          # 4096-integer blocks; 8 → 1024-integer blocks


# --------------------------------------------------------------------------
# container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PackedList:
    """One compressed sorted list (tensors on one device)."""
    flat_words: torch.Tensor   # (T, 128) int32 bit patterns of uint32 words
    widths: torch.Tensor       # (K,) int32   bit width per block
    offsets: torch.Tensor      # (K,) int32   row offset of each block
    maxes: torch.Tensor        # (K,) int32 bit patterns of uint32 block maxima
    n: int                     # valid count
    mode: str = "d1"           # delta mode
    block_rows: int = DEFAULT_ROWS

    @property
    def num_blocks(self) -> int:
        return self.widths.shape[0]

    @property
    def padded_n(self) -> int:
        return self.num_blocks * self.block_rows * LANES

    def to(self, device) -> "PackedList":
        return dataclasses.replace(
            self, flat_words=self.flat_words.to(device),
            widths=self.widths.to(device), offsets=self.offsets.to(device),
            maxes=self.maxes.to(device))


def _np_u32(t: torch.Tensor) -> np.ndarray:
    """int32-bit-pattern tensor → numpy uint32 (host copy)."""
    return t.cpu().numpy().view(np.uint32)


# --------------------------------------------------------------------------
# batch-uniform layout (posting-source layer)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PackedLayout:
    """Host-side (numpy) view of one compressed list, padded to bucket sizes
    so it stacks into uniform device operands.  ``PackedList`` and
    ``fastpfor.PatchedList`` both project onto it (a bitpacked list has zero
    exceptions)."""
    words: np.ndarray      # (t_pad, 128) uint32
    widths: np.ndarray     # (k_pad,) int32   (pad blocks: width 0)
    offsets: np.ndarray    # (k_pad,) int32   (pad blocks: clamped in-range)
    maxes: np.ndarray      # (k_pad,) uint32  (edge-padded → stays monotone)
    exc_pos: np.ndarray    # (e_pad,) int32   (pad entries: -1 → dropped)
    exc_add: np.ndarray    # (e_pad,) uint32
    n: int
    mode: str
    block_rows: int


def skip_capable(payload) -> bool:
    """True when the payload carries the flat packed-block layout (and so a
    block-max skip index): PackedList and fastpfor.PatchedList both do."""
    return all(hasattr(payload, a)
               for a in ("flat_words", "widths", "offsets", "maxes"))


def pad_fills(T: int, last_max) -> tuple:
    """The pad value of each of a layout's six operands, in K5's order
    (words, widths, offsets, maxes, exc_pos, exc_add), for a list of ``T``
    word rows whose last block's max is ``last_max``: zero words and
    widths, offsets T − 1, maxes the last block's max (the edge pad keeps
    maxes monotone), exception positions -1 and additions 0."""
    return 0, 0, max(T - 1, 0), last_max, -1, 0


def layout_np(payload, k_pad: int, t_pad: int, e_pad: int) -> PackedLayout:
    """Project a skip-capable payload onto the batch-uniform layout."""
    widths = payload.widths.cpu().numpy()
    offsets = payload.offsets.cpu().numpy()
    maxes = _np_u32(payload.maxes)
    words = _np_u32(payload.flat_words)
    K, T = widths.shape[0], words.shape[0]
    if K > k_pad or T > t_pad:
        raise ValueError(f"pads too small: K={K} > {k_pad} or T={T} > {t_pad}")
    f_words, f_widths, f_offsets, f_maxes, f_pos, f_add = pad_fills(
        T, maxes[-1] if K else 0)
    w = np.full(k_pad, f_widths, np.int32)
    w[:K] = widths
    o = np.full(k_pad, f_offsets, np.int32)
    o[:K] = offsets
    mx = np.full(k_pad, f_maxes, np.uint32)
    mx[:K] = maxes
    fw = np.full((t_pad, LANES), f_words, np.uint32)
    fw[:T] = words
    exc_pos = getattr(payload, "exc_pos", None)
    ep_src = (exc_pos.cpu().numpy() if exc_pos is not None
              else np.zeros(0, np.int32))
    ea_src = (_np_u32(payload.exc_add) if exc_pos is not None
              else np.zeros(0, np.uint32))
    E = ep_src.shape[0]
    if E > e_pad:
        raise ValueError(f"pads too small: E={E} > {e_pad}")
    ep = np.full(e_pad, f_pos, np.int32)
    ep[:E] = ep_src
    ea = np.full(e_pad, f_add, np.uint32)
    ea[:E] = ea_src
    return PackedLayout(words=fw, widths=w, offsets=o, maxes=mx,
                        exc_pos=ep, exc_add=ea, n=payload.n,
                        mode=payload.mode, block_rows=payload.block_rows)


def self_pads(payload) -> tuple[int, int, int]:
    """A skip-capable payload's own pow2 (k_pad, t_pad, e_pad) buckets."""
    k = int(payload.widths.shape[0])
    t = int(payload.flat_words.shape[0])
    exc_pos = getattr(payload, "exc_pos", None)
    e = int(exc_pos.shape[0]) if exc_pos is not None else 0
    return (_pow2(k), _pow2(t), _pow2(e) if e else 0)


def candidate_block_ids(maxes_np: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Unique block ids whose value range may contain any of ``values``
    (host-side probe of the block-max skip index)."""
    mx = np.asarray(maxes_np).astype(np.int64)
    v = np.asarray(values, dtype=np.int64)
    if mx.size == 0 or v.size == 0:
        return np.zeros(0, np.int32)
    blk = np.searchsorted(mx, v, side="left")
    blk = np.minimum(blk, mx.size - 1)
    return np.unique(blk).astype(np.int32)


# --------------------------------------------------------------------------
# host-side pack (numpy)
# --------------------------------------------------------------------------

def pack_block_np(deltas_block: np.ndarray, width: int) -> np.ndarray:
    """deltas_block: (R, 128) uint32 with values < 2**width -> (width, 128)."""
    R, L = deltas_block.shape
    if width == 0:
        return np.zeros((0, L), dtype=np.uint32)
    d = deltas_block.astype(np.uint64)
    out = np.zeros((width, L), dtype=np.uint64)
    for r in range(R):
        start = r * width
        w, sh = divmod(start, 32)
        out[w] |= d[r] << np.uint64(sh)
        if sh + width > 32:
            out[w + 1] |= d[r] >> np.uint64(32 - sh)
    return (out & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _u32_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32))


def encode(values: np.ndarray, mode: str = "d1",
           block_rows: int | None = None) -> PackedList:
    """Compress a sorted 1-D array of non-negative ints (< 2**32) on the host
    into CPU tensors (``PackedList.to`` moves them).

    block_rows=None picks the block size adaptively: lists of at most 8192
    ints use 1024-int blocks (8 rows), longer ones 4096-int blocks."""
    v = np.asarray(values, dtype=np.int64).ravel()
    n = int(v.size)
    if block_rows is None:
        block_rows = 8 if n <= 8192 else DEFAULT_ROWS
    if n == 0:
        v = np.zeros(1, dtype=np.int64)
    per = block_rows * LANES
    npad = (-len(v)) % per
    if npad:
        v = np.concatenate([v, np.full(npad, v[-1], dtype=np.int64)])
    K = len(v) // per
    blocks = v.reshape(K, block_rows, LANES)
    maxes = blocks[:, -1, -1].copy()
    seeds = np.concatenate([[0], maxes[:-1]])
    d = deltas_lib.encode_deltas_np(blocks, seeds, mode)
    widths = np.array(
        [int(d[k].max()).bit_length() for k in range(K)], dtype=np.int32)
    packed = [pack_block_np(d[k], int(widths[k])) for k in range(K)]
    offsets = np.concatenate([[0], np.cumsum(widths[:-1])]).astype(np.int32)
    total_rows = int(widths.sum())
    flat = (np.concatenate(packed, axis=0) if total_rows
            else np.zeros((0, LANES), dtype=np.uint32))
    if flat.shape[0] == 0:                      # keep gathers in-bounds
        flat = np.zeros((1, LANES), dtype=np.uint32)
    return PackedList(
        flat_words=_u32_tensor(flat), widths=torch.from_numpy(widths),
        offsets=torch.from_numpy(offsets),
        maxes=_u32_tensor(maxes.astype(np.uint32)),
        n=n, mode=mode, block_rows=block_rows)


# --------------------------------------------------------------------------
# unpack (plain torch) and decode
# --------------------------------------------------------------------------

def unpack_deltas(flat_words, widths, offsets, block_rows: int = DEFAULT_ROWS):
    """Width-generic gather-based bit unpack (plain torch).

    flat_words: (T, 128) uint32 words (int32 bit patterns or int64);
    widths/offsets: (K,).  Returns (K, block_rows, 128) int64 deltas.
    Word indices clamp to [0, T−1] as in the reference.
    """
    T = flat_words.shape[0]
    words = to_u32(flat_words)
    r = torch.arange(block_rows, dtype=torch.int64, device=words.device)
    b = widths.to(torch.int64)[:, None]                    # (K, 1)
    start = r[None, :] * b                                 # (K, R) bit offset
    w = start >> 5
    sh = start & 31
    off = offsets.to(torch.int64)[:, None]
    lo = words[(off + w).clamp(0, T - 1)]                  # (K, R, 128)
    hi = words[(off + w + 1).clamp(0, T - 1)]
    mask = torch.where(b >= 32, U32_MASK,
                       (torch.ones_like(b) << b.clamp(0, 31)) - 1)[..., None]
    spill = ((sh + b) > 32)[..., None]
    val = lo >> sh[..., None]
    hi_part = (hi << ((32 - sh) & 31)[..., None]) & U32_MASK
    val = torch.where(spill, val | hi_part, val)
    return val & mask


def seeds_of(pl: PackedList) -> torch.Tensor:
    """Per-block seeds: 0, then the previous block's max (int32 bit patterns)."""
    return torch.cat([torch.zeros(1, dtype=torch.int32,
                                  device=pl.maxes.device), pl.maxes[:-1]])


def decode(pl: PackedList) -> torch.Tensor:
    """Decode to the (padded) flat value array (padded_n,), uint32 values as
    int32 bit patterns, through the integrated unpack kernel."""
    from repro_torch.kernels import bitunpack
    vals = bitunpack.unpack_blocks(pl.flat_words, pl.offsets, pl.widths,
                                   seeds_of(pl), pl.mode, pl.block_rows)
    return vals.reshape(-1)


def decode_np(pl: PackedList) -> np.ndarray:
    """Decode and trim to the valid length (numpy uint32)."""
    return decode(pl).cpu().numpy().view(np.uint32)[: pl.n]


def _pow2(n: int, floor: int = 1) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def decode_bucketed(pl: PackedList) -> torch.Tensor:
    """Decode with K padded to a power of two, as the reference does; pad
    blocks have width 0 and decode to the seed value, and callers trim to
    ``pl.n``.  (The reference also pads T so as to bound jit
    specializations; word reads clamp into [0, T−1] here, which gives the
    same values, and torch has no specializations to bound.)"""
    from repro_torch.kernels import bitunpack
    K = pl.num_blocks
    T = pl.flat_words.shape[0]
    Kp = _pow2(K)
    dev = pl.widths.device
    widths = torch.cat([pl.widths, torch.zeros(Kp - K, dtype=torch.int32,
                                               device=dev)])
    offsets = torch.cat([pl.offsets, torch.full((Kp - K,), T - 1,
                                                dtype=torch.int32, device=dev)])
    edge = pl.maxes[-1:] if K else torch.zeros(1, dtype=torch.int32, device=dev)
    maxes = torch.cat([pl.maxes, edge.expand(Kp - K)])
    seeds = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       maxes[:-1]])
    vals = bitunpack.unpack_blocks(pl.flat_words, offsets, widths, seeds,
                                   pl.mode, pl.block_rows)
    return vals.reshape(-1)


# --------------------------------------------------------------------------
# accounting
# --------------------------------------------------------------------------

def bits_per_int(pl: PackedList) -> float:
    """Storage cost: packed words + per-block metadata (1B width + 4B max)."""
    data_bits = int(pl.widths.sum()) * LANES * 32
    meta_bits = pl.num_blocks * (8 + 32)
    return (data_bits + meta_bits) / max(pl.n, 1)
