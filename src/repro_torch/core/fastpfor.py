"""FastPFOR / S4-FastPFOR patched coding (paper §3).

Port of ``src/repro/core/fastpfor.py``.  Per block of ROWS×128 deltas the
encoder picks a base width b' ≤ b minimizing the paper's cost heuristic
``N·b' + c(b')·(b − b' + POS_BITS)``; the low b' bits of every delta are
bit-packed like a BP block and each exception stores its position and its
high bits, pre-shifted by b'.

Decode = unpack base → patch (add high<<b' at exception positions) → prefix
sum.  The patch must precede the prefix sum.  As in the reference this is
plain tensor code on every device (the reference's is jnp outside Pallas);
the skip path decodes FastPFOR blocks inside the packed-gallop kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack, deltas as deltas_lib
from repro_torch.core.deltas import to_i32, to_u32

LANES = 128
POS_BITS = 16      # exception positions within a 4096 block (paper: 8 for 128)


@dataclasses.dataclass
class PatchedList:
    flat_words: torch.Tensor   # (T, 128) int32 bit patterns — base packed at b'
    widths: torch.Tensor       # (K,) int32 — b' per block
    offsets: torch.Tensor      # (K,) int32
    maxes: torch.Tensor        # (K,) int32 bit patterns of uint32 maxima
    exc_pos: torch.Tensor      # (E,) int32 — global padded positions, ascending
    exc_add: torch.Tensor      # (E,) int32 bit patterns — high bits << b'
    n: int
    mode: str = "d1"
    block_rows: int = bitpack.DEFAULT_ROWS
    format_bits: int = 0       # storage accounting (paper format)

    @property
    def num_blocks(self):
        return self.widths.shape[0]

    def to(self, device) -> "PatchedList":
        return dataclasses.replace(
            self, flat_words=self.flat_words.to(device),
            widths=self.widths.to(device), offsets=self.offsets.to(device),
            maxes=self.maxes.to(device), exc_pos=self.exc_pos.to(device),
            exc_add=self.exc_add.to(device))


def _best_base_width(d_flat: np.ndarray) -> tuple[int, int]:
    """Pick b' minimizing the paper's cost heuristic. Returns (b', b)."""
    N = d_flat.size
    bl = np.zeros(N, dtype=np.int32)
    nz = d_flat > 0
    bl[nz] = np.floor(np.log2(d_flat[nz].astype(np.float64))).astype(np.int32) + 1
    b = int(bl.max()) if N else 0
    counts = np.bincount(bl, minlength=b + 1)
    ge = np.cumsum(counts[::-1])[::-1]          # ge[w] = #deltas with bl > w-1
    best_bp, best_cost = b, N * b
    for bp in range(b + 1):
        c = int(ge[bp + 1]) if bp + 1 <= b else 0   # exceptions: bl > bp
        cost = N * bp + c * (b - bp + POS_BITS)
        if cost < best_cost:
            best_cost, best_bp = cost, bp
    return best_bp, b


def encode(values: np.ndarray, mode: str = "d1",
           block_rows: int = bitpack.DEFAULT_ROWS) -> PatchedList:
    """Host encode (numpy) into CPU tensors; ``PatchedList.to`` moves them."""
    v = np.asarray(values, dtype=np.int64).ravel()
    n = int(v.size)
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

    widths = np.zeros(K, dtype=np.int32)
    packed, all_pos, all_add = [], [], []
    format_bits = 0
    exc_class_counts = np.zeros(33, dtype=np.int64)   # per (b-b') class
    for k in range(K):
        dk = d[k].reshape(-1).astype(np.uint64)
        bp, b = _best_base_width(dk)
        widths[k] = bp
        mask = np.uint64((1 << bp) - 1) if bp else np.uint64(0)
        base = (dk & mask).astype(np.uint32)
        packed.append(bitpack.pack_block_np(
            base.reshape(block_rows, LANES), bp))
        exc = np.nonzero(dk > mask)[0]
        if exc.size:
            high = (dk[exc] >> np.uint64(bp)).astype(np.uint32)
            all_pos.append(exc.astype(np.int64) + k * per)
            all_add.append((high.astype(np.uint64) << np.uint64(bp))
                           .astype(np.uint32))
            exc_class_counts[b - bp] += exc.size
        # paper format: 2 width bytes + 1 exception-count byte per block
        format_bits += per * bp + 24 + exc.size * POS_BITS
        format_bits += 8 + 32          # our per-block metadata: width byte + max
    # high-bit arrays: bit-packed per class, padded to multiples of 32 ints
    for cls in range(1, 33):
        cnt = exc_class_counts[cls]
        if cnt:
            padded = int(np.ceil(cnt / 32) * 32)
            format_bits += padded * cls

    offsets = np.concatenate([[0], np.cumsum(widths[:-1])]).astype(np.int32)
    total_rows = int(widths.sum())
    flat = (np.concatenate(packed, axis=0) if total_rows
            else np.zeros((0, LANES), dtype=np.uint32))
    if flat.shape[0] == 0:
        flat = np.zeros((1, LANES), dtype=np.uint32)
    exc_pos = (np.concatenate(all_pos) if all_pos
               else np.zeros(0, np.int64)).astype(np.int32)
    exc_add = (np.concatenate(all_add) if all_add
               else np.zeros(0, np.uint32))
    return PatchedList(
        flat_words=bitpack._u32_tensor(flat), widths=torch.from_numpy(widths),
        offsets=torch.from_numpy(offsets),
        maxes=bitpack._u32_tensor(maxes.astype(np.uint32)),
        exc_pos=torch.from_numpy(exc_pos),
        exc_add=bitpack._u32_tensor(exc_add),
        n=n, mode=mode, block_rows=block_rows, format_bits=int(format_bits))


def decode_device(flat_words, widths, offsets, seeds, exc_pos, exc_add,
                  mode: str, block_rows: int) -> torch.Tensor:
    """unpack → patch → prefix sum.  Returns (K, R, 128) int32 bit patterns.
    Positions outside [0, K·R·128) drop, as the reference's ``mode="drop"``."""
    d = bitpack.unpack_deltas(flat_words, widths, offsets, block_rows)
    K = widths.shape[0]
    dflat = d.reshape(-1)
    pos = exc_pos.to(torch.int64)
    ok = (pos >= 0) & (pos < dflat.shape[0])
    dflat = dflat.index_add(0, pos[ok], to_u32(exc_add)[ok])
    d = dflat.reshape(K, block_rows, LANES)
    return to_i32(deltas_lib.prefix_sum(d, seeds, mode))


def decode(pl: PatchedList) -> torch.Tensor:
    seeds = torch.cat([torch.zeros(1, dtype=torch.int32,
                                   device=pl.maxes.device), pl.maxes[:-1]])
    return decode_device(pl.flat_words, pl.widths, pl.offsets, seeds,
                         pl.exc_pos, pl.exc_add, pl.mode,
                         pl.block_rows).reshape(-1)


def decode_np(pl: PatchedList) -> np.ndarray:
    return decode(pl).cpu().numpy().view(np.uint32)[: pl.n]


def bits_per_int(pl: PatchedList) -> float:
    return pl.format_bits / max(pl.n, 1)
