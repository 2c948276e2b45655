"""Bitmap posting representation (paper §6.7, HYB+M2 substrate).

Port of ``src/repro/core/bitmap.py``.  A bitmap is an array of uint32 words,
held on the device as int32 bit patterns; a list is stored as a bitmap when
its average gap ≤ B.  These stay plain tensor ops, as they are jnp outside
Pallas in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.deltas import to_u32


def build_np(values: np.ndarray, n_docs: int) -> np.ndarray:
    words = np.zeros((n_docs + 31) // 32, dtype=np.uint32)
    v = np.asarray(values, dtype=np.int64)
    np.bitwise_or.at(words, v >> 5, (np.uint32(1) << (v & 31).astype(np.uint32)))
    return words


def probe(words: torch.Tensor, vals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """mask &= bitmap[vals] for sentinel-padded int32 vals.  An arithmetic
    right shift of the int32 word leaves bit ``s`` at bit 0, so ``& 1`` reads
    the same bit as the reference's logical shift."""
    w = words[(vals >> 5).clamp(0, words.shape[0] - 1)]
    bit = (w >> (vals & 31)) & 1
    return mask & (bit == 1)


def bitmap_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a & b


def popcount(words: torch.Tensor) -> int:
    """Number of set bits (SWAR popcount on int64 lanes)."""
    x = to_u32(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) & 0xFFFFFFFF
    return int((x >> 24).sum())


def extract_np(words: np.ndarray) -> np.ndarray:
    """Host-side: bitmap (uint32 words) -> sorted doc-id list."""
    w = np.ascontiguousarray(np.asarray(words)).view(np.uint32)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return np.nonzero(bits)[0].astype(np.int32)


def bits_per_int(words, n: int) -> float:
    return words.shape[0] * 32 / max(n, 1)
