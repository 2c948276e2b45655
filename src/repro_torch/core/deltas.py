"""Differential coding for sorted integer blocks (paper §4).

Port of ``src/repro/core/deltas.py``.  Blocks are (R, 128) tiles; the six
modes are the reference's: none, d1, d2, d4 (stride-s deltas), dm (row-max)
and dv (stride-128 row deltas), each seeded with the last value of the
previous block.

uint32 in torch: torch's CPU build has no ``>>``, ``+`` or ``>`` on
``torch.uint32``, so the port stores a uint32 as its int32 bit pattern
(``to_i32``) and computes on int64 values in [0, 2**32) (``to_u32``),
masking after each sum.  Addition mod 2**32 is a ring homomorphism, so masking
once after an int64 cumsum equals wrapping at every add, as the reference's
``dtype=jnp.uint32`` cumsums do.
"""

from __future__ import annotations

import numpy as np
import torch

MODES = ("none", "d1", "d2", "d4", "dm", "dv")
MODE_IDS = {m: i for i, m in enumerate(MODES)}     # kernel mode argument
_STRIDE = {"d1": 1, "d2": 2, "d4": 4}
U32_MASK = 0xFFFFFFFF


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or int64) → int64 values in [0, 2**32)."""
    return x.to(torch.int64) & U32_MASK


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (taken mod 2**32) → int32 tensor of the same bit pattern."""
    x = x & U32_MASK
    return torch.where(x > 0x7FFFFFFF, x - (1 << 32), x).to(torch.int32)


# --------------------------------------------------------------------------
# host-side encode (numpy, int64 domain) — a copy of the reference's
# --------------------------------------------------------------------------

def encode_deltas_np(blocks: np.ndarray, seeds: np.ndarray, mode: str) -> np.ndarray:
    """blocks: (K, R, 128) int64 sorted (flattened row-major per block).

    seeds: (K,) int64 scalar carry-in per block.  Returns (K, R, 128) uint32.
    """
    if mode not in MODES:
        raise ValueError(f"unknown delta mode {mode!r}")
    K, R, L = blocks.shape
    if L != 128:
        raise ValueError("blocks must be (K, R, 128)")
    x = blocks.astype(np.int64)
    if mode == "none":
        d = x.copy()
    elif mode == "dv":
        d = np.empty_like(x)
        d[:, 0] = x[:, 0] - seeds[:, None]
        d[:, 1:] = x[:, 1:] - x[:, :-1]
    elif mode == "dm":
        d = np.empty_like(x)
        d[:, 0] = x[:, 0] - seeds[:, None]
        d[:, 1:] = x[:, 1:] - x[:, :-1, 127:128]
    else:  # stride modes d1/d2/d4
        s = _STRIDE[mode]
        flat = x.reshape(K, R * L)
        d = np.empty_like(flat)
        d[:, :s] = flat[:, :s] - seeds[:, None]
        d[:, s:] = flat[:, s:] - flat[:, :-s]
        d = d.reshape(K, R, L)
    if d.min() < 0:
        raise ValueError("input not sorted (negative delta)")
    if d.max() > 0xFFFFFFFF:
        raise ValueError("delta exceeds 32 bits")
    return d.astype(np.uint32)


# --------------------------------------------------------------------------
# tensor encode (torch, int64 values taken mod 2**32)
# --------------------------------------------------------------------------

def encode_deltas(blocks: torch.Tensor, seeds: torch.Tensor,
                  mode: str) -> torch.Tensor:
    """Port of the reference's ``encode_deltas_jnp``, the inverse of
    ``prefix_sum`` on the payload's device.

    blocks: (K, R, 128) sorted uint32 values (int32 bit patterns or int64);
    seeds: (K,).  Returns (K, R, 128) int64 deltas in [0, 2**32): every
    difference wraps mod 2**32 as the reference's uint32 ones do, and
    nothing checks that the input was sorted."""
    if mode not in MODES:
        raise ValueError(f"unknown delta mode {mode!r}")
    x = to_u32(blocks)
    seeds = to_u32(seeds)
    if mode == "none":
        return x
    if mode == "dv":
        d = torch.cat([x[:, :1] - seeds[:, None, None],
                       x[:, 1:] - x[:, :-1]], dim=1)
    elif mode == "dm":
        d = torch.cat([x[:, :1] - seeds[:, None, None],
                       x[:, 1:] - x[:, :-1, 127:128]], dim=1)
    else:
        s = _STRIDE[mode]
        K, R, L = x.shape
        flat = x.reshape(K, R * L)
        d = torch.cat([flat[:, :s] - seeds[:, None],
                       flat[:, s:] - flat[:, :-s]], dim=1).reshape(K, R, L)
    return d & U32_MASK


# --------------------------------------------------------------------------
# prefix sum (torch, int64 values taken mod 2**32)
# --------------------------------------------------------------------------

def _excl_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cumsum(a, dim=dim) - a


def _d1_block_cumsum(d: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """d: (K, R, C) int64, seeds: (K,) → inclusive running sum in row-major
    order per block, seeded (not yet reduced mod 2**32)."""
    row_cum = torch.cumsum(d, dim=-1)
    carry = seeds[:, None] + _excl_cumsum(row_cum[..., -1], dim=1)   # (K, R)
    return row_cum + carry[..., None]


def prefix_sum(deltas: torch.Tensor, seeds: torch.Tensor, mode: str) -> torch.Tensor:
    """Reconstruct original values from deltas (paper Algorithm 1).

    deltas: (K, R, 128) uint32 values (int32 bit patterns or int64);
    seeds: (K,).  Returns (K, R, 128) int64 values in [0, 2**32).
    """
    if mode not in MODES:
        raise ValueError(f"unknown delta mode {mode!r}")
    d = to_u32(deltas)
    seeds = to_u32(seeds)
    if mode == "none":
        return d
    if mode == "dv":
        out = seeds[:, None, None] + torch.cumsum(d, dim=1)
    elif mode == "dm":
        carry_prev = seeds[:, None] + _excl_cumsum(d[..., 127], dim=1)
        out = d + carry_prev[..., None]
    elif mode == "d1":
        out = _d1_block_cumsum(d, seeds)
    else:
        # d2 / d4: s independent stride-1 chains interleaved across lanes
        s = _STRIDE[mode]
        K, R, L = d.shape
        dd = d.reshape(K, R, L // s, s)
        outs = [_d1_block_cumsum(dd[..., p], seeds) for p in range(s)]
        out = torch.stack(outs, dim=-1).reshape(K, R, L)
    return out & U32_MASK
