"""K1: integrated bit-unpack + prefix sum (paper Algorithm 1), and the plain
candidate-block decode of K3 and K5.

Port of ``src/repro/kernels/bitunpack.py``: ``unpack_blocks`` replaces the
Pallas kernel ``unpack_blocks`` (``make_unpack_kernel``) with the CUDA
kernel in ``csrc/unpack_blocks.cu``; ``decode_candidates`` is the plain
version of the candidate-block decode that K3 (``csrc/packed_gallop.cu``)
and K5 (``csrc/packed_fold.cu``) run, a block a warp in shared memory
through ``csrc/packed_warp.cuh`` (the reference's ``decode_candidates``).

The Hopper kernel reads the flat (T, 128) words through per-block row
offsets, so a list is decoded in place: the reference's gather into
(K, 32, 128) padded blocks (``ops.pad_packed``) has no counterpart.  It
takes ``block_rows`` at run time (32 for ``bp-*``, 8 for ``bp8-*`` and the
short lists of ``bp-*``).  One warp decodes one block, ``WARPS`` blocks a
CTA (``csrc/unpack_warp.cuh``); the wrapper takes the lean launch path
(``_build.kernel_device`` / ``_build.launch``).
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack as core_bitpack
from repro_torch.core import deltas as core_deltas
from repro_torch.core.deltas import MODE_IDS, to_i32, to_u32
from repro_torch.kernels import _build

ROWS = 32
LANES = 128
WARPS = 4            # blocks a CTA: csrc/unpack_warp.cuh's kUnpackWarps
SENTINEL = 2**31 - 1


def unpack_blocks_plain(words, offsets, widths, seeds, mode: str = "d1",
                        block_rows: int = ROWS) -> torch.Tensor:
    """Plain version of K1: (T, 128) words, (K,) offsets/widths/seeds →
    (K, block_rows, 128) int32 bit patterns of the uint32 values."""
    d = core_bitpack.unpack_deltas(words, widths, offsets, block_rows)
    return to_i32(core_deltas.prefix_sum(d, seeds, mode))


def unpack_blocks(words, offsets, widths, seeds, mode: str = "d1",
                  block_rows: int = ROWS) -> torch.Tensor:
    """K1's wrapper.  words: (T, 128) int32 bit patterns, T ≥ 1; offsets and
    widths: (K,) int32; seeds: (K,) int32 bit patterns.  Returns
    (K, block_rows, 128) int32 bit patterns.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown delta mode {mode!r}")
    index = _build.kernel_device(words, offsets, widths, seeds)
    if index < 0:
        return unpack_blocks_plain(words, offsets, widths, seeds, mode,
                                   block_rows)
    _build.require(words, "words", torch.int32, 2)
    for name, t in (("offsets", offsets), ("widths", widths), ("seeds", seeds)):
        _build.require(t, name, torch.int32, 1)
    K = widths.shape[0]
    T = words.shape[0]
    if words.shape[1] != LANES or T < 1:
        raise ValueError(f"words must be (T ≥ 1, {LANES}), got {tuple(words.shape)}")
    if offsets.shape[0] != K or seeds.shape[0] != K:
        raise ValueError("offsets, widths and seeds must have one entry per block")
    if not 1 <= block_rows <= 32:
        raise ValueError(f"block_rows must be in [1, 32], got {block_rows}")
    if words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary (the kernel "
                         "copies 16 bytes a lane)")
    out = words.new_empty((K, block_rows, LANES))
    if K:
        _build.launch("unpack_blocks", "repro_unpack_blocks", index,
                      words.data_ptr(), T, offsets.data_ptr(),
                      widths.data_ptr(), seeds.data_ptr(), K, block_rows,
                      MODE_IDS[mode], out.data_ptr())
    return out


def decode_candidates(words, widths, offsets, maxes, blk, exc_pos, exc_add,
                      *, mode: str, block_rows: int) -> torch.Tensor:
    """Plain partial decode of one row's candidate blocks → a flat sorted
    int32 window of C·block_rows·128 values, SENTINEL on pad slots.

    words (T, 128), widths/offsets/maxes (Kp,), blk (C,) ascending unique
    block ids padded with ids ≥ Kp, exc_pos/exc_add (E,) FastPFOR patches
    (-1-padded) or None.  Each candidate block is unpacked, its exceptions are
    added before the prefix sum (exceptions of other blocks drop), and it is
    prefix-summed from the seed ``maxes[id−1]`` (0 for block 0)."""
    per = block_rows * LANES
    Kp = maxes.shape[0]
    C = blk.shape[0]
    b64 = blk.to(torch.int64)
    pad = b64 >= Kp
    ids = b64.clamp(max=Kp - 1)
    seeds = torch.where(ids > 0, to_u32(maxes)[(ids - 1).clamp(min=0)], 0)
    d = core_bitpack.unpack_deltas(words, widths[ids], offsets[ids],
                                   block_rows)
    if exc_pos is not None and exc_pos.shape[0]:
        ep = exc_pos.to(torch.int64)
        eb = torch.div(ep, per, rounding_mode="floor")
        slot_of = torch.full((Kp + 1,), -1, dtype=torch.int64, device=d.device)
        slot_of[b64.clamp(0, Kp)] = torch.arange(C, device=d.device)
        slot = slot_of[eb.clamp(0, Kp)]
        ok = (ep >= 0) & (eb < Kp) & (slot >= 0)
        tgt = slot[ok] * per + ep[ok] % per
        d = d.reshape(-1).index_add(0, tgt, to_u32(exc_add)[ok]).reshape(d.shape)
    flat = to_i32(core_deltas.prefix_sum(d, seeds, mode).reshape(-1))
    return torch.where(pad.repeat_interleave(per), SENTINEL, flat)
