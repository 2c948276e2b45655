"""K2 (galloping intersection) and K3 (packed gallop) wrappers and their
plain versions.

Port of ``src/repro/kernels/intersect_gallop.py``:

  gallop_tiles / gallop_tiles_batched  ← Pallas ``gallop_tiles`` /
      ``gallop_tiles_batched`` (body ``_gallop_body``); CUDA kernel in
      ``csrc/gallop.cuh``, library ``csrc/gallop_tiles.cu``.  One thread per
      candidate runs ⌈log2 N⌉ branchless lower-bound rounds over ``f`` in
      global memory, so there is no VMEM-sized cap on N and N need not be a
      power of two; a warp of SENTINEL candidates writes false and leaves
      before the first round.  The two wrappers take the lean launch path
      (``_build.kernel_device`` / ``_build.launch``).
  packed_gallop_batched  ← Pallas ``packed_gallop_batched`` (body
      ``make_packed_gallop_kernel`` with ``bitunpack.decode_candidates``);
      CUDA in ``csrc/packed_gallop.cu``: one launch, one warp per (row,
      candidate slot), which decodes its block into shared memory with K1's
      warp decode and searches there the candidates only that block can
      hold (the warp body is ``csrc/packed_warp.cuh``, which K5 shares);
      pad slots write nothing.  Lean launch path, no scratch.

The plain versions are ``core.intersect.intersect_gallop`` and
``core.intersect.intersect_packed_batch``; a wrapper takes them only for CPU
tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core import intersect as its
from repro_torch.core.deltas import MODE_IDS
from repro_torch.kernels import _build

LANES = 128
SENTINEL = 2**31 - 1


def _gallop_launch(r, f, B: int, M: int, N: int, index: int,
                   name: str) -> torch.Tensor:
    """K2 on checked r (B, M) and f (B, N) on CUDA device ``index``: the
    (B, M) bool mask (r's shape)."""
    if N < 1:
        raise ValueError(f"f must hold N ≥ 1 entries a row, got {N}")
    out = torch.empty_like(r, dtype=torch.bool)
    if B and M:
        _build.launch(name, "repro_gallop_tiles", index, r.data_ptr(), B, M,
                      f.data_ptr(), N, out.data_ptr())
    return out


def gallop_tiles(r: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """r (M,) SENTINEL-padded int32; f (N,) sorted SENTINEL-padded int32,
    N ≥ 1.  Returns the (M,) bool match mask."""
    index = _build.kernel_device(r, f)
    if index < 0:
        return its.intersect_gallop(r, f)
    _build.require(r, "r", torch.int32, 1)
    _build.require(f, "f", torch.int32, 1)
    return _gallop_launch(r, f, 1, r.shape[0], f.shape[0], index,
                          "gallop_tiles")


def gallop_tiles_batched(r: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """r (B, M), f (B, N): ``gallop_tiles`` per row → (B, M) bool."""
    index = _build.kernel_device(r, f)
    if index < 0:
        return its.intersect_gallop(r, f)
    _build.require(r, "r", torch.int32, 2)
    _build.require(f, "f", torch.int32, 2)
    B, M = r.shape
    if f.shape[0] != B:
        raise ValueError(f"f must be (B={B}, N ≥ 1), got {tuple(f.shape)}")
    return _gallop_launch(r, f, B, M, f.shape[1], index,
                          "gallop_tiles_batched")


def packed_gallop_batched(r, words, widths, offsets, maxes, blk_ids,
                          exc_pos, exc_add, mode: str,
                          block_rows: int) -> torch.Tensor:
    """Batched skip-aware packed gallop.  r (B, M) SENTINEL-padded int32;
    words (B, Tp, 128), widths/offsets/maxes (B, Kp), blk_ids (B, C) ascending
    unique ids padded with ids ≥ Kp, exc_pos/exc_add (B, E) FastPFOR patches
    in ascending position order, -1-padded at the end; uint32 arrays as
    int32 bit patterns.  Returns the (B, M) bool match mask.

    The kernel gives slot c (block id ``blk_ids[b, c]``) the candidates x with
    hi(c−1) < x ≤ hi(c), hi(c) = ``maxes[b, blk_ids[b, c]]``, and searches
    them in that block alone; the candidates above every candidate block
    are false.  That equals the reference's gallop over the concatenated
    window of the candidate blocks because (i) r's valid prefix is strictly
    increasing, then SENTINEL, and (ii) each block decodes to values in
    (maxes[id−1], maxes[id]]: the engine's compacted candidate buffers and
    the encoders' lists of strictly increasing ids give both
    (``csrc/packed_gallop.cu``)."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown delta mode {mode!r}")
    ops_ = (r, words, widths, offsets, maxes, blk_ids, exc_pos, exc_add)
    index = _build.kernel_device(*ops_)
    if index < 0:
        return its.intersect_packed_batch(*ops_, mode=mode,
                                          block_rows=block_rows)
    _build.require(r, "r", torch.int32, 2)
    _build.require(words, "words", torch.int32, 3)
    for name, t in (("widths", widths), ("offsets", offsets),
                    ("maxes", maxes), ("blk_ids", blk_ids),
                    ("exc_pos", exc_pos), ("exc_add", exc_add)):
        _build.require(t, name, torch.int32, 2)
    B, M = r.shape
    _, Tp, lanes = words.shape
    Kp, C, E = widths.shape[1], blk_ids.shape[1], exc_pos.shape[1]
    if lanes != LANES or Tp < 1 or Kp < 1 or C < 1:
        raise ValueError("need words (B, Tp ≥ 1, 128), Kp ≥ 1 and C ≥ 1")
    if not all(t.shape[0] == B for t in ops_):
        raise ValueError("every operand needs the same batch size")
    if offsets.shape[1] != Kp or maxes.shape[1] != Kp or exc_add.shape[1] != E:
        raise ValueError("widths/offsets/maxes and exc_pos/exc_add must agree")
    if not 1 <= block_rows <= 32:
        raise ValueError(f"block_rows must be in [1, 32], got {block_rows}")
    if words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary (the kernel "
                         "copies 16 bytes a lane)")
    out = r.new_empty((B, M), dtype=torch.bool)
    if B and M:
        _build.launch("packed_gallop_batched", "repro_packed_gallop", index,
                      r.data_ptr(), M, words.data_ptr(), Tp,
                      widths.data_ptr(), offsets.data_ptr(), maxes.data_ptr(),
                      Kp, blk_ids.data_ptr(), C, exc_pos.data_ptr(),
                      exc_add.data_ptr(), E, block_rows, MODE_IDS[mode], B,
                      out.data_ptr())
    return out
