"""K4 (decoded fold) and K5 (packed fold): a batch's whole SvS fold chain in
one call each, and their plain versions.

Port of ``src/repro/kernels/megakernel.py``:

  decoded_fold_batched  ← Pallas ``decoded_fold_batched`` (body
      ``make_decoded_fold_kernel``); CUDA kernel ``fold_kernel`` in
      ``csrc/fold.cuh``, library ``csrc/decoded_fold.cu``.  The TPU kernel
      revisits row b's output block across a sequential j axis; the CUDA
      kernel loops over j inside the thread of each candidate instead, so no
      order between blocks is needed.
  packed_fold_batched  ← Pallas ``packed_fold_batched`` (body
      ``make_packed_fold_kernel``); CUDA in ``csrc/packed_fold.cu``: one pass
      with no window.  ``valid`` is copied into the output, then a warp per
      (j, b, candidate slot) decodes its block in shared memory (K3's warp
      body, ``csrc/packed_warp.cuh``) and clears the candidates that block
      can hold but does not; the fold's AND is a clear, so the warps need no
      order.

Both ANDs are seeded from ``valid``, and an inactive (j, b) slot is the
identity.  Both wrappers take the lean launch path (``_build.kernel_device``
/ ``_build.launch``).

The plain versions loop over j with ``core.intersect.intersect_gallop`` /
``intersect_packed_batch`` and AND through ``torch.where(active, hit,
True)``; a wrapper takes them only for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.core import intersect as its
from repro_torch.core.deltas import MODE_IDS
from repro_torch.kernels import _build

LANES = 128
MAX_GRID_Y = 65535      # CUDA's limit on gridDim.y (K4's rows)


def _fold_and(out, hit, active_j):
    return out & torch.where(active_j[:, None], hit, True)


def decoded_fold_plain(r, valid, folds, fold_active) -> torch.Tensor:
    """Plain K4: AND the gallop hits of r (B, M) in each folds[j] (B, N)
    into ``valid`` where fold_active[j] (B,) is set."""
    out = valid
    for j in range(folds.shape[0]):
        out = _fold_and(out, its.intersect_gallop(r, folds[j]), fold_active[j])
    return out


def packed_fold_plain(r, valid, words, widths, offsets, maxes, blk_ids,
                      exc_pos, exc_add, active, *, mode: str,
                      block_rows: int) -> torch.Tensor:
    """Plain K5: ``decoded_fold_plain`` over the partial decodes of the Jp
    packed slots (``core.intersect.intersect_packed_batch``)."""
    out = valid
    for j in range(words.shape[0]):
        hit = its.intersect_packed_batch(
            r, words[j], widths[j], offsets[j], maxes[j], blk_ids[j],
            exc_pos[j], exc_add[j], mode=mode, block_rows=block_rows)
        out = _fold_and(out, hit, active[j])
    return out


def _check_rows(r, valid) -> tuple[int, int]:
    _build.require(r, "r", torch.int32, 2)
    _build.require(valid, "valid", torch.bool, 2)
    if valid.shape != r.shape:
        raise ValueError(f"valid {tuple(valid.shape)} must match r "
                         f"{tuple(r.shape)}")
    return r.shape


def decoded_fold_batched(r, valid, folds, fold_active) -> torch.Tensor:
    """K4.  r (B, M) SENTINEL-padded int32, valid (B, M) bool, folds
    (J, B, N) sorted SENTINEL-padded int32 with N ≥ 1, fold_active (J, B)
    bool → the (B, M) bool mask after ANDing all J folds.  J = 0 returns
    ``valid`` without a launch."""
    if folds.shape[0] == 0:
        return valid
    index = _build.kernel_device(r, valid, folds, fold_active)
    if index < 0:
        return decoded_fold_plain(r, valid, folds, fold_active)
    B, M = _check_rows(r, valid)
    _build.require(folds, "folds", torch.int32, 3)
    _build.require(fold_active, "fold_active", torch.bool, 2)
    J, _, N = folds.shape
    if folds.shape[1] != B or N < 1 or fold_active.shape != (J, B):
        raise ValueError(f"need folds (J, B={B}, N ≥ 1) and fold_active "
                         f"(J, B), got {tuple(folds.shape)} and "
                         f"{tuple(fold_active.shape)}")
    if B > MAX_GRID_Y:
        raise ValueError(f"B={B} exceeds the grid limit {MAX_GRID_Y}")
    out = r.new_empty((B, M), dtype=torch.bool)
    if B and M:
        _build.launch("decoded_fold_batched", "repro_decoded_fold", index,
                      r.data_ptr(), valid.data_ptr(), B, M, folds.data_ptr(),
                      J, N, fold_active.data_ptr(), out.data_ptr())
    return out


def packed_fold_batched(r, valid, words, widths, offsets, maxes, blk_ids,
                        exc_pos, exc_add, active, *, mode: str,
                        block_rows: int) -> torch.Tensor:
    """K5.  r (B, M), valid (B, M) as K4; words (Jp, B, Tp, 128),
    widths/offsets/maxes (Jp, B, Kp), blk_ids (Jp, B, C) ascending with pad
    ids ≥ Kp, exc_pos/exc_add (Jp, B, E) ascending and -1-padded (E may be
    0), uint32 arrays as int32 bit patterns; active (Jp, B) bool.  Returns
    the (B, M) bool mask after folding every active slot's partial decode.
    Jp = 0 returns ``valid`` without a launch.

    The kernel copies ``valid`` into the output and then only clears: warp
    (j, b, c) searches in its decoded block only the candidates x with
    hi(c−1) < x ≤ hi(c), hi(c) = ``maxes[j, b, blk_ids[j, b, c]]``, that
    ``valid`` still holds, and clears the non-members; the candidates above
    every candidate block of an active slot, and the whole row where an
    active slot has no real block, are cleared.  That equals the
    reference's gallop over the concatenated window of each slot's
    candidate blocks, ANDed over the active slots, because (i) every row of
    r is strictly increasing, then SENTINEL, (ii) the real candidate slots
    of each (j, b) form an ascending prefix and (iii) block id decodes to
    values in (maxes[id−1], maxes[id]]: the only caller,
    ``index.batch._svs_program`` through ``ops.intersect_packed_fold``,
    gives (i) with its seed rows (``_assemble_svs``), (ii) with
    ``_stack_packed``'s candidate ids and ``source.pad_block_ids``, and the
    encoders give (iii) (``csrc/packed_fold.cu``).  ``valid`` may have
    holes."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown delta mode {mode!r}")
    if words.shape[0] == 0:
        return valid
    ops_ = (r, valid, words, widths, offsets, maxes, blk_ids, exc_pos,
            exc_add, active)
    index = _build.kernel_device(*ops_)
    if index < 0:
        return packed_fold_plain(*ops_, mode=mode, block_rows=block_rows)
    B, M = _check_rows(r, valid)
    _build.require(words, "words", torch.int32, 4)
    for name, t in (("widths", widths), ("offsets", offsets),
                    ("maxes", maxes), ("blk_ids", blk_ids),
                    ("exc_pos", exc_pos), ("exc_add", exc_add)):
        _build.require(t, name, torch.int32, 3)
    _build.require(active, "active", torch.bool, 2)
    Jp, _, Tp, lanes = words.shape
    Kp, C, E = widths.shape[2], blk_ids.shape[2], exc_pos.shape[2]
    if lanes != LANES or Tp < 1 or Kp < 1 or C < 1:
        raise ValueError("need words (Jp, B, Tp ≥ 1, 128), Kp ≥ 1 and C ≥ 1")
    if not all(t.shape[:2] == (Jp, B) for t in ops_[2:]):
        raise ValueError(f"every packed operand needs leading dims "
                         f"(Jp={Jp}, B={B})")
    if offsets.shape[2] != Kp or maxes.shape[2] != Kp or exc_add.shape[2] != E:
        raise ValueError("widths/offsets/maxes and exc_pos/exc_add must agree")
    if not 1 <= block_rows <= 32:
        raise ValueError(f"block_rows must be in [1, 32], got {block_rows}")
    if Jp * B * C >= 2**31:
        raise ValueError(f"Jp·B·C={Jp * B * C} slots exceed the kernel's "
                         f"int32 slot index")
    if words.data_ptr() % 16:
        raise ValueError("words must start on a 16-byte boundary (the kernel "
                         "copies 16 bytes a lane)")
    out = r.new_empty((B, M), dtype=torch.bool)
    if B and M:
        _build.launch("packed_fold_batched", "repro_packed_fold", index,
                      r.data_ptr(), valid.data_ptr(), B, M, words.data_ptr(),
                      Tp, widths.data_ptr(), offsets.data_ptr(),
                      maxes.data_ptr(), Kp, blk_ids.data_ptr(), C,
                      exc_pos.data_ptr(), exc_add.data_ptr(), E, block_rows,
                      MODE_IDS[mode], Jp, active.data_ptr(), out.data_ptr())
    return out
