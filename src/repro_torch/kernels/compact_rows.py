"""compact_rows: each row's surviving values moved to the front of a narrow
row on the card, with their count; and its plain version.

Replaces no TPU kernel: the reference's batched program returns each seed
row whole (SENTINEL where a value did not survive, the count beside it) and
leaves the extraction to the host (``src/repro/index/batch.py``,
``_svs_program`` and ``collect_batch``).  On the card that made every
result copy, and the host's scan of it, as wide as the seed's bucket (up to
2**20 slots) for a few hundred answers.  ``index.batch._svs_program`` ends
in this kernel instead, so the copy and the host's read are the answer's
size, capped at the caller's ``max_results``.

CUDA kernels ``count_tiles`` and ``compact_tiles`` in
``csrc/compact_rows.cu``, one C entry: a row tiled across blocks of 4,096
slots, each tile's survivors counted, then each tile's offset summed from
its row's earlier counts and its survivors written by warp-ballot ranks
(the design and its bound are in the source).  The wrapper takes the lean
launch path (``_build.kernel_device`` / ``_build.launch``), counts one
launch of ``compact_rows`` a call, and allocates the output and the tile
counts with ``torch.empty``; nothing waits for the card.  The plain
version (``compact_rows_plain``) runs for CPU tensors only.
"""

from __future__ import annotations

import torch

from repro_torch.core import intersect as its
from repro_torch.kernels import _build

SENT = int(its.SENTINEL)
TILE = 4096          # slots a block (``kTile`` in csrc/compact_rows.cu)


def compact_rows_plain(r, valid, max_results: int) -> torch.Tensor:
    """Plain compact_rows: see ``compact_rows``."""
    B, M = r.shape
    C = min(M, max_results)
    out = torch.full((B, C + 1), SENT, dtype=torch.int32, device=r.device)
    pos = valid.cumsum(1) - 1
    keep = valid & (pos < C)
    rows = torch.arange(B, device=r.device)[:, None].expand(B, M)
    out[rows[keep], pos[keep]] = r[keep]
    out[:, C] = valid.sum(1, dtype=torch.int32)
    return out


def compact_rows(r, valid, max_results: int) -> torch.Tensor:
    """r (B, M) int32, valid (B, M) bool → (B, C + 1) int32 with C =
    min(M, max_results): each row's first min(count, C) values of r where
    ``valid`` is set, in order, SENTINEL in the columns after them, and the
    row's full count of them in column C."""
    index = _build.kernel_device(r, valid)
    if index < 0:
        return compact_rows_plain(r, valid, max_results)
    _build.require(r, "r", torch.int32, 2)
    _build.require(valid, "valid", torch.bool, 2)
    if valid.shape != r.shape:
        raise ValueError(f"valid {tuple(valid.shape)} must match r "
                         f"{tuple(r.shape)}")
    if max_results < 0:
        raise ValueError(f"max_results must be ≥ 0, got {max_results}")
    B, M = r.shape
    C = min(M, max_results)
    blocks = B * -(-M // TILE)
    if blocks >= 2**31:
        raise ValueError(f"B={B}, M={M} need {blocks} blocks, over the "
                         f"kernel's int32 grid")
    if not M:
        return r.new_zeros((B, 1))
    out = r.new_empty((B, C + 1))
    if B:
        counts = torch.empty(blocks, dtype=torch.int32, device=r.device)
        _build.launch("compact_rows", "repro_compact_rows", index,
                      r.data_ptr(), valid.data_ptr(), B, M, C,
                      out.data_ptr(), counts.data_ptr())
    return out
