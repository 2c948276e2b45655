"""K6: block bit packing (the encode side of paper §3), and its plain version.

Port of ``src/repro/kernels/bitpack_pack.py``: ``pack_blocks_padded``
replaces the Pallas kernel ``pack_blocks_padded`` (``pack_kernel``) with the
CUDA kernel in ``csrc/bitpack_pack.cu``; ``pack_blocks_padded_plain`` is the
same function in torch.  One (32, 128) delta tile packs into a (32, 128)
word tile whose first ``b`` rows are the packed words and the rest zero:
the block-padded mirror of K1.  The deltas are computed outside the kernel
(``ops.pack_blocks``), as in the reference.  The wrapper takes the lean
launch path (``_build.kernel_device`` / ``_build.launch``).
"""

from __future__ import annotations

import torch

from repro_torch.core.deltas import U32_MASK, to_i32, to_u32
from repro_torch.kernels import _build

ROWS = 32
LANES = 128


def pack_blocks_padded_plain(deltas, widths) -> torch.Tensor:
    """Plain version of K6, ``pack_kernel``'s arithmetic row by row: row r
    ORs ``val << sh`` into word ``(r·b) >> 5`` and, on a spill, ``val >>
    (32 − sh)`` into word ``min(w + 1, 31)``; uint32 arithmetic, word indices
    clamped to 31.  deltas (K, 32, 128) uint32 (int32 bit patterns or int64),
    widths (K,) → (K, 32, 128) int32 bit patterns."""
    K = deltas.shape[0]
    d = to_u32(deltas)
    b = to_u32(widths)
    out = torch.zeros_like(d)
    ks = torch.arange(K, device=d.device)
    for r in range(ROWS):
        start = (r * b) & U32_MASK
        w = start >> 5
        sh = (start & 31)[:, None]
        val = d[:, r]
        lo = w.clamp(max=ROWS - 1)
        out[ks, lo] = out[ks, lo] | ((val << sh) & U32_MASK)
        spill = ((sh + b[:, None]) & U32_MASK) > 32
        hi = (w + 1).clamp(max=ROWS - 1)
        out[ks, hi] = out[ks, hi] | torch.where(
            spill, val >> ((32 - sh) & 31), 0)
    return to_i32(out)


def pack_blocks_padded(deltas, widths) -> torch.Tensor:
    """K6's wrapper: deltas (K, 32, 128) int32 bit patterns of uint32 deltas
    (< 2**width per block), widths (K,) int32 in [0, 32].  Returns
    (K, 32, 128) int32 bit patterns of the block-padded packed words.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    index = _build.kernel_device(deltas, widths)
    if index < 0:
        return pack_blocks_padded_plain(deltas, widths)
    _build.require(deltas, "deltas", torch.int32, 3)
    _build.require(widths, "widths", torch.int32, 1)
    K = deltas.shape[0]
    if tuple(deltas.shape[1:]) != (ROWS, LANES):
        raise ValueError(f"deltas must be (K, {ROWS}, {LANES}), got "
                         f"{tuple(deltas.shape)}")
    if widths.shape[0] != K:
        raise ValueError("widths must have one entry per block")
    out = torch.empty_like(deltas)
    if K:
        _build.launch("pack_blocks_padded", "repro_pack_blocks", index,
                      deltas.data_ptr(), widths.data_ptr(), K, out.data_ptr())
    return out
