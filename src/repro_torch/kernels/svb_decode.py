"""K7: Stream VByte decode (arXiv 1709.08990), and its plain version.

Port of ``src/repro/kernels/svb_decode.py``: ``decode_svb`` is the plain
version (the reference's jnp ``decode_svb``); ``unpack_svb_blocks`` replaces
the Pallas kernel ``unpack_svb_blocks`` (``make_svb_kernel``) with the CUDA
kernel in ``csrc/svb_decode.cu``.  Both compute, per block: control words →
2-bit codes → byte lengths → prefix-summed byte offsets from the block's
data offset → the two uint32 data words around each value's offset
(indices clamped to [0, DW−1]), shifted and masked to its 1–4 bytes → the
mode's delta prefix sum from the block's seed.  Pad blocks (code 0, offset 0)
decode to clamped garbage that callers trim.

The reference keeps the whole data stream resident in VMEM; the Hopper
kernel decodes a block a warp (``WARPS`` blocks a CTA), stages each row
group's data span in shared memory and reads the rare value outside it from
device memory, so there is no cap on DW.  The wrapper takes the lean launch
path (``_build.kernel_device`` / ``_build.launch``).  ``decode_bucketed``
pads K and DW to powers of two as the reference does, once per list on the
payload's device (``bucketed_operands``), so a decode on the card is one
launch and nothing crosses to the host.
"""

from __future__ import annotations

import torch

from repro_torch.core import deltas as core_deltas
from repro_torch.core.deltas import MODE_IDS, U32_MASK, to_i32, to_u32
from repro_torch.kernels import _build

LANES = 128
WARPS = 4            # blocks a CTA: csrc/svb_decode.cu's kSvbWarps


def _reconstruct(codes, offs, data):
    """codes: (..., per) int64 2-bit byte-length codes; offs: (..., per)
    absolute byte offsets (int32 values held in int64); data: (DW,) int64
    uint32 words.  Returns (..., per) int64 uint32 values."""
    DW = data.shape[0]
    lens = codes + 1
    word = offs >> 2
    sh = (offs & 3) << 3
    lo = data[word.clamp(0, DW - 1)]
    hi = data[(word + 1).clamp(0, DW - 1)]
    val = (lo >> sh) | torch.where(sh > 0, (hi << ((32 - sh) & 31)) & U32_MASK,
                                   0)
    nbits = lens << 3
    mask = torch.where(lens >= 4, U32_MASK,
                       (torch.ones_like(nbits) << nbits.clamp(max=31)) - 1)
    return val & mask


def decode_svb(ctrl, data, doffs, seeds, mode: str,
               block_rows: int) -> torch.Tensor:
    """Plain version of K7: ctrl (K, CW) uint32 words, data (DW,) uint32
    words (int32 bit patterns or int64), doffs/seeds (K,).  Returns
    (K, block_rows, 128) int32 bit patterns of the uint32 values.  Byte
    offsets are int32 sums, as in the reference."""
    K = ctrl.shape[0]
    per = block_rows * LANES
    i = torch.arange(K * per, dtype=torch.int64, device=ctrl.device)
    codes = ((to_u32(ctrl).reshape(-1)[i >> 4] >> ((i & 15) << 1)) & 3
             ).reshape(K, per)
    lens = codes + 1
    offs = doffs.to(torch.int64)[:, None] + torch.cumsum(lens, dim=1) - lens
    offs = to_i32(offs).to(torch.int64)
    d = _reconstruct(codes, offs, to_u32(data)).reshape(K, block_rows, LANES)
    return to_i32(core_deltas.prefix_sum(d, seeds, mode))


def unpack_svb_blocks(ctrl, data, doffs, seeds, mode: str = "d1",
                      block_rows: int = 1) -> torch.Tensor:
    """K7's wrapper, the reference's operands: ctrl (K, 8·block_rows) int32
    bit patterns, data (DW ≥ 1,) int32 bit patterns on a 16-byte boundary,
    doffs (K,) int32, seeds (K,) int32 bit patterns.  Returns
    (K, block_rows, 128) int32 bit patterns.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    if mode not in MODE_IDS:
        raise ValueError(f"unknown delta mode {mode!r}")
    index = _build.kernel_device(ctrl, data, doffs, seeds)
    if index < 0:
        return decode_svb(ctrl, data, doffs, seeds, mode, block_rows)
    _build.require(ctrl, "ctrl", torch.int32, 2)
    _build.require(data, "data", torch.int32, 1)
    for name, t in (("doffs", doffs), ("seeds", seeds)):
        _build.require(t, name, torch.int32, 1)
    K, CW = ctrl.shape
    DW = data.shape[0]
    if block_rows < 1 or CW != block_rows * LANES // 16:
        raise ValueError(f"ctrl must be (K, {block_rows * LANES // 16}) for "
                         f"block_rows={block_rows}, got {tuple(ctrl.shape)}")
    if DW < 1:
        raise ValueError("data must hold at least one word")
    if doffs.shape[0] != K or seeds.shape[0] != K:
        raise ValueError("ctrl, doffs and seeds must have one entry per block")
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary (the kernel "
                         "copies 16 bytes a lane)")
    out = ctrl.new_empty((K, block_rows, LANES))
    if K:
        _build.launch("unpack_svb_blocks", "repro_svb_decode", index,
                      ctrl.data_ptr(), CW, data.data_ptr(), DW,
                      doffs.data_ptr(), seeds.data_ptr(), K, block_rows,
                      MODE_IDS[mode], out.data_ptr())
    return out


def _pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def bucketed_operands(sl) -> tuple:
    """An SVBList's K7 operands with (K, DW) padded to powers of two, as the
    reference's ``decode_bucketed`` pads them: pad blocks carry code 0,
    offset 0 and the last block's max as seed; pad data words are zero.
    Made on the payload's device at the first call and kept on the list."""
    if sl.bucketed is None:
        K, CW = sl.ctrl.shape
        DW = sl.data.shape[0]
        Kp, DWp = _pow2(K), _pow2(DW)
        dev = sl.ctrl.device
        ctrl = torch.zeros((Kp, CW), dtype=torch.int32, device=dev)
        ctrl[:K] = sl.ctrl
        data = torch.zeros(DWp, dtype=torch.int32, device=dev)
        data[:DW] = sl.data
        doffs = torch.zeros(Kp, dtype=torch.int32, device=dev)
        doffs[:K] = sl.doffs
        seeds = torch.zeros(Kp, dtype=torch.int32, device=dev)
        seeds[1:K] = sl.maxes[:-1]
        seeds[K:] = sl.maxes[-1]
        sl.bucketed = (ctrl, data, doffs, seeds)
    return sl.bucketed


def decode_bucketed(sl) -> torch.Tensor:
    """Decode an SVBList with (K, DW) padded to powers of two → flat
    (Kp·block_rows·128,) int32 bit patterns, the reference's values in every
    position; callers trim to ``sl.n``."""
    vals = unpack_svb_blocks(*bucketed_operands(sl), sl.mode, sl.block_rows)
    return vals.reshape(-1)
