"""Stream VByte coding (Lemire, Kurz & Rupp, arXiv 1709.08990).

Port of ``src/repro/core/streamvbyte.py``.  A control stream holds one 2-bit
code per integer (byte length − 1) and a data stream the raw little-endian
value bytes, so every byte length of a block is known before its bytes are
read.  Values are grouped into blocks of ``block_rows``×128, delta-coded per
block with the mode family of ``core.deltas``, each block seeded with the
previous block's last value.  The control stream is stored as uint32 words
(16 codes per word: code *i* of a block sits at bit ``2·(i mod 16)`` of word
``i // 16``), the data stream as the uint32 word view of the byte stream.

The host encoder is numpy and emits the reference's arrays bit for bit;
tensors hold uint32 words and maxima as int32 bit patterns
(``deltas.to_i32``).  ``decode`` runs the K7 kernel (``kernels.svb_decode``)
where the payload lies.  SVBList is not skip-capable (no packed word/width
layout), so these lists always serve through ``DecodedSource``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import deltas as deltas_lib
from repro_torch.core.bitpack import _u32_tensor

LANES = 128
DEFAULT_ROWS = 1           # 128-int blocks: tail padding stays negligible


@dataclasses.dataclass
class SVBList:
    """One Stream-VByte-compressed sorted list (tensors on one device)."""
    ctrl: torch.Tensor     # (K, CW) int32 bit patterns — 16 2-bit codes/word
    data: torch.Tensor     # (DW,) int32 bit patterns — LE byte stream
    doffs: torch.Tensor    # (K,) int32 — data byte offset per block
    maxes: torch.Tensor    # (K,) int32 bit patterns — last value per block
    nbytes: int            # true data-stream byte count (accounting)
    n: int
    mode: str = "d1"
    block_rows: int = DEFAULT_ROWS
    # the pow2-padded K7 operands, made once on the payload's device by
    # ``kernels.svb_decode.bucketed_operands``; ``to`` drops them
    bucketed: tuple | None = dataclasses.field(default=None, init=False,
                                               repr=False, compare=False)

    @property
    def num_blocks(self) -> int:
        return int(self.ctrl.shape[0])

    @property
    def padded_n(self) -> int:
        return self.num_blocks * self.block_rows * LANES

    def to(self, device) -> "SVBList":
        return dataclasses.replace(
            self, ctrl=self.ctrl.to(device), data=self.data.to(device),
            doffs=self.doffs.to(device), maxes=self.maxes.to(device))


def _byte_lens(d: np.ndarray) -> np.ndarray:
    """Byte length (1–4) of each uint32 delta."""
    d = d.astype(np.uint32)
    return (1 + (d >= (1 << 8)).astype(np.int64)
            + (d >= (1 << 16)).astype(np.int64)
            + (d >= (1 << 24)).astype(np.int64))


def encode(values: np.ndarray, mode: str = "d1",
           block_rows: int = DEFAULT_ROWS) -> SVBList:
    """Compress a sorted 1-D array of non-negative ints (< 2**32) on the host
    into CPU tensors (``SVBList.to`` moves them)."""
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
    maxes = blocks[:, -1, -1].astype(np.uint32)
    seeds = np.concatenate([[0], maxes[:-1].astype(np.int64)])
    d = deltas_lib.encode_deltas_np(blocks, seeds, mode).reshape(-1)

    lens = _byte_lens(d)                               # (K*per,)
    # control stream: 2-bit codes, 4 per byte, LE bytes → uint32 words
    codes = (lens - 1).astype(np.uint8).reshape(-1, 4)
    ctrl_bytes = (codes[:, 0] | (codes[:, 1] << 2)
                  | (codes[:, 2] << 4) | (codes[:, 3] << 6))
    ctrl = ctrl_bytes.view(np.uint32).reshape(K, per // 16)
    # data stream: raw LE value bytes
    ends = np.cumsum(lens)
    starts = ends - lens
    nbytes = int(ends[-1])
    out = np.zeros(nbytes + (-nbytes) % 4, dtype=np.uint8)
    du = d.astype(np.uint32)
    for byte_i in range(4):
        live = lens > byte_i
        out[starts[live] + byte_i] = (
            (du[live] >> np.uint32(8 * byte_i)) & np.uint32(0xFF))
    data = out.view(np.uint32)
    if data.size == 0:                                 # keep gathers in-bounds
        data = np.zeros(1, np.uint32)
    doffs = starts.reshape(K, per)[:, 0].astype(np.int32)
    return SVBList(ctrl=_u32_tensor(ctrl), data=_u32_tensor(data),
                   doffs=torch.from_numpy(doffs), maxes=_u32_tensor(maxes),
                   nbytes=nbytes, n=n, mode=mode, block_rows=block_rows)


def seeds_of(sl: SVBList) -> torch.Tensor:
    """Per-block seeds: 0, then the previous block's max (int32 bit patterns)."""
    return torch.cat([torch.zeros(1, dtype=torch.int32,
                                  device=sl.maxes.device), sl.maxes[:-1]])


def decode_np(sl: SVBList) -> np.ndarray:
    """Host decode in numpy (the reference's), trimmed to the valid length."""
    K, per = sl.num_blocks, sl.block_rows * LANES
    i = np.arange(K * per)
    ctrl = sl.ctrl.cpu().numpy().view(np.uint32).reshape(-1)
    codes = (ctrl[i >> 4] >> (2 * (i & 15))) & 3
    lens = codes.astype(np.int64) + 1
    offs = np.cumsum(lens) - lens
    data_bytes = sl.data.cpu().numpy().view(np.uint8)
    d = np.zeros(K * per, dtype=np.uint32)
    for byte_i in range(4):
        live = lens > byte_i
        idx = np.minimum(offs[live] + byte_i, data_bytes.size - 1)
        d[live] |= data_bytes[idx].astype(np.uint32) << np.uint32(8 * byte_i)
    vals = deltas_lib.prefix_sum(
        torch.from_numpy(d.astype(np.int64)).reshape(K, sl.block_rows, LANES),
        seeds_of(sl).cpu(), sl.mode)
    return vals.reshape(-1)[: sl.n].numpy()


def decode(sl: SVBList) -> torch.Tensor:
    """Decode where the payload lies (K7 on the card, its plain version on
    the CPU), with K and DW padded to powers of two as the reference pads
    them → padded flat values (pow2(K)·block_rows·128,), uint32 values as
    int32 bit patterns; callers trim to ``sl.n``."""
    from repro_torch.kernels import svb_decode
    return svb_decode.decode_bucketed(sl)


def bits_per_int(sl: SVBList) -> float:
    """Storage cost: data bytes + control bytes + per-block metadata
    (4B data offset + 4B block max)."""
    ctrl_bytes = sl.num_blocks * sl.block_rows * LANES // 4
    meta_bytes = sl.num_blocks * 8
    return (sl.nbytes + ctrl_bytes + meta_bytes) * 8 / max(sl.n, 1)
