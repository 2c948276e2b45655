"""Composite codec: bitpack for full blocks, varint for the tail.

Port of ``src/repro/core/composite.py``.  Block codecs only compress
multiples of their block size, so a composite pairs one with a byte-oriented
tail codec for the remainder: the head is a ``bitpack.PackedList`` over the
longest full-block prefix (1024-int blocks, the bp8 geometry) and the tail a
``varint.VarintList`` over the < block-size remainder, coded absolute
(varint's D1-from-0 framing).

The head alone is skip-capable, but the composite payload deliberately is
not (no top-level ``flat_words``/``maxes``): a skip probe over the head would
drop tail postings.  Composite lists always serve through ``DecodedSource``.
``decode`` returns the values on the payload's device: the head through K1
where it lies, the tail decoded on the host, as in the reference, and
uploaded once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core import varint as varint_lib
from repro_torch.core.intersect import to_device

LANES = 128
DEFAULT_ROWS = 8           # 1024-int head blocks (the bp8 geometry)


@dataclasses.dataclass
class CompositeList:
    head: bitpack.PackedList | None   # full blocks only; None when n < block
    tail: varint_lib.VarintList       # remainder (may be zero-length), host
    n: int
    mode: str = "d1"
    block_rows: int = DEFAULT_ROWS
    device: torch.device = torch.device("cpu")   # where ``decode`` returns

    @property
    def n_head(self) -> int:
        return 0 if self.head is None else self.head.n

    @property
    def padded_n(self) -> int:
        return self.n_head + self.tail.n

    def to(self, device) -> "CompositeList":
        return dataclasses.replace(
            self, head=None if self.head is None else self.head.to(device),
            device=torch.device(device))


def encode(values: np.ndarray, mode: str = "d1",
           block_rows: int = DEFAULT_ROWS) -> CompositeList:
    v = np.asarray(values, dtype=np.int64).ravel()
    n = int(v.size)
    per = block_rows * LANES
    n_head = (n // per) * per
    head = (bitpack.encode(v[:n_head], mode=mode, block_rows=block_rows)
            if n_head else None)
    tail = varint_lib.encode(v[n_head:])
    return CompositeList(head=head, tail=tail, n=n, mode=mode,
                         block_rows=block_rows)


def decode(cl: CompositeList) -> torch.Tensor:
    """Exact-length decode on ``cl.device`` → (n,) int32 bit patterns of the
    uint32 values: the head's bucketed decode (K1 on the card), then the
    tail's host decode, uploaded once."""
    parts = []
    if cl.head is not None:
        parts.append(bitpack.decode_bucketed(cl.head)[: cl.head.n])
    if cl.tail.n:
        parts.append(to_device(varint_lib.decode(cl.tail).astype(np.int32),
                               cl.device))
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=cl.device)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def decode_np(cl: CompositeList) -> np.ndarray:
    """Exact-length host decode (int64)."""
    return decode(cl).cpu().numpy().view(np.uint32).astype(np.int64)


def bits_per_int(cl: CompositeList) -> float:
    bits = 0.0
    if cl.head is not None:
        bits += bitpack.bits_per_int(cl.head) * cl.head.n
    bits += varint_lib.bits_per_int(cl.tail) * cl.tail.n
    return bits / max(cl.n, 1)
