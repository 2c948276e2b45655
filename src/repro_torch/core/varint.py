"""Variable-byte coding (paper §3, VARINT baseline).

Port of ``src/repro/core/varint.py``: a numpy copy, since the reference keeps
this scalar codec on the host too.  Encoded form: little-endian 7-bit
groups, high bit = continuation, applied to D1 deltas of the sorted list
(first value coded against 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VarintList:
    data: np.ndarray   # (nbytes,) uint8
    n: int


def encode(values: np.ndarray) -> VarintList:
    v = np.asarray(values, dtype=np.int64).ravel()
    n = int(v.size)
    if n == 0:
        return VarintList(np.zeros(0, np.uint8), 0)
    d = np.empty(n, dtype=np.uint64)
    d[0] = v[0]
    d[1:] = (v[1:] - v[:-1]).astype(np.uint64)
    # vectorized byte-length per delta, then scatter 7-bit groups
    bl = np.frompyfunc(lambda x: max((int(x).bit_length() + 6) // 7, 1), 1, 1)(d)
    bl = bl.astype(np.int64)
    ends = np.cumsum(bl)
    starts = ends - bl
    out = np.zeros(int(ends[-1]), dtype=np.uint8)
    rem = d.copy()
    for byte_i in range(int(bl.max())):
        live = bl > byte_i
        pos = starts[live] + byte_i
        chunk = (rem[live] & np.uint64(0x7F)).astype(np.uint8)
        cont = (bl[live] - 1 > byte_i).astype(np.uint8) << 7
        out[pos] = chunk | cont
        rem[live] >>= np.uint64(7)
    return VarintList(out, n)


def decode(vl: VarintList) -> np.ndarray:
    out = np.empty(vl.n, dtype=np.int64)
    data = vl.data
    p = 0
    acc = 0
    for i in range(vl.n):
        val = 0
        shift = 0
        while True:
            byte = int(data[p]); p += 1
            val |= (byte & 0x7F) << shift
            if not byte & 0x80:
                break
            shift += 7
        acc += val
        out[i] = acc
    return out


def bits_per_int(vl: VarintList) -> float:
    return vl.data.size * 8 / max(vl.n, 1)
