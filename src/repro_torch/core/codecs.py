"""Codec registry, by name and by payload type (paper §3's scheme zoo).

Port of ``src/repro/core/codecs.py`` for the ``bp-<mode>``, ``bp8-<mode>``,
``fastpfor-<mode>`` and ``varint`` names.  StreamVByte and composite raise
"not yet ported".  ``bp-<mode>-ni`` decodes like ``bp-<mode>``: the two-pass
variant exists for the reference's Fig. 1a benchmark, which is not ported.
"""

from __future__ import annotations

from repro_torch.core import bitpack, fastpfor, varint
from repro_torch.core.deltas import MODES


class _BPCodec:
    def __init__(self, mode: str, block_rows: int | None = None):
        self.mode, self.block_rows = mode, block_rows

    def encode(self, values):
        return bitpack.encode(values, mode=self.mode, block_rows=self.block_rows)

    def decode(self, pl):
        return bitpack.decode(pl)

    def decode_np(self, pl):
        return bitpack.decode_np(pl)

    def bits_per_int(self, pl):
        return bitpack.bits_per_int(pl)


class _PForCodec:
    def __init__(self, mode: str, block_rows: int = 32):
        self.mode, self.block_rows = mode, block_rows

    def encode(self, values):
        return fastpfor.encode(values, mode=self.mode, block_rows=self.block_rows)

    def decode(self, pl):
        return fastpfor.decode(pl)

    def decode_np(self, pl):
        return fastpfor.decode_np(pl)

    def bits_per_int(self, pl):
        return fastpfor.bits_per_int(pl)


class _VarintCodec:
    mode = "d1"

    def encode(self, values):
        return varint.encode(values)

    def decode(self, vl):
        return varint.decode(vl)

    def decode_np(self, vl):
        return varint.decode(vl)

    def bits_per_int(self, vl):
        return varint.bits_per_int(vl)


def get_codec(name: str):
    name = name.lower()
    if name == "varint":
        return _VarintCodec()
    parts = name.split("-")
    fam = parts[0]
    mode = parts[1] if len(parts) > 1 else "d1"
    if fam in ("streamvbyte", "svb", "composite") or name == "auto":
        raise NotImplementedError(f"codec {name!r} is not yet ported")
    if mode not in MODES:
        raise ValueError(f"unknown delta mode {mode!r} in codec {name!r}")
    if fam == "bp":
        return _BPCodec(mode)
    if fam == "bp8":    # 1024-integer blocks (finer width granularity)
        return _BPCodec(mode, block_rows=8)
    if fam == "fastpfor":
        return _PForCodec(mode)
    raise ValueError(f"unknown codec {name!r}")


def codec_for(payload):
    """Resolve the decode/accounting codec from a payload object."""
    if isinstance(payload, fastpfor.PatchedList):
        return _PForCodec(payload.mode, payload.block_rows)
    if isinstance(payload, bitpack.PackedList):
        return _BPCodec(payload.mode, block_rows=payload.block_rows)
    if isinstance(payload, varint.VarintList):
        return _VarintCodec()
    return None


def family_of(payload) -> str:
    """Codec family name of a payload (per-codec list-count reporting)."""
    if isinstance(payload, fastpfor.PatchedList):
        return "fastpfor"
    if isinstance(payload, bitpack.PackedList):
        return "bp8" if payload.block_rows == 8 else "bp"
    if isinstance(payload, varint.VarintList):
        return "varint"
    return "unknown"


ALL_CODECS = (
    ["varint"]
    + [f"bp-{m}" for m in ("d1", "d2", "d4", "dm", "dv")]
    + [f"bp8-{m}" for m in ("d1", "d2", "d4", "dm", "dv")]
    + [f"fastpfor-{m}" for m in ("d1", "d2", "d4", "dm", "dv")]
)
