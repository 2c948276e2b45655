"""Posting-source layer: one decode/skip policy for the engine.

Port of the non-residency half of ``src/repro/index/source.py``.  A query
term resolves to one of two sources:

  DecodedSource — the padded int32 value tensor: short lists, cache-resident
                  lists and codecs without a skip index.
  PackedSource  — the compressed list stays packed; intersection searches
                  the block-max skip index and decodes only candidate blocks
                  (paper §6.5).  Long skip-capable lists land here.

``resolve`` chooses from the candidate/list cardinality ratio, the codec
family (``bitpack.skip_capable``) and cache residency, and keeps the
decoded-ints accounting in ``stats``.  Decodes stay on the index's device:
where the reference decodes to numpy and uploads, the port decodes on the
card and pads there.  The device-resident pool (``ResidentPool``) is not
yet ported.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core import codecs as codec_lib
from repro_torch.core import intersect as its
from repro_torch.core import varint as varint_lib

# Ratio above which a skip-capable list is probed packed instead of decoded
# (the same constant the decoded-path dispatcher uses).
SKIP_MIN_RATIO = its.TILED_MAX_RATIO
# Below this many blocks the skip index cannot prune anything worth it.
SKIP_MIN_BLOCKS = 4

# Bucket floor for the candidate-block-id buffer.
CAND_FLOOR = 8


@dataclasses.dataclass
class DecodedSource:
    """Fully decoded posting list: padded int32 values + valid count."""
    vals: torch.Tensor
    n: int
    key: tuple = ()


@dataclasses.dataclass
class PackedSource:
    """Compressed posting list kept packed for skip-aware partial decode."""
    payload: object            # PackedList | PatchedList
    n: int
    key: tuple = ()            # (part.uid, tid) — layout memoization key

    @property
    def mode(self) -> str:
        return self.payload.mode

    @property
    def block_rows(self) -> int:
        return self.payload.block_rows

    @property
    def num_blocks(self) -> int:
        return int(self.payload.widths.shape[0])

    @property
    def maxes_np(self) -> np.ndarray:
        """Host copy of the block-max skip index (uint32), read from the
        memoized host layout so the query path copies nothing off the card."""
        entry = _layout_entry(self, self.self_pads())
        return entry["np"].maxes[: self.num_blocks]

    def candidate_block_ids(self, values: np.ndarray) -> np.ndarray:
        """Unique block ids possibly containing any candidate value."""
        return bitpack.candidate_block_ids(self.maxes_np, values)

    def layout(self, k_pad: int, t_pad: int, e_pad: int) -> bitpack.PackedLayout:
        return bitpack.layout_np(self.payload, k_pad, t_pad, e_pad)

    def self_pads(self) -> tuple[int, int, int]:
        return bitpack.self_pads(self.payload)


def pad_block_ids(blk: np.ndarray, c_pad: int, k_pad: int) -> np.ndarray:
    """Pad a candidate block-id list to its bucket; pad entries use the
    out-of-range id ``k_pad``, which decodes to all-SENTINEL."""
    out = np.full(c_pad, k_pad, np.int32)
    out[: blk.shape[0]] = blk
    return out


# Memoized padded layouts, keyed by ((part.uid, tid), pads) and LRU-bounded
# by total layout ints: each entry holds the host layout and its copy on the
# payload's device, so the query path uploads only candidate block ids.
_LAYOUT_CACHE: OrderedDict = OrderedDict()
_LAYOUT_CACHE_BUDGET = 1 << 26      # total ints across cached layouts
_layout_cache_size = 0


def _layout_ints(pads: tuple) -> int:
    k_pad, t_pad, e_pad = pads
    return t_pad * bitpack.LANES + 3 * k_pad + 2 * e_pad


def _layout_entry(src: PackedSource, pads: tuple, stats: dict | None = None):
    global _layout_cache_size
    key = (src.key, pads)
    entry = _LAYOUT_CACHE.get(key)
    if entry is None:
        _bump(stats, "layout_misses")
        entry = {"np": src.layout(*pads), "dev": None}
        _LAYOUT_CACHE[key] = entry
        _layout_cache_size += _layout_ints(pads)
        while (_layout_cache_size > _LAYOUT_CACHE_BUDGET
               and len(_LAYOUT_CACHE) > 1):
            (_, old_pads), _ = _LAYOUT_CACHE.popitem(last=False)
            _layout_cache_size -= _layout_ints(old_pads)
    else:
        _bump(stats, "layout_hits")
        _LAYOUT_CACHE.move_to_end(key)
    return entry


def cached_layout_np(src: PackedSource, pads: tuple,
                     stats: dict | None = None) -> bitpack.PackedLayout:
    """Memoized host-side padded layout."""
    return _layout_entry(src, pads, stats)["np"]


def cached_layout_dev(src: PackedSource, pads: tuple,
                      stats: dict | None = None) -> tuple:
    """Memoized layout operands on the payload's device: (words, widths,
    offsets, maxes, exc_pos, exc_add), uint32 arrays as int32 bit patterns."""
    entry = _layout_entry(src, pads, stats)
    if entry["dev"] is None:
        lay = entry["np"]
        device = src.payload.widths.device
        entry["dev"] = tuple(
            torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(device)
            for x in (lay.words, lay.widths, lay.offsets, lay.maxes,
                      lay.exc_pos, lay.exc_add))
    return entry["dev"]


def precompute_layouts(parts, stats: dict | None = None) -> int:
    """Build-time projection of every skip-capable list payload onto its
    self-padded PackedLayout.  Returns the number of layouts staged."""
    n = 0
    for part in parts:
        for tid, tp in part.terms.items():
            if (tp.kind == "list" and bitpack.skip_capable(tp.payload)
                    and getattr(tp, "skip_ok", True)
                    and int(tp.payload.widths.shape[0]) >= SKIP_MIN_BLOCKS):
                src = PackedSource(tp.payload, tp.n, key=(part.uid, tid))
                cached_layout_np(src, src.self_pads(), stats)
                n += 1
    return n


def decoded_ints_of(payload) -> int:
    """Integers materialized by a full decode of this payload."""
    if isinstance(payload, varint_lib.VarintList):
        return payload.n
    if bitpack.skip_capable(payload):
        return int(payload.widths.shape[0]) * payload.block_rows * bitpack.LANES
    return int(getattr(payload, "padded_n", payload.n))


def decode_padded(codec, tp, device) -> tuple[torch.Tensor, int]:
    """Decode one term posting to (pow2-padded int32 vals on ``device``,
    count).  Packed payloads decode where they lie; Varint decodes on the
    host, as in the reference, and is uploaded."""
    if isinstance(tp.payload, bitpack.PackedList):
        vals = bitpack.decode_bucketed(tp.payload)[: tp.n]
    elif isinstance(tp.payload, varint_lib.VarintList):
        vals = torch.from_numpy(
            varint_lib.decode(tp.payload).astype(np.int32)).to(device)
    else:
        c = codec_lib.codec_for(tp.payload) or codec
        vals = c.decode(tp.payload)[: tp.n]
    return its.pad_to_tensor(vals, its.pow2_bucket(tp.n)), tp.n


def decode_padded_np(codec, tp) -> tuple[np.ndarray, int]:
    """Host copy of ``decode_padded``."""
    vals, n = decode_padded(codec, tp, "cpu")
    return vals.cpu().numpy(), n


def _bump(stats, key, by=1):
    if stats is not None:
        stats[key] = stats.get(key, 0) + by


def resolve(part, tid: int, tp, codec, cache=None, r_count: int | None = None,
            skip: bool = True, stats: dict | None = None):
    """Resolve one term posting to a DecodedSource or a PackedSource.

    r_count: current candidate cardinality — None means this term *is* the
    candidate seed and must decode.  skip=False forces the decoded path
    everywhere.  A list already in the DecodeCache is served decoded even
    where the ratio would skip-probe it."""
    key = (part.uid, tid)
    want_skip = (skip and r_count is not None
                 and bitpack.skip_capable(tp.payload)
                 and getattr(tp, "skip_ok", True)
                 and tp.n / max(r_count, 1) > SKIP_MIN_RATIO
                 and int(tp.payload.widths.shape[0]) >= SKIP_MIN_BLOCKS)
    if want_skip:
        if cache is not None and key in cache:
            vals, n = cache.get(key)
            return DecodedSource(vals, n, key=key)
        return PackedSource(tp.payload, tp.n, key=key)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            return DecodedSource(hit[0], hit[1], key=key)
    vals, n = decode_padded(codec, tp, part.device)
    _bump(stats, "decoded_ints", decoded_ints_of(tp.payload))
    _bump(stats, "decoded_lists")
    if cache is not None:
        cache.put(key, vals, n)
    return DecodedSource(vals, n, key=key)
