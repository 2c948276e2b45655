"""Conjunctive query engine: SvS over compressed lists + bitmap probes
(paper §5–§6.7), the sequential path.

Port of ``src/repro/index/engine.py``.  Per query, per index part:
  1. order terms by posting length (SvS),
  2. decode the shortest compressed list as the candidate seed,
  3. fold in the remaining lists: skip-probe long packed lists (decode only
     candidate blocks), gallop over decoded lists whose ratio exceeds
     ``TILED_MAX_RATIO``, tile-merge the others,
  4. probe the candidates against each bitmap term,
  5. (all-bitmap queries) AND the bitmaps directly.

The engine follows the reference's kernel branches (its
``REPRO_USE_KERNELS=1`` structure) on every device and calls the
``kernels.ops`` wrappers there.  There is no switch: the index's device
picks the hand kernels (CUDA) or their plain versions (CPU).
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import codecs as codec_lib
from repro_torch.core import intersect as its
from repro_torch.index import source
from repro_torch.index.builder import HybridIndex, IndexPart
from repro_torch.kernels import ops


class DecodeCache:
    """LRU cache of decoded (padded) posting lists — the paper's Table 4
    regime: SvS over lists decoded once, not per query.  ``hits``/``misses``
    give the hit rate serve reports."""

    def __init__(self, capacity_ints: int = 1 << 24):
        self.capacity = capacity_ints
        self._store: OrderedDict = OrderedDict()
        self._size = 0
        self.hits = 0
        self.misses = 0

    def __contains__(self, key) -> bool:
        return key in self._store        # residency peek: no counter, no LRU

    def get(self, key):
        hit = self._store.get(key)
        if hit is None:
            self.misses += 1
            return None
        self.hits += 1
        self._store.move_to_end(key)
        return hit

    def put(self, key, vals, n):
        old = self._store.pop(key, None)
        if old is not None:
            self._size -= int(old[0].shape[0])
        self._size += int(vals.shape[0])
        self._store[key] = (vals, n)
        while self._size > self.capacity and len(self._store) > 1:
            _, (old_vals, _) = self._store.popitem(last=False)
            self._size -= int(old_vals.shape[0])

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.hits + self.misses, 1)


@dataclasses.dataclass
class QueryResult:
    count: int
    docs: np.ndarray        # global doc ids (may be truncated to cap)


def _packed_probe(r: torch.Tensor, r_count: int, src: source.PackedSource,
                  stats: dict | None = None) -> torch.Tensor:
    """Skip-probe the candidates against a PackedSource: the host searches
    the block-max index for the candidate blocks, the device decodes only
    those and gallops (``ops.intersect_packed_batch``, K3 on the card).  The
    padded layout operands are memoized per (part, term); only the candidate
    block ids move to the device here."""
    blk = src.candidate_block_ids(r[:r_count].cpu().numpy())
    k_pad, t_pad, e_pad = src.self_pads()
    c_pad = its.pow2_bucket(len(blk), floor=source.CAND_FLOOR)
    words, widths, offsets, maxes, exc_pos, exc_add = \
        source.cached_layout_dev(src, (k_pad, t_pad, e_pad), stats)
    blk_p = torch.from_numpy(source.pad_block_ids(blk, c_pad, k_pad)).to(
        r.device)
    source._bump(stats, "decoded_ints", c_pad * src.block_rows * 128)
    source._bump(stats, "skip_folds")
    args = (words, widths, offsets, maxes, blk_p, exc_pos, exc_add)
    return ops.intersect_packed_batch(
        r[None], *(a[None] for a in args),
        mode=src.mode, block_rows=src.block_rows)[0]


def _intersect_part(part: IndexPart, term_ids: list[int], codec,
                    skip: bool = True, cache=None,
                    stats: dict | None = None):
    """Returns (('list', padded candidate vals) | ('bitmap', words), count)."""
    tps = [part.terms[t] for t in term_ids]
    if any(tp.kind == "empty" for tp in tps):
        return None, 0
    lists = sorted((tp for tp in tps if tp.kind == "list"), key=lambda t: t.n)
    bitmaps = [tp for tp in tps if tp.kind == "bitmap"]

    if not lists:
        words = bitmaps[0].payload
        for tp in bitmaps[1:]:
            words = bm.bitmap_and(words, tp.payload)
        return ("bitmap", words), bm.popcount(words)

    id_of = {id(tp): t for t, tp in zip(term_ids, tps)}
    # the shortest list seeds the candidate buffer — always decoded
    seed = source.resolve(part, id_of[id(lists[0])], lists[0], codec,
                          cache=cache, r_count=None, stats=stats)
    r, r_count = seed.vals, seed.n
    for tp in lists[1:]:
        if r_count == 0:
            break
        src = source.resolve(part, id_of[id(tp)], tp, codec, cache=cache,
                             r_count=r_count, skip=skip, stats=stats)
        if isinstance(src, source.PackedSource):
            # galloping + skip: the long list is never fully decoded
            mask = _packed_probe(r, r_count, src, stats=stats)
        elif tp.n / max(r_count, 1) > its.TILED_MAX_RATIO:
            mask = ops.intersect_gallop(r, src.vals)
        else:
            mask = its.intersect_auto(r, src.vals, r_count, tp.n)
        r, r_count = its.compact(r, mask)
    for tp in bitmaps:
        if r_count == 0:
            break
        mask = bm.probe(tp.payload, r, r != int(its.SENTINEL))
        r, r_count = its.compact(r, mask)
    return ("list", r), r_count


def query(index: HybridIndex, term_ids: list[int],
          max_results: int = 1 << 16, cache: DecodeCache | None = None,
          skip: bool = True, stats: dict | None = None) -> QueryResult:
    """Answer one conjunctive query on the index's device.

    cache: optional DecodeCache → the paper's Table 4 regime (SvS over
    already-decoded lists); None → Table 5 regime (decode per query).  Long
    skip-capable lists go through the packed skip path unless
    ``skip=False``.  stats: optional dict accumulating decoded_ints /
    skip_folds counters."""
    codec = codec_lib.get_codec(index.codec_name)
    total = 0
    out_docs = []
    for part in index.parts:
        res, cnt = _intersect_part(part, term_ids, codec, skip=skip,
                                   cache=cache, stats=stats)
        total += cnt
        if cnt and res is not None:
            kind, payload = res
            if kind == "list":
                docs = payload[:cnt].cpu().numpy()
            else:
                docs = bm.extract_np(payload.cpu().numpy())
            out_docs.append(docs.astype(np.int64) + part.doc_lo)
    docs = (np.concatenate(out_docs) if out_docs
            else np.zeros(0, np.int64))[:max_results]
    return QueryResult(count=total, docs=docs)


def brute_force(postings: list[np.ndarray], term_ids: list[int]) -> np.ndarray:
    """Oracle: numpy set intersection over the raw posting lists.  The lists
    are sorted and unique (``corpus.synthesize`` makes them so), so each step
    keeps the values found by a binary search; that is the reference's
    ``np.intersect1d`` chain without its sort of the long list."""
    res = np.asarray(postings[term_ids[0]])
    for t in term_ids[1:]:
        p = np.asarray(postings[t])
        if p.size == 0:
            return p[:0]
        pos = np.minimum(np.searchsorted(p, res), p.size - 1)
        res = res[p[pos] == res]
    return res
