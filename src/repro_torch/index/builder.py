"""HYB+M2 inverted index builder (paper §6.7, after Culpepper & Moffat [6]).

Port of ``src/repro/index/builder.py`` (``build`` and its containers).
Lists with average gap ≤ B (len ≥ n_docs/B) become bitmaps; the rest are
compressed with the configured codec, lists shorter than
``varint_tail_below`` with Varint.  The corpus is split into ``n_parts``
doc-id ranges.  Encoding runs on the host (numpy); the payloads then move
to ``device``, where the engine serves them.  ``codec_name="auto"`` (the
reference's storage autotuner) is not yet ported.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import codecs as codec_lib
from repro_torch.core import varint
from repro_torch.kernels import ops


@dataclasses.dataclass
class TermPosting:
    kind: str                  # 'list' | 'bitmap' | 'empty'
    payload: Any               # PackedList/PatchedList/VarintList | words
    n: int                     # postings in this part
    raw: np.ndarray | None = None   # kept for oracle checks in tests
    skip_ok: bool = True       # False forces the decoded path


_part_uids = itertools.count()


@dataclasses.dataclass
class IndexPart:
    doc_lo: int
    doc_hi: int
    terms: dict[int, TermPosting]
    device: Any = "cpu"         # where the payloads lie
    # process-unique id for cache keying (id(part) can be reused)
    uid: int = dataclasses.field(default_factory=lambda: next(_part_uids))


@dataclasses.dataclass
class HybridIndex:
    n_docs: int
    B: int                      # bitmap threshold (0 = no bitmaps)
    codec_name: str
    parts: list[IndexPart]

    def stats(self) -> dict:
        """Storage accounting by payload type via the codec registry:
        bits/int and bytes/int over the whole index plus per-family list
        counts."""
        bits = 0.0
        n = 0
        counts: dict[str, int] = {}
        fam_bits: dict[str, float] = {}
        for part in self.parts:
            for tp in part.terms.values():
                n += tp.n
                if tp.kind == "bitmap":
                    fam, b = "bitmap", float(int(tp.payload.shape[0]) * 32)
                elif tp.kind == "list":
                    fam = codec_lib.family_of(tp.payload)
                    b = (codec_lib.codec_for(tp.payload)
                         .bits_per_int(tp.payload) * tp.n)
                else:
                    continue
                bits += b
                counts[fam] = counts.get(fam, 0) + 1
                fam_bits[fam] = fam_bits.get(fam, 0.0) + b
        return {"bits_per_int": bits / max(n, 1),
                "bytes_per_int": bits / 8 / max(n, 1),
                "postings": n,
                "codec_counts": counts,
                "codec_bytes": {k: int(v // 8) for k, v in fam_bits.items()}}

    def device_bytes(self) -> int:
        """Bytes of the index's tensors (payloads and bitmaps)."""
        total = 0
        for part in self.parts:
            for tp in part.terms.values():
                if tp.kind == "bitmap":
                    total += tp.payload.numel() * tp.payload.element_size()
                elif tp.kind == "list" and not isinstance(tp.payload,
                                                          varint.VarintList):
                    total += sum(t.numel() * t.element_size()
                                 for t in vars(tp.payload).values()
                                 if isinstance(t, torch.Tensor))
        return total


def build(postings: list[np.ndarray], n_docs: int, codec_name: str = "bp-d1",
          B: int = 0, n_parts: int = 1, keep_raw: bool = False,
          varint_tail_below: int = 1024,
          precompute_layouts: bool = True, device=None) -> HybridIndex:
    """Build the index and place it on ``device`` (None = the CUDA card;
    raises where there is none — pass ``device="cpu"`` for the CPU).

    varint_tail_below: lists shorter than this are stored Varint (the
    paper's tail-codec rule).  precompute_layouts: project every skip-capable
    list onto its self-padded PackedLayout at build time, so serving never
    pays the projection on the query path."""
    device = ops.resolve_device(device)
    if codec_name == "auto":
        raise NotImplementedError("codec_name='auto' (the storage autotuner) "
                                  "is not yet ported")
    codec = codec_lib.get_codec(codec_name)
    tail_codec = codec_lib.get_codec("varint")
    bounds = np.linspace(0, n_docs, n_parts + 1).astype(np.int64)
    parts = []
    for p in range(n_parts):
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        span = max(hi - lo, 1)
        terms: dict[int, TermPosting] = {}
        for tid, docs in enumerate(postings):
            seg = docs[(docs >= lo) & (docs < hi)] - lo
            if seg.size == 0:
                terms[tid] = TermPosting("empty", None, 0)
                continue
            avg_gap = span / seg.size
            if B > 0 and avg_gap <= B:
                words = bm.build_np(seg, span).view(np.int32)
                terms[tid] = TermPosting(
                    "bitmap", torch.from_numpy(words).to(device),
                    int(seg.size), raw=seg if keep_raw else None)
            else:
                c = tail_codec if (codec_name != "varint"
                                   and seg.size < varint_tail_below) else codec
                payload = c.encode(seg)
                if not isinstance(payload, varint.VarintList):
                    payload = payload.to(device)
                terms[tid] = TermPosting(
                    "list", payload, int(seg.size),
                    raw=seg if keep_raw else None)
        parts.append(IndexPart(lo, hi, terms, device=device))
    if precompute_layouts:
        from repro_torch.index import source
        source.precompute_layouts(parts)
    return HybridIndex(n_docs=n_docs, B=B, codec_name=codec_name, parts=parts)
