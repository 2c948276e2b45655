"""HYB+M2 inverted index builder (paper §6.7, after Culpepper & Moffat [6]).

Port of ``src/repro/index/builder.py`` (``build``, its containers and the
storage autotuner).  Lists with average gap ≤ B (len ≥ n_docs/B) become
bitmaps; the rest are compressed with the configured codec, lists shorter
than ``varint_tail_below`` with Varint.  The corpus is split into
``n_parts`` doc-id ranges.  Encoding runs on the host (numpy); the payloads
then move to ``device``, where the engine serves them.

``codec_name="auto"`` turns on the build-time storage autotuner: per list it
estimates every family's bytes in closed form from the list's deltas,
combines them with a cost table (decode ns/int and dispatch ns/list per
codec, gallop ns/probe) and picks the family and skip policy of least
estimated serve-plus-storage cost.  The default table is the reference's
(``configs.paper_index``), so an autotuned port build makes the reference's
choices list by list.  Every choice is lossless: an autotuned index answers
as a single-codec one does.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
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
    payload: Any               # PackedList/PatchedList/VarintList/… | words
    n: int                     # postings in this part
    raw: np.ndarray | None = None   # kept for oracle checks in tests
    skip_ok: bool = True       # False forces the decoded path
    host: np.ndarray | None = None  # a bitmap's host words, taken on first
                                    # use (source.bitmap_host)


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
        """Bytes of the index's tensors (payloads and bitmaps; a composite's
        head).  Memoized decode operands (layouts, SVB pads) are not
        counted."""
        def nbytes(obj) -> int:
            if isinstance(obj, torch.Tensor):
                return obj.numel() * obj.element_size()
            if dataclasses.is_dataclass(obj):
                return sum(nbytes(getattr(obj, f.name))
                           for f in dataclasses.fields(obj) if f.init)
            return 0
        return sum(nbytes(tp.payload) for part in self.parts
                   for tp in part.terms.values()
                   if tp.kind in ("bitmap", "list"))


# --------------------------------------------------------------------------
# build-time storage autotuner
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CostModel:
    """Per-codec costs driving per-list codec + skip selection.

    The modeled decode time of one list is the family's fixed per-decode
    dispatch term plus ``n ·`` its per-int term (``_decode_cost``); a
    family's score adds ``space_ns_per_byte · bytes``, bytes estimated in
    closed form from the list's delta statistics.  ``gallop_ns_per_probe``
    prices the packed skip path: a long bitpacked list keeps ``skip_ok``
    only when probing its skip index at ``ref_probes`` candidates is
    estimated cheaper than decoding it outright."""
    decode_ns_per_int: dict[str, float]
    dispatch_ns_per_list: dict[str, float] = dataclasses.field(
        default_factory=dict)
    gallop_ns_per_probe: float = 90.0
    space_ns_per_byte: float = 2.0
    ref_probes: int = 4096

    def decode_ns(self, family: str) -> float:
        t = self.decode_ns_per_int
        return float(t.get(f"{family}-d1", t.get(family, 1.0)))

    def dispatch_ns(self, family: str) -> float:
        t = self.dispatch_ns_per_list
        return float(t.get(f"{family}-d1", t.get(family, 0.0)))

    @classmethod
    def resolve(cls, table=None) -> "CostModel":
        """table: None → the default table (``configs.paper_index``), str →
        path to a JSON table, dict → an inline table."""
        if table is None:
            from repro_torch.configs.paper_index import DEFAULT_COST_TABLE
            table = DEFAULT_COST_TABLE
        elif isinstance(table, str):
            with open(table) as f:
                table = json.load(f)
        return cls(
            decode_ns_per_int=dict(table.get("decode_ns_per_int", {})),
            dispatch_ns_per_list=dict(table.get("dispatch_ns_per_list", {})),
            gallop_ns_per_probe=float(table.get("gallop_ns_per_probe", 90.0)),
            space_ns_per_byte=float(table.get("space_ns_per_byte", 2.0)))


def list_stats(seg: np.ndarray, span: int) -> dict:
    """Per-list statistics: length, density, and gap skew (max/mean delta
    ratio)."""
    n = int(seg.size)
    d = np.diff(seg.astype(np.int64), prepend=np.int64(0))
    mean_gap = float(d.mean()) if n else 0.0
    return {"n": n,
            "density": n / max(span, 1),
            "skew": float(d.max()) / max(mean_gap, 1e-9) if n else 0.0}


def _est_bytes(seg: np.ndarray) -> dict[str, float]:
    """Closed-form storage estimate per codec family from the D1 deltas, no
    trial encodes: bitpack pads to full blocks at the adaptive block size
    and pays the per-block max width; streamvbyte pays whole bytes + 2-bit
    control codes on 128-padded blocks; varint pays 7-bit groups; composite
    pays bitpack on the full-block prefix and varint on the tail."""
    n = int(seg.size)
    d = np.diff(seg.astype(np.int64), prepend=np.int64(0)).astype(np.uint64)
    bl = np.zeros(n, dtype=np.int64)
    nz = d > 0
    bl[nz] = np.floor(
        np.log2(d[nz].astype(np.float64))).astype(np.int64) + 1

    def block_bytes(rows: int, lens: np.ndarray) -> float:
        per = rows * 128
        k = max(-(-max(len(lens), 1) // per), 1)
        padded = np.zeros(k * per, np.int64)
        padded[: len(lens)] = lens
        widths = padded.reshape(k, per).max(axis=1)
        return float(widths.sum()) * per / 8 + k * 5     # +width/max meta

    rows = 8 if n <= 8192 else 32
    varint_b = float(np.maximum(-(-bl // 7), 1).sum())
    svb_pad = (-n) % 128
    svb_b = (float(np.maximum(-(-bl // 8), 1).sum()) + svb_pad
             + (n + svb_pad) / 4 + max(-(-n // 128), 1) * 8)
    bp_b = block_bytes(rows, bl)
    per8 = 8 * 128
    n_head = (n // per8) * per8
    comp_b = ((block_bytes(8, bl[:n_head]) if n_head else 0.0)
              + float(np.maximum(-(-bl[n_head:] // 7), 1).sum()))
    return {"bp": bp_b, "streamvbyte": svb_b, "varint": varint_b,
            "composite": comp_b}


# Below this many ints a bitpacked list can't reach SKIP_MIN_BLOCKS blocks
# at the adaptive block size, so packed serving is off the table and the
# decode-cost comparison decides alone.
_SKIP_MIN_INTS = 4 * 8 * 128


def _decode_cost(fam: str, n: int, cm: CostModel) -> float:
    """Modeled ns to decode one n-int list: the family's dispatch term plus
    a per-int term.  Composite is derived from its parts (bp8 head + varint
    tail), whose blend depends on n."""
    if fam == "composite":
        per = 8 * 128
        n_head = (n // per) * per
        cost = cm.dispatch_ns("varint") + (n - n_head) * cm.decode_ns("varint")
        if n_head:
            cost += cm.dispatch_ns("bp8") + n_head * cm.decode_ns("bp8")
        return cost
    if fam == "bp" and n <= 8192:
        fam = "bp8"     # bitpack.encode adapts to 8-row blocks here
    return cm.dispatch_ns(fam) + n * cm.decode_ns(fam)


def autotune_choice(seg: np.ndarray, span: int, cm: CostModel,
                    mode: str = "d1") -> tuple[str, bool]:
    """Pick (codec name, skip_ok) for one posting list."""
    n = int(seg.size)
    if n >= _SKIP_MIN_INTS:
        # long lists: bitpack, the only skip-capable layout, keeping the
        # skip index only when probing beats decoding at reference load
        skip_ok = (cm.gallop_ns_per_probe * cm.ref_probes
                   < _decode_cost("bp", n, cm))
        return f"bp-{mode}", skip_ok
    est = _est_bytes(seg)
    score = {fam: _decode_cost(fam, n, cm) + cm.space_ns_per_byte * b
             for fam, b in est.items()}
    fam = min(score, key=score.get)
    name = "varint" if fam == "varint" else f"{fam}-{mode}"
    return name, fam == "bp"


def build(postings: list[np.ndarray], n_docs: int, codec_name: str = "bp-d1",
          B: int = 0, n_parts: int = 1, keep_raw: bool = False,
          varint_tail_below: int = 1024,
          precompute_layouts: bool = True, device=None,
          cost_table=None) -> HybridIndex:
    """Build the index and place it on ``device`` (None = the CUDA card;
    raises where there is none — pass ``device="cpu"`` for the CPU).

    varint_tail_below: lists shorter than this are stored Varint (the
    paper's tail-codec rule).  ``codec_name="auto"`` replaces the fixed
    codec and tail rule with the autotuner; ``cost_table`` feeds it a table
    (path or dict, None = the default).  precompute_layouts: stage every
    list's decode operands at build time (``source.precompute_layouts``),
    so serving never pays for them on the query path."""
    device = ops.resolve_device(device)
    auto = codec_name == "auto"
    cm = CostModel.resolve(cost_table) if auto else None
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
                skip_ok = True
                if auto:
                    name, skip_ok = autotune_choice(seg, span, cm)
                    c = codec_lib.get_codec(name)
                else:
                    c = tail_codec if (codec_name != "varint"
                                       and seg.size < varint_tail_below) \
                        else codec
                payload = c.encode(seg)
                if not isinstance(payload, varint.VarintList):
                    payload = payload.to(device)
                terms[tid] = TermPosting(
                    "list", payload, int(seg.size),
                    raw=seg if keep_raw else None, skip_ok=skip_ok)
        parts.append(IndexPart(lo, hi, terms, device=device))
    if precompute_layouts:
        from repro_torch.index import source
        source.precompute_layouts(parts)
    return HybridIndex(n_docs=n_docs, B=B, codec_name=codec_name, parts=parts)


def build_sharded(postings: list[np.ndarray], n_docs: int, *, n_shards: int,
                  codec_name: str = "bp-d1", B: int = 0,
                  n_parts: int | None = None, keep_raw: bool = False,
                  varint_tail_below: int = 1024,
                  capacity_ints: int = 1 << 26, warm: bool = True,
                  cost_table=None, device=None):
    """Per-part build placed onto data-parallel shards: ``n_parts``
    doc-id-range parts (default ``n_shards``, the 1:1 mapping) built on
    ``device`` (None = the CUDA card) and returned as an
    ``index.shard.ShardedIndex`` with its part→shard→device placement map,
    each shard's working set staged on its own device when ``warm``."""
    if n_parts is None:
        n_parts = n_shards
    idx = build(postings, n_docs, codec_name=codec_name, B=B,
                n_parts=n_parts, keep_raw=keep_raw,
                varint_tail_below=varint_tail_below, device=device,
                cost_table=cost_table)
    from repro_torch.index import shard as shard_lib
    return shard_lib.shard_index(idx, n_shards, capacity_ints=capacity_ints,
                                 warm=warm)
