"""Posting-source layer: one decode/skip policy for both engines, and the
device-resident operand pool.

Port of ``src/repro/index/source.py``.  A query term resolves to one of two
sources:

  DecodedSource — the padded int32 value tensor: short lists, cache-resident
                  lists and codecs without a skip index.
  PackedSource  — the compressed list stays packed; intersection searches
                  the block-max skip index and decodes only candidate blocks
                  (paper §6.5).  Long skip-capable lists land here.

``resolve`` chooses from the candidate/list cardinality ratio, the codec
family (``bitpack.skip_capable``) and cache residency, and keeps the
decoded-ints accounting in ``stats``.  Decodes stay on the index's device:
where the reference decodes to numpy and uploads, the port decodes on the
card (K1, K7) and pads there.

Residency (``ResidentPool``, ``RowArena``): decoded value rows and bitmap
word rows are staged once on the pool's device, LRU-evicted against an int
budget that counts every tensor the pool holds there (store entries, their
pad memos, identity rows and arenas), and served to every later batch.  A
``RowArena`` packs same-shape rows into one device matrix so that a group's
operand is one ``index_select`` gather; a row joins it by a write on the
device from the tensor that holds it, and the arena grows there.  Every
store entry keeps a host copy (``vals_np``): the scheduler reads seed values
on the host for the block-max search, and a copy off the card per seed
would wait for every batch already queued on the stream.  A pool miss
decodes on the card and keeps a ``HostCopy``, taken off the card once, at
its first read.  Bitmap and layout rows keep the port's int32 bit patterns
(the bitmap all-ones row is -1).

Accounting for the query paths: ``_bump`` adds to a counter of the
caller's ``stats`` dict, and ``span`` times a stage into the caller's
``stats`` or ``pipeline.StageTimings`` and, under a torch profiler, marks
it as a ``repro_torch.<name>`` range.  Neither does anything without a
carrier (nor ``span`` without a profiler).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core import codecs as codec_lib
from repro_torch.core import intersect as its
from repro_torch.core import streamvbyte
from repro_torch.core import varint as varint_lib
from repro_torch.core.intersect import to_device
from repro_torch.kernels import ops, svb_decode

# Ratio above which a skip-capable list is probed packed instead of decoded
# (the same constant the decoded-path dispatcher uses).
SKIP_MIN_RATIO = its.TILED_MAX_RATIO
# Below this many blocks the skip index cannot prune anything worth it.
SKIP_MIN_BLOCKS = 4

# Bucket floor for the candidate-block-id buffer.
CAND_FLOOR = 8


@dataclasses.dataclass
class DecodedSource:
    """Fully decoded posting list: padded int32 values + valid count.
    ``vals_np`` is the host copy where the pool keeps one (an array, or a
    ``HostCopy`` taken at its first read), so schedulers read values
    without a copy off the card once it is taken.  ``key`` is the
    (part.uid, tid) identity for pool lookups."""
    vals: torch.Tensor
    n: int
    vals_np: np.ndarray | None = None
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
    def num_exceptions(self) -> int:
        exc_pos = getattr(self.payload, "exc_pos", None)
        return int(exc_pos.shape[0]) if exc_pos is not None else 0

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
        """The layout at (k_pad, t_pad, e_pad).  At the payload's own pads it
        is projected from the payload (at build, by ``precompute_layouts``);
        at wider pads (a group's) it extends the memoized self-padded host
        layout, so the query path copies nothing off the card."""
        pads = (k_pad, t_pad, e_pad)
        if pads == self.self_pads():
            return bitpack.layout_np(self.payload, k_pad, t_pad, e_pad)
        return _extend_layout(_layout_entry(self, self.self_pads())["np"],
                              self.num_blocks,
                              int(self.payload.flat_words.shape[0]),
                              self.num_exceptions, pads)

    def self_pads(self) -> tuple[int, int, int]:
        return bitpack.self_pads(self.payload)


def _extend_layout(lay: bitpack.PackedLayout, K: int, T: int, E: int,
                   pads: tuple) -> bitpack.PackedLayout:
    """``lay`` re-padded to wider ``pads`` with ``bitpack.pad_fills``."""
    k_pad, t_pad, e_pad = pads
    if K > k_pad or T > t_pad or E > e_pad:
        raise ValueError(f"pads too small: K={K}, T={T}, E={E} for {pads}")
    fills = bitpack.pad_fills(T, lay.maxes[K - 1] if K else 0)

    def ext(a, size, fill):
        out = np.full((size,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a[:size]
        return out

    words, widths, offsets, maxes, exc_pos, exc_add = (
        ext(a[:n], size, f) for a, n, size, f in zip(
            (lay.words, lay.widths, lay.offsets, lay.maxes, lay.exc_pos,
             lay.exc_add), (T, K, K, K, E, E),
            (t_pad, k_pad, k_pad, k_pad, e_pad, e_pad), fills))
    return dataclasses.replace(lay, words=words, widths=widths,
                               offsets=offsets, maxes=maxes,
                               exc_pos=exc_pos, exc_add=exc_add)


def pad_block_ids(blk: np.ndarray, c_pad: int, k_pad: int) -> np.ndarray:
    """Pad a candidate block-id list to its bucket; pad entries use the
    out-of-range id ``k_pad``, which decodes to all-SENTINEL."""
    out = np.full(c_pad, k_pad, np.int32)
    out[: blk.shape[0]] = blk
    return out


# Memoized padded layouts, keyed by ((part.uid, tid), pads) and LRU-bounded
# by total layout ints: each entry holds the host layout and its copies by
# device (the payload's, and each shard's pool device), so the query path
# uploads only candidate block ids.
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
        entry = {"np": src.layout(*pads), "dev": {}}
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


def layout_rows(lay: bitpack.PackedLayout) -> tuple:
    """A host layout's six operands in K5's order less the block ids —
    words, widths, offsets, maxes, exc_pos, exc_add — as int32 bit
    patterns."""
    return tuple(np.ascontiguousarray(x).view(np.int32)
                 for x in (lay.words, lay.widths, lay.offsets, lay.maxes,
                           lay.exc_pos, lay.exc_add))


def layout_device_rows(payload) -> tuple:
    """A skip-capable payload's six layout operands (``layout_rows``'
    order) as (row, fill) pairs of its own device tensors, for
    ``RowArena`` writes at any pads: the row, then its pad value
    (``bitpack.pad_fills``).  No host copy and no upload."""
    K = int(payload.widths.shape[0])
    T = int(payload.flat_words.shape[0])
    exc_pos = getattr(payload, "exc_pos", None)
    if exc_pos is None:
        exc_pos = exc_add = payload.widths[:0]
    else:
        exc_add = payload.exc_add
    return tuple(zip((payload.flat_words, payload.widths, payload.offsets,
                      payload.maxes, exc_pos, exc_add),
                     bitpack.pad_fills(T, payload.maxes[K - 1] if K else 0)))


def cached_layout_dev(src: PackedSource, pads: tuple,
                      stats: dict | None = None, device=None) -> tuple:
    """Memoized layout operands on ``device`` (None = the payload's):
    (words, widths, offsets, maxes, exc_pos, exc_add), uint32 arrays as
    int32 bit patterns.  Sharded serving keeps one copy per shard device."""
    entry = _layout_entry(src, pads, stats)
    device = src.payload.widths.device if device is None else device
    dev = entry["dev"].get(device)
    if dev is None:
        dev = tuple(to_device(x, device) for x in layout_rows(entry["np"]))
        entry["dev"][device] = dev
    return dev


def precompute_layouts(parts, stats: dict | None = None) -> int:
    """Build-time staging: project every skip-capable list payload onto its
    self-padded PackedLayout, and pad every StreamVByte payload's K7
    operands on its device.  Returns the number of layouts staged."""
    n = 0
    for part in parts:
        for tid, tp in part.terms.items():
            if isinstance(tp.payload, streamvbyte.SVBList):
                svb_decode.bucketed_operands(tp.payload)
            elif (tp.kind == "list" and bitpack.skip_capable(tp.payload)
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
    count).  Packed and StreamVByte payloads decode where they lie (K1, K7);
    Varint decodes on the host, as in the reference, and is uploaded; a
    composite decodes its head where it lies and uploads its tail."""
    if isinstance(tp.payload, bitpack.PackedList):
        vals = bitpack.decode_bucketed(tp.payload)[: tp.n]
    elif isinstance(tp.payload, varint_lib.VarintList):
        vals = to_device(varint_lib.decode(tp.payload).astype(np.int32),
                         device)
    else:
        c = codec_lib.codec_for(tp.payload) or codec
        vals = c.decode(tp.payload)[: tp.n]
    return its.pad_to_tensor(vals, its.pow2_bucket(tp.n)), tp.n


class HostCopy:
    """The host copy of a decoded row on a device (padded with SENTINEL
    past its count), taken when it is first read — ``np.asarray``, an index
    or a slice — and kept.  A pool miss holds one instead of copying at
    once: a copy off the card waits for every program queued on the
    stream, and the host reads few misses (a seed whose folds are probed
    packed, for the block-max search).  ``put`` takes the copy from a
    reader that copied the row's first values itself."""
    __slots__ = ("dev", "_np")

    def __init__(self, dev: torch.Tensor):
        self.dev, self._np = dev, None

    @property
    def shape(self) -> tuple:
        return tuple(self.dev.shape)

    @property
    def taken(self) -> bool:
        return self._np is not None

    def numpy(self) -> np.ndarray:
        if self._np is None:
            self._np = self.dev.cpu().numpy()
        return self._np

    def put(self, head: np.ndarray) -> None:
        """Keep ``head`` (the row's first values) and SENTINEL after it as
        the copy, unless one is taken already."""
        if self._np is None:
            self._np = its.pad_to(head, self.dev.shape[0])

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __getitem__(self, i):
        return self.numpy()[i]


def host_taken(vals_np) -> bool:
    """A source's host copy is on the host: an array, or a taken
    ``HostCopy``."""
    return vals_np is not None and (not isinstance(vals_np, HostCopy)
                                    or vals_np.taken)


def decode_staged(codec, tp, device) -> tuple[torch.Tensor, object, int]:
    """A pool miss: (values on ``device``, their host copy, count).  Varint
    decodes on the host and is uploaded; the rest decode where the payload
    lies (K1 or K7 on the card), move to ``device`` where that is another
    one, and keep a ``HostCopy``, copied off the card when first read."""
    if isinstance(tp.payload, varint_lib.VarintList):
        host = its.pad_to(varint_lib.decode(tp.payload).astype(np.int32),
                          its.pow2_bucket(tp.n))
        return to_device(host, device), host, tp.n
    vals, n = decode_padded(codec, tp, device)
    vals = vals.to(device)
    return vals, HostCopy(vals), n


def bitmap_host(tp) -> np.ndarray:
    """Host copy of a bitmap term's words (int32 bit patterns), taken once
    and kept on the term, so schedulers read it without a copy off the
    card."""
    if getattr(tp, "host", None) is None:
        tp.host = tp.payload.cpu().numpy()
    return tp.host


# The pool's counters in a query path's ``stats``: lookups that hit and
# missed (``ResidentPool.get``), ints staged into the store and written into
# arenas, arena doublings.  ``batch.schedule`` sets them to 0 when it runs
# with a pool, so a reader tells "none" from "not counted".
POOL_COUNTERS = ("pool_hits", "pool_misses", "staged_ints", "arena_grows")


def _bump(stats, key, by=1):
    if stats is not None:
        stats[key] = stats.get(key, 0) + by


SPAN_PREFIX = "repro_torch."


class _Span:
    """An open span (see ``span``)."""
    __slots__ = ("carrier", "name", "rf", "t0")

    def __init__(self, carrier, name: str, profiling: bool):
        self.carrier, self.name = carrier, name
        self.rf = (torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)
                   if profiling else None)

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        if self.carrier is not None:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        c = self.carrier
        if c is not None:
            dt = time.perf_counter() - self.t0
            if isinstance(c, dict):
                s, n = c.setdefault("span_s", {}), c.setdefault("span_n", {})
                s[self.name] = s.get(self.name, 0.0) + dt
                n[self.name] = n.get(self.name, 0) + 1
            else:
                field = self.name.rsplit(".", 1)[1]
                setattr(c, field, getattr(c, field) + dt)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(carrier, name: str):
    """A timed span of the query paths, as a context manager.  ``carrier``
    takes its seconds: a ``stats`` dict, under ``stats["span_s"][name]``
    with the count of entries in ``stats["span_n"][name]``, or an object
    with a field named by the last part of ``name`` (``pipeline.StageTimings``:
    ``"batch.wait"`` adds to ``.wait``).  While a torch profiler runs, the
    span is also a range named ``repro_torch.<name>`` on the profiler's
    clock, beside the device's events: torch's ``_RecordFunctionFast``, a
    host event with no mirror on the device's timeline, which costs the
    host a seventh of a ``record_function``.  With no carrier and no
    profiler it is off: it reads no clock and calls nothing of the
    profiler."""
    profiling = torch.autograd.profiler._is_profiler_enabled
    if carrier is None and not profiling:
        return _OFF
    return _Span(carrier, name, profiling)


# --------------------------------------------------------------------------
# device-resident operand pool
# --------------------------------------------------------------------------

def pool_device(device) -> torch.device:
    """A pool's device: the CUDA card unless the caller asks for the CPU
    (as ``ops.resolve_device``), with the card's index filled in so that
    the device compares equal to a tensor's."""
    dev = ops.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class RowArena:
    """Same-shape resident rows packed into ONE device matrix, so a group's
    operand assembly is one ``index_select`` gather instead of a stack of
    row copies.

    Identity rows (SENTINEL / all-ones / all-zero / pad layout) take the
    first slots, so padded and inactive grid positions gather them.  The
    buffer is made once, from the identity rows, at a power-of-two row
    capacity (filler: the identity row).  A row joins by a write into its
    slot on the device, copied from the device tensor that already holds it
    (a decoded list, a bitmap row, a packed payload's arrays) and padded
    there with its fill value; when the slots run out the capacity doubles
    with one device-side copy of the rows already there.  Writes and copies
    are ordered on the device's stream after every gather already queued,
    so programs in flight read the rows they were assembled from; a grown
    buffer replaces the tensor.  The arena keeps no host copy of its rows.

    ``evict(key)`` returns a row's slot to a free list for the next miss,
    so churn does not grow the buffer; ``ints`` is the allocated footprint
    (the high-water row count), which the pool counts against its
    capacity.  ``builds`` counts buffers uploaded whole (one, the
    identities), ``grows`` the doublings."""

    def __init__(self, identities: list, device):
        self.identities = [np.asarray(r) for r in identities]
        self.row_shape = tuple(self.identities[0].shape)
        self.row_ints = int(np.prod(self.row_shape))
        self.n_rows = len(self.identities)
        self.slots: dict = {}
        self.device = device
        self.evictions = 0
        self.builds = 0
        self.grows = 0
        self._free: list[int] = []
        self._buf = None

    def slot(self, key, make_row, stats: dict | None = None) -> int:
        """The slot of ``key``, written on a miss from ``make_row()``: a
        pair (row, fill) of a device tensor, as long as the arena's rows or
        shorter along its first axis, and the value of the rest (a number
        or a 0-d device tensor).  A write adds the row's ints to
        ``stats["staged_ints"]``, a doubling to ``stats["arena_grows"]``;
        both run in the span ``pool.arena``."""
        s = self.slots.get(key)
        if s is None:
            with span(stats, "pool.arena"):
                buf = self.buffer()
                if self._free:
                    s = self._free.pop()
                else:
                    s = self.n_rows
                    self.n_rows += 1
                    if s >= buf.shape[0]:
                        buf = self._grow(stats)
                self._write(buf[s], make_row(), stats)
            self.slots[key] = s
        return s

    def _grow(self, stats) -> torch.Tensor:
        old = self._buf
        cap = old.shape[0]
        buf = torch.empty((2 * cap,) + self.row_shape, dtype=old.dtype,
                          device=old.device)
        buf[:cap].copy_(old)
        buf[cap:].copy_(old[0].expand((cap,) + self.row_shape))
        self._buf = buf
        self.grows += 1
        _bump(stats, "arena_grows")
        return buf

    def _write(self, dst: torch.Tensor, got, stats) -> None:
        row, fill = got
        if row.device != dst.device:
            row = row.to(dst.device, non_blocking=True)
        n = row.shape[0]
        dst[:n].copy_(row)
        if n < dst.shape[0]:
            rest = dst[n:]
            if isinstance(fill, torch.Tensor):
                rest.copy_(fill.to(dst.device).expand(rest.shape))
            else:
                rest.fill_(fill)
        _bump(stats, "staged_ints", self.row_ints)

    def evict(self, key) -> int:
        """Drop one row: its slot goes to the free list, to be written by
        the next ``slot()`` miss.  Returns the ints the slot will stop
        pinning once reused."""
        s = self.slots.pop(key, None)
        if s is None:
            return 0
        self._free.append(s)
        self.evictions += 1
        return self.row_ints

    @property
    def ints(self) -> int:
        return self.n_rows * self.row_ints

    def buffer(self) -> torch.Tensor:
        if self._buf is None:
            cap = 1
            while cap < self.n_rows:
                cap <<= 1
            ids = self.identities
            self._buf = to_device(
                np.stack(ids + [ids[0]] * (cap - len(ids))), self.device)
            self.builds += 1
        return self._buf

    def gather(self, idx: np.ndarray) -> torch.Tensor:
        """Rows ``idx`` (any shape) of the buffer, shaped idx.shape + row:
        one upload of the ids and one ``index_select``."""
        flat = to_device(np.ascontiguousarray(idx, np.int32).reshape(-1),
                         self.device)
        rows = torch.index_select(self.buffer(), 0, flat)
        return rows.reshape(idx.shape + self.row_shape)


class ResidentPool:
    """Device-resident index operands: decoded value rows and bitmap word
    rows staged once on ``device`` (None = the CUDA card; pass "cpu" for
    the CPU) and reused by every later batch (packed layouts stay resident
    through the layout memo).

    Entries are LRU-evicted against ``capacity_ints``, which bounds the
    pool's whole footprint on its device (``device_ints``): store entries,
    their per-size pad memos (dropped with the entry), identity rows and
    arenas.  ``staged_ints - evicted_ints == resident_ints`` holds for the
    store.  Evicting an entry also frees its arena rows.  Each entry keeps
    the host copy beside the device tensor (see the module docstring)."""

    def __init__(self, capacity_ints: int = 1 << 26, device=None, tag=None):
        self.capacity = capacity_ints
        self.device = pool_device(device)
        self.tag = tag
        self._store: OrderedDict = OrderedDict()
        self._pad_rows: dict[tuple, torch.Tensor] = {}
        self._arenas: dict[tuple, RowArena] = {}
        self.hits = 0
        self.misses = 0
        self.staged_lists = 0
        self.staged_ints = 0
        self.evicted_lists = 0
        self.evicted_ints = 0
        self.resident_ints = 0
        self.pad_ints = 0              # current pad-memo ints (⊂ resident)

    # -- staging -----------------------------------------------------------

    def overhead_ints(self) -> int:
        """Device ints the pool holds outside the LRU store: identity rows
        and the row arenas (allocated footprint)."""
        return (sum(int(r.numel()) for r in self._pad_rows.values())
                + sum(a.ints for a in self._arenas.values()))

    def device_ints(self) -> int:
        """The pool's whole footprint on its device."""
        return self.resident_ints + self.overhead_ints()

    def _evict(self):
        while (self.device_ints() > self.capacity
               and len(self._store) > 1):
            key, old = self._store.popitem(last=False)
            freed = old["ints"] + old["pad_ints"]
            self.evicted_lists += 1
            self.evicted_ints += freed
            self.resident_ints -= freed
            self.pad_ints -= old["pad_ints"]
            old["pads"].clear()
            for arena in self._arenas.values():
                arena.evict(key)

    def _on_device(self, host: np.ndarray, dev) -> torch.Tensor:
        if dev is None:
            return to_device(host, self.device)
        return dev if dev.device == self.device else dev.to(self.device)

    def _add(self, key, host: np.ndarray, n: int, dev, stats) -> dict:
        entry = {"dev": self._on_device(host, dev), "np": host, "n": n,
                 "pads": {}, "ints": int(host.shape[0]), "pad_ints": 0}
        self._store[key] = entry
        self.staged_lists += 1
        self.staged_ints += entry["ints"]
        _bump(stats, "staged_ints", entry["ints"])
        self.resident_ints += entry["ints"]
        self._evict()
        return entry

    def stage(self, key, vals_np: np.ndarray, n: int,
              dev: torch.Tensor | None = None,
              stats: dict | None = None) -> dict:
        """Stage one padded decoded list; ``dev`` is its tensor where one
        exists already (moved to the pool's device if it lies elsewhere),
        else the host copy is uploaded.  ``stats["staged_ints"]`` takes
        the ints staged."""
        if key in self._store:
            self._store.move_to_end(key)
            return self._store[key]
        return self._add(key, vals_np, n, dev, stats)

    def stage_bitmap(self, key, words_np: np.ndarray,
                     dev: torch.Tensor | None = None,
                     stats: dict | None = None) -> torch.Tensor:
        """Stage one bitmap term's word row (``key`` carries a 'bm' tag);
        ``dev`` and ``stats`` as in ``stage``."""
        entry = self._store.get(key)
        if entry is None:
            entry = self._add(key, words_np, int(words_np.shape[0]), dev,
                              stats)
        else:
            self._store.move_to_end(key)
        return entry["dev"]

    # -- lookup ------------------------------------------------------------

    def get(self, key, stats: dict | None = None):
        """(device vals, host vals, n) or None — counts hit/miss, also in
        ``stats["pool_hits"]`` / ``stats["pool_misses"]``."""
        entry = self._store.get(key)
        if entry is None:
            self.misses += 1
            _bump(stats, "pool_misses")
            return None
        self.hits += 1
        _bump(stats, "pool_hits")
        self._store.move_to_end(key)
        return entry["dev"], entry["np"], entry["n"]

    def __contains__(self, key) -> bool:
        return key in self._store        # residency peek: no counters

    def padded(self, src: DecodedSource, size: int,
               stats: dict | None = None) -> torch.Tensor:
        """Device row of ``src`` SENTINEL-padded to ``size``, memoized per
        (entry, size) (its ints in ``stats["staged_ints"]``); a source that
        is not this pool's entry pads on the device."""
        base = src.vals
        if base.shape[0] == size:
            return base
        entry = self._store.get(src.key) if src.key else None
        if entry is not None and entry["dev"] is base:
            dev = entry["pads"].get(size)
            if dev is None:
                dev = its.pad_to_tensor(base, size)
                entry["pads"][size] = dev
                entry["pad_ints"] += size
                self.staged_ints += size
                _bump(stats, "staged_ints", size)
                self.resident_ints += size
                self.pad_ints += size
                self._evict()
            return dev
        return its.pad_to_tensor(base, size)

    def _identity(self, kind: str, size: int, fill: int) -> torch.Tensor:
        row = self._pad_rows.get((kind, size))
        if row is None:
            row = torch.full((size,), fill, dtype=torch.int32,
                             device=self.device)
            self._pad_rows[(kind, size)] = row
        return row

    def sentinel_row(self, size: int) -> torch.Tensor:
        """All-SENTINEL row (inactive fold / padded batch slots)."""
        return self._identity("sent", size, int(its.SENTINEL))

    def ones_row(self, words: int) -> torch.Tensor:
        """All-ones bitmap row — the probe/AND identity."""
        return self._identity("ones", words, -1)

    def zeros_row(self, words: int) -> torch.Tensor:
        """All-zero bitmap row — padded batch slots (popcount 0)."""
        return self._identity("zero", words, 0)

    # -- arenas ------------------------------------------------------------

    # identity slots shared with the batch assembler:
    #   fold arenas:   slot 0 = all-SENTINEL row
    #   bitmap arenas: slot 0 = all-ones (probe/AND identity),
    #                  slot 1 = all-zero (padded batch rows, popcount 0)
    FOLD_PAD_SLOT = 0
    BM_ONES_SLOT = 0
    BM_ZERO_SLOT = 1

    def _arena(self, key: tuple, identities) -> RowArena:
        a = self._arenas.get(key)
        if a is None:
            a = self._arenas[key] = RowArena(identities(), self.device)
        return a

    def fold_arena(self, size: int) -> RowArena:
        """Arena of SENTINEL-padded int32 value rows of length ``size``."""
        return self._arena(("fold", size), lambda: [
            np.full(size, its.SENTINEL, np.int32)])

    def bitmap_arena(self, words: int) -> RowArena:
        return self._arena(("bm", words), lambda: [
            np.full(words, -1, np.int32), np.zeros(words, np.int32)])

    def layout_arena(self, pads: tuple, op: int) -> RowArena:
        """Arena of packed-layout operand ``op`` (words, widths, offsets,
        maxes, exc_pos, exc_add) at group pads; slot 0 is the all-pad
        layout, whose blocks are never candidates."""
        k_pad, t_pad, e_pad = pads
        return self._arena(("lay", pads, op), lambda: [(
            np.zeros((t_pad, bitpack.LANES), np.int32),
            np.zeros(k_pad, np.int32), np.zeros(k_pad, np.int32),
            np.zeros(k_pad, np.int32), np.full(e_pad, -1, np.int32),
            np.zeros(e_pad, np.int32))[op]])

    def arena_stats(self) -> dict:
        return {"arenas": len(self._arenas),
                "arena_ints": sum(a.ints for a in self._arenas.values()),
                "arena_rows": sum(len(a.slots)
                                  for a in self._arenas.values()),
                "arena_evictions": sum(a.evictions
                                       for a in self._arenas.values())}

    def arena_builds(self) -> int:
        """Arena buffers uploaded whole so far: one an arena, at its
        creation (a steady state creates none)."""
        return sum(a.builds for a in self._arenas.values())

    def arena_grows(self) -> int:
        """Arena capacity doublings so far (a steady state makes none)."""
        return sum(a.grows for a in self._arenas.values())

    # -- lifecycle ---------------------------------------------------------

    def carry_from(self, other: "ResidentPool",
                   part_uids: set | None = None) -> int:
        """Adopt another pool's staged entries around their device tensors
        (no re-decode, no second upload); ``part_uids`` restricts the carry
        to those parts (None = all).  Returns the entries carried; they
        count as freshly staged here."""
        carried = 0
        for key, e in list(other._store.items()):
            if part_uids is not None:
                uid = key[1] if (key and key[0] == "bm") else key[0]
                if uid not in part_uids:
                    continue
            if key in self._store:
                continue
            if key and key[0] == "bm":
                self.stage_bitmap(key, e["np"], dev=e["dev"])
            else:
                self.stage(key, e["np"], e["n"], dev=e["dev"])
            carried += 1
        return carried

    def warm(self, index, stats: dict | None = None) -> dict:
        """Stage the whole index per the resolve policy: bitmaps (around
        the index's own tensors where they lie on the pool's device) and
        decode-policy lists (decoded on the card, K1 or K7) go resident;
        skip-capable long lists stay compressed and only warm their
        self-padded layout.  Already-resident entries skip the decode."""
        codec = codec_lib.get_codec(index.codec_name)
        for part in index.parts:
            for tid, tp in part.terms.items():
                if tp.kind == "bitmap":
                    self.stage_bitmap(("bm", part.uid, tid), bitmap_host(tp),
                                      dev=tp.payload)
                elif tp.kind == "list":
                    if (part.uid, tid) in self._store:
                        self._store.move_to_end((part.uid, tid))
                        continue
                    if (bitpack.skip_capable(tp.payload) and
                            getattr(tp, "skip_ok", True) and
                            int(tp.payload.widths.shape[0])
                            >= SKIP_MIN_BLOCKS):
                        continue                 # serves packed
                    vals, vals_np, n = decode_staged(codec, tp, self.device)
                    _bump(stats, "decoded_ints", decoded_ints_of(tp.payload))
                    self.stage((part.uid, tid), vals_np, n, dev=vals)
        precompute_layouts(index.parts, stats)
        return self.stats()

    def stats(self) -> dict:
        return {"tag": self.tag,
                "resident_lists": len(self._store),
                "resident_ints": self.resident_ints,
                "staged_lists": self.staged_lists,
                "staged_ints": self.staged_ints,
                "evicted_lists": self.evicted_lists,
                "evicted_ints": self.evicted_ints,
                "pad_ints": self.pad_ints,
                "overhead_ints": self.overhead_ints(),
                "device_ints": self.device_ints(),
                "hits": self.hits, "misses": self.misses,
                **self.arena_stats()}


def resolve(part, tid: int, tp, codec, cache=None, r_count: int | None = None,
            skip: bool = True, stats: dict | None = None,
            pool: ResidentPool | None = None):
    """Resolve one term posting to a DecodedSource or a PackedSource.

    r_count: current (or scheduled) candidate cardinality — None means this
    term *is* the candidate seed and must decode.  skip=False forces the
    decoded path everywhere.  A list already in the DecodeCache or the
    ``pool`` is served decoded even where the ratio would skip-probe it;
    with a pool, fresh decodes are staged so the next batch gathers
    instead of decoding."""
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
        if pool is not None and key in pool:
            dev, vals_np, n = pool.get(key, stats)
            _bump(stats, "resident_hits")
            return DecodedSource(dev, n, vals_np=vals_np, key=key)
        return PackedSource(tp.payload, tp.n, key=key)
    if pool is not None:
        hit = pool.get(key, stats)
        if hit is not None:
            _bump(stats, "resident_hits")
            return DecodedSource(hit[0], hit[2], vals_np=hit[1], key=key)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            if pool is not None:          # promote: next batch gathers
                pool.stage(key, hit[0].cpu().numpy(), hit[1], dev=hit[0],
                           stats=stats)
            return DecodedSource(hit[0], hit[1], key=key)
    vals_np = None
    if pool is not None:
        vals, vals_np, n = decode_staged(codec, tp, pool.device)
        vals = pool.stage(key, vals_np, n, dev=vals, stats=stats)["dev"]
    else:
        vals, n = decode_padded(codec, tp, part.device)
    _bump(stats, "decoded_ints", decoded_ints_of(tp.payload))
    _bump(stats, "decoded_lists")
    if cache is not None:
        cache.put(key, vals, n)
    return DecodedSource(vals, n, vals_np=vals_np, key=key)
