"""Mutable segmented index: adds, deletes, background merge.

Port of ``src/repro/index/segments.py``: the same segment lifecycle on top
of the port's frozen serving machinery (``builder.build``, the batched
engine, ``ResidentPool``, the sharded fan-out), with the same answers,
counters and durable state.

  mutable segment   new documents accumulate in a small append-only segment
                    (per-term python lists of ascending local doc ids),
                    served on the host: a sorted intersection merged into
                    results at collect time.  No program on the card ever
                    sees it, so adds never change a group signature.
  sealed segments   ``seal()`` freezes the mutable segment into a normal
                    ``builder.build`` index on the index's device, covering
                    a contiguous global doc-id range.  A generation's
                    serving view is the concatenation of its sealed
                    segments' parts, doc-range shifted.
  tombstones        deletes set one bit in a global doc-id-indexed host
                    bitmap and are filtered at collect (``finalize``), after
                    the card's programs ran, so results equal a rebuild
                    from scratch while the programs never see a delete.
  generations       the serving state is one atomically swapped reference
                    ``_state = (Generation, MutableSegment)``.  Each
                    ``Generation`` owns its composed view and its own
                    generation-tagged ``ResidentPool`` (or per-shard pools
                    through ``ShardedIndex``).  ``carry_from`` moves the
                    surviving segments' device tensors into the new pool
                    without a second decode or upload, and part ``uid``s
                    are kept, so the layout memo keeps hitting.
  background merge  ``merge()`` decodes the snapshot segments' live
                    postings (tombstoned docs drop out here), rebuilds them
                    as one segment, stages and optionally plan-warms the
                    candidate generation off the lock, then swaps under the
                    mutation lock.  A ``hook(stage)`` seam is called at
                    every phase boundary.

Differences from the reference, all of the port's device model:

  * ``device`` (None = the CUDA card, "cpu" for the CPU) places every
    sealed segment's payloads and every generation's pools.  It is not part
    of the durable configuration, so a directory recovers on either device
    and in either package.
  * The merge's decode (``_decode_live``) goes through
    ``source.decode_staged``: a packed or StreamVByte list decodes where it
    lies (K1 or K7 on the card) and its host copy comes from there; the
    reference decodes on the host (``source.decode_padded_np``).
  * No ``backend`` argument: the port has one program (the kernels on the
    card, their plain versions on the CPU).
  * The merge thread launches on the current stream of its own thread,
    which for a new thread is the device's default stream, the one the
    serving thread launches on: the two threads' launches and the caching
    allocator's reuse stay in one stream order.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

from repro_torch.core import bitmap as bm
from repro_torch.core import codecs as codec_lib
from repro_torch.index import batch as batch_lib
from repro_torch.index import builder
from repro_torch.index import source
from repro_torch.index.builder import HybridIndex, IndexPart, TermPosting
from repro_torch.index.engine import QueryResult


_EMPTY = TermPosting("empty", None, 0)


class TermMap(dict):
    """Per-part term dict that answers *any* term id: a sealed segment was
    built against the vocabulary of its own era, so a query touching a
    newer term sees an empty posting there, not a KeyError."""

    def __missing__(self, tid):
        return _EMPTY


def _wrap_terms(index: HybridIndex) -> HybridIndex:
    for part in index.parts:
        if not isinstance(part.terms, TermMap):
            part.terms = TermMap(part.terms)
    return index


# --------------------------------------------------------------------------
# segments
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Segment:
    """One sealed, immutable doc-id range ``[doc_base, doc_hi)`` backed by a
    normal ``builder.build`` index over its local id space.  ``file`` names
    the segment's persisted raw-postings file in a ``DurableLog`` segment
    store (None while the index runs without a WAL)."""
    doc_base: int
    doc_hi: int
    index: HybridIndex
    file: "str | None" = None

    @property
    def span(self) -> int:
        return self.doc_hi - self.doc_base


class MutableSegment:
    """The append-only write buffer: per-term ascending local doc ids.
    Appends publish ``n_docs`` last, so a reader that slices postings by a
    ``cutoff`` read from ``n_docs`` sees only complete documents."""

    def __init__(self, doc_base: int):
        self.doc_base = doc_base
        self.postings: dict[int, list[int]] = {}
        self.n_docs = 0

    def add(self, terms) -> int:
        lid = self.n_docs
        for t in terms:
            self.postings.setdefault(int(t), []).append(lid)
        self.n_docs = lid + 1          # publish after postings are complete
        return self.doc_base + lid

    def intersect(self, term_ids, cutoff: int) -> np.ndarray:
        """Sorted global doc ids matching the conjunction, restricted to
        the first ``cutoff`` docs (a snapshot's consistent prefix)."""
        empty = np.zeros(0, np.int64)
        if cutoff <= 0 or not term_ids:
            return empty
        arrs = []
        for t in term_ids:
            lst = self.postings.get(int(t))
            if not lst:
                return empty
            a = np.asarray(lst, dtype=np.int64)
            a = a[: int(np.searchsorted(a, cutoff))]    # ids are ascending
            if a.size == 0:
                return empty
            arrs.append(a)
        arrs.sort(key=len)
        r = arrs[0]
        for a in arrs[1:]:
            r = np.intersect1d(r, a, assume_unique=True)
            if r.size == 0:
                break
        return r + self.doc_base


@dataclasses.dataclass
class Generation:
    """One immutable serving epoch: the composed view over sealed segments
    plus the generation-tagged residency that serves it (a ``ResidentPool``
    on one device, a ``ShardedIndex`` with per-shard pools under fan-out)."""
    gid: int
    segments: list[Segment]
    view: HybridIndex
    pool: "source.ResidentPool | None"
    sharded: object = None          # shard.ShardedIndex | None

    def residency_stats(self) -> dict:
        if self.sharded is not None:
            return self.sharded.stats()
        return self.pool.stats() if self.pool is not None else {}


@dataclasses.dataclass
class Snapshot:
    """What one batch serves against: a generation reference plus a
    consistent prefix of the mutable segment.  Grabbing it is one tuple
    read, and everything it points at is append-only or immutable."""
    gen: Generation
    mseg: MutableSegment
    cutoff: int


class MergeAborted(RuntimeError):
    """A merge hook interrupted the merge; nothing was published."""


# --------------------------------------------------------------------------
# the mutable index
# --------------------------------------------------------------------------

class MutableIndex:
    """Segmented mutable index serving through the batched engine.

    ``add``/``delete``/``seal``/``merge`` mutate under one re-entrant lock;
    queries never take it — they snapshot ``_state`` (one tuple read) and
    run against immutable or append-only structures.

    n_parts:  doc-range parts per sealed/merged segment.
    n_shards: 0 = one ``ResidentPool`` a generation; N = every generation
              is a ``ShardedIndex`` fan-out.
    device:   where segments and pools live (None = the CUDA card).
    """

    def __init__(self, *, codec_name: str = "bp-d1", B: int = 16,
                 n_parts: int = 1, n_shards: int = 0,
                 capacity_ints: int = 1 << 26,
                 varint_tail_below: int = 1024,
                 plan: "batch_lib.FusionPlan | None" = None,
                 wal=None, device=None):
        self.codec_name = codec_name
        self.B = B
        self.n_parts = max(n_parts, 1)
        self.n_shards = n_shards
        self.capacity_ints = capacity_ints
        self.varint_tail_below = varint_tail_below
        self.device = source.pool_device(device)
        self.plan = plan if plan is not None else batch_lib.FusionPlan()
        self._lock = threading.RLock()
        self._next_id = 0
        self._vocab = 0
        self._dead = np.zeros(1024, dtype=bool)
        self._n_dead = 0
        self._gen_counter = 0
        self._merging = False
        self.n_seals = 0
        self.n_merges = 0
        self._last_merge_error: str | None = None
        self._merge_failures = 0
        # with a DurableLog attached, every mutation is appended to the WAL
        # before it is applied, and seal/merge/bootstrap commit snapshots;
        # _wal_replaying suppresses appends while recovery replays
        self._wal = wal
        self._wal_replaying = False
        gen = self._new_generation([], carry=None)
        self._state: tuple[Generation, MutableSegment] = \
            (gen, MutableSegment(0))
        if wal is not None:
            wal.start_fresh()
            self._wal_checkpoint()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_postings(cls, postings: list[np.ndarray], n_docs: int,
                      **kw) -> "MutableIndex":
        """Bootstrap from a frozen corpus: one initial sealed segment over
        ``[0, n_docs)`` built exactly as ``builder.build`` would."""
        mi = cls(**kw)
        with mi._lock:
            mi._vocab = len(postings)
            mi._next_id = n_docs
            mi._ensure_dead(n_docs)
            seg = mi._build_segment(0, n_docs, list(postings))
            if mi._wal is not None:
                mi._wal.persist_segment(seg, list(postings))
            gen = mi._new_generation([seg], carry=mi._state[0])
            mi._state = (gen, MutableSegment(n_docs))
            mi._wal_checkpoint()
        return mi

    @classmethod
    def recover(cls, directory: str, **kw) -> "MutableIndex":
        """Rebuild from a ``DurableLog`` directory: the newest readable
        snapshot plus a replay of the WAL tail."""
        from repro_torch.index import durability
        return durability.recover(directory, **kw)

    # -- mutation ----------------------------------------------------------

    def _ensure_dead(self, n: int):
        if n > self._dead.shape[0]:
            grown = np.zeros(max(2 * self._dead.shape[0], n + 1024),
                             dtype=bool)
            grown[: self._dead.shape[0]] = self._dead
            self._dead = grown

    def add(self, terms) -> int:
        """Add one document; returns its (permanent) global doc id."""
        terms = [int(t) for t in terms]
        if not terms:
            raise ValueError("a document needs at least one term")
        with self._lock:
            self._wal_append("add", {"terms": terms})
            self._vocab = max(self._vocab, max(terms) + 1)
            # grow the tombstone bitmap here, so delete() always sets its
            # bit in place, where lock-free readers see it at once
            self._ensure_dead(self._next_id + 1)
            gid = self._state[1].add(terms)
            self._next_id = gid + 1
            return gid

    def delete(self, doc_id: int) -> bool:
        """Tombstone one document (idempotent).  Takes effect immediately:
        collect-time filtering reads the shared bitmap."""
        with self._lock:
            if not (0 <= doc_id < self._next_id):
                raise KeyError(f"doc id {doc_id} was never assigned")
            if self._dead[doc_id]:
                return False
            self._wal_append("delete", {"doc": int(doc_id)})
            self._dead[doc_id] = True
            self._n_dead += 1
            return True

    def seal(self) -> "Segment | None":
        """Freeze the mutable segment into a sealed one and publish a new
        generation.  The ``seal`` WAL record lands first, then the
        in-memory apply, then the snapshot checkpoint."""
        with self._lock:
            gen, mseg = self._state
            if mseg.n_docs == 0:
                return None
            self._wal_append("seal", {})
            seg = self._apply_seal()
            self._wal_checkpoint()
            return seg

    def _apply_seal(self) -> "Segment":
        """The in-memory seal (lock held, mutable segment non-empty)."""
        gen, mseg = self._state
        postings = [
            np.asarray(mseg.postings.get(t, []), dtype=np.int64)
            for t in range(self._vocab)]
        seg = self._build_segment(mseg.doc_base, mseg.n_docs, postings)
        if self._wal is not None:
            self._wal.persist_segment(seg, postings)
        new_gen = self._new_generation(gen.segments + [seg], carry=gen)
        self._state = (new_gen, MutableSegment(self._next_id))
        self.n_seals += 1
        return seg

    # -- durability hooks --------------------------------------------------

    def _wal_append(self, rtype: str, payload: dict) -> None:
        if self._wal is not None and not self._wal_replaying:
            self._wal.append(rtype, payload)

    def _wal_config(self) -> dict:
        return {"codec_name": self.codec_name, "B": self.B,
                "n_parts": self.n_parts, "n_shards": self.n_shards,
                "capacity_ints": self.capacity_ints,
                "varint_tail_below": self.varint_tail_below}

    def _wal_checkpoint(self) -> None:
        """Commit the full serving state as an atomic snapshot and rotate
        the WAL (the mutable segment is part of the snapshot)."""
        if self._wal is None or self._wal_replaying:
            return
        from repro_torch.index import durability
        with self._lock:
            gen, mseg = self._state
            entries = []
            for s in sorted(gen.segments, key=lambda s: s.doc_base):
                if s.file is None:
                    raise durability.WalError(
                        f"segment [{s.doc_base},{s.doc_hi}) was never "
                        f"persisted — cannot checkpoint")
                entries.append({"base": int(s.doc_base),
                                "hi": int(s.doc_hi), "file": s.file})
            self._wal.checkpoint({
                "config": self._wal_config(),
                "segments": entries,
                "mseg_base": mseg.doc_base,
                "mseg_n_docs": mseg.n_docs,
                "mseg_postings": mseg.postings,
                "dead_ids": np.flatnonzero(self._dead[: self._next_id]),
                "next_doc_id": self._next_id,
                "vocab": self._vocab,
                "counters": {"n_seals": self.n_seals,
                             "n_merges": self.n_merges,
                             "gen_counter": self._gen_counter},
            })

    # -- segment building / generations ------------------------------------

    def _build_segment(self, base: int, span: int,
                       postings: list[np.ndarray]) -> Segment:
        idx = builder.build(postings, span, codec_name=self.codec_name,
                            B=self.B, n_parts=min(self.n_parts, max(span, 1)),
                            varint_tail_below=self.varint_tail_below,
                            device=self.device)
        return Segment(base, base + span, _wrap_terms(idx))

    def _compose_view(self, segments: list[Segment]) -> HybridIndex:
        """The serving view: every segment's parts doc-range shifted into
        global id space, in base order, with their ``uid``s kept."""
        parts = []
        for seg in sorted(segments, key=lambda s: s.doc_base):
            for p in seg.index.parts:
                parts.append(IndexPart(doc_lo=seg.doc_base + p.doc_lo,
                                       doc_hi=seg.doc_base + p.doc_hi,
                                       terms=p.terms, device=p.device,
                                       uid=p.uid))
        return HybridIndex(n_docs=max(self._next_id, 1), B=self.B,
                           codec_name=self.codec_name, parts=parts)

    def _new_generation(self, segments: list[Segment], *,
                        carry: Generation | None,
                        pool: "source.ResidentPool | None" = None
                        ) -> Generation:
        view = self._compose_view(segments)
        with self._lock:
            gid = self._gen_counter
            self._gen_counter += 1
        if self.n_shards:
            from repro_torch.index import shard as shard_lib
            sharded = shard_lib.shard_index(
                view, self.n_shards,
                devices=None if self.device.type == "cuda" else [self.device],
                capacity_ints=self.capacity_ints, warm=True)
            return Generation(gid, segments, view, None, sharded)
        if pool is None:
            pool = source.ResidentPool(capacity_ints=self.capacity_ints,
                                       device=self.device, tag=gid)
            if carry is not None and carry.pool is not None:
                pool.carry_from(carry.pool)
        pool.tag = gid
        pool.warm(view)
        return Generation(gid, segments, view, pool, None)

    # -- background merge --------------------------------------------------

    def merge(self, *, hook=None, warm_queries=None) -> bool:
        """Compact all sealed segments of the current generation into one,
        dropping tombstoned docs, and swap the new generation in.

        Every heavy phase (decode, build, pool staging, plan warm) runs
        before the lock is taken; the locked step is the reference swap.
        ``hook(stage)`` is called at each phase boundary (``snapshot``,
        ``decode``, ``build``, ``stage``, ``warm``, ``swap``): an exception
        there aborts the merge with the old generation untouched.
        ``warm_queries`` pre-warms the candidate generation's fused
        signatures through the shared sticky plan."""
        with self._lock:
            if self._merging:
                return False
            self._merging = True
        try:
            hook = hook or (lambda stage: None)
            with self._lock:
                gen, _ = self._state
                segs = list(gen.segments)
                vocab = self._vocab
            lo = min((s.doc_base for s in segs), default=0)
            hi = max((s.doc_hi for s in segs), default=0)
            in_range = int(self._dead[lo:hi].sum()) if hi > lo else 0
            if len(segs) < 2 and in_range == 0:
                return False                   # nothing to compact
            hook("snapshot")

            postings = self._decode_live(segs, vocab, lo)
            hook("decode")
            merged = self._build_segment(lo, hi - lo, postings)
            if self._wal is not None:
                # persisted while the postings are in hand; pinned against
                # pruning until the swap checkpoint references it
                self._wal.persist_segment(merged, postings)
            hook("build")

            # stage the candidate generation off the lock: carried entries
            # keep the old generation's device tensors, merged lists pay
            # their one decode and upload here
            cand_segs = sorted([merged] + [s for s in segs
                                           if s.doc_hi > hi or s.doc_base < lo],
                               key=lambda s: s.doc_base)
            pool = None
            if not self.n_shards:
                pool = source.ResidentPool(capacity_ints=self.capacity_ints,
                                           device=self.device)
                if gen.pool is not None:
                    pool.carry_from(gen.pool)
            cand = self._new_generation(cand_segs, carry=gen, pool=pool)
            hook("stage")
            if warm_queries:
                self._warm_generation(cand, warm_queries)
            hook("warm")

            hook("swap")
            with self._lock:
                cur, mseg = self._state
                snap_set = set(map(id, segs))
                late = [s for s in cur.segments if id(s) not in snap_set]
                if late:
                    # a seal published between snapshot and swap: rebuild
                    # the generation with the late segments included
                    cand = self._new_generation(
                        sorted(cand_segs + late, key=lambda s: s.doc_base),
                        carry=cand, pool=cand.pool)
                self._state = (cand, mseg)
                self.n_merges += 1
                self._wal_checkpoint()
            return True
        finally:
            with self._lock:
                self._merging = False

    def merge_async(self, *, retries: int = 2,
                    retry_backoff_s: float = 0.05,
                    max_backoff_s: float = 2.0, **kw) -> threading.Thread:
        """Run ``merge`` on a daemon thread (serving continues lock-free
        while it compacts); join the returned thread to wait for it.  A
        failure is recorded in ``counters()['last_merge_error']`` (cleared
        on the next success), ``merge_failures`` is bumped, and the merge is
        retried up to ``retries`` times with capped exponential backoff."""
        def run():
            delay = retry_backoff_s
            for attempt in range(retries + 1):
                try:
                    self.merge(**kw)
                except Exception as e:       # noqa: BLE001 — surfaced below
                    with self._lock:
                        self._last_merge_error = f"{type(e).__name__}: {e}"
                        self._merge_failures += 1
                    if attempt == retries:
                        return
                    time.sleep(delay)
                    delay = min(delay * 2, max_backoff_s)
                else:
                    with self._lock:
                        self._last_merge_error = None
                    return

        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    def _decode_live(self, segs: list[Segment], vocab: int,
                     base: int) -> list[np.ndarray]:
        """Decode every segment's postings back to global doc ids, drop
        tombstoned docs, and re-base to the merged span.  Lists decode where
        they lie (``source.decode_staged``: K1 or K7 on the card), bitmaps
        from their host copy."""
        acc: list[list[np.ndarray]] = [[] for _ in range(vocab)]
        dead = self._dead
        for seg in sorted(segs, key=lambda s: s.doc_base):
            codec = codec_lib.get_codec(seg.index.codec_name)
            for part in seg.index.parts:
                off = seg.doc_base + part.doc_lo
                for tid, tp in part.terms.items():
                    if tp.kind == "empty" or tid >= vocab:
                        continue
                    if tp.kind == "bitmap":
                        loc = bm.extract_np(source.bitmap_host(tp))
                    else:
                        _, vals, n = source.decode_staged(codec, tp,
                                                          part.device)
                        loc = vals[:n]
                    g = loc.astype(np.int64) + off
                    g = g[~dead[g]]
                    if g.size:
                        acc[tid].append(g - base)
        return [np.concatenate(a) if a else np.zeros(0, np.int64)
                for a in acc]

    def _warm_generation(self, gen: Generation, queries):
        """Drive the candidate generation through the shared sticky plan to
        the signature fixed point before it is published, walking the same
        ×1.5 batch-row ladder as ``server.warm_server``."""
        snap = Snapshot(gen, MutableSegment(self._next_id), 0)
        sizes, b = [], 1
        while b < len(queries):
            sizes.append(b)
            b = b * 3 // 2 if b >= 2 else b + 1
        sizes.append(len(queries))

        def one_pass(stats):
            for size in sizes:
                for lo in range(0, len(queries), size):
                    chunk = queries[lo: lo + size]
                    groups = self.schedule(snap, chunk, stats=stats)
                    groups = batch_lib.fuse_groups(groups, plan=self.plan,
                                                   stats=stats)
                    batch_lib.collect_batch(self.launch(
                        snap, groups, len(chunk), stats=stats))

        batch_lib.warm_to_fixed_point(one_pass)

    # -- serving -----------------------------------------------------------

    def snapshot(self) -> Snapshot:
        gen, mseg = self._state
        return Snapshot(gen, mseg, mseg.n_docs)

    def schedule(self, snap: Snapshot, queries, *, stats=None, cache=None):
        """``batch.schedule`` over the snapshot generation (raw groups: the
        caller fuses, so admission accounting stays possible)."""
        gen = snap.gen
        pool = (gen.sharded.pool_map if gen.sharded is not None
                else gen.pool)
        return batch_lib.schedule(gen.view, queries, cache=cache,
                                  stats=stats, pool=pool)

    def launch(self, snap: Snapshot, groups, n_queries: int, *,
               max_results: int = 1 << 16,
               max_group_size: int = batch_lib.MAX_GROUP_SIZE,
               stats=None) -> "batch_lib.PendingBatch":
        gen = snap.gen
        if gen.sharded is not None:
            from repro_torch.index import shard as shard_lib
            return shard_lib.launch_groups_sharded(
                gen.sharded, groups, n_queries=n_queries,
                max_results=max_results, max_group_size=max_group_size,
                stats=stats)
        return batch_lib.launch_groups(
            groups, n_queries=n_queries, max_results=max_results,
            max_group_size=max_group_size, pool=gen.pool, stats=stats)

    def finalize(self, snap: Snapshot, queries, results,
                 max_results: int = 1 << 16) -> list[QueryResult]:
        """Collect-time completion on the host: filter tombstones out of
        the sealed hits, append the mutable segment's hits (the highest
        doc ids, so concatenation stays sorted), and recount."""
        dead = self._dead
        out = []
        for q, r in zip(queries, results):
            docs = r.docs
            if docs.size:
                docs = docs[~dead[docs]]
            mdocs = snap.mseg.intersect(q, snap.cutoff)
            if mdocs.size:
                mdocs = mdocs[~dead[mdocs]]
                docs = np.concatenate([docs, mdocs]) if docs.size else mdocs
            out.append(QueryResult(count=int(docs.size),
                                   docs=docs[:max_results]))
        return out

    def execute_batch(self, queries, *, fuse: bool = True, stats=None,
                      cache=None, max_results: int = 1 << 16
                      ) -> list[QueryResult]:
        """One-call serving path, equal to rebuilding the live corpus from
        scratch and running ``batch.execute_batch`` on it."""
        snap = self.snapshot()
        groups = self.schedule(snap, queries, stats=stats, cache=cache)
        if fuse:
            groups = batch_lib.fuse_groups(groups, plan=self.plan,
                                           stats=stats)
        pending = self.launch(snap, groups, len(queries), stats=stats)
        results = batch_lib.collect_batch(pending)
        return self.finalize(snap, queries, results, max_results)

    def warm(self, queries, *, fuse: bool = True) -> dict:
        """Warm the current generation's signatures (and pools) to the
        fixed point through the same path serving uses."""
        t0 = time.perf_counter()
        c0 = batch_lib._compile_count()
        n_sigs, passes, converged = batch_lib.warm_to_fixed_point(
            lambda s: self.execute_batch(queries, fuse=fuse, stats=s))
        return {"n_compiles": batch_lib._compile_count() - c0,
                "n_signatures": n_sigs, "passes": passes,
                "converged": converged,
                "time_s": time.perf_counter() - t0}

    # -- introspection -----------------------------------------------------

    @property
    def next_doc_id(self) -> int:
        return self._next_id

    @property
    def generation(self) -> int:
        return self._state[0].gid

    def live_postings(self) -> list[np.ndarray]:
        """The rebuild-from-scratch oracle's input: per-term sorted global
        doc ids of every live document (decodes sealed payloads)."""
        with self._lock:
            gen, mseg = self._state
            vocab = self._vocab
            cutoff = mseg.n_docs
        sealed = self._decode_live(gen.segments, vocab, 0)
        dead = self._dead
        out = []
        for t in range(vocab):
            parts = [sealed[t]] if sealed[t].size else []
            lst = mseg.postings.get(t)
            if lst:
                a = np.asarray(lst, dtype=np.int64)
                a = a[: int(np.searchsorted(a, cutoff))] + mseg.doc_base
                a = a[~dead[a]]
                if a.size:
                    parts.append(a)
            out.append(np.concatenate(parts) if parts
                       else np.zeros(0, np.int64))
        return out

    def counters(self) -> dict:
        """Segment, tombstone and generation counters."""
        gen, mseg = self._state
        return {"generation": gen.gid,
                "n_segments": len(gen.segments),
                "mutable_docs": mseg.n_docs,
                "tombstones": self._n_dead,
                "next_doc_id": self._next_id,
                "vocab": self._vocab,
                "n_seals": self.n_seals,
                "n_merges": self.n_merges,
                "last_merge_error": self._last_merge_error,
                "merge_failures": self._merge_failures}

    def stats(self) -> dict:
        gen, _ = self._state
        return {**self.counters(),
                "residency": gen.residency_stats(),
                "index": gen.view.stats() if gen.view.parts else {}}
