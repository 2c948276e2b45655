"""Batched query execution: shape-bucketed scheduling and SvS on the card.

Port of ``src/repro/index/batch.py`` with the reference's
``backend="pallas"`` program, without a pool and with a ``ResidentPool``:

  1. **Schedule.** Every (query, index-part) work item gets a shape
     signature (``GroupKey``): pow2 bucket of the seed list M, of the longest
     decoded fold N, bitmap word count W, the ratio algorithm, and the
     packed block layout of its long skip-capable folds (k/t/c/e pads, block
     rows, delta mode).  Terms resolve through ``index.source``: short lists
     decode on the card (and cache, or stage in the pool), long skip-capable
     lists stay packed with their candidate block ids searched on the host.
     Pool entries carry their host copy, so the seeds' values are read
     there; only seeds without one (no pool, cache hits) cross to the host,
     all together in one copy per batch.
  2. **Fuse.** ``fuse_groups`` coarsens keys into families — (kind, packed
     block geometry) — at family-ceiling buckets, kept monotone across
     batches by a sticky ``FusionPlan``, so a batch launches O(#families)
     programs.
  3. **Execute.** Each group chunk's operands are assembled on the card.
     Without a pool: seed rows into a SENTINEL-filled (Bp, M) tensor,
     decoded folds into a SENTINEL-filled (J, Bp, N) stack, packed folds
     into zero-extended (Jp, Bp, ...) stacks from the memoized device
     layouts (``source.cached_layout_dev``), bitmaps into an all-ones
     (Jb, Bp, W) stack.  With a pool each operand is one ``index_select``
     gather from a ``source.RowArena`` (the reference's ``_GATHER``), or,
     for sources without a host copy, a stack of the pool's padded rows.
     Only block ids, gather ids and active flags cross to the card, from
     pinned memory without waiting for it.  The program ANDs K4 (decoded
     folds, ``ops.intersect_fold_batch``), K5 (packed folds,
     ``ops.intersect_packed_fold``) and the bitmap probes into one validity
     mask over the seed row, and ``ops.compact_rows`` moves each row's
     survivors to the front of a row of min(M, max_results) columns, with
     the full count in the last (the reference leaves the extraction of the
     M-wide row to the host); all-bitmap items AND their words and popcount
     each row.  Right after its program, each chunk's result starts its
     copy into pinned host memory and records a CUDA event: nothing in
     ``schedule`` or ``launch_groups`` waits for the card.
  4. **Aggregate.** ``collect_batch`` waits for each chunk's event alone,
     reads each svs row's prefix of survivors (each item keeps its first
     min(count, max_results), so the concatenation cut to ``max_results``
     is the reference's), and re-assembles per-query results in part order,
     byte-identical to ``engine.query``; shard-pad slots (None) are
     skipped.

Invariants, as in the reference: a ``GroupKey`` describes shapes only
(residency, arenas and sharding never change one); padding (SENTINEL rows,
inactive fold slots, all-pad packed slots, all-ones probe rows) never
contributes to a real row's result; results concatenate in part order.

Program count.  The reference's ``_compile_count`` reads JAX's jit caches.
The port compiles nothing per shape: its kernels are built once per process
by ``nvcc`` and take every shape at run time.  So ``_compile_count`` counts
the distinct program signatures (kind, key, Bp, J, Jb, Jp) launched so far
in the process, plus the kernel libraries this process built
(``kernels._build.BUILDS``).  A steady state after ``warmup`` reports 0
exactly when it launches no shape and builds no library that warmup did not.

Not ported (ROADMAP): the interpret-mode occupancy guard
(``PALLAS_MIN_OCCUPANCY``, ``pallas_occupancy``, ``_effective_backend``) and
the ``backend="jax"`` program, since the port has no ``backend`` switch (the
kernels run on the card and their plain versions on the CPU); the JAX-only
candidate donation and jitted row stackers.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import codecs as codec_lib
from repro_torch.core import intersect as its
from repro_torch.index import source
from repro_torch.index.builder import HybridIndex
from repro_torch.index.engine import QueryResult
from repro_torch.kernels import _build, ops

MAX_GROUP_SIZE = 128          # hard cap on items per device program
GROUP_INT_BUDGET = 1 << 25    # cap operand ints per program: B·(J·N+M+J_b·W)
BATCH_TILED_MAX_RATIO = 4.0   # the reference's batched ratio rule
SENT = int(its.SENTINEL)

# every program signature launched in this process (see "Program count")
_PROGRAMS: set = set()


@dataclasses.dataclass(frozen=True)
class GroupKey:
    """Shape signature shared by all work items of one device program.
    Term counts are not part of the key: queries of different arity merge
    into one program, padded with inactive folds and all-ones bitmap rows.
    ``packed`` is (k_pad, t_pad, c_pad, e_pad, block_rows, mode); ``fused``
    holds the arity ceilings of a fused key — (J, Jb, Jp) for 'svs', (J,)
    for 'bitmap' — and is None on a scheduled key."""
    kind: str              # 'svs' (≥1 list term) | 'bitmap' (all-bitmap)
    m_bucket: int          # candidate buffer length M
    n_bucket: int          # decoded fold-list pad length N
    words: int             # bitmap word count W (0 when no bitmaps)
    algo: str              # 'tiled' | 'gallop' | '-'
    packed: tuple | None = None
    fused: tuple | None = None


@dataclasses.dataclass
class _Item:
    qi: int                            # query index within the batch
    pi: int                            # index-part ordinal (aggregation order)
    doc_lo: int
    r: torch.Tensor | None = None      # (M,) seed values on the card
    folds: list | None = None          # no pool: J × decoded (own pow2
                                       # length,) rows; pool: J ×
                                       # DecodedSource (padded at assembly)
    psrc: list | None = None           # Jp × (layout, raw candidate block
                                       # ids); layout: the device layout at
                                       # the list's self pads (no pool) or
                                       # the PackedSource (pool: arenas)
    bm_words: list | None = None       # no pool: J_b × (W,) bitmap rows
    bm_dev: list | None = None         # pool: J_b × (W,) resident rows
    bm_keys: list | None = None        # pool: J_b × pool key
    rsrc: object = None                # pool: the seed DecodedSource


def _bucket_rows(b: int) -> int:
    """Batch-dim bucket: ~×1.5 geometric ladder (1,2,3,4,6,9,13,19,28,…)."""
    size = 1
    while size < b:
        size = size * 3 // 2 if size >= 2 else size + 1
    return size


def _n_bitmaps(it: _Item) -> int:
    return (len(it.bm_words) if it.bm_words is not None
            else len(it.bm_dev) if it.bm_dev is not None else 0)


def _seeds_to_host(seeds: list) -> list[np.ndarray]:
    """The valid values of every seed: a source's host copy where it is
    taken; the rest (no copy, or a pool entry's ``source.HostCopy`` not
    read yet) copied to the host together, in one copy, which each
    ``HostCopy`` keeps."""
    keys = [id(s.vals_np) if s.vals_np is not None else id(s) for s in seeds]
    missing = {k: s for k, s in zip(keys, seeds)
               if not source.host_taken(s.vals_np)}
    heads = {}
    if missing:
        flat = torch.cat([s.vals[: s.n]
                          for s in missing.values()]).cpu().numpy()
        heads = dict(zip(missing, np.split(flat, np.cumsum(
            [s.n for s in missing.values()])[:-1])))
        for k, s in missing.items():
            if isinstance(s.vals_np, source.HostCopy):
                s.vals_np.put(heads[k])
    return [heads[k] if k in heads else s.vals_np[: s.n]
            for k, s in zip(keys, seeds)]


def schedule(index: HybridIndex, queries: list[list[int]], cache=None,
             skip: bool = True, stats: dict | None = None,
             pool: "source.ResidentPool | None" = None
             ) -> dict[GroupKey, list[_Item]]:
    """Bucket every (query, part) work item by shape signature.  Terms
    resolve through the posting-source layer on the index's device.  With a
    ResidentPool items carry resident sources (and their host copies);
    without one, device tensors.  ``pool`` may also be an object with
    ``for_part(pi)`` (``shard.PartPools``: one pool per shard)."""
    codec = codec_lib.get_codec(index.codec_name)
    pool_of = (pool.for_part if hasattr(pool, "for_part")
               else (lambda pi: pool))
    if pool is not None and stats is not None:
        for k in source.POOL_COUNTERS:
            stats.setdefault(k, 0)
    work = []      # per item: (qi, pi, part, pool, seed, dec, packed,
    #                            bitmaps, W)
    for qi, term_ids in enumerate(queries):
        for pi, part in enumerate(index.parts):
            ppool = pool_of(pi)
            tps = [part.terms[t] for t in term_ids]
            if any(tp.kind == "empty" for tp in tps):
                continue
            pairs = sorted(((t, tp) for t, tp in zip(term_ids, tps)
                            if tp.kind == "list"), key=lambda p: p[1].n)
            bm_pairs = [(t, tp) for t, tp in zip(term_ids, tps)
                        if tp.kind == "bitmap"]
            W = int(bm_pairs[0][1].payload.shape[0]) if bm_pairs else 0
            bitmaps = None
            if bm_pairs and ppool is not None:
                # keys and the staged rows themselves: the arena assembler
                # must not depend on store residency (a small pool evicts
                # between schedule and assembly)
                keys = [("bm", part.uid, t) for t, _ in bm_pairs]
                bitmaps = (keys, [ppool.stage_bitmap(k, source.bitmap_host(tp),
                                                     dev=tp.payload,
                                                     stats=stats)
                                  for k, (_, tp) in zip(keys, bm_pairs)])
            elif bm_pairs:
                bitmaps = [tp.payload for _, tp in bm_pairs]
            if not pairs:
                work.append((qi, pi, part, ppool, None, None, None, bitmaps,
                             W))
                continue
            seed_t, seed_tp = pairs[0]
            seed = source.resolve(part, seed_t, seed_tp, codec, cache=cache,
                                  r_count=None, stats=stats, pool=ppool)
            dec, packed = [], []
            for t, tp in pairs[1:]:
                src = source.resolve(part, t, tp, codec, cache=cache,
                                     r_count=seed_tp.n, skip=skip,
                                     stats=stats, pool=ppool)
                (packed if isinstance(src, source.PackedSource)
                 else dec).append((t, tp, src))
            dec = [s for _, _, s in dec]
            keep = []
            if packed:
                # one block geometry per fold stack: keep the longest fold's
                # (block_rows, mode) and decode the rare mismatch, uncached
                # and unstaged (staged, it would win over the skip path);
                # with a pool it keeps a host copy (taken if read), so its
                # group is gathered from the arenas as a staged list's is
                ref = max(packed, key=lambda p: p[2].n)[2]
                for t, tp, s in packed:
                    if (s.block_rows, s.mode) == (ref.block_rows, ref.mode):
                        keep.append(s)
                        continue
                    d = source.resolve(part, t, tp, codec, cache=None,
                                       skip=False, stats=stats)
                    if ppool is not None:
                        d.vals_np = source.HostCopy(d.vals)
                    dec.append(d)
            work.append((qi, pi, part, ppool, seed, dec, keep, bitmaps, W))
    host = iter(_seeds_to_host([w[4] for w in work if w[6]]))
    groups: dict[GroupKey, list[_Item]] = defaultdict(list)
    for qi, pi, part, ppool, seed, dec, keep, bitmaps, W in work:
        bm_words = bm_dev = bm_keys = None
        if ppool is not None and bitmaps:
            bm_keys, bm_dev = bitmaps
        else:
            bm_words = bitmaps
        if seed is None:
            key = GroupKey("bitmap", 0, 0, W, "-")
            groups[key].append(_Item(qi, pi, part.doc_lo, bm_words=bm_words,
                                     bm_dev=bm_dev, bm_keys=bm_keys))
            continue
        M = seed.vals.shape[0]
        psig = psrc = None
        if keep:
            r_valid = next(host)
            cand = [(s, s.candidate_block_ids(r_valid)) for s in keep]
            k_pad = max(s.self_pads()[0] for s, _ in cand)
            t_pad = max(s.self_pads()[1] for s, _ in cand)
            c_pad = max(its.pow2_bucket(len(b), floor=source.CAND_FLOOR)
                        for _, b in cand)
            e_max = max(s.num_exceptions for s, _ in cand)
            e_pad = its.pow2_bucket(e_max, floor=1) if e_max else 0
            psig = (k_pad, t_pad, c_pad, e_pad, keep[0].block_rows,
                    keep[0].mode)
            # the pool keeps the PackedSource (its layout rows go to the
            # arenas at the launching key's pads); without one, the memoized
            # device layout at the list's own pads
            psrc = (cand if ppool is not None else
                    [(source.cached_layout_dev(s, s.self_pads(), stats), b)
                     for s, b in cand])
            # decoded_ints of packed folds is counted at launch, at the
            # launching key's c_pad (fusion may raise it)
            source._bump(stats, "skip_folds", len(psrc))
        N = max((s.vals.shape[0] for s in dec), default=128)
        algo = "tiled" if N / M <= BATCH_TILED_MAX_RATIO else "gallop"
        key = GroupKey("svs", M, N, W, algo, psig)
        groups[key].append(_Item(
            qi, pi, part.doc_lo, r=seed.vals,
            folds=dec if ppool is not None else [s.vals for s in dec],
            psrc=psrc, bm_words=bm_words, bm_dev=bm_dev, bm_keys=bm_keys,
            rsrc=seed if ppool is not None else None))
    return groups


# --------------------------------------------------------------------------
# device programs (one per GroupKey chunk)
# --------------------------------------------------------------------------

def _svs_program(r, folds, fold_active, pk, pk_active, words, mode: str,
                 block_rows: int, max_results: int) -> torch.Tensor:
    """Decoded folds (K4) → packed folds (K5) → bitmap probes, each ANDed
    into one validity mask over the seed rows ``r`` (Bp, M), then
    compacted (``ops.compact_rows``).  Returns (Bp, C + 1) int32, C =
    min(M, max_results): each row's first min(count, C) surviving values,
    in order, SENTINEL after them, and in the last column the full count."""
    valid = r != SENT
    valid = ops.intersect_fold_batch(r, valid, folds, fold_active)
    if pk is not None:
        valid = ops.intersect_packed_fold(r, valid, pk, pk_active, mode=mode,
                                          block_rows=block_rows)
    if words is not None:
        for w in words:
            valid = bm.probe_batched(w, r, valid)
    return ops.compact_rows(r, valid, max_results)


def _bitmap_and_program(words) -> torch.Tensor:
    """All-bitmap items: AND-reduce (Bp, J, W) words.  Returns (Bp, W + 1)
    int32: the ANDed words and, in the last column, their popcount."""
    out = words[:, 0]
    for j in range(1, words.shape[1]):
        out = out & words[:, j]
    counts = bm.popcount_rows(out).to(torch.int32)
    return torch.cat([out, counts[:, None]], 1)


def _stack_packed(key: GroupKey, items: list[_Item], Bp: int, device,
                  jp: int | None = None):
    """Stack the items' packed layouts into (Jp, Bp, ...) operands on the
    card.  Each slot zero-extends its self-padded device layout into the
    key's pads (which fusion may have raised): pad blocks have width 0 and
    are never candidates.  Candidate block ids pad with the out-of-range
    id ``k_pad`` (all-SENTINEL decode); inactive slots stay all-pad and are
    masked by the active flags.  Returns (six device stacks in a device
    layout's order — words, widths, offsets, maxes, exc_pos, exc_add —,
    host candidate block ids, host active flags)."""
    k_pad, t_pad, c_pad, e_pad, _, _ = key.packed
    Jp = (max((len(it.psrc) for it in items), default=0)
          if jp is None else jp)
    z = dict(dtype=torch.int32, device=device)
    stacked = [torch.zeros((Jp, Bp, t_pad, 128), **z),
               torch.zeros((Jp, Bp, k_pad), **z),
               torch.zeros((Jp, Bp, k_pad), **z),
               torch.zeros((Jp, Bp, k_pad), **z),
               torch.full((Jp, Bp, e_pad), -1, **z),
               torch.zeros((Jp, Bp, e_pad), **z)]
    PBk = np.full((Jp, Bp, c_pad), k_pad, np.int32)
    active = np.zeros((Jp, Bp), bool)
    for b, it in enumerate(items):
        for j, (lay, blk) in enumerate(it.psrc):
            for dst, src in zip(stacked, lay):
                if src.shape[0]:
                    dst[j, b, : src.shape[0]] = src
            PBk[j, b, : blk.shape[0]] = blk
            active[j, b] = True
    return stacked, PBk, active


def _stack_packed_arena(key: GroupKey, items: list[_Item], Bp: int,
                        pool: "source.ResidentPool", jp: int | None = None,
                        stats: dict | None = None):
    """Pool-mode packed stacking: each of the six layout operands is one
    gather from its ``RowArena`` at the key's pads with one (Jp·Bp,) id
    vector — slot 0 is the all-pad layout, so inactive grid positions
    decode to SENTINEL as in ``_stack_packed``.  A list's rows join the
    arenas the first time it is gathered, written on the device from its
    payload's own arrays (``source.layout_device_rows``).  Returns what
    ``_stack_packed`` returns."""
    k_pad, t_pad, c_pad, e_pad, _, _ = key.packed
    pads = (k_pad, t_pad, e_pad)
    Jp = (max((len(it.psrc) for it in items), default=0)
          if jp is None else jp)
    arenas = [pool.layout_arena(pads, o) for o in range(6)]
    idx = np.zeros((Jp, Bp), np.int32)          # 0 = all-pad layout slot
    PBk = np.full((Jp, Bp, c_pad), k_pad, np.int32)
    active = np.zeros((Jp, Bp), bool)
    for b, it in enumerate(items):
        for j, (src, blk) in enumerate(it.psrc):
            slot = arenas[0].slots.get(src.key)
            if slot is None:
                rows = source.layout_device_rows(src.payload)
                for a, row in zip(arenas, rows):
                    slot = a.slot(src.key, lambda r=row: r, stats)
            idx[j, b] = slot
            PBk[j, b, : blk.shape[0]] = blk
            active[j, b] = True
    return [a.gather(idx) for a in arenas], PBk, active


def _compose_pk(stacked, PBk: torch.Tensor) -> tuple:
    """K5's operand order: words, widths, offsets, maxes, candidate block
    ids, exc_pos, exc_add."""
    return (*stacked[:4], PBk, *stacked[4:])


def _arena_ok(items: list[_Item]) -> bool:
    """Arena assembly takes value rows that carry a host copy (taken or
    not) and a pool key; cache-hit sources carry no copy, so groups holding
    one stack the pool's padded rows instead, as the reference's do."""
    for it in items:
        if it.rsrc is None or it.rsrc.vals_np is None or not it.rsrc.key:
            return False
        for f in it.folds:
            if f.vals_np is None or not f.key:
                return False
    return True


def _extend_dev(row: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    if row.shape[0] == size:
        return row
    out = torch.full((size,), fill, dtype=row.dtype, device=row.device)
    out[: row.shape[0]] = row
    return out


def _assemble_svs(key: GroupKey, items: list[_Item], pool=None, *,
                  bp: int | None = None, j: int | None = None,
                  jb: int | None = None, jp: int | None = None,
                  device=None, stats: dict | None = None):
    """The operands of one svs group chunk on the card.  Without a pool they
    are stacked from the items' device rows; with one, each is gathered
    from the pool's arenas, a row joining its arena by a device write from
    the source's own tensor (or, for sources without a host copy, stacked
    from the pool's padded rows); ``stats`` takes the pool's counters.
    Rows narrower than the key's buckets extend with SENTINEL / zero-word
    filler, inert by the padding invariant.  ``bp``/``j``/``jb``/``jp``
    override the chunk-derived paddings (the sharded launcher assembles
    uniform per-shard slices, some of them empty, on ``device``); fused
    keys pin the arity ceilings.
    Returns (R, F, host active flags, packed parts or None, W or None, Bp,
    J, Jb)."""
    B = len(items)
    kj, kjb, kjp = key.fused if key.fused else (None, None, None)
    Bp = _bucket_rows(B) if bp is None else bp
    j = kj if j is None else j
    jb = kjb if jb is None else jb
    jp = kjp if jp is None else jp
    J = max((len(it.folds) for it in items), default=0) if j is None else j
    Jb = (max((_n_bitmaps(it) for it in items), default=0)
          if jb is None else jb)
    if device is None:
        device = pool.device if pool is not None else items[0].r.device
    M, N, Wd = key.m_bucket, key.n_bucket, key.words
    active = np.zeros((J, Bp), dtype=bool)
    W = None
    if pool is not None and _arena_ok(items):
        fa_m = pool.fold_arena(M)
        ridx = np.zeros(Bp, np.int32)               # 0 = SENTINEL row
        for b, it in enumerate(items):
            ridx[b] = fa_m.slot(it.rsrc.key, lambda s=it.rsrc: (s.vals, SENT),
                                stats)
        R = fa_m.gather(ridx)
        fidx = np.zeros((J, Bp), np.int32)
        if J:
            fa_n = pool.fold_arena(N)
            for b, it in enumerate(items):
                for jj, f in enumerate(it.folds):
                    fidx[jj, b] = fa_n.slot(f.key, lambda s=f: (s.vals, SENT),
                                            stats)
                    active[jj, b] = True
            F = fa_n.gather(fidx)
        else:
            F = torch.zeros((0, Bp, N), dtype=torch.int32, device=device)
        if Jb:
            wa = pool.bitmap_arena(Wd)
            widx = np.zeros((Jb, Bp), np.int32)     # 0 = probe identity
            for b, it in enumerate(items):
                for jj, bk in enumerate(it.bm_keys or ()):
                    widx[jj, b] = wa.slot(
                        bk, lambda w=it.bm_dev[jj]: (w, 0), stats)
            W = wa.gather(widx)
    elif pool is not None:
        R = torch.stack([pool.padded(it.rsrc, M, stats) for it in items]
                        + [pool.sentinel_row(M)] * (Bp - B))
        rows = []
        for jj in range(J):
            for b in range(Bp):
                it = items[b] if b < B else None
                if it is not None and jj < len(it.folds):
                    rows.append(pool.padded(it.folds[jj], N, stats))
                    active[jj, b] = True
                else:
                    rows.append(pool.sentinel_row(N))
        F = (torch.stack(rows).reshape(J, Bp, N) if J else
             torch.zeros((0, Bp, N), dtype=torch.int32, device=device))
        if Jb:
            # inactive slots are all-ones rows, the probe identity
            W = torch.stack([
                _extend_dev(items[b].bm_dev[jj], Wd, 0)
                if b < B and jj < _n_bitmaps(items[b])
                else pool.ones_row(Wd)
                for jj in range(Jb) for b in range(Bp)]).reshape(Jb, Bp, Wd)
    else:
        R = torch.full((Bp, M), SENT, dtype=torch.int32, device=device)
        F = torch.full((J, Bp, N), SENT, dtype=torch.int32, device=device)
        for b, it in enumerate(items):
            R[b, : it.r.shape[0]] = it.r
            for jj, fold in enumerate(it.folds):
                F[jj, b, : fold.shape[0]] = fold
                active[jj, b] = True
        if Jb:
            # inactive slots are all-ones rows, the probe identity; the
            # zero extension past a real row's own W is never probed
            W = torch.full((Jb, Bp, Wd), -1, dtype=torch.int32,
                           device=device)
            for b, it in enumerate(items):
                for jj, w in enumerate(it.bm_words or ()):
                    W[jj, b, : w.shape[0]] = w
                    W[jj, b, w.shape[0]:] = 0
    pkparts = None
    if key.packed is not None:
        pkparts = (_stack_packed_arena(key, items, Bp, pool, jp=jp,
                                       stats=stats)
                   if pool is not None else
                   _stack_packed(key, items, Bp, device, jp=jp))
    return R, F, active, pkparts, W, Bp, J, Jb


def _svs_launch_args(key: GroupKey, items: list, pkparts, stats):
    """(mode, block_rows, Jp) of a chunk's packed folds, counting the
    decoded ints of its packed slots: every active slot decodes c_pad
    blocks at the LAUNCHING key's bucket."""
    if pkparts is None:
        return "d1", 32, 0
    rows, mode = key.packed[4], key.packed[5]
    source._bump(stats, "decoded_ints",
                 sum(len(it.psrc) for it in items if it is not None)
                 * key.packed[2] * rows * 128)
    return mode, rows, pkparts[2].shape[0]


def _launch_svs_group(key: GroupKey, items: list[_Item], pool,
                      stats: dict | None, timings, max_results: int
                      ) -> torch.Tensor:
    """Assemble and launch one svs chunk; ``timings`` (a
    ``pipeline.StageTimings``) takes the assembly and the launch apart."""
    with source.span(timings, "batch.assemble"):
        R, F, active, pkparts, W, Bp, J, Jb = _assemble_svs(key, items, pool,
                                                            stats=stats)
        device = R.device
        pk = pk_active = None
        mode, rows, Jp = _svs_launch_args(key, items, pkparts, stats)
        if pkparts is not None:
            stacked, PBk, pk_act = pkparts
            pk = _compose_pk(stacked, its.to_device(PBk, device))
            pk_active = its.to_device(pk_act, device)
        active = its.to_device(active, device)
        if stats is not None:
            stats.setdefault("signatures", set()).add(("svs", key, Bp, J, Jb))
        _PROGRAMS.add(("svs", key, Bp, J, Jb, Jp))
    with source.span(timings, "batch.dispatch"):
        return _svs_program(R, F, active, pk, pk_active, W, mode, rows,
                            max_results)


def _assemble_bitmap(key: GroupKey, items: list[_Item], pool=None, *,
                     bp: int | None = None, j: int | None = None,
                     device=None, stats: dict | None = None):
    """(Bp, J, W) word stack of one all-bitmap chunk on the card: real rows
    pad missing terms with all-ones (the AND identity) over their own W;
    padded rows, and every row past its own W, stay zero (popcount 0).
    With a pool it is one gather from the pool's bitmap arena (slot 0 all
    ones, slot 1 all zero).  ``bp``/``j`` override the chunk-derived
    paddings for sharded per-shard slices (on ``device``)."""
    B = len(items)
    Bp = _bucket_rows(B) if bp is None else bp
    if j is None and key.fused:
        j = key.fused[0]
    J = max((_n_bitmaps(it) for it in items), default=1) if j is None else j
    Wd = key.words
    if pool is not None:
        wa = pool.bitmap_arena(Wd)
        widx = np.full((Bp, J), source.ResidentPool.BM_ONES_SLOT, np.int32)
        widx[B:, :] = source.ResidentPool.BM_ZERO_SLOT
        for b, it in enumerate(items):
            for jj, bk in enumerate(it.bm_keys):
                widx[b, jj] = wa.slot(bk, lambda w=it.bm_dev[jj]: (w, 0),
                                      stats)
        return wa.gather(widx), Bp, J
    if device is None:
        device = items[0].bm_words[0].device
    words = torch.zeros((Bp, J, Wd), dtype=torch.int32, device=device)
    for b, it in enumerate(items):
        wr = it.bm_words[0].shape[0]
        words[b, :, :wr] = -1
        for jj, w in enumerate(it.bm_words):
            words[b, jj, :wr] = w
    return words, Bp, J


def _launch_bitmap_group(key: GroupKey, items: list[_Item], pool,
                         stats: dict | None, timings=None) -> torch.Tensor:
    with source.span(timings, "batch.assemble"):
        words, Bp, J = _assemble_bitmap(key, items, pool, stats=stats)
        if stats is not None:
            stats.setdefault("signatures", set()).add(("bm", key, Bp, J))
        _PROGRAMS.add(("bm", key, Bp, J, 0, 0))
    with source.span(timings, "batch.dispatch"):
        return _bitmap_and_program(words)


def _chunk_size(key: GroupKey, items: list[_Item],
                max_group_size: int) -> int:
    """Items per device program: flat cap ∧ operand-int budget (so huge J·N
    stacks and packed words shrink the batch instead of exhausting device
    memory).  Fused keys budget at their arity ceilings.  The budget still
    counts the reference's decode window of the packed folds, which K5 no
    longer allocates, so that the port's chunks, and its dispatch counts,
    stay the reference's."""
    if key.kind == "bitmap":
        J = (key.fused[0] if key.fused else
             max(_n_bitmaps(it) for it in items))
        per_item = J * key.words
    else:
        if key.fused:
            J, Jb, Jp = key.fused
        else:
            J = max(len(it.folds) for it in items)
            Jb = max(_n_bitmaps(it) for it in items)
        per_item = J * key.n_bucket + key.m_bucket + Jb * key.words
        if key.packed is not None:
            k_pad, t_pad, c_pad, e_pad, rows, _ = key.packed
            if not key.fused:
                Jp = max(len(it.psrc) for it in items)
            # compressed words + per-block metadata + the reference's decode
            # window (c_pad blocks of rows×128 per slot)
            per_item += Jp * (t_pad * 128 + 3 * k_pad + c_pad
                              + 2 * e_pad + c_pad * rows * 128)
    return max(1, min(max_group_size, GROUP_INT_BUDGET // max(per_item, 1)))


# --------------------------------------------------------------------------
# megagroup fusion
# --------------------------------------------------------------------------

def _pow2_ceil(x: int) -> int:
    """Next power of two ≥ x (0 stays 0): fused arity ceilings."""
    return its.pow2_bucket(x, floor=1) if x > 0 else 0


class FusionPlan:
    """Sticky fused-dimension ceilings, one entry per signature family.
    Every batch raises its family's dims to at least everything seen before,
    so fused signatures converge to a fixed point.  Create one per serving
    session and pass it to every execute call."""

    def __init__(self):
        self.dims: dict[tuple, list[int]] = {}

    def raised(self, famid: tuple, dims: tuple) -> tuple:
        cur = self.dims.get(famid)
        if cur is None:
            self.dims[famid] = cur = list(dims)
        else:
            for i, d in enumerate(dims):
                if d > cur[i]:
                    cur[i] = d
        return tuple(cur)

    def covers(self, famid: tuple, dims: tuple) -> bool:
        """Read-only peek: True iff the family is known and every dim is
        within its sticky ceiling."""
        cur = self.dims.get(famid)
        return cur is not None and all(d <= c for d, c in zip(dims, cur))


def _families(groups: dict[GroupKey, list[_Item]]) -> dict[tuple, list]:
    """Scheduled groups by signature family: (kind, packed block geometry)."""
    fams: dict[tuple, list] = {}
    for key, items in groups.items():
        geom = None if key.packed is None else (key.packed[4], key.packed[5])
        fams.setdefault((key.kind, geom), []).append((key, items))
    return fams


def _family_dims(kind: str, geom, members: list) -> tuple:
    """Ceiling dims of one family: bitmap -> (W, Jb); svs ->
    (M, N, W, J, Jb[, k, t, c, e, Jp])."""
    items = [it for _, mi in members for it in mi]
    if kind == "bitmap":
        return (max(k.words for k, _ in members),
                _pow2_ceil(max(_n_bitmaps(it) for it in items)))
    dims = [max(k.m_bucket for k, _ in members),
            max(k.n_bucket for k, _ in members),
            max(k.words for k, _ in members),
            _pow2_ceil(max(len(it.folds) for it in items)),
            _pow2_ceil(max(_n_bitmaps(it) for it in items))]
    if geom is not None:
        dims += [max(k.packed[i] for k, _ in members) for i in range(4)]
        dims.append(_pow2_ceil(max(len(it.psrc) for it in items)))
    return tuple(dims)


def plan_covers(groups: dict[GroupKey, list[_Item]],
                plan: FusionPlan | None) -> bool:
    """True iff fusing ``groups`` under ``plan`` would raise no sticky
    ceiling (a read-only peek; evaluate before ``fuse_groups``)."""
    if plan is None:
        return False
    return all(plan.covers((kind, geom), _family_dims(kind, geom, members))
               for (kind, geom), members in _families(groups).items())


def fuse_groups(groups: dict[GroupKey, list[_Item]],
                plan: FusionPlan | None = None,
                stats: dict | None = None) -> dict[GroupKey, list[_Item]]:
    """Coarsen scheduled GroupKeys into signature families and merge each
    family's items along the batch-row axis.  Every dim outside the family
    identity is raised to the family ceiling (and by the sticky ``plan``);
    padding is inert, so fused == unfused byte for byte.  Fused svs keys
    force ``algo='gallop'``, as the reference's do."""
    fused: dict[GroupKey, list[_Item]] = {}
    for (kind, geom), members in _families(groups).items():
        items = [it for _, mi in members for it in mi]
        dims = _family_dims(kind, geom, members)
        if plan is not None:
            dims = plan.raised((kind, geom), dims)
        if kind == "bitmap":
            w, jb = dims
            fkey = GroupKey("bitmap", 0, 0, w, "-", fused=(jb,))
        else:
            m, n, w, j, jb = dims[:5]
            packed = (tuple(dims[5:9]) + geom) if geom is not None else None
            jp = dims[9] if geom is not None else 0
            fkey = GroupKey("svs", m, n, w, "gallop", packed,
                            fused=(j, jb, jp))
        fused[fkey] = items
    if stats is not None:
        stats["n_sched_groups"] = (stats.get("n_sched_groups", 0)
                                   + len(groups))
        stats["n_fused_groups"] = (stats.get("n_fused_groups", 0)
                                   + len(fused))
    return fused


def _compile_count() -> int:
    """Program signatures launched so far plus kernel libraries built (see
    "Program count" in the module docstring)."""
    return len(_PROGRAMS) + _build.BUILDS


# --------------------------------------------------------------------------
# launch / collect and the public entry point
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PendingBatch:
    """Launched but not yet collected: per group chunk, its items (None in
    shard-pad slots) and its result copies (see ``copy_to_host``), and the
    launcher's ``timings`` (a ``pipeline.StageTimings`` or None), which
    ``collect_batch``'s wait and collect spans add to."""
    n_queries: int
    max_results: int
    launched: list          # [(key, chunk_items, [(host tensor, event)])]
    timings: object = None


def copy_to_host(res: torch.Tensor) -> tuple:
    """Start the copy of a result (compacted svs rows of min(M,
    max_results) + 1 columns, or all-bitmap rows of W + 1) to the host.  On
    the card: into pinned memory from torch's caching host allocator,
    without waiting, followed by a CUDA event that ``collect_batch`` waits
    on alone; the pinned tensor is held until then.  On the CPU: the tensor
    itself, and no event."""
    if res.device.type != "cuda":
        return res, None
    with torch.cuda.device(res.device):
        host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
        host.copy_(res, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    return host, event


def launch_groups(groups: dict[GroupKey, list[_Item]], *, n_queries: int,
                  max_results: int = 1 << 16,
                  max_group_size: int = MAX_GROUP_SIZE,
                  pool: "source.ResidentPool | None" = None,
                  stats: dict | None = None, timings=None) -> PendingBatch:
    """Launch one device program per (possibly fused) group chunk, each
    followed by its result's copy to the host, and return without waiting
    for the card.  Each svs row keeps its first ``max_results`` survivors.
    ``timings`` (a ``pipeline.StageTimings``) takes operand assembly and
    the launches apart; ``stats["result_bytes"]`` adds the bytes of the
    result copies."""
    launched = []
    n_dispatches = 0
    c0 = _compile_count() if stats is not None else 0
    for key, items in groups.items():
        step = _chunk_size(key, items, max_group_size)
        for lo in range(0, len(items), step):
            chunk = items[lo: lo + step]
            if key.kind == "bitmap":
                res = _launch_bitmap_group(key, chunk, pool, stats, timings)
            else:
                res = _launch_svs_group(key, chunk, pool, stats, timings,
                                        max_results)
            launched.append((key, chunk, [copy_to_host(res)]))
            source._bump(stats, "result_bytes", res.nbytes)
            n_dispatches += 1
    accumulate_launch_stats(stats, groups, n_dispatches)
    if stats is not None:
        stats["n_compiles"] = (stats.get("n_compiles", 0)
                               + _compile_count() - c0)
    return PendingBatch(n_queries=n_queries, max_results=max_results,
                        launched=launched, timings=timings)


def accumulate_launch_stats(stats: dict | None, groups, n_dispatches: int):
    """Accumulate the per-launch counters."""
    if stats is None:
        return
    for k, v in (("n_groups", len(groups)), ("n_dispatches", n_dispatches),
                 ("n_items", sum(len(v) for v in groups.values()))):
        stats[k] = stats.get(k, 0) + v


def collect_batch(pending: PendingBatch) -> list[QueryResult]:
    """Wait for each chunk's result copy (its event alone) and re-assemble
    per-query results in part order — byte-identical to ``engine.query``.
    An svs row is read as its prefix of min(count, C) survivors (C + 1
    columns: ``_svs_program``), an all-bitmap row by extracting its words.
    Shard-pad slots (None) are skipped.  It launches nothing and reads
    only pinned host memory, so it may run on another thread than the
    launches (the live server's collector); an event's wait does not
    depend on that thread's current device.  ``pending.timings`` takes
    the waits (``batch.wait``) and the host work (``batch.collect``)
    apart."""
    timings = pending.timings
    per_query: list[list[tuple[int, np.ndarray]]] = \
        [[] for _ in range(pending.n_queries)]
    counts = [0] * pending.n_queries
    for key, chunk, copies in pending.launched:
        with source.span(timings, "batch.wait"):
            for _, event in copies:
                if event is not None:
                    event.synchronize()
        with source.span(timings, "batch.collect"):
            host = (copies[0][0].numpy() if len(copies) == 1 else
                    np.concatenate([h.numpy() for h, _ in copies]))
            for b, it in enumerate(chunk):
                if it is None:
                    continue
                cnt = int(host[b, -1])
                counts[it.qi] += cnt
                if not cnt:
                    continue
                docs = (bm.extract_np(host[b, :-1]) if key.kind == "bitmap"
                        else host[b, : min(cnt, host.shape[1] - 1)])
                per_query[it.qi].append((it.pi, docs.astype(np.int64)
                                         + it.doc_lo))
    out = []
    with source.span(timings, "batch.collect"):
        for qi in range(pending.n_queries):
            chunks = [d for _, d in sorted(per_query[qi],
                                           key=lambda x: x[0])]
            docs = (np.concatenate(chunks) if chunks
                    else np.zeros(0, np.int64))[: pending.max_results]
            out.append(QueryResult(count=counts[qi], docs=docs))
    return out


def execute_batch(index: HybridIndex, queries: list[list[int]], *,
                  max_results: int = 1 << 16,
                  max_group_size: int = MAX_GROUP_SIZE, cache=None,
                  skip: bool = True, stats: dict | None = None,
                  pool: "source.ResidentPool | None" = None,
                  fuse: bool = True, plan: FusionPlan | None = None
                  ) -> list[QueryResult]:
    """Answer a batch of conjunctive queries on the index's device; results
    are element-for-element identical to ``engine.query`` per query.

    cache: optional DecodeCache.  skip: False forces full decodes of every
    fold list.  pool: optional ResidentPool — operands are served from (and
    staged into) the device-resident index and assembled by arena gathers.
    fuse: coarsen the scheduled groups into megagroup families (False keeps
    one program per scheduled signature; results are identical either way).
    plan: a FusionPlan carrying sticky family ceilings across calls.
    stats: optional dict of scheduler counters (n_groups,
    n_sched_groups/n_fused_groups, n_dispatches, n_compiles, n_items,
    decoded_ints, skip_folds, resident_hits, result_bytes, signatures)."""
    groups = schedule(index, queries, cache=cache, skip=skip, stats=stats,
                      pool=pool)
    if fuse:
        groups = fuse_groups(groups, plan=plan, stats=stats)
    pending = launch_groups(groups, n_queries=len(queries),
                            max_results=max_results,
                            max_group_size=max_group_size, pool=pool,
                            stats=stats)
    return collect_batch(pending)


# --------------------------------------------------------------------------
# warmup
# --------------------------------------------------------------------------

def synth_warmup_queries(index: HybridIndex, n: int, seed: int = 0,
                         arities=(2, 3, 4, 5)) -> list[list[int]]:
    """A warmup query sample from the index's own term stats: seeds from the
    shortest tercile of list terms, other positions uniform."""
    rng = np.random.default_rng(seed)
    lens: dict[int, int] = {}
    for part in index.parts:
        for tid, tp in part.terms.items():
            if tp.kind != "empty":
                lens[tid] = lens.get(tid, 0) + tp.n
    terms = sorted(lens.items(), key=lambda t: t[1])
    if not terms:
        return []
    ids = [t for t, _ in terms]
    short = ids[: max(len(ids) // 3, 1)]
    queries = []
    for i in range(n):
        a = arities[i % len(arities)]
        q = {int(rng.choice(short))}
        while len(q) < min(a, len(ids)):
            q.add(int(rng.choice(ids)))
        queries.append(sorted(q))
    return queries


def warm_to_fixed_point(run_fn, max_passes: int = 4
                        ) -> tuple[int, int, bool]:
    """Repeat ``run_fn(stats)`` until a pass adds no new program signature.
    Returns (n_signatures, passes, converged)."""
    stats: dict = {}
    seen = -1
    passes = 0
    converged = False
    for _ in range(max_passes):
        run_fn(stats)
        passes += 1
        n_sigs = len(stats.get("signatures", ()))
        if n_sigs == seen:
            converged = True
            break
        seen = n_sigs
    return len(stats.get("signatures", ())), passes, converged


def warmup(index: HybridIndex, queries: list[list[int]] | None = None, *,
           plan: FusionPlan, batch_size: int = 32,
           pool: "source.ResidentPool | None" = None, cache=None,
           skip: bool = True, max_group_size: int = MAX_GROUP_SIZE,
           max_passes: int = 4, seed: int = 0) -> dict:
    """Run the fused pipeline over ``queries`` (or a synthesized sample)
    until no new program signature appears, so the plan's ceilings reach
    their fixed point before serving.  Returns ``{"n_compiles",
    "n_signatures", "passes", "converged", "time_s"}``; a steady state after
    it reports ``n_compiles == 0``."""
    t0 = time.perf_counter()
    c0 = _compile_count()
    if queries is None:
        queries = synth_warmup_queries(index, 2 * batch_size, seed=seed)

    def one_pass(stats):
        for lo in range(0, len(queries), batch_size):
            execute_batch(index, queries[lo: lo + batch_size], cache=cache,
                          skip=skip, pool=pool, fuse=True, plan=plan,
                          max_group_size=max_group_size, stats=stats)

    n_signatures, passes, converged = warm_to_fixed_point(one_pass,
                                                          max_passes)
    return {"n_compiles": _compile_count() - c0,
            "n_signatures": n_signatures,
            "passes": passes,
            "converged": converged,
            "time_s": time.perf_counter() - t0}
