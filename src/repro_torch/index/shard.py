"""Sharded query fan-out: index parts on data-parallel shards.

Port of ``src/repro/index/shard.py``.  Index parts map contiguously onto
shards (1:1 when the counts agree), each shard's ``ResidentPool`` is pinned
to its device, every query batch fans out to all shards, and per-part hits
concatenate in part order — byte-identical to the single-device engine.

Execution model — shard along the batch axis, not the program.  The batched
scheduler's programs are row-independent (each (query, part) item is one
row; only the fold axis J is walked in order), so no per-shard program is
built: each shard's rows are assembled from its own pool on its own device
and glued along the row axis (``_glue``).

  * All shards on one device (the card, or the CPU): the slices are
    concatenated and one program covers every shard's rows.
  * Shards on several devices: torch has no SPMD partitioner, so each
    device runs the same program on its own slice.  The chunk still counts
    as ONE dispatch, as the reference's SPMD program does, and its result
    stays as one copy per device until ``batch.collect_batch`` joins them.

More shards than devices is allowed (shards fold onto devices contiguously,
``n_shards % n_devices == 0``), so the shard count is a logical choice: the
same 4-shard index serves on 1, 2 or 4 devices.  The layout memo keeps one
copy of a packed list's operands per device (``source.cached_layout_dev``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import intersect as its
from repro_torch.index import batch as batch_lib
from repro_torch.index import pipeline as pipe_lib
from repro_torch.index import source
from repro_torch.index.builder import HybridIndex
from repro_torch.index.engine import QueryResult
from repro_torch.launch.mesh import make_index_mesh


@dataclasses.dataclass
class PartPools:
    """Per-part pool routing: ``batch.schedule`` resolves each (query, part)
    item through the pool of the shard that owns the part, so staged rows
    lie on (and are gathered on) that shard's device."""
    pools: list
    part_shard: list

    def for_part(self, pi: int):
        return self.pools[self.part_shard[pi]]


@dataclasses.dataclass
class ShardedIndex:
    """A HybridIndex plus its shard topology: part→shard map, shard→device
    placement, and one device-pinned ResidentPool per shard."""
    index: HybridIndex
    n_shards: int
    devices: list                     # the mesh: torch.devices, in order
    part_shard: list                  # part ordinal -> shard id (contiguous)
    placement: list                   # shard id -> torch.device
    pools: list                       # shard id -> source.ResidentPool

    @property
    def pool_map(self) -> PartPools:
        return PartPools(self.pools, self.part_shard)

    def warm(self, stats: dict | None = None) -> dict:
        """Stage every shard's working set on its own device, per the
        resolve policy (skip-served lists stay packed)."""
        for sid, pool in enumerate(self.pools):
            parts = [p for p, s in zip(self.index.parts, self.part_shard)
                     if s == sid]
            view = HybridIndex(n_docs=self.index.n_docs, B=self.index.B,
                               codec_name=self.index.codec_name, parts=parts)
            pool.warm(view, stats)
        return self.stats()

    def stats(self) -> dict:
        """The placement map: which parts and how many resident ints lie on
        which device, per shard."""
        shards = []
        for sid, pool in enumerate(self.pools):
            shards.append({
                "shard": sid,
                "device": str(self.placement[sid]),
                "parts": [p for p, s in enumerate(self.part_shard)
                          if s == sid],
                **pool.stats(),
            })
        return {"n_shards": self.n_shards,
                "n_devices": len(self.devices),
                "shards": shards}


def shard_index(index: HybridIndex, n_shards: int, devices=None,
                capacity_ints: int = 1 << 26, warm: bool = True
                ) -> ShardedIndex:
    """Place an index's parts onto ``n_shards`` data-parallel shards.

    Parts map contiguously onto shards; shards map contiguously onto
    ``devices`` (None: the devices of the index's type — the widest set of
    CUDA cards that divides the shard count, or the CPU).  With fewer
    devices than shards, consecutive shards share a device: the dataflow
    is the same, only the physical parallelism shrinks."""
    assert n_shards >= 1, n_shards
    if devices is None:
        kind = (torch.device(index.parts[0].device).type if index.parts
                else "cuda")
        ndev = torch.cuda.device_count() if kind == "cuda" else 1
        width = max(d for d in range(1, min(n_shards, ndev) + 1)
                    if n_shards % d == 0)
        devices = make_index_mesh(width, kind)
    devs = [source.pool_device(d) for d in devices]
    assert n_shards % len(devs) == 0, (n_shards, len(devs))
    per_dev = n_shards // len(devs)
    placement = [devs[s // per_dev] for s in range(n_shards)]
    n_parts = len(index.parts)
    part_shard = [min(p * n_shards // max(n_parts, 1), n_shards - 1)
                  for p in range(n_parts)]
    pools = [source.ResidentPool(capacity_ints=capacity_ints, device=d)
             for d in placement]
    sharded = ShardedIndex(index=index, n_shards=n_shards, devices=devs,
                           part_shard=part_shard, placement=placement,
                           pools=pools)
    if warm:
        sharded.warm()
    return sharded


# --------------------------------------------------------------------------
# shard-axis glue
# --------------------------------------------------------------------------

def _glue(sharded: ShardedIndex, slices: list, axis: int) -> list:
    """Per-shard slices (each on its shard's device) joined along ``axis``
    into one tensor per device, in device order."""
    per_dev = len(slices) // len(sharded.devices)
    return [slices[d * per_dev] if per_dev == 1 else
            torch.cat(slices[d * per_dev: (d + 1) * per_dev], dim=axis)
            for d in range(len(sharded.devices))]


def _put_host(sharded: ShardedIndex, arr: np.ndarray, axis: int) -> list:
    """One host operand (active flags, candidate block ids) split along
    ``axis`` into one slice per device, each uploaded from pinned memory
    without waiting for the card."""
    devs = sharded.devices
    return [its.to_device(part, d)
            for part, d in zip(np.split(arr, len(devs), axis=axis), devs)]


# --------------------------------------------------------------------------
# sharded launch (the fan-out) — collect is batch.collect_batch
# --------------------------------------------------------------------------

def _flat_items(per_shard: list, Bq: int) -> list:
    """Collect-order item list of one sharded chunk: shard-contiguous rows,
    None in the per-shard padding slots (skipped by ``collect_batch``)."""
    return [it for sub in per_shard
            for it in list(sub) + [None] * (Bq - len(sub))]


def _launch_svs_sharded(sharded: ShardedIndex, key, per_shard: list,
                        stats: dict | None, timings, max_results: int):
    """One program covering all shards' items of one group chunk: rows laid
    out shard-contiguously ((shard, slot) flattened), operands assembled
    per shard from its pool on its device and glued along the row axis.
    Returns (flat item list with None pads, one result per device)."""
    with source.span(timings, "batch.assemble"):
        S = sharded.n_shards
        all_items = [it for sub in per_shard for it in sub]
        Bq = batch_lib._bucket_rows(max(len(sub) for sub in per_shard))
        if key.fused:
            J, Jb, Jp = key.fused
        else:
            J = max((len(it.folds) for it in all_items), default=0)
            Jb = max((batch_lib._n_bitmaps(it) for it in all_items),
                     default=0)
            Jp = (max((len(it.psrc) for it in all_items), default=0)
                  if key.packed is not None else 0)
        parts = [batch_lib._assemble_svs(key, per_shard[sid],
                                         sharded.pools[sid],
                                         bp=Bq, j=J, jb=Jb, jp=Jp,
                                         device=sharded.pools[sid].device,
                                         stats=stats)
                 for sid in range(S)]
        R = _glue(sharded, [p[0] for p in parts], axis=0)    # (S·Bq, M)
        F = _glue(sharded, [p[1] for p in parts], axis=1)    # (J, S·Bq, N)
        active = _put_host(sharded,
                           np.concatenate([p[2] for p in parts], 1), 1)
        W = (_glue(sharded, [p[4] for p in parts], axis=1)  # (Jb, S·Bq, W)
             if Jb else [None] * len(R))
        Pk = [p[3] for p in parts]
        mode, rows, Jp = batch_lib._svs_launch_args(key, all_items, Pk[0],
                                                    stats)
        pks = pk_actives = [None] * len(R)
        if key.packed is not None:
            stacked = [_glue(sharded, [p[0][o] for p in Pk], axis=1)
                       for o in range(6)]
            PBk = _put_host(sharded,
                            np.concatenate([p[1] for p in Pk], 1), 1)
            pks = [batch_lib._compose_pk([s[d] for s in stacked], PBk[d])
                   for d in range(len(R))]
            pk_actives = _put_host(sharded,
                                   np.concatenate([p[2] for p in Pk], 1), 1)
        if stats is not None:
            stats.setdefault("signatures", set()).add(
                ("svs-sharded", key, S, Bq, J, Jb))
        batch_lib._PROGRAMS.add(("svs", key, R[0].shape[0], J, Jb, Jp))
    with source.span(timings, "batch.dispatch"):
        out = [batch_lib._svs_program(R[d], F[d], active[d], pks[d],
                                      pk_actives[d], W[d], mode, rows,
                                      max_results)
               for d in range(len(R))]
    return _flat_items(per_shard, Bq), out


def _launch_bitmap_sharded(sharded: ShardedIndex, key, per_shard: list,
                           stats: dict | None, timings=None):
    with source.span(timings, "batch.assemble"):
        S = sharded.n_shards
        all_items = [it for sub in per_shard for it in sub]
        Bq = batch_lib._bucket_rows(max(len(sub) for sub in per_shard))
        J = (key.fused[0] if key.fused else
             max((batch_lib._n_bitmaps(it) for it in all_items), default=1))
        words = _glue(sharded, [
            batch_lib._assemble_bitmap(key, per_shard[sid],
                                       sharded.pools[sid], bp=Bq, j=J,
                                       stats=stats)[0]
            for sid in range(S)], axis=0)                # (S·Bq, J, W)
        if stats is not None:
            stats.setdefault("signatures", set()).add(
                ("bm-sharded", key, S, Bq, J))
        batch_lib._PROGRAMS.add(("bm", key, words[0].shape[0], J, 0, 0))
    with source.span(timings, "batch.dispatch"):
        out = [batch_lib._bitmap_and_program(w) for w in words]
    return _flat_items(per_shard, Bq), out


def launch_groups_sharded(sharded: ShardedIndex, groups, *, n_queries: int,
                          max_results: int = 1 << 16,
                          max_group_size: int = batch_lib.MAX_GROUP_SIZE,
                          stats: dict | None = None, timings=None
                          ) -> batch_lib.PendingBatch:
    """Launch every group chunk as one program across the shard devices,
    each result followed by its copy to the host, without waiting for the
    card (the fan-out half; ``batch.collect_batch`` is the concatenate
    half: item part ordinals order per-query results as the single-device
    engine does).  ``timings``, ``max_results`` and
    ``stats["result_bytes"]`` as in ``batch.launch_groups``."""
    launched = []
    n_dispatches = 0
    c0 = batch_lib._compile_count() if stats is not None else 0
    for key, items in groups.items():
        per = [[] for _ in range(sharded.n_shards)]
        for it in items:
            per[sharded.part_shard[it.pi]].append(it)
        # lockstep chunking: the int budget bounds per-device operand rows,
        # so chunk by the widest shard's slice
        step = batch_lib._chunk_size(key, items, max_group_size)
        width = max(len(sub) for sub in per)
        for lo in range(0, max(width, 1), step):
            chunk = [s[lo: lo + step] for s in per]
            if key.kind == "bitmap":
                flat, out = _launch_bitmap_sharded(sharded, key, chunk,
                                                   stats, timings)
            else:
                flat, out = _launch_svs_sharded(sharded, key, chunk, stats,
                                                timings, max_results)
            launched.append((key, flat,
                             [batch_lib.copy_to_host(r) for r in out]))
            source._bump(stats, "result_bytes", sum(r.nbytes for r in out))
            n_dispatches += 1
    batch_lib.accumulate_launch_stats(stats, groups, n_dispatches)
    if stats is not None:
        stats["n_compiles"] = (stats.get("n_compiles", 0)
                               + batch_lib._compile_count() - c0)
    return batch_lib.PendingBatch(n_queries=n_queries,
                                  max_results=max_results,
                                  launched=launched, timings=timings)


def execute_sharded(sharded: ShardedIndex, queries: list, *,
                    batch_size: int = 32, depth: int = 2,
                    max_results: int = 1 << 16,
                    max_group_size: int = batch_lib.MAX_GROUP_SIZE,
                    fuse: bool = True,
                    plan: "batch_lib.FusionPlan | None" = None,
                    stats: dict | None = None,
                    timings: "pipe_lib.StageTimings | None" = None
                    ) -> list[QueryResult]:
    """Answer ``queries`` against the sharded index, pipelined at ``depth``:
    every batch fans out to all shards in one dispatch per chunk and
    results concatenate in part order — byte-identical to ``engine.query``
    / ``batch.execute_batch`` on the unsharded index.  ``fuse``/``plan``
    coarsen each batch into megagroup families before the fan-out."""
    pool_map = sharded.pool_map
    if fuse and plan is None:
        plan = batch_lib.FusionPlan()

    def schedule_fn(chunk, stats):
        groups = batch_lib.schedule(sharded.index, chunk, pool=pool_map,
                                    stats=stats)
        if fuse:
            groups = batch_lib.fuse_groups(groups, plan=plan, stats=stats)
        return groups

    def launch_fn(groups, n_queries, stats):
        return launch_groups_sharded(
            sharded, groups, n_queries=n_queries, max_results=max_results,
            max_group_size=max_group_size, stats=stats, timings=timings)

    return pipe_lib.execute_pipelined(
        sharded.index, queries, batch_size=batch_size, depth=depth,
        max_results=max_results, stats=stats, timings=timings,
        schedule_fn=schedule_fn, launch_fn=launch_fn)
