"""Pipelined serving: up to ``depth`` batches in flight.

Port of ``src/repro/index/pipeline.py``.  ``batch.execute_batch`` waits for
each batch's results before it schedules the next one, so the card idles
while the host schedules and the host idles while the card runs.  Here the
host schedules and launches batch k+1 (and k+2, … up to ``depth``) while
the card runs batch k: ``batch.launch_groups`` enqueues the programs and
their result copies on the stream and returns, and only ``collect_batch``
waits, on the copy of each chunk's result.  ``depth`` bounds the batches
not yet collected — each holds its operands and pinned result buffers, so
depth is a memory knob as well:

    depth 1   launch → collect, strictly serial (== execute_batch)
    depth 2   double buffering: stage k+1 while k runs
    depth d   d-1 batches of slack for jittery schedule times

With a ``source.ResidentPool`` the host stage is bookkeeping (bucketing,
skip-index searches on host copies, gather ids), which is what lets it hide
under the card's work.  Shared state (pool staging, cache fills, the layout
memo, arenas, the plan's ceilings) changes in schedule order, so results
equal ``execute_batch`` run batch by batch, at every depth.  Results
return in submission order.

``StageTimings`` adds up the wall time of each stage:

    stage     host scheduling: resolve, bucketing, candidate-block search,
              megagroup fusion
    assemble  operand assembly (arena gathers / stacking, uploads)
    dispatch  program launches and result-copy enqueues
    block     ``collect_batch`` whole: wait + collect
    wait      its waits on the card (each chunk's event)
    collect   its host work: each svs row's prefix of compacted survivors,
              bitmap extraction, the per-row loop and the per-query
              concatenation

Each is a ``source.span`` (``pipeline.stage``, ``batch.assemble``,
``batch.dispatch``, ``pipeline.block``, ``batch.wait``,
``batch.collect``), so under a torch profiler each is also a
``repro_torch.<name>`` range.  The assemble/dispatch split is made inside
the launcher (``batch.launch_groups``, ``shard.launch_groups_sharded``),
and the wait/collect split inside ``collect_batch``, which finds the
timings on the ``PendingBatch`` the launcher made; a custom ``launch_fn``
that ignores the timings leaves those four zero.  The sharded
executor (``index.shard``) runs this loop through the ``schedule_fn`` /
``launch_fn`` hooks.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from repro_torch.index import batch as batch_lib
from repro_torch.index import source
from repro_torch.index.builder import HybridIndex
from repro_torch.index.engine import QueryResult


@dataclasses.dataclass
class StageTimings:
    """Cumulative per-stage wall time across a pipelined run."""
    stage: float = 0.0          # host scheduling (resolve + bucket + fuse)
    assemble: float = 0.0       # operand assembly (gathers / stacks, uploads)
    dispatch: float = 0.0       # program launches
    block: float = 0.0          # collect_batch: wait + collect
    wait: float = 0.0           # collect_batch's waits on the card
    collect: float = 0.0        # collect_batch's host work
    batches: int = 0

    def as_dict(self) -> dict:
        """The reference's keys."""
        return {"stage_s": self.stage, "assemble_s": self.assemble,
                "dispatch_s": self.dispatch, "block_s": self.block,
                "batches": self.batches}


def execute_pipelined(index: HybridIndex, queries: list[list[int]], *,
                      batch_size: int, depth: int = 2,
                      max_results: int = 1 << 16,
                      max_group_size: int = batch_lib.MAX_GROUP_SIZE,
                      cache=None, skip: bool = True, pool=None,
                      fuse: bool = True,
                      plan: "batch_lib.FusionPlan | None" = None,
                      stats: dict | None = None,
                      timings: StageTimings | None = None,
                      schedule_fn=None, launch_fn=None
                      ) -> list[QueryResult]:
    """Answer ``queries`` in ``batch_size`` chunks with up to ``depth``
    batches in flight; results are byte-identical to ``execute_batch`` run
    chunk by chunk (and so to ``engine.query`` per query).

    ``fuse``/``plan`` as in ``execute_batch``; one sticky plan is made for
    the run when none is passed.  ``schedule_fn(chunk, stats) -> groups``
    and ``launch_fn(groups, n_queries, stats) -> PendingBatch`` replace the
    two stages (the sharded executor's hooks); the defaults are the
    single-device scheduler and launcher."""
    assert depth >= 1, depth
    assert batch_size >= 1, batch_size
    if fuse and plan is None:
        plan = batch_lib.FusionPlan()
    if schedule_fn is None:
        def schedule_fn(chunk, stats):
            groups = batch_lib.schedule(index, chunk, cache=cache,
                                        skip=skip, stats=stats, pool=pool)
            if fuse:
                groups = batch_lib.fuse_groups(groups, plan=plan,
                                               stats=stats)
            return groups
    if launch_fn is None:
        def launch_fn(groups, n_queries, stats):
            return batch_lib.launch_groups(
                groups, n_queries=n_queries, max_results=max_results,
                max_group_size=max_group_size, pool=pool, stats=stats,
                timings=timings)
    inflight: deque[batch_lib.PendingBatch] = deque()
    out: list[QueryResult] = []

    def drain_one():
        with source.span(timings, "pipeline.block"):
            out.extend(batch_lib.collect_batch(inflight.popleft()))

    for lo in range(0, len(queries), batch_size):
        chunk = queries[lo: lo + batch_size]
        with source.span(timings, "pipeline.stage"):
            groups = schedule_fn(chunk, stats)
        pending = launch_fn(groups, len(chunk), stats)
        if timings is not None:
            timings.batches += 1
        inflight.append(pending)
        while len(inflight) >= depth:
            drain_one()
    while inflight:
        drain_one()
    return out
