"""Continuous-batching index server.

Port of ``src/repro/launch/server.py``: an online serving loop in front of
the batched engine.  Requests arrive one at a time (an open-loop generator
models live traffic — Poisson, bursty, or a drain backlog), an async
batcher packs them into batches, and each batch rides the launch/collect
split (``batch.launch_groups`` / ``batch.collect_batch``, the sharded
fan-out, or a ``segments.MutableIndex`` snapshot), so ``pool``, ``fuse``,
``warm_server``, ``sharded`` and ``mutable`` compose and every answer equals
the offline path's.

The loop's three policies, as in the reference:

  admission   arrivals pack greedily into the open batch; a flush is
              family-aligned when the sticky ``FusionPlan`` already covers
              every scheduled group (``batch.plan_covers``, read before
              fusion raises ceilings).
  flush       whichever fires first of max_batch and max_wait; drain mode
              (a pre-submitted backlog) flushes only full batches.
  backpressure  the arrival queue is bounded; open-loop arrivals that find
              it full are shed (counted), and at most ``depth`` launched
              batches may await collection.

Every request resolves to exactly one of done / shed / timeout / error.
Transient faults from the schedule/launch seam retry with bounded
exponential backoff; repeated failures trip the degradation ladder.

Where the port differs:

  * **The ladder has one rung below the top: fused → unfused.**  The
    reference's rungs are (backend, fuse) pairs, fused → unfused and then
    pallas → jax.  The port has one program (the hand kernels on the card,
    their plain versions on the CPU), so its rungs are the fuse flags
    alone, ``DegradationLadder(True).levels == [True, False]``, exactly the
    fuse flags of the reference's ``DegradationLadder("jax", True)``.  A
    plain-torch rung on the card would be a hidden fallback, not a port.
  * **Two host threads.**  Schedule and launch run on the event-loop thread
    in flush order; collect runs on a one-worker executor.  On the card the
    collector only waits on each result copy's event and reads pinned host
    memory: it launches nothing.
  * **Only injected faults are served around.**  The seams catch
    ``faults.TransientFault`` and ``faults.InjectedError`` alone, where the
    reference catches every exception; anything else (a failed build or
    launch, a CUDA error, which poisons the context) propagates out of
    ``run``.
  * **Open-loop arrivals keep their schedule.**  Each arrival is due at
    the sum of the gaps before it and is timed from then (``t_arrive``),
    so latency includes any delay the event loop put between a request's
    due time and its submission (``arrival_lag_s``), and requests that fell
    behind arrive together, as they would have queued.  The reference
    sleeps each gap after the last submission.
  * ``--device`` in place of ``--backend``; compile counts are the port's
    own (``batch._compile_count``: new program signatures plus ``nvcc``
    builds), 0 after ``warm_server``.

  PYTHONPATH=src python -m repro_torch.launch.server --queries 256 --qps 500
  PYTHONPATH=src python -m repro_torch.launch.server --queries 256 --qps 0 \\
      --warmup --check --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

from repro_torch.index import batch as batch_lib
from repro_torch.launch import faults as faults_lib


_STOP = object()


# --------------------------------------------------------------------------
# requests + metrics
# --------------------------------------------------------------------------

@dataclass
class Request:
    """One in-flight query: terms plus the three timestamps the latency
    report is built from (arrive -> admit -> done).  Every admitted request
    ends in exactly one of ``done`` / ``timeout`` / ``error`` with its
    ``done`` event set (shed arrivals never become a Request)."""
    rid: int
    terms: list
    t_arrive: float
    t_admit: float = 0.0
    t_done: float = 0.0
    result: object = None
    outcome: str = "pending"
    done: asyncio.Event = field(default_factory=asyncio.Event)

    @property
    def wait_s(self) -> float:
        return self.t_admit - self.t_arrive

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrive


def _pctl(xs: list, q: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


class ServerMetrics:
    """Latency and queue accounting for one serving run: per-request
    end-to-end latency percentiles, time in queue, a power-of-two histogram
    of the queue depth each arrival saw, flush reasons and outcomes."""

    def __init__(self):
        self.latency_s: list[float] = []
        self.wait_s: list[float] = []
        self.depth_hist: dict[int, int] = {}
        self.n_shed = 0
        self.n_done = 0
        self.n_flushes = 0
        self.flush_full = 0
        self.flush_deadline = 0
        self.flush_drain = 0
        self.aligned_flushes = 0
        self.unaligned_flushes = 0
        self.n_timeout = 0          # expired per-request deadlines
        self.n_errors = 0           # requests resolved by a failed flush
        self.n_faults = 0           # faults observed at the dispatch seams
        self.n_retries = 0          # transient-fault retry attempts
        self.degraded_flushes = 0   # flushes served below the top rung
        self.t_first: float | None = None
        self.t_last: float | None = None

    def observe_depth(self, depth: int):
        b = 0 if depth <= 0 else 1 << (depth - 1).bit_length()
        self.depth_hist[b] = self.depth_hist.get(b, 0) + 1

    def record(self, req: Request):
        self.n_done += 1
        self.latency_s.append(req.latency_s)
        self.wait_s.append(req.wait_s)
        if self.t_first is None or req.t_arrive < self.t_first:
            self.t_first = req.t_arrive
        if self.t_last is None or req.t_done > self.t_last:
            self.t_last = req.t_done

    def summary(self) -> dict:
        span = ((self.t_last - self.t_first)
                if (self.t_first is not None and self.t_last is not None)
                else 0.0)
        return {
            "n_done": self.n_done,
            "n_shed": self.n_shed,
            "qps": self.n_done / span if span > 0 else 0.0,
            "p50_ms": _pctl(self.latency_s, 50) * 1e3,
            "p99_ms": _pctl(self.latency_s, 99) * 1e3,
            "p999_ms": _pctl(self.latency_s, 99.9) * 1e3,
            "mean_ms": (float(np.mean(self.latency_s)) * 1e3
                        if self.latency_s else 0.0),
            "wait_p50_ms": _pctl(self.wait_s, 50) * 1e3,
            "wait_p99_ms": _pctl(self.wait_s, 99) * 1e3,
            "queue_depth_hist": {str(k): self.depth_hist[k]
                                 for k in sorted(self.depth_hist)},
            "n_flushes": self.n_flushes,
            "flush_full": self.flush_full,
            "flush_deadline": self.flush_deadline,
            "flush_drain": self.flush_drain,
            "aligned_flushes": self.aligned_flushes,
            "unaligned_flushes": self.unaligned_flushes,
            "n_timeout": self.n_timeout,
            "n_errors": self.n_errors,
            "n_faults": self.n_faults,
            "n_retries": self.n_retries,
            "degraded_flushes": self.degraded_flushes,
        }


# --------------------------------------------------------------------------
# the degradation ladder (circuit breaker)
# --------------------------------------------------------------------------

class DegradationLadder:
    """Circuit breaker over the fuse flag: fused → unfused (see the module
    docstring for why there is no third rung).  Both rungs are
    differentially verified, so a degraded answer is the same answer.

    State machine: ``threshold`` consecutive flush failures step one rung
    down (streak resets); any failure re-arms the cool-down; the first
    success after a full quiet ``cooldown_s`` steps one rung back up.
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, fuse: bool = True, *, threshold: int = 3,
                 cooldown_s: float = 0.5, clock=time.monotonic):
        levels = [fuse]
        if fuse:
            levels.append(False)
        self.levels = levels
        self.level = 0
        self.threshold = max(threshold, 1)
        self.cooldown_s = cooldown_s
        self.clock = clock
        self.fail_streak = 0
        self.n_degradations = 0
        self.n_promotions = 0
        self._quiet_at = clock()       # earliest instant a promotion may fire

    @property
    def current(self) -> bool:
        """The fuse flag of the current rung."""
        return self.levels[self.level]

    @property
    def degraded(self) -> bool:
        return self.level > 0

    def on_failure(self) -> bool:
        """Record one failed flush; True if this tripped a degradation."""
        self.fail_streak += 1
        self._quiet_at = self.clock() + self.cooldown_s
        if (self.fail_streak >= self.threshold
                and self.level < len(self.levels) - 1):
            self.level += 1
            self.fail_streak = 0
            self.n_degradations += 1
            return True
        return False

    def on_success(self) -> bool:
        """Record one successful flush; True if this re-promoted a rung."""
        self.fail_streak = 0
        if self.level > 0 and self.clock() >= self._quiet_at:
            self.level -= 1
            self.n_promotions += 1
            self._quiet_at = self.clock() + self.cooldown_s
            return True
        return False


# --------------------------------------------------------------------------
# arrival processes (open loop: the generator never waits for results)
# --------------------------------------------------------------------------

def arrival_gaps(n: int, qps: float, pattern: str = "poisson",
                 seed: int = 0, burst: int = 8) -> list[float]:
    """Inter-arrival gaps (seconds) for ``n`` requests at offered load
    ``qps``.  ``qps <= 0`` is a drain backlog (everything at t=0);
    ``poisson`` is memoryless, ``bursty`` keeps the mean rate but releases
    bursts of ``burst``, ``uniform`` is deterministic.  The same numpy
    draws as the reference, so one seed gives the same gaps."""
    if n <= 0:
        return []
    if qps is None or qps <= 0:
        return [0.0] * n
    rng = np.random.default_rng(seed)
    if pattern == "poisson":
        return [float(g) for g in rng.exponential(1.0 / qps, n)]
    if pattern == "uniform":
        return [1.0 / qps] * n
    if pattern == "bursty":
        gaps = []
        for i in range(n):
            if i % burst == 0:
                gaps.append(float(rng.exponential(burst / qps)))
            else:
                gaps.append(0.0)
        return gaps
    raise ValueError(f"unknown arrival pattern {pattern!r}")


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------

class ContinuousBatchingServer:
    """Async continuous-batching loop over the batched engine.

    Scheduling (group assembly, fusion, launch) happens on the event-loop
    thread in flush order, so shared-state changes (pool staging, plan
    ceilings, layout memos) happen in schedule order.  Collection runs on a
    one-worker executor, in launch order, while the loop keeps batching; at
    most ``depth`` launched batches await collection.

    ``sharded`` (a ``shard.ShardedIndex``) swaps the launch seam for the
    fan-out.  ``mutable`` (a ``segments.MutableIndex``) serves a live
    corpus: every flush snapshots the current generation and mutable
    prefix, launches against that snapshot, and completes at collect with
    tombstone filtering and the mutable segment's hits
    (``MutableIndex.finalize``); the server shares the mutable index's
    sticky plan."""

    def __init__(self, index=None, *, max_batch: int = 32,
                 max_wait_ms: float = 2.0, max_queue: int = 256,
                 depth: int = 2, max_results: int = 1 << 16,
                 max_group_size: int = batch_lib.MAX_GROUP_SIZE,
                 cache=None, pool=None, fuse: bool = True, plan=None,
                 sharded=None, mutable=None, drain: bool = False,
                 stats: dict | None = None,
                 metrics: ServerMetrics | None = None,
                 timeout_ms: float | None = None,
                 injector: "faults_lib.FaultInjector | None" = None,
                 max_retries: int = 3, retry_backoff_ms: float = 5.0,
                 breaker_threshold: int = 3, cooldown_ms: float = 500.0,
                 clock=time.monotonic):
        assert max_batch >= 1 and depth >= 1 and max_queue >= 1
        self.index = index
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms * 1e-3
        self.max_queue = max_queue
        self.depth = depth
        self.max_results = max_results
        self.max_group_size = max_group_size
        self.cache = cache
        self.pool = pool
        self.fuse = fuse
        self.mutable = mutable
        if plan is not None:
            self.plan = plan
        elif mutable is not None:
            self.plan = mutable.plan       # share the sticky plan: merges
        else:                              # pre-warm through it pre-swap
            self.plan = batch_lib.FusionPlan() if fuse else None
        self.sharded = sharded
        self.drain = drain
        self.stats: dict = {} if stats is None else stats
        self.metrics = metrics if metrics is not None else ServerMetrics()
        self.timeout_s = timeout_ms * 1e-3 if timeout_ms else None
        self.injector = injector
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_ms * 1e-3
        self.ladder = DegradationLadder(fuse, threshold=breaker_threshold,
                                        cooldown_s=cooldown_ms * 1e-3,
                                        clock=clock)
        self.requests: list[Request | None] = []
        self.arrival_lag_s: list[float] = []
        self._next_rid = 0
        self._queue: asyncio.Queue | None = None

    # -- the dispatch seam -------------------------------------------------

    def _snapshot(self):
        """One lock-free state grab per flush (None on frozen indexes);
        schedule, launch and finalize of that flush all serve it."""
        return self.mutable.snapshot() if self.mutable is not None else None

    def _schedule(self, chunk, stats, account: bool = True, snap=None,
                  fuse: bool | None = None):
        if fuse is None:
            fuse = self.fuse
        if snap is not None:
            groups = self.mutable.schedule(snap, chunk, stats=stats,
                                           cache=self.cache)
        elif self.sharded is not None:
            groups = batch_lib.schedule(self.sharded.index, chunk,
                                        pool=self.sharded.pool_map,
                                        stats=stats)
        else:
            groups = batch_lib.schedule(self.index, chunk, cache=self.cache,
                                        stats=stats, pool=self.pool)
        if fuse:
            # family-aligned admission, read before fuse_groups raises the
            # ceilings (which would make coverage trivially true)
            if account:
                if batch_lib.plan_covers(groups, self.plan):
                    self.metrics.aligned_flushes += 1
                else:
                    self.metrics.unaligned_flushes += 1
            groups = batch_lib.fuse_groups(groups, plan=self.plan,
                                           stats=stats)
        return groups

    def _launch(self, groups, n_queries, stats, snap=None):
        if snap is not None:
            return self.mutable.launch(
                snap, groups, n_queries, max_results=self.max_results,
                max_group_size=self.max_group_size, stats=stats)
        if self.sharded is not None:
            from repro_torch.index import shard as shard_lib
            return shard_lib.launch_groups_sharded(
                self.sharded, groups, n_queries=n_queries,
                max_results=self.max_results,
                max_group_size=self.max_group_size, stats=stats)
        return batch_lib.launch_groups(
            groups, n_queries=n_queries, max_results=self.max_results,
            max_group_size=self.max_group_size, pool=self.pool, stats=stats)

    # -- admission ---------------------------------------------------------

    def _new_request(self, terms, t_arrive: float | None = None) -> Request:
        req = Request(rid=self._next_rid, terms=list(terms),
                      t_arrive=(time.perf_counter() if t_arrive is None
                                else t_arrive))
        self._next_rid += 1
        return req

    def submit_nowait(self, terms,
                      t_arrive: float | None = None) -> Request | None:
        """Open-loop admission: enqueue or shed (never blocks).  A request
        is timed from ``t_arrive`` (its due time) where given, else from
        now."""
        self.metrics.observe_depth(self._queue.qsize())
        if self._queue.full():
            self.metrics.n_shed += 1
            return None
        req = self._new_request(terms, t_arrive)
        self._queue.put_nowait(req)
        return req

    async def submit(self, terms) -> Request:
        """Closed-loop admission: wait until the queue has room (drain)."""
        self.metrics.observe_depth(self._queue.qsize())
        req = self._new_request(terms)
        await self._queue.put(req)
        return req

    # -- the batching loop -------------------------------------------------

    async def _batcher(self, finishers: list):
        loop = asyncio.get_running_loop()
        sem = asyncio.Semaphore(self.depth)
        collector = ThreadPoolExecutor(max_workers=1)
        try:
            stopping = False
            while not stopping:
                first = await self._queue.get()
                if first is _STOP:
                    break
                batch = [first]
                reason = "full"
                deadline = loop.time() + self.max_wait_s
                while len(batch) < self.max_batch:
                    try:
                        nxt = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        if self.drain:
                            # backlog mode: only full batches
                            nxt = await self._queue.get()
                        else:
                            left = deadline - loop.time()
                            if left <= 0:
                                reason = "deadline"
                                break
                            try:
                                nxt = await asyncio.wait_for(
                                    self._queue.get(), left)
                            except asyncio.TimeoutError:
                                reason = "deadline"
                                break
                    if nxt is _STOP:
                        stopping = True
                        reason = "drain"
                        break
                    batch.append(nxt)
                await self._flush(batch, reason, loop, sem, collector,
                                  finishers)
            # bound in-flight work before the run tears the executor down
            for _ in range(self.depth):
                await sem.acquire()
        finally:
            collector.shutdown(wait=True)

    def _resolve_error(self, reqs: list[Request]):
        """A failed flush still resolves every request it carried: result
        None, outcome ``error``, done event set."""
        now = time.perf_counter()
        for r in reqs:
            r.result = None
            r.t_done = now
            r.outcome = "error"
            self.metrics.n_errors += 1
            r.done.set()

    async def _flush(self, reqs: list[Request], reason: str, loop, sem,
                     collector, finishers: list):
        await sem.acquire()             # at most `depth` awaiting collection
        m = self.metrics
        now = time.perf_counter()
        if self.timeout_s is not None:
            # per-request deadlines at flush assembly: a request that waited
            # out its budget resolves as a timeout instead of a launch
            live = []
            for r in reqs:
                if now - r.t_arrive > self.timeout_s:
                    r.t_admit = r.t_done = now
                    r.outcome = "timeout"
                    m.n_timeout += 1
                    r.done.set()
                else:
                    live.append(r)
            reqs = live
            if not reqs:
                sem.release()
                return
        for r in reqs:
            r.t_admit = now
        m.n_flushes += 1
        if reason == "full":
            m.flush_full += 1
        elif reason == "deadline":
            m.flush_deadline += 1
        else:
            m.flush_drain += 1

        fuse = self.ladder.current
        if self.ladder.degraded:
            m.degraded_flushes += 1
        attempt = 0
        account = True
        while True:
            try:
                if self.injector is not None:
                    self.injector.fire("launch")
                snap = self._snapshot()
                groups = self._schedule([r.terms for r in reqs], self.stats,
                                        account=account, snap=snap,
                                        fuse=fuse)
                pending = self._launch(groups, len(reqs), self.stats,
                                       snap=snap)
                break
            except faults_lib.TransientFault:
                # bounded retry with exponential backoff; transients also
                # feed the breaker
                m.n_faults += 1
                account = False
                self.ladder.on_failure()
                if attempt >= self.max_retries:
                    self._resolve_error(reqs)
                    sem.release()
                    return
                attempt += 1
                m.n_retries += 1
                await asyncio.sleep(
                    self.retry_backoff_s * (2 ** (attempt - 1)))
                fuse = self.ladder.current
            except faults_lib.InjectedError:
                # non-retryable: resolve the batch as errors, trip the
                # breaker, keep the serving loop alive.  Only injected
                # faults are served around: any other exception (a failed
                # launch, a CUDA error) propagates and ends the run
                m.n_faults += 1
                self.ladder.on_failure()
                self._resolve_error(reqs)
                sem.release()
                return

        def collect():
            if self.injector is not None:
                self.injector.fire("collect")
            results = batch_lib.collect_batch(pending)
            if snap is not None:
                results = self.mutable.finalize(
                    snap, [r.terms for r in reqs], results,
                    self.max_results)
            done = time.perf_counter()
            for r, res in zip(reqs, results):
                r.result = res
                r.t_done = done
            return reqs

        fut = loop.run_in_executor(collector, collect)

        async def finish():
            err = None
            try:
                await fut
            except (faults_lib.TransientFault,
                    faults_lib.InjectedError) as e:
                err = e                 # injected at collect: resolved below
            finally:
                sem.release()
            if err is not None:
                m.n_faults += 1
                self.ladder.on_failure()
                self._resolve_error(reqs)
                return
            self.ladder.on_success()
            for r in reqs:
                r.outcome = "done"
                m.record(r)
                r.done.set()

        finishers.append(asyncio.ensure_future(finish()))

    # -- one full open-loop run --------------------------------------------

    async def run(self, queries: list[list[int]],
                  gaps: list[float] | None = None) -> list:
        """Feed ``queries`` through the server with the given inter-arrival
        gaps (None = drain backlog) and return per-query results in
        submission order (None for shed requests).  Open loop, request i is
        due ``sum(gaps[:i + 1])`` after the start and timed from then;
        ``arrival_lag_s[i]`` is how late the event loop let it in."""
        if gaps is None:
            gaps = [0.0] * len(queries)
        self._queue = asyncio.Queue(maxsize=self.max_queue)
        finishers: list = []
        batcher = asyncio.ensure_future(self._batcher(finishers))
        reqs: list[Request | None] = []
        self.arrival_lag_s = []
        due = time.perf_counter()
        for terms, gap in zip(queries, gaps):
            if self.drain:
                if gap > 0:
                    await asyncio.sleep(gap)
                reqs.append(await self.submit(terms))
                continue
            due += gap
            ahead = due - time.perf_counter()
            if ahead > 0:
                await asyncio.sleep(ahead)
            now = time.perf_counter()
            self.arrival_lag_s.append(max(now - due, 0.0))
            reqs.append(self.submit_nowait(terms, min(due, now)))
        await self._queue.put(_STOP)
        await batcher
        if finishers:
            await asyncio.gather(*finishers)
        self.requests = reqs
        return [r.result if r is not None else None for r in reqs]

    def outcomes(self) -> list[str]:
        """Per-request resolution of the last ``run``, submission order:
        ``shed`` / ``done`` / ``timeout`` / ``error``."""
        return ["shed" if r is None else r.outcome for r in self.requests]


def warm_server(server: ContinuousBatchingServer,
                queries: list[list[int]] | None = None,
                seed: int = 0) -> dict:
    """Warm the server's sticky plan and pool through its own dispatch seam
    to the signature fixed point, walking the ×1.5 batch-row ladder
    (``batch._bucket_rows``) every 1..max_batch flush can land in.  After
    it, every flush whose groups the plan covers launches no new program
    signature.  Returns ``batch.warmup``'s dict (n_compiles, n_signatures,
    passes, converged, time_s)."""
    t0 = time.perf_counter()
    c0 = batch_lib._compile_count()
    if queries is None:
        if server.mutable is not None:
            view = server.mutable.snapshot().gen.view
        elif server.sharded is not None:
            view = server.sharded.index
        else:
            view = server.index
        queries = batch_lib.synth_warmup_queries(
            view, 2 * server.max_batch, seed=seed)

    sizes, b = [], 1
    while b < batch_lib._bucket_rows(server.max_batch):
        sizes.append(b)
        b = b * 3 // 2 if b >= 2 else b + 1
    sizes.append(server.max_batch)

    def one_pass(stats):
        for size in sizes:
            for lo in range(0, len(queries), size):
                chunk = queries[lo: lo + size]
                snap = server._snapshot()
                groups = server._schedule(chunk, stats, account=False,
                                          snap=snap)
                pending = server._launch(groups, len(chunk), stats,
                                         snap=snap)
                batch_lib.collect_batch(pending)

    n_signatures, passes, converged = batch_lib.warm_to_fixed_point(one_pass)
    return {"n_compiles": batch_lib._compile_count() - c0,
            "n_signatures": n_signatures,
            "passes": passes,
            "converged": converged,
            "time_s": time.perf_counter() - t0}


def serve_open_loop(index, queries, *, qps: float = 0.0,
                    pattern: str = "poisson", seed: int = 0,
                    warmup: bool = False, **server_kw):
    """Build a server, optionally warm it, and push ``queries`` through at
    offered load ``qps`` (0 = drain backlog).  Returns ``(results,
    server)``: results in submission order (None where shed), the server
    with ``.metrics``, ``.stats`` and the warm report at ``.warm_report``."""
    drain = qps is None or qps <= 0
    server = ContinuousBatchingServer(index, drain=drain, **server_kw)
    server.warm_report = (warm_server(server, queries, seed=seed)
                          if warmup else None)
    gaps = arrival_gaps(len(queries), qps, pattern, seed=seed)
    results = asyncio.run(server.run(queries, gaps))
    return results, server


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(
        description="open-loop continuous-batching server over the "
                    "paper-index engine")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="offered load (requests/s); 0 = drain backlog "
                         "(everything arrives at t=0, full batches only)")
    ap.add_argument("--pattern", choices=["poisson", "bursty", "uniform"],
                    default="poisson")
    ap.add_argument("--batch", type=int, default=32,
                    help="max batch per flush")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="deadline flush: max time the oldest queued "
                         "request waits before a partial batch launches")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="bounded arrival queue; open-loop arrivals that "
                         "find it full are shed")
    ap.add_argument("--depth", type=int, default=2,
                    help="max launched batches awaiting collection")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--fuse", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--warmup", action="store_true",
                    help="warm the fused family ladder through the server's "
                         "own dispatch seam before serving")
    ap.add_argument("--resident", action="store_true",
                    help="warm the device-resident index before serving")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve against an N-shard fan-out index")
    ap.add_argument("--check", action="store_true",
                    help="differential: compare every served result "
                         "against offline execute_batch")
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="per-request deadline: a request still queued "
                         "after this long resolves as an explicit timeout")
    ap.add_argument("--chaos", type=str, default=None,
                    help="fault-injection spec, e.g. "
                         "'transient@launch:0.01,delay@launch:2' "
                         "(see launch/faults.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shared-vocab", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.index import builder, corpus as corpus_lib, source
    from repro_torch.kernels import ops
    device = ops.resolve_device(args.device)
    corpus = corpus_lib.synthesize(n_docs=1 << 16, n_queries=args.queries,
                                   seed=5, shared_vocab=args.shared_vocab)
    injector = (faults_lib.FaultInjector(args.chaos, seed=args.seed)
                if args.chaos else None)
    kw = dict(max_batch=args.batch, max_wait_ms=args.max_wait_ms,
              max_queue=args.max_queue, depth=args.depth, fuse=args.fuse,
              timeout_ms=args.timeout_ms, injector=injector)
    if args.shards:
        sharded = builder.build_sharded(
            corpus.postings, corpus.n_docs, n_shards=args.shards,
            codec_name="fastpfor-d1", B=16, n_parts=max(args.shards, 2),
            device=device)
        idx = sharded.index
        kw["sharded"] = sharded
    else:
        idx = builder.build(corpus.postings, corpus.n_docs,
                            codec_name="fastpfor-d1", B=16, n_parts=2,
                            device=device)
        if args.resident:
            pool = source.ResidentPool(device=device)
            pool.warm(idx)
            kw["pool"] = pool
    results, server = serve_open_loop(idx, corpus.queries, qps=args.qps,
                                      pattern=args.pattern, seed=args.seed,
                                      warmup=args.warmup, **kw)
    if server.warm_report is not None:
        wu = server.warm_report
        print(f"[server] warmup: {wu['n_compiles']} compiles over "
              f"{wu['n_signatures']} signatures in {wu['passes']} passes "
              f"({wu['time_s']:.2f}s)")
        if not wu["converged"]:
            print("[server] warning: warmup stopped at max_passes before "
                  "the signature ladder converged — serving may compile")
    s = server.metrics.summary()
    mode = (f"--shards {args.shards}" if args.shards
            else ("--resident" if args.resident else "cold"))
    load = (f"qps {args.qps:g} ({args.pattern})" if args.qps > 0
            else "drain backlog")
    print(f"[server] paper-index {mode} ({device.type}"
          f"{', fused' if args.fuse else ', unfused'}, batch {args.batch}, "
          f"wait {args.max_wait_ms:g} ms, {load}): "
          f"{s['n_done']} done / {s['n_shed']} shed, "
          f"{s['qps']:.1f} q/s, latency p50 {s['p50_ms']:.2f} ms / "
          f"p99 {s['p99_ms']:.2f} ms / p99.9 {s['p999_ms']:.2f} ms, "
          f"queue wait p99 {s['wait_p99_ms']:.2f} ms, "
          f"{s['n_flushes']} flushes "
          f"(full {s['flush_full']}, deadline {s['flush_deadline']}, "
          f"drain {s['flush_drain']}; "
          f"{s['aligned_flushes']} family-aligned), "
          f"{server.stats.get('n_dispatches', 0)} dispatches, "
          f"{server.stats.get('n_compiles', 0)} compiles")
    print(f"[server]   queue depth histogram (pow2 buckets): "
          f"{s['queue_depth_hist']}")
    lad = server.ladder
    if (s["n_timeout"] or s["n_errors"] or s["n_faults"]
            or lad.n_degradations or injector is not None):
        print(f"[server]   resilience: {s['n_timeout']} timed out, "
              f"{s['n_errors']} errored, {s['n_faults']} faults seen, "
              f"{s['n_retries']} retries, "
              f"{s['degraded_flushes']} degraded flushes "
              f"({lad.n_degradations} degradations / "
              f"{lad.n_promotions} promotions, final rung "
              f"{'fused' if lad.current else 'unfused'})")
        if injector is not None:
            print(f"[server]   chaos fired: {injector.counts()}")
    if args.check:
        served = [(q, r) for q, r in zip(corpus.queries, results)
                  if r is not None]
        offline = batch_lib.execute_batch(
            idx, [q for q, _ in served], fuse=args.fuse)
        for (q, got), want in zip(served, offline):
            assert got.count == want.count and \
                np.array_equal(got.docs, want.docs), f"mismatch on {q}"
        print(f"[server] differential check: {len(served)} served results "
              f"byte-identical to offline execute_batch")
    return results, server


if __name__ == "__main__":
    main()
