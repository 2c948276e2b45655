"""Closed loop over the whole log, again and again, through the program's
``index.pipeline.execute_pipelined`` with its own scheduler and launcher:
``batch_size`` queries a batch, ``depth`` batches in flight, a warm
``source.ResidentPool`` of ``pool_ints`` and one sticky
``batch.FusionPlan``, both warmed by whole passes until no new program
signature appears (the calls ``serve --pipeline 2 --resident --batch
256`` makes).  The window runs whole passes of the log, the last one
ending past ``seconds``."""

from __future__ import annotations

import time

from portbench import tracing
from portbench.window import Window, launch_total, note


class Driver:
    def __init__(self, idx, corpus, traffic: dict, devices: list):
        from repro_torch.index import batch as batch_lib, source
        self.idx, self.t = idx, traffic
        self.log = [tuple(q) for q in corpus.queries]
        self.queries = [list(q) for q in self.log]
        self.pool = source.ResidentPool(capacity_ints=traffic["pool_ints"],
                                        device=devices[0])
        t0 = time.perf_counter()
        ps = self.pool.warm(idx)
        note(f"pool warm: {ps['staged_lists']} lists, {ps['device_ints']} "
             f"device ints in {time.perf_counter() - t0:.2f} s")
        self.plan = batch_lib.FusionPlan()

        def warm_pass(stats):
            t = time.perf_counter()
            self._pass(stats=stats)
            note(f"warm pass: {len(stats.get('signatures', ()))} signatures "
                 f"so far, {time.perf_counter() - t:.2f} s")
        n_sigs, passes, converged = batch_lib.warm_to_fixed_point(
            warm_pass, max_passes=traffic["max_warm_passes"])
        if not converged:
            raise RuntimeError(f"the warm loop found new program signatures "
                               f"in each of its {passes} passes")
        self.warm = {"signatures": n_sigs, "passes": passes}

    def _pass(self, stats=None, timings=None, n=None):
        from repro_torch.index import pipeline
        return pipeline.execute_pipelined(
            self.idx, self.queries[:n],
            batch_size=self.t["batch_size"], depth=self.t["depth"],
            max_results=self.t["max_results"], pool=self.pool,
            plan=self.plan, stats=stats, timings=timings)

    def window(self, seconds: float, traced: bool, sampler) -> Window:
        from repro_torch.index import pipeline
        stats = {} if traced else None
        timings = pipeline.StageTimings() if traced else None
        sent, kept, n_answered, passes = [], [], 0, []
        l0 = launch_total()
        t0 = t = time.perf_counter()
        while True:
            results = self._pass(stats=stats, timings=timings)
            sent.extend(self.log)
            n_answered += len(results)
            sampler.keep(results, kept)
            del results
            now = time.perf_counter()
            passes.append(now - t)
            t = now
            if now - t0 >= seconds:
                break
        n_b = -(-len(self.log) // self.t["batch_size"])
        note("window passes: " + ", ".join(f"{p:.2f} s" for p in passes))
        return Window(sent, n_answered, kept, now - t0, [], stats, timings,
                      n_b * len(passes), launch_total() - l0)

    def traced_slice(self, n: int):
        """The log's first ``n`` queries (whole batches of the window's
        passes, so the same programs) in one call, inside a span."""
        with tracing.span("pipeline.execute_pipelined"):
            return list(self.log[:n]), self._pass(n=n)

    def close(self):
        self.pool = self.plan = None
