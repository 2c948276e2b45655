"""One query at a time through the program's ``index.engine.query``, no
pool and no DecodeCache: every list decoded or skip-probed from its
compressed payload on each query, as the paper measures (time per query,
its Tables 4 and 5).  Set-up sends the log's first ``warm_queries``."""

from __future__ import annotations

import time

from portbench import tracing
from portbench.window import Window, launch_total


class Driver:
    warm = None

    def __init__(self, idx, corpus, traffic: dict, devices: list):
        self.idx, self.t = idx, traffic
        self.log = [tuple(q) for q in corpus.queries]
        for q in self.log[: traffic["warm_queries"]]:
            self._one(q)

    def _one(self, q, stats=None):
        from repro_torch.index import engine
        return engine.query(self.idx, list(q), stats=stats,
                            max_results=self.t["max_results"])

    def window(self, seconds: float, traced: bool, sampler) -> Window:
        stats = {} if traced else None
        sent, kept, lat = [], [], []
        clock = time.perf_counter
        l0 = launch_total()
        t0 = clock()
        i = 0
        while True:
            q = self.log[i % len(self.log)]
            a = clock()
            r = self._one(q, stats)
            b = clock()
            sent.append(q)
            lat.append(b - a)
            sampler.keep((r,), kept)
            i += 1
            if b - t0 >= seconds:
                break
        return Window(sent, len(sent), kept, clock() - t0, lat, stats, None,
                      0, launch_total() - l0)

    def traced_slice(self, n: int):
        qs = self.log[:n]
        out = []
        for q in qs:
            with tracing.span("engine.query"):
                out.append(self._one(q))
        return list(qs), out

    def close(self):
        pass
