#!/usr/bin/env python
"""What one ``repro_torch.index.source.span`` costs the host, in ns a span.

Times ``with source.span(carrier, name): pass`` in a loop, in each of the
helper's states:

  off                no carrier, no profiler: no clock, no profiler call
  stats              a ``stats`` dict carrier (the sequential path)
  timings            a ``pipeline.StageTimings`` carrier (the pipeline)
  profiler           no carrier, under a torch profiler (a
                     ``record_function`` range)
  profiler+timings   both

and the bare loop, which the figures do not subtract.  Prints one JSON
line.

    PYTHONPATH=src python scripts/span_cost.py [--n 200000]
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.index import pipeline, source


def per_span_ns(carrier, n: int) -> float:
    span = source.span
    t0 = time.perf_counter()
    for _ in range(n):
        with span(carrier, "batch.wait"):
            pass
    return (time.perf_counter() - t0) / n * 1e9


def bare_ns(n: int) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        pass
    return (time.perf_counter() - t0) / n * 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    n = args.n
    per_span_ns(None, n // 10)                     # warm
    out = {"bare_loop": bare_ns(n), "off": per_span_ns(None, n),
           "stats": per_span_ns({}, n),
           "timings": per_span_ns(pipeline.StageTimings(), n)}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    m = min(n, 50_000)                             # the profiler keeps each
    with profile(activities=acts):
        out["profiler"] = per_span_ns(None, m)
        out["profiler+timings"] = per_span_ns(pipeline.StageTimings(), m)
    print(json.dumps({"ns_per_span": out, "n": n, "n_profiled": m}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
