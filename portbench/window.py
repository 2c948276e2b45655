"""What every traffic mode shares: the measured window's record, the
sample of answers kept for the check, progress lines, and the control.

A traffic file (``traffic/<name>.json``) names its ``mode``; the mode is
the module ``modes/<mode>.py``, whose ``Driver(system, corpus, traffic,
devices)`` takes what the configuration's build made and the run's query
log, warms in set-up every shape its window will use, and then, in
``window``, sends queries until ``seconds`` have passed and the last
answer is on the host.  It returns a ``Window``: the queries sent, how
many answers came back, the answers a ``Sampler`` keeps for the check with
their positions (the rest are dropped as they come, as a reader of the log
would drop them), and what the per-layer readers need.
``traced_slice(n)`` sends the log's first ``n`` queries once more, in the
window's own calls, for the profiler.

``Control`` puts a reference in the program's place, in the sequential
window's loop (see ``reference/``).
"""

from __future__ import annotations

import dataclasses
import sys
import time
import types

import numpy as np


class Sampler:
    """Which answers of the window are kept for the check: each with
    probability ``share``, drawn from the run's seed."""

    def __init__(self, seed: int, share: float):
        self.rng = np.random.default_rng([seed, 1])
        self.share = share
        self.n = 0

    def keep(self, results, kept: list) -> None:
        """Append (position in the window, result) of the kept ones."""
        mask = self.rng.random(len(results)) < self.share
        kept.extend((self.n + i, r) for i, r in enumerate(results) if mask[i])
        self.n += len(results)


@dataclasses.dataclass
class Window:
    sent: list                 # term tuples, in the order sent
    n_answered: int            # answers that came back
    kept: list                 # (position, result) sampled for the check
    seconds: float
    latencies_s: list          # per query (sequential) or empty
    stats: dict | None         # the program's counters (traced run)
    timings: object | None     # pipeline.StageTimings (traced run)
    batches: int               # batches sent (pipelined)
    launches: int              # kernel launches in the window


def note(msg: str) -> None:
    """A progress line on standard error (before the check lines)."""
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def launch_total() -> int:
    """Kernel launches the program's ``kernels.ops`` has counted so far."""
    from repro_torch.kernels import ops
    return sum(ops.launches().values())


class Control:
    """The reference in the program's place: the sequential window's loop,
    each query answered by ``answerer.answer``."""

    def __init__(self, answerer, corpus, traffic: dict):
        self.ref, self.max_results = answerer, traffic["max_results"]
        self.log = [tuple(q) for q in corpus.queries]
        self.warm = None

    def window(self, seconds: float, traced: bool,
               sampler: Sampler) -> Window:
        sent, kept = [], []
        t0 = time.perf_counter()
        i = 0
        while True:
            q = self.log[i % len(self.log)]
            ids = self.ref.answer(q).cpu().numpy().astype(np.int64)
            sampler.keep((types.SimpleNamespace(
                count=ids.size, docs=ids[: self.max_results]),), kept)
            sent.append(q)
            i += 1
            if time.perf_counter() - t0 >= seconds and i >= len(self.log):
                break
        return Window(sent, len(sent), kept, time.perf_counter() - t0, [],
                      None, None, 0, 0)

    def close(self):
        self.ref = None
