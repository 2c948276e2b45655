"""The least bytes a conjunctive query needs any implementation to move.

Counted from the benchmark's own postings and the queries alone, so it
reads the same work whatever codec, kernel or schedule answers them.  Per
query and per doc-id part (the index splits ``[0, n_docs)`` into
``n_parts`` equal ranges, as the program's builder does):

  * the shortest list of the query in that part, read once, at the
    information-theoretic least: log2 C(span, n) bits for n sorted ids in
    a span of ``span`` doc ids (no codec can store the list in fewer);
  * 4 bytes for each id of the answer, written once.

A part where some term has no posting contributes nothing: an empty
answer needs no list read.  The sum over a traced slice's queries, over
the card's memory bandwidth times the device's busy time, is the kernels'
share of the roofline; since no implementation moves fewer bytes, the
share cannot pass 100 %.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

PEAKS = Path(__file__).resolve().parent / "peaks.json"


def peak(device_kind: str, key: str) -> float | None:
    """The data-sheet figure ``key`` of the card named ``device_kind``, or
    None where the table has no such card."""
    table = json.loads(PEAKS.read_text())
    row = table.get(device_kind)
    return None if row is None else float(row[key])


def part_bounds(n_docs: int, n_parts: int) -> np.ndarray:
    return np.linspace(0, n_docs, n_parts + 1).astype(np.int64)


def log2_binomial(span: int, n: int) -> float:
    """log2 C(span, n), the bits to name one n-subset of a span."""
    if n <= 0 or n >= span:
        return 0.0
    return (math.lgamma(span + 1) - math.lgamma(n + 1)
            - math.lgamma(span - n + 1)) / math.log(2)


class LeastBytes:
    """Per-term, per-part least bits, computed once from the postings."""

    def __init__(self, postings: list[np.ndarray], n_docs: int,
                 n_parts: int):
        bounds = part_bounds(n_docs, n_parts)
        spans = np.diff(bounds)
        # counts[t, p]: postings of term t in part p
        self.counts = np.stack([np.diff(np.searchsorted(p, bounds))
                                for p in postings]) if postings else \
            np.zeros((0, n_parts), np.int64)
        self.bits = np.array([[log2_binomial(int(spans[j]), int(c))
                               for j, c in enumerate(row)]
                              for row in self.counts]).reshape(
                                  self.counts.shape)

    def query(self, terms, n_answer: int) -> float:
        """Least bytes of one query whose answer has ``n_answer`` ids."""
        t = list(terms)
        counts = self.counts[t]                      # (terms, parts)
        bits = 0.0
        for p in range(counts.shape[1]):
            if counts[:, p].min() == 0:
                continue
            bits += self.bits[t[int(np.argmin(counts[:, p]))], p]
        return bits / 8 + 4 * n_answer
