"""A corpus of sorted posting lists and a query log, drawn from a table of
query-log marginals (``marginals/<name>.json``).

A frozen copy of the port's ``index/corpus.py::synthesize`` and
``data/clusterdata.py::clusterdata`` (Lemire, Boytsov, Kurz,
arXiv:1401.6399 §6: Table 2's term-count and per-position list-length
marginals; ClusterData-style lists after Anh and Moffat).  It lives here so
that a later change to the program cannot change the benchmark's inputs;
``tests/test_portbench_gen.py`` holds ``synthesize`` equal to the program's
generator, list for list and query for query.  It imports numpy alone.

``make(seed, cfg)`` is a run's corpus: the log (its queries, and the
length of every term's list) is drawn from the configuration's fixed
``shape_seed``, so every run has the same sizes and the same queries; the
doc ids of every list and the order the log is sent in are drawn from the
run's seed.

One change of form, none of result: the inter-cluster jumps are added with
a fancy-indexed ``+=`` instead of ``np.add.at``.  The jump positions come
from ``choice(..., replace=False)``, so they are distinct and the two add
the same values.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

MARGINALS = Path(__file__).resolve().parent.parent / "marginals"


@dataclasses.dataclass
class Corpus:
    n_docs: int
    postings: list[np.ndarray]        # term id -> sorted doc ids (int64)
    queries: list[list[int]]          # query -> term ids

    @property
    def n_postings(self) -> int:
        return int(sum(p.size for p in self.postings))


def marginals(table) -> tuple[dict, int]:
    """``{terms: (query %, [avg hits per term, thousands])}`` and the
    number of documents they refer to: read from ``marginals/<table>.json``,
    or ``table`` itself where it is such a dict already (then at the
    ClueWeb09 scale of 50M documents)."""
    if isinstance(table, dict):
        return table, 50_000_000
    raw = json.loads((MARGINALS / f"{table}.json").read_text())
    return ({int(k): (v["query_pct"], list(v["avg_hits_thousands"]))
             for k, v in raw["terms"].items()}, int(raw["n_docs"]))


def clusterdata(rng: np.random.Generator, n: int, universe_bits: int,
                cluster_size: int = 32) -> np.ndarray:
    """n strictly increasing ints in [0, 2**universe_bits): runs of small
    gaps, uniform in [1, U/n], broken by large jumps that use up the rest
    of the universe."""
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    U = 1 << universe_bits
    if n >= U:
        raise ValueError("universe too small")
    small_max = max(int(U // n), 2)
    small = rng.integers(1, small_max + 1, size=n).astype(np.int64)
    n_clusters = max(n // cluster_size, 1)
    starts = rng.choice(n, size=n_clusters, replace=False) if n_clusters < n \
        else np.arange(n)
    budget = U - 1 - int(small.sum())
    if budget > 0 and n_clusters > 0:
        w = rng.random(n_clusters)
        w /= w.sum()
        big = np.floor(w * budget).astype(np.int64)
        gaps = small
        gaps[starts] += big          # starts are distinct: np.add.at's sums
    else:
        gaps = small
    vals = np.cumsum(gaps) - 1
    if vals[-1] >= U:                      # numeric safety; rescale tail
        vals = (vals.astype(np.float64) * (U - 1) / vals[-1]).astype(np.int64)
        vals = np.unique(vals)
    return vals


def draw_log(rng: np.random.Generator, n_docs: int, n_queries: int, *,
             table="clueweb09", shared_vocab: bool = True,
             zipf_s: float = 1.1, vocab_per_bucket: int = 6
             ) -> tuple[list[int], list[list[int]]]:
    """The target length of every term's list, and the queries.

    With ``shared_vocab`` the term ids come from a shared vocabulary: per
    length bucket (about the log2 of the target posting count) at most
    ``vocab_per_bucket`` terms exist, and a repeat pick follows a Zipf(s)
    law over the bucket's creation rank."""
    table, table_docs = marginals(table)
    scale = n_docs / table_docs
    term_sizes: list[int] = []
    queries: list[list[int]] = []
    probs = np.array([p for _, (p, _) in table.items()])
    probs = probs / probs.sum()
    n_terms_options = list(table.keys())
    vocab: dict[int, list[int]] = {}        # length bucket -> term ids
    for _ in range(n_queries):
        k = int(rng.choice(n_terms_options, p=probs))
        tids: list[int] = []
        for ln in table[k][1]:
            target = max(int(ln * 1000 * scale *
                             float(np.exp(rng.normal(0, 0.35)))), 4)
            target = min(target, n_docs - 1)
            if not shared_vocab:
                tids.append(len(term_sizes))
                term_sizes.append(target)
                continue
            bucket = vocab.setdefault(int(np.log2(target)), [])
            pool = [t for t in bucket if t not in tids]
            if len(bucket) < vocab_per_bucket or not pool:
                tid = len(term_sizes)
                term_sizes.append(target)
                bucket.append(tid)
            else:
                w = np.array([1.0 / (i + 1) ** zipf_s
                              for i, t in enumerate(bucket) if t in pool])
                tid = pool[int(rng.choice(len(pool), p=w / w.sum()))]
            tids.append(tid)
        queries.append(tids)
    return term_sizes, queries


def draw_lists(rng: np.random.Generator, term_sizes: list[int],
               n_docs: int) -> list[np.ndarray]:
    """Each term's sorted doc ids: ``clusterdata`` over the power-of-two
    universe above ``n_docs``, cut to ``[0, n_docs)``."""
    universe_bits = int(np.ceil(np.log2(n_docs)))
    postings = [clusterdata(rng, sz, universe_bits) for sz in term_sizes]
    return [p[p < n_docs] for p in postings]


def synthesize(n_docs: int, n_queries: int, seed: int, **log_kw) -> Corpus:
    """Posting lists and a query log scaled from the marginals, all from
    one seed: the program's ``corpus.synthesize``."""
    rng = np.random.default_rng(seed)
    sizes, queries = draw_log(rng, n_docs, n_queries, **log_kw)
    return Corpus(n_docs=n_docs, postings=draw_lists(rng, sizes, n_docs),
                  queries=queries)


LOG_KEYS = ("table", "shared_vocab", "zipf_s", "vocab_per_bucket")


def make(seed: int, cfg: dict) -> Corpus:
    """One run's corpus and log: the sizes and queries of the
    configuration's ``shape_seed``, the doc ids from ``seed``, the log sent
    in an order drawn from ``seed``."""
    n_docs = cfg["n_docs"]
    sizes, queries = draw_log(np.random.default_rng(cfg["shape_seed"]),
                              n_docs, cfg["n_queries"],
                              **{k: cfg[k] for k in LOG_KEYS if k in cfg})
    postings = draw_lists(np.random.default_rng([seed, 2]), sizes, n_docs)
    order = np.random.default_rng(seed).permutation(len(queries))
    return Corpus(n_docs=n_docs, postings=postings,
                  queries=[queries[i] for i in order])
