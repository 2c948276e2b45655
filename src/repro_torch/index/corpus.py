"""Synthetic corpus + query log matched to the paper's Table 2 marginals.

Port of ``src/repro/index/corpus.py``: a numpy copy, so one seed gives the
same corpus and query log in both packages.

No TREC data is available offline, so we generate: (a) per-term posting lists
whose documents follow the ClusterData process (sorted-run structure like the
URL-sorted GOV2), and (b) a query log whose term-count distribution and
per-position posting-list lengths are fitted to the paper's Table 2 statistics
(scaled to the synthetic corpus size).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.clusterdata import clusterdata

# Table 2(a), ClueWeb09: {terms: (query %, [avg hits per term, thousands])}
TABLE2_CLUEWEB = {
    2: (19.8, [380, 2600]),
    3: (32.5, [400, 1500, 5100]),
    4: (26.3, [480, 1400, 3200, 8100]),
    5: (13.2, [420, 1200, 2600, 4800, 10000]),
    6: (4.9, [350, 1000, 2100, 3700, 6500, 13000]),
    7: (1.7, [390, 1100, 2100, 3400, 5200, 7300, 13000]),
}
TABLE2_DOCS = 50_000_000    # ClueWeb09 corpus size the marginals refer to


@dataclasses.dataclass
class Corpus:
    n_docs: int
    postings: list[np.ndarray]        # term id → sorted doc ids
    queries: list[list[int]]          # query → term ids (sorted by length)

    @property
    def n_terms(self) -> int:
        return len(self.postings)


def synthesize(n_docs: int = 1 << 20, n_queries: int = 200,
               seed: int = 0, table=TABLE2_CLUEWEB,
               shared_vocab: bool = False, zipf_s: float = 1.1,
               vocab_per_bucket: int = 6) -> Corpus:
    """Build posting lists + queries scaled from the paper's Table 2.

    shared_vocab=False keeps the original behavior: every query position
    mints a fresh term id, so a DecodeCache only helps across exact query
    repeats.  shared_vocab=True draws term ids from a shared vocabulary
    instead: per length bucket (~pow2 of the target posting count) at most
    ``vocab_per_bucket`` terms exist, and repeat picks follow a Zipf(s)
    rank distribution over the bucket — the head-heavy term reuse real
    query logs show, which is what gives the DecodeCache a realistic hit
    rate (ROADMAP: cross-query decode reuse).
    """
    rng = np.random.default_rng(seed)
    scale = n_docs / TABLE2_DOCS
    universe_bits = int(np.ceil(np.log2(n_docs)))

    # desired per-position lengths (thousands → docs, scaled)
    term_sizes: list[int] = []
    queries: list[list[int]] = []
    probs = np.array([p for _, (p, _) in table.items()])
    probs = probs / probs.sum()
    n_terms_options = list(table.keys())
    vocab: dict[int, list[int]] = {}        # length bucket → term ids
    for _ in range(n_queries):
        k = int(rng.choice(n_terms_options, p=probs))
        lens = table[k][1]
        tids: list[int] = []
        for ln in lens:
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
                # Zipf over creation rank: early terms are the hot head
                w = np.array([1.0 / (i + 1) ** zipf_s
                              for i, t in enumerate(bucket) if t in pool])
                tid = pool[int(rng.choice(len(pool), p=w / w.sum()))]
            tids.append(tid)
        queries.append(tids)

    postings = [clusterdata(rng, sz, universe_bits) for sz in term_sizes]
    postings = [p[p < n_docs] for p in postings]
    return Corpus(n_docs=n_docs, postings=postings, queries=queries)
