"""END-TO-END DRIVER (the paper's kind is serving): build an inverted index
over a synthetic corpus fitted to the paper's Table 2 query-log marginals,
compress posting lists with S4-BP128-style codecs + HYB+M2 bitmaps, and
serve conjunctive queries — results verified against a brute-force
oracle.

Port of ``examples/search_engine.py``, on the card unless asked for the
CPU (the engine's kernels, K1–K3, run there):

  PYTHONPATH=src python -m repro_torch.examples.search_engine [--device cpu]

The ms/query are the card's (or the CPU's) own, host clock over the
queries after one warm query, ending with each answer on the host.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.index import builder, corpus as corpus_lib, engine
from repro_torch.kernels import ops

BUILDS = (("fastpfor-d1", 0), ("bp-d1", 16), ("fastpfor-d1", 16))


def main(device=None, n_docs: int = 1 << 17, n_queries: int = 40) -> dict:
    device = ops.resolve_device(device)
    print(f"synthesizing corpus: {n_docs} docs, {n_queries} queries "
          "(Table 2 marginals)...")
    corpus = corpus_lib.synthesize(n_docs=n_docs, n_queries=n_queries,
                                   seed=11)
    sizes = [len(p) for p in corpus.postings]
    print(f"  {corpus.n_terms} terms, posting lengths "
          f"p50={int(np.median(sizes))} max={max(sizes)}")

    out = {}
    for codec, B in BUILDS:
        idx = builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                            B=B, n_parts=2, device=device)
        st = idx.stats()
        engine.query(idx, corpus.queries[0])        # warm
        t0 = time.perf_counter()
        hits = 0
        for q in corpus.queries:
            hits += engine.query(idx, q).count
        dt = (time.perf_counter() - t0) / len(corpus.queries)
        # verify against the oracle
        for q in corpus.queries[:10]:
            assert engine.query(idx, q).count == \
                len(engine.brute_force(corpus.postings, q))
        out[(codec, B)] = {"bits_per_int": st["bits_per_int"],
                           "ms_per_query": dt * 1e3, "hits": hits}
        print(f"codec={codec:12s} B={B:2d}: {st['bits_per_int']:5.2f} "
              f"bits/int, {dt * 1e3:7.2f} ms/query, {hits} total hits — "
              f"verified ✓")

    print("\nServed and verified — HYB+M2 over compressed lists "
          "(paper §6.7).")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
