"""The benchmark's frozen generator gives the program's corpus and log."""

import numpy as np
import pytest

from portbench.generators import table2_log as gen
from repro_torch.index import corpus


@pytest.mark.parametrize("seed, n_docs", [(5, 1 << 20), (2**31 + 7, 3_000_000)])
def test_frozen_generator_equals_synthesize(seed, n_docs):
    mine = gen.synthesize(n_docs, 256, seed)
    theirs = corpus.synthesize(n_docs=n_docs, n_queries=256, seed=seed,
                               shared_vocab=True)
    assert mine.queries == theirs.queries
    assert len(mine.postings) == len(theirs.postings)
    for a, b in zip(mine.postings, theirs.postings):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_lists_sorted_unique_in_range():
    c = gen.synthesize(1 << 18, 64, 11)
    for p in c.postings:
        assert p.size == 0 or (np.all(np.diff(p) > 0) and p[0] >= 0
                               and p[-1] < c.n_docs)
    assert all(2 <= len(q) <= 7 and len(set(q)) == len(q) for q in c.queries)


@pytest.mark.parametrize("seeds", [(1, 2), (2**31 + 3, 17)])
def test_runs_share_the_sizes_and_queries(seeds):
    """Every run has the configuration's queries and list lengths; the
    run's seed draws the doc ids and the order of the log."""
    cfg = dict(shape_seed=5, n_docs=1 << 20, n_queries=128, table="clueweb09",
               shared_vocab=True, vocab_per_bucket=6, zipf_s=1.1)
    base = gen.synthesize(1 << 20, 128, 5)
    a, b = (gen.make(s, cfg) for s in seeds)
    for run_corpus in (a, b):
        assert sorted(run_corpus.queries) == sorted(base.queries)
        assert len(run_corpus.postings) == len(base.postings)
        for x, y in zip(run_corpus.postings, base.postings):
            # the same target length, cut to [0, n_docs) by the draw
            assert abs(x.size - y.size) <= 0.05 * y.size + 8
    assert a.queries != b.queries
    assert not all(np.array_equal(x, y) for x, y in zip(a.postings, b.postings))
    again = gen.make(seeds[0], cfg)
    assert again.queries == a.queries
    assert all(np.array_equal(x, y) for x, y in zip(again.postings, a.postings))


def test_marginals_file_holds_table_2a():
    table, n_docs = gen.marginals("clueweb09")
    assert n_docs == 50_000_000 and sorted(table) == [2, 3, 4, 5, 6, 7]
    assert all(len(hits) == k for k, (_, hits) in table.items())
    assert sum(p for p, _ in table.values()) == pytest.approx(98.4)
