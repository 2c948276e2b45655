"""The least-bytes count behind ``kernels_roofline``."""

import math

import numpy as np
import pytest

from portbench import roofline
from portbench.generators import table2_log as gen
from portbench.reference import intersect


def test_log2_binomial_small_cases():
    assert roofline.log2_binomial(10, 0) == 0.0
    assert roofline.log2_binomial(10, 10) == 0.0
    assert roofline.log2_binomial(8, 4) == pytest.approx(math.log2(70))


@pytest.mark.parametrize("seed, n_parts", [(4, 1), (2**31 + 1, 2), (9, 3)])
def test_least_bytes_never_exceed_the_lists(seed, n_parts):
    c = gen.synthesize(1 << 18, 128, seed)
    least = roofline.LeastBytes(c.postings, c.n_docs, n_parts)
    truth = intersect.answers(c.postings, c.queries, "cpu")
    for q in c.queries:
        n_answer = truth[tuple(q)].size
        got = least.query(q, n_answer)
        raw = sum(4 * c.postings[t].size for t in q)
        shortest = min(c.postings[t].size for t in q)
        assert 4 * n_answer <= got <= raw
        assert got <= 4 * shortest + 4 * n_answer


def test_parts_match_the_builder_split():
    bounds = roofline.part_bounds(50_000_000, 2)
    assert list(bounds) == list(np.linspace(0, 50_000_000, 3).astype(np.int64))
