"""The plain reference and its float32 control."""

import numpy as np
import pytest
import torch

from portbench.generators import table2_log as gen
from portbench.reference import intersect
from repro_torch.index import engine


@pytest.mark.parametrize("seed", [3, 2**31 + 99])
def test_reference_equals_brute_force(seed):
    c = gen.synthesize(1 << 18, 96, seed)
    got = intersect.answers(c.postings, c.queries, "cpu")
    for q in c.queries:
        assert np.array_equal(got[tuple(q)], engine.brute_force(c.postings, q))


def test_reference_takes_any_term_order():
    c = gen.synthesize(1 << 16, 16, 8)
    ref = intersect.Reference(c.postings, "cpu")
    for q in c.queries:
        assert torch.equal(ref.answer(q), ref.answer(list(reversed(q))))


TINY = {2: (50.0, [200, 600]), 3: (50.0, [200, 400, 800])}


def test_float32_control_breaks_exactness():
    """On a 50M-document universe float32 doc ids round above 2**24, so the
    control's answers differ from the exact reference's."""
    c = gen.synthesize(50_000_000, 24, 1, table=TINY)
    exact = intersect.answers(c.postings, c.queries, "cpu")
    low = intersect.answers(c.postings, c.queries, "cpu", torch.float32)
    found = [k for k in exact if exact[k].size]
    differ = [k for k in found if not np.array_equal(exact[k], low[k])]
    assert found and len(differ) >= len(found) // 2
