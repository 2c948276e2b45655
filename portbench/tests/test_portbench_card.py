"""The harness on the card at a small size: the program's run is correct,
the control's is not.  Skips without a CUDA card."""

import pytest

from portbench import run

pytestmark = [pytest.mark.cuda]
MIX = {"batch_size": 64, "pool_ints": 1 << 24, "warm_queries": 16,
       "trace_queries": 16, "stack_queries": 8}
TINY = {2: (50.0, [200, 600]), 3: (50.0, [200, 400, 800])}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    return "cuda:0"


@pytest.mark.parametrize("cell", ["cw09b-bp128-b16.bulk",
                                  "cw09b-fastpfor-b0.seq",
                                  "cw09b-bp128-b16.seq"])
def test_cell_on_the_card(card, cell):
    out = run.run_cell(cell, 2**31 + 3, 0.5, True, devices=[card],
                       overrides={"n_docs": 1 << 22, "n_queries": 256},
                       traffic_overrides=MIX)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert out["breakdown"]["idle_gaps"]
    assert 0 < out["metrics"]["kernels_roofline"]["value"] <= 100


def test_control_on_the_card(card):
    out = run.run_cell("cw09b-bp128-b16.seq", 7, 0.1, False, devices=[card],
                       control=True, traffic_overrides=MIX,
                       overrides={"n_queries": 24, "table": TINY})
    assert not out["correct"]
