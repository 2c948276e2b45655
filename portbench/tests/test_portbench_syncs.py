"""The program's count of the host's waits for the card
(``stats["syncs"]``, read by ``metrics/engine.syncs_per_query.py``)
against torch's own: over 32 queries of the log on each build, the count
equals the warnings of ``torch.cuda.set_sync_debug_mode("warn")``.  Skips
without a CUDA card."""

import collections
import warnings

import pytest

from portbench import run

pytestmark = [pytest.mark.cuda]
SMALL = {"n_docs": 1 << 22, "n_queries": 256}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    return torch.device("cuda:0")


@pytest.mark.parametrize("config", ["cw09b-bp128-b16", "cw09b-fastpfor-b0"])
def test_syncs_equal_the_sync_debug_warnings(card, config):
    import torch
    from repro_torch.index import engine

    cell = next(w for w in run.load_json(run.ROOT / "BENCHMARK.json")
                ["workloads"] if w["config"] == config)
    cfg = {**run.cell_files(cell["name"])[2], **SMALL}
    corpus = run.named("generators", cfg["generator"]).make(2**31 + 7, cfg)
    idx, _ = run.named("builds", cfg["build"]).build(corpus, cfg, [card])
    queries = [list(q) for q in corpus.queries[:32]]
    for q in queries:                   # kernels built and loaded
        engine.query(idx, q)
    torch.cuda.synchronize(card)
    stats = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for q in queries:
                engine.query(idx, q, stats=stats)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in syncs)
    assert stats["syncs"] == len(syncs), (stats["syncs"], dict(sites))
    assert stats["syncs"] > 0
