"""The port's examples (``repro_torch.examples``) on the CPU against the
reference's library on the same inputs.

Each example's ``main(device="cpu")`` runs, and its deterministic numbers
equal what the reference computes from the same numpy draws: bits/int of
each codec and the match counts (quickstart); bits/int and total hits of
each build (search_engine); bits/item and the candidate list
(recsys_retrieval); bits/edge (gnn_sampling); the shuffle index's bits/id
and the parameter count (train_lm).  The GNN's and the LM's losses must
fall.  Sizes cut for the CPU's time, said at each test: search_engine
(2**15 docs, 12 queries: the reference's 2**17 docs take about a minute a
build), gnn_sampling (30 of its 60 steps), train_lm (40 of its 300
steps).  Weights and sampler draws come from ``torch.Generator``s in the
port and from ``jax.random`` in the reference, so losses and top-k lists
are each package's own.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.core import bitpack as ref_bitpack
from repro.core import codecs as ref_codecs
from repro.data import clusterdata as ref_clusterdata
from repro.data import graph_data as ref_graph_data
from repro.data import lm_data as ref_lm_data
from repro.index import builder as ref_builder
from repro.index import corpus as ref_corpus
from repro.index import engine as ref_engine
from repro.models import transformer as ref_transformer
from repro_torch.examples import (gnn_sampling, quickstart,
                                  recsys_retrieval, search_engine, train_lm)

pytestmark = pytest.mark.torch_port


def test_quickstart():
    got = quickstart.main("cpu")
    rng = np.random.default_rng(0)
    docs = ref_clusterdata.clusterdata(rng, 100_000, universe_bits=24)
    for name, bits in got["bits_per_int"].items():
        codec = ref_codecs.get_codec(name)
        assert bits == codec.bits_per_int(codec.encode(docs)), name
    r, f = ref_clusterdata.paired_lists(rng, 2_000, 500_000,
                                        universe_bits=24)
    want = len(np.intersect1d(r, f))
    assert got["matches"] == got["packed_matches"] == want


def test_search_engine():
    n_docs, n_queries = 1 << 15, 12          # cut for the CPU's time
    got = search_engine.main("cpu", n_docs=n_docs, n_queries=n_queries)
    corpus = ref_corpus.synthesize(n_docs=n_docs, n_queries=n_queries,
                                   seed=11)
    hits = sum(len(ref_engine.brute_force(corpus.postings, q))
               for q in corpus.queries)
    assert set(got) == set(search_engine.BUILDS)
    for (codec, B), res in got.items():
        idx = ref_builder.build(corpus.postings, corpus.n_docs,
                                codec_name=codec, B=B, n_parts=2)
        assert res["bits_per_int"] == idx.stats()["bits_per_int"], \
            (codec, B)
        assert res["hits"] == hits
        assert res["ms_per_query"] > 0


def test_recsys_retrieval():
    got = recsys_retrieval.main("cpu")
    rng = np.random.default_rng(7)
    cate_of = rng.integers(0, 64, size=1 << 16)
    brand_of = rng.integers(0, 128, size=1 << 16)
    cate = {c: np.nonzero(cate_of == c)[0].astype(np.int64)
            for c in range(64)}
    bits = np.mean([ref_bitpack.bits_per_int(ref_bitpack.encode(v, "d1"))
                    for v in cate.values()])
    assert got["bits_per_item"] == bits
    want = np.intersect1d(cate[3], np.nonzero(brand_of == 17)[0])
    assert np.array_equal(got["candidates"], want)
    top = got["top"]                  # the port's own weights' ranking
    assert len(set(top)) == len(top) == min(10, len(want))
    assert set(top) <= set(want.tolist())


def test_gnn_sampling():
    got = gnn_sampling.main("cpu", steps=30)         # 30 of 60 steps
    g = ref_graph_data.synthetic_graph(20_000, 16, seed=0, d_feat=64,
                                       n_classes=16)
    cc = ref_graph_data.CompressedCSR.compress(g["indptr"], g["indices"],
                                               20_000)
    assert got["bits_per_edge"] == cc.bits_per_edge()
    assert got["losses"][-1] < got["losses"][0]


def test_train_lm(tmp_path):
    got = train_lm.main("cpu", steps=40,               # 40 of 300 steps
                        ckpt_dir=str(tmp_path / "ckpt"))
    _, packed = ref_lm_data.make_shuffle_index(100_000, epoch=0)
    assert got["shuffle_bits_per_id"] == ref_bitpack.bits_per_int(packed)
    cfg = ref_transformer.LMConfig(
        name="lm-demo", n_layers=4, d_model=128, n_heads=4, n_kv=2,
        d_ff=256, vocab=512, act="swiglu", remat="none")
    shapes = jax.eval_shape(lambda: ref_transformer.init_params(
        jax.random.PRNGKey(0), cfg))
    assert got["n_params"] == sum(x.size for x in jax.tree.leaves(shapes))
    assert got["history"][-1] < got["history"][0]
    assert (tmp_path / "ckpt").is_dir()
