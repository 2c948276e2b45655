"""The port's sequential engine against the reference's, end to end on the
tests/test_system.py corpus, plus the port's guards: no JAX or reference
import in the port, entry points that refuse to run on a missing card.
Every comparison is exact."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

from repro.core import varint as r_varint
from repro.index import builder as r_builder
from repro.index import corpus as r_corpus
from repro.index import engine as r_engine
from repro_torch.index import builder as t_builder
from repro_torch.index import convert as t_convert
from repro_torch.index import corpus as t_corpus
from repro_torch.index import engine as t_engine
from repro_torch.launch import serve as t_serve

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus():
    return r_corpus.synthesize(n_docs=1 << 16, n_queries=10, seed=3)


def _both(corpus, codec, B, **kw):
    ref = r_builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                          B=B, n_parts=2, **kw)
    port = t_builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                           B=B, n_parts=2, device="cpu", **kw)
    return ref, port


def _assert_same_answers(corpus, ref, port, *, skip=True, cache=False):
    r_cache = r_engine.DecodeCache() if cache else None
    t_cache = t_engine.DecodeCache() if cache else None
    for _ in range(2 if cache else 1):
        r_stats, t_stats = {}, {}
        for q in corpus.queries:
            a = r_engine.query(ref, q, cache=r_cache, skip=skip, stats=r_stats)
            b = t_engine.query(port, q, cache=t_cache, skip=skip, stats=t_stats)
            assert a.count == b.count, q
            assert a.docs.dtype == b.docs.dtype
            assert np.array_equal(a.docs, b.docs), q
        for k in ("decoded_ints", "skip_folds", "decoded_lists"):
            assert r_stats.get(k, 0) == t_stats.get(k, 0), k


def test_corpus_same_seed_same_corpus(corpus):
    port = t_corpus.synthesize(n_docs=1 << 16, n_queries=10, seed=3)
    assert port.queries == corpus.queries
    assert all(np.array_equal(a, b)
               for a, b in zip(port.postings, corpus.postings))
    shared = [c.synthesize(n_docs=1 << 16, n_queries=16, seed=5,
                           shared_vocab=True) for c in (r_corpus, t_corpus)]
    assert shared[0].queries == shared[1].queries


@pytest.mark.parametrize("codec", ["bp-d1", "bp-dv", "fastpfor-d1", "varint"])
@pytest.mark.parametrize("B", [0, 16])
def test_engine_matches_reference(corpus, codec, B):
    ref, port = _both(corpus, codec, B)
    _assert_same_answers(corpus, ref, port)
    assert port.stats() == ref.stats()


@pytest.mark.parametrize("codec", ["bp-d1", "fastpfor-d1"])
@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("cache", [True, False])
def test_engine_skip_and_cache_regimes(corpus, codec, skip, cache):
    ref, port = _both(corpus, codec, 16)
    _assert_same_answers(corpus, ref, port, skip=skip, cache=cache)


def test_engine_answers_match_brute_force(corpus):
    _, port = _both(corpus, "fastpfor-d1", 16)
    for q in corpus.queries:
        want = r_engine.brute_force(corpus.postings, q)
        assert np.array_equal(t_engine.brute_force(corpus.postings, q), want)
        got = t_engine.query(port, q)
        assert got.count == len(want)
        assert np.array_equal(np.sort(got.docs), want[: len(got.docs)])


def ref_index_to_numpy(idx) -> dict:
    """Read a reference HybridIndex into the plain numpy dict that
    ``convert.index_from_numpy`` takes."""
    parts = []
    for part in idx.parts:
        terms = {}
        for tid, tp in part.terms.items():
            p = tp.payload
            if tp.kind == "empty":
                payload = None
            elif tp.kind == "bitmap":
                payload = np.asarray(p)
            elif isinstance(p, r_varint.VarintList):
                payload = {"data": p.data, "n": p.n}
            else:
                payload = {f.name: (np.asarray(getattr(p, f.name))
                                    if hasattr(getattr(p, f.name), "shape")
                                    else getattr(p, f.name))
                           for f in dataclasses.fields(p)}
            terms[tid] = {"kind": tp.kind, "n": tp.n, "skip_ok": tp.skip_ok,
                          "payload": payload}
        parts.append({"doc_lo": part.doc_lo, "doc_hi": part.doc_hi,
                      "terms": terms})
    return {"n_docs": idx.n_docs, "B": idx.B, "codec_name": idx.codec_name,
            "parts": parts}


@pytest.mark.parametrize("codec", ["fastpfor-d1", "bp-d1"])
def test_index_from_numpy_serves_reference_index(corpus, codec):
    ref = r_builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                          B=16, n_parts=2)
    port = t_convert.index_from_numpy(ref_index_to_numpy(ref), device="cpu")
    _assert_same_answers(corpus, ref, port)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        t_serve.main(["--queries", "2"])
    with pytest.raises(RuntimeError):
        t_builder.build([np.arange(10)], 100)


@pytest.mark.parametrize("codec", ["streamvbyte", "composite", "auto"])
def test_serve_codec_breadth_hits_equal_fastpfor(codec, capsys):
    """``serve --codec streamvbyte|composite|auto`` on the CPU answers as the
    default fastpfor serve, sequential and batched, and prints the
    per-family storage line."""
    base = ["--queries", "6", "--device", "cpu", "--shared-vocab"]
    want = t_serve.main(base)["hits"]
    assert t_serve.main(base + ["--codec", codec])["hits"] == want
    assert t_serve.main(base + ["--codec", codec, "--batch", "4",
                                "--warmup"])["hits"] == want
    out = capsys.readouterr().out
    assert f"index codec {codec} on cpu" in out and "bytes/int" in out


def test_serve_runs_on_cpu_and_refuses_later_slices(capsys, tmp_path):
    """The sequential serve on the CPU, then the flags of the live and
    mutable slice, once refused, served the same way: their hits equal
    the sequential serve's where the corpus is the same (--qps), and the
    mutable runs end on their differential (and recovery) lines; an
    injected WAL crash is recovered from.  Archs not yet ported are still
    refused."""
    base = ["--queries", "4", "--device", "cpu", "--cache", "--shared-vocab"]
    rep = t_serve.main(base)
    assert len(rep["results"]) == 4
    assert "paper-index: 4 queries" in capsys.readouterr().out
    assert t_serve.main(base + ["--qps", "50"])["hits"] == rep["hits"]
    for flags in (["--mutate", "10"], ["--wal", str(tmp_path / "a")],
                  ["--mutate", "64", "--wal", str(tmp_path / "b"),
                   "--chaos", "crash@wal.append.add:3"]):
        t_serve.main(base + flags)
        out = capsys.readouterr().out
        assert "byte-identical to rebuild-from-scratch" in out
        assert ("--wal" not in flags) or "[serve] recovery check:" in out
        assert ("--chaos" not in flags) or "recovering from" in out
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_serve.main(["--arch", "graphsage-reddit", "--device", "cpu"])
