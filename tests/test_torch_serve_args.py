"""The port's ``coerce_index_flags`` against the reference's, case for case
with tests/test_serve_args.py: the same namespace through both functions
gives the same effective flags and warnings naming the same flags, and
every case, the live (``--qps``), mutable (``--mutate``), durable
(``--wal``) and chaos (``--chaos``) ones included, is accepted after
coercion and serves on the CPU."""

import argparse
import re

import pytest

from repro.launch.serve import coerce_index_flags as r_coerce
from repro_torch.launch import serve as t_serve

pytestmark = pytest.mark.torch_port


def _ns(**kw):
    base = dict(batch=0, pipeline=0, shards=0, resident=False, fuse=True,
                warmup=False, cache=False, queries=20, backend="jax",
                shared_vocab=False, tokens=16, mutate=0, delete_frac=None,
                wal=None, chaos=None, timeout_ms=None, qps=0.0, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


def _flags(warnings: list[str]) -> list[str]:
    """The flag each warning is about (the first it names), in order."""
    return [re.findall(r"--[a-z-]+", w)[0] for w in warnings]


CASES = {
    "plain_flags_pass_through_unwarned":
        dict(batch=64, pipeline=2, resident=True),
    "sequential_mode_untouched": {},
    "shards_coerces_batch_pipeline_resident": dict(shards=2),
    "shards_ignores_cache_with_warning":
        dict(shards=2, batch=64, pipeline=4, resident=True, cache=True),
    "pipeline_implies_batched_and_resident": dict(pipeline=2),
    "pipeline_with_explicit_batch_keeps_it":
        dict(pipeline=3, batch=16, resident=True),
    "warmup_without_fuse_warns": dict(batch=8, warmup=True, fuse=False),
    "warmup_with_fuse_silent": dict(batch=8, warmup=True),
    "mutate_implies_batched_and_resident": dict(mutate=100),
    "mutate_drops_pipeline_and_cache_with_warnings":
        dict(mutate=100, batch=16, resident=True, pipeline=2, cache=True),
    "mutate_with_explicit_flags_silent":
        dict(mutate=100, batch=16, resident=True, delete_frac=0.2),
    "delete_frac_without_mutate_warns_and_clears":
        dict(batch=8, delete_frac=0.5),
    "mutate_composes_with_shards_unwarned":
        dict(mutate=100, batch=16, resident=True, shards=2),
    "wal_implies_mutate": dict(wal="/tmp/w", batch=16, resident=True),
    "wal_with_explicit_mutate_silent":
        dict(wal="/tmp/w", mutate=64, batch=16, resident=True),
    "chaos_without_wal_warns_but_keeps_spec":
        dict(chaos="transient@launch:0.1", batch=8),
    "chaos_with_wal_unwarned":
        dict(chaos="crash@wal.append.add:5", wal="/tmp/w", mutate=64,
             batch=16, resident=True),
    "timeout_without_qps_warns_and_clears": dict(timeout_ms=50.0, batch=8),
    "timeout_with_qps_kept": dict(timeout_ms=50.0, qps=500.0, batch=16),
    "qps_coerces_batch_and_drops_pipeline_and_shards":
        dict(qps=500.0, pipeline=2, shards=2),
    "qps_mutate_with_explicit_flags_silent":
        dict(qps=500.0, mutate=64, batch=16, resident=True, timeout_ms=100.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_coerce_matches_reference(case):
    r_args, t_args = _ns(**CASES[case]), _ns(**CASES[case])
    want = r_coerce(r_args)
    got = t_serve.coerce_index_flags(t_args)
    assert vars(t_args) == vars(r_args)
    assert _flags(got) == _flags(want)
    # every warning reads as the reference's but the one that points at
    # the reference's live server
    ours = "--shards ignored with --qps"
    assert [w for w in got if not w.startswith(ours)] == \
        [w for w in want if not w.startswith(ours)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_later_slices_still_refused_after_coercion(case, tmp_path, capsys):
    """Once refused as "not yet ported", every case's flags now pass
    ``check_ported`` after coercion and serve four queries on the CPU
    (a 4096-document corpus), down the branch the reference's
    ``serve_index`` takes: live, mutable, sharded, pipelined, batched or
    sequential, each with its own checks."""
    kw = dict(CASES[case])
    if kw.get("wal"):
        kw["wal"] = str(tmp_path / "wal")
    args = _ns(**kw, queries=4, device="cpu", codec="fastpfor",
               corpus_seed=5)
    t_serve.coerce_index_flags(args)
    t_serve.check_ported(args)
    rep = t_serve.serve_index(args, n_docs=1 << 12)
    assert len(rep["results"]) == 4
    out = capsys.readouterr().out
    if args.qps:
        assert "answered queries byte-identical to direct execution" in out
    elif args.mutate:
        assert "byte-identical to rebuild-from-scratch" in out
    if args.wal:
        assert "[serve] recovery check:" in out


@pytest.mark.parametrize("flags", [["--pipeline", "2"], ["--shards", "2"],
                                   ["--resident"]])
def test_cli_parses_the_ported_flags(flags):
    args = t_serve.build_parser().parse_args(flags)
    t_serve.coerce_index_flags(args)
    t_serve.check_ported(args)          # no longer "not yet ported"
    assert args.resident and (args.batch > 1 or flags == ["--resident"])


@pytest.mark.parametrize("flag", [
    ["--qps", "400"], ["--mutate", "10"], ["--wal", "WAL"],
    ["--chaos", "transient@launch:2", "--qps", "400"]])
def test_cli_refuses_later_slices(flag, tmp_path, capsys):
    """The four flags once refused now parse and run through ``main`` on
    the CPU, each printing the reference's differential line (and, under
    --wal, its recovery line); a spec naming no fault point is refused."""
    flag = [str(tmp_path / "wal") if f == "WAL" else f for f in flag]
    args = t_serve.build_parser().parse_args(flag)
    t_serve.coerce_index_flags(args)
    t_serve.check_ported(args)
    rep = t_serve.main(["--queries", "4", "--device", "cpu", *flag])
    assert len(rep["results"]) == 4
    out = capsys.readouterr().out
    assert "[serve] differential check:" in out
    if "--wal" in flag:
        assert "[serve] recovery check:" in out
    if "--chaos" in flag:
        assert "[serve] chaos: {'transient@launch':" in out
        with pytest.raises(ValueError, match="unknown fault point"):
            t_serve.main(["--queries", "4", "--device", "cpu", "--qps",
                          "400", "--chaos", "crash@x"])


@pytest.mark.parametrize("seed", [0, 7])
def test_seed_seeds_chaos_and_arrivals_as_the_reference(seed, monkeypatch,
                                                         capsys):
    """``--seed`` means what the reference's does: the --chaos schedule
    and the --qps arrival gaps (the corpus takes ``--corpus-seed``).  The
    port's injector from ``--seed N`` fires at the same calls as the
    reference's, and its live serve draws the reference's gaps."""
    from repro.launch import serve as r_serve, server as r_server
    from repro_torch.launch import server as t_server
    spec = "transient@launch:0.3,error@collect:0.2"
    args = t_serve.build_parser().parse_args(
        ["--chaos", spec, "--seed", str(seed)])
    assert args.corpus_seed == 5
    ours = t_serve._injector(args)
    ref = r_serve._injector(argparse.Namespace(chaos=spec, seed=seed))
    for inj in (ours, ref):
        for i in range(200):
            try:
                inj.fire("launch" if i % 2 else "collect")
            except RuntimeError:
                pass
    assert ours.fired == ref.fired and ours.counts() == ref.counts()
    drawn, real = [], t_server.arrival_gaps

    def gaps(*a, **kw):
        drawn.append(real(*a, **kw))
        return drawn[-1]

    monkeypatch.setattr(t_server, "arrival_gaps", gaps)
    t_serve.main(["--queries", "4", "--device", "cpu", "--qps", "400",
                  "--seed", str(seed)])
    assert "[serve] differential check:" in capsys.readouterr().out
    assert drawn == [r_server.arrival_gaps(4, 400.0, "poisson", seed=seed)]


@pytest.mark.parametrize("fails", [1, 3])
def test_mutate_refuses_a_merge_that_failed(fails, monkeypatch):
    """``merge_async`` retries a failed merge and records it; the mutable
    serve raises where a merge attempt failed without an injected
    ``merge.*`` fault, whether a retry then succeeded (1) or all three
    attempts failed (3)."""
    from repro_torch.index import segments
    merge, calls = segments.MutableIndex.merge, []

    def flaky(self, **kw):
        calls.append(1)
        if len(calls) <= fails:
            raise RuntimeError("a merge that failed")
        return merge(self, **kw)

    monkeypatch.setattr(segments.MutableIndex, "merge", flaky)
    with pytest.raises(RuntimeError, match="background merge failed"):
        t_serve.main(["--queries", "4", "--device", "cpu", "--mutate", "20",
                      "--batch", "4"])
    assert len(calls) == min(fails + 1, 3)
