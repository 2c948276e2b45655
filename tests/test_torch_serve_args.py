"""The port's ``coerce_index_flags`` against the reference's, case for case
with tests/test_serve_args.py: the same namespace through both functions
gives the same effective flags and warnings naming the same flags, and
the flags of later slices are still refused after coercion."""

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
def test_later_slices_still_refused_after_coercion(case):
    args = _ns(**CASES[case])
    t_serve.coerce_index_flags(args)
    later = [f for f in ("mutate", "qps", "wal", "chaos")
             if getattr(args, f)]
    if later:
        with pytest.raises(NotImplementedError, match="not yet ported"):
            t_serve.check_ported(args)
    else:
        t_serve.check_ported(args)


@pytest.mark.parametrize("flags", [["--pipeline", "2"], ["--shards", "2"],
                                   ["--resident"]])
def test_cli_parses_the_ported_flags(flags):
    args = t_serve.build_parser().parse_args(flags)
    t_serve.coerce_index_flags(args)
    t_serve.check_ported(args)          # no longer "not yet ported"
    assert args.resident and (args.batch > 1 or flags == ["--resident"])


@pytest.mark.parametrize("flag", [["--qps", "100"], ["--mutate", "10"],
                                  ["--wal", "w"], ["--chaos", "crash@x"]])
def test_cli_refuses_later_slices(flag):
    args = t_serve.build_parser().parse_args(flag)
    t_serve.coerce_index_flags(args)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_serve.check_ported(args)
