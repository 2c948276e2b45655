"""The port's fault injector and server resilience
(``repro_torch.launch.faults``, ``launch.server``) against the reference's,
case for case with tests/test_faults.py: the same spec and seed fire the
same faults at the same calls in both packages; the degradation ladder
walks its rungs in lockstep with the reference's
``DegradationLadder("jax", True)`` under an injected clock; and the port's
server, under injected faults, resolves every request and answers as the
reference's sequential engine does."""

import asyncio

import numpy as np
import pytest

from repro.index import builder as r_builder
from repro.index import corpus as r_corpus
from repro.index import engine as r_engine
from repro.launch import faults as r_faults
from repro.launch import server as r_server
from repro_torch.index import builder as t_builder
from repro_torch.launch import faults
from repro_torch.launch import server as server_lib

pytestmark = [pytest.mark.torch_port, pytest.mark.server, pytest.mark.faults]


@pytest.fixture(scope="module")
def uniform():
    corpus = r_corpus.synthesize(n_docs=1 << 14, n_queries=12, seed=33)
    ref = r_builder.build(corpus.postings, corpus.n_docs,
                          codec_name="fastpfor-d1", B=16, n_parts=2)
    idx = t_builder.build(corpus.postings, corpus.n_docs,
                          codec_name="fastpfor-d1", B=16, n_parts=2,
                          device="cpu")
    seq = [r_engine.query(ref, q) for q in corpus.queries]
    return idx, corpus.queries, seq


def _assert_identical(results, seq):
    assert len(results) == len(seq)
    for got, want in zip(results, seq):
        assert got.count == want.count
        assert got.docs.dtype == want.docs.dtype
        assert np.array_equal(got.docs, want.docs)


def _drive(inj, points):
    """Fire ``points`` in order; the outcome of each ("ok", "torn" or the
    exception's class name) and the injector's record afterwards."""
    out = []
    for p in points:
        try:
            out.append(inj.fire(p) or "ok")
        except RuntimeError as e:
            out.append(type(e).__name__)
    return out, dict(inj.hits), list(inj.fired), inj.counts(), inj.armed


# --------------------------------------------------------------------------
# the injector
# --------------------------------------------------------------------------

def test_spec_parsing_arms_rules():
    spec = "crash@wal.append.add:3, transient@launch:0.5,delay@collect:2"
    inj, ref = faults.FaultInjector(spec), r_faults.FaultInjector(spec)
    assert inj.armed == ref.armed == 3
    assert inj.counts() == ref.counts() == {}
    assert faults.CRASH_POINTS == r_faults.CRASH_POINTS
    assert faults.KNOWN_POINTS == r_faults.KNOWN_POINTS


@pytest.mark.parametrize("spec", [
    "explode@launch",                   # unknown kind
    "crash@nowhere",                    # unknown point
    "crash@launch",                     # crash at a server seam
    "torn@snapshot.write",              # torn off the WAL
    "crash-wal.append.add",             # malformed clause
])
def test_bad_specs_rejected(spec):
    with pytest.raises(ValueError):
        r_faults.FaultInjector(spec)
    with pytest.raises(ValueError):
        faults.FaultInjector(spec)


def test_counted_rule_counts_from_arm_time():
    def run(mod):
        inj = mod.FaultInjector()
        inj.fire("wal.append.add")      # pre-arm traffic must not count
        inj.arm("crash", "wal.append.add", 3)
        return _drive(inj, ["wal.append.add"] * 4)
    got = run(faults)
    assert got == run(r_faults)
    out, hits, _, counts, armed = got
    assert out == ["ok", "ok", "InjectedCrash", "ok"]
    assert armed == 0 and counts == {"crash@wal.append.add": 1}
    assert hits["wal.append.add"] == 5


def test_transient_first_n_hits_then_clean():
    def run(mod):
        return _drive(mod.FaultInjector("transient@launch:2"), ["launch"] * 3)
    got = run(faults)
    assert got == run(r_faults)
    assert got[0] == ["TransientFault", "TransientFault", "ok"]
    assert got[3] == {"transient@launch": 2}


def test_probability_rule_is_seed_deterministic():
    def run(mod, seed):
        inj = mod.FaultInjector("transient@launch:0.3", seed=seed)
        return _drive(inj, ["launch"] * 64)[0]
    a = run(faults, 7)
    assert a == run(faults, 7) == run(r_faults, 7)   # the reference's too
    assert 0 < a.count("TransientFault") < 64
    assert run(faults, 8) != a and run(faults, 8) == run(r_faults, 8)


def test_merge_hook_adapter_chains_inner():
    for mod in (r_faults, faults):
        inj = mod.FaultInjector()
        inj.arm("crash", "merge.build", 1)
        seen = []
        hook = inj.merge_hook(inner=seen.append)
        hook("snapshot")
        hook("decode")
        with pytest.raises(mod.InjectedCrash):
            hook("build")
        assert seen == ["snapshot", "decode", "build"]


# --------------------------------------------------------------------------
# the degradation ladder, in lockstep with the reference's
# --------------------------------------------------------------------------

def _lockstep(events, *, threshold, cooldown_s):
    """Drive the port's ladder and the reference's ("jax", True) ladder
    through the same events under one injected clock; at every step the
    rung index, its fuse flag and both counters must agree."""
    t = [0.0]
    lad = server_lib.DegradationLadder(True, threshold=threshold,
                                       cooldown_s=cooldown_s,
                                       clock=lambda: t[0])
    ref = r_server.DegradationLadder("jax", True, threshold=threshold,
                                     cooldown_s=cooldown_s,
                                     clock=lambda: t[0])
    assert lad.levels == [fuse for _, fuse in ref.levels] == [True, False]
    trace = []
    for ev in events:
        if isinstance(ev, float):
            t[0] += ev
            continue
        a = getattr(lad, ev)()
        b = getattr(ref, ev)()
        assert a == b
        assert (lad.level, lad.current, lad.n_degradations,
                lad.n_promotions) == (ref.level, ref.current[1],
                                      ref.n_degradations, ref.n_promotions)
        trace.append(lad.level)
    return lad, trace


def test_degradation_ladder_state_machine():
    """tests/test_faults.py's sequence (threshold 2, cooldown 1 s).  The
    reference's case runs ("pallas", True), three rungs; the port has the
    two of ("jax", True), so the third step-down holds at the bottom."""
    lad, trace = _lockstep(
        ["on_failure", "on_failure", "on_failure", "on_failure",
         "on_failure", "on_failure", "on_success", 1.5, "on_success",
         "on_success", 1.5, "on_success"], threshold=2, cooldown_s=1.0)
    assert trace == [0, 1, 1, 1, 1, 1, 1, 0, 0, 0]
    assert lad.n_degradations == 1 and lad.n_promotions == 1
    assert lad.current is True and not lad.degraded


def test_ladder_failure_rearms_cooldown():
    lad, trace = _lockstep(
        ["on_failure", 0.9, "on_failure", 0.9, "on_success", 0.2,
         "on_success"], threshold=1, cooldown_s=1.0)
    assert trace == [1, 1, 1, 0]


# --------------------------------------------------------------------------
# server end-to-end resilience
# --------------------------------------------------------------------------

def test_server_transient_faults_retry_zero_lost(uniform):
    idx, queries, seq = uniform
    inj = faults.FaultInjector("transient@launch:3", seed=0)
    srv = server_lib.ContinuousBatchingServer(
        idx, max_batch=4, max_queue=1024, injector=inj, max_retries=6,
        retry_backoff_ms=0.1)
    results = asyncio.run(srv.run(queries, [0.0] * len(queries)))
    m = srv.metrics
    assert m.n_faults == 3 and m.n_retries == 3
    assert m.n_errors == 0 and m.n_shed == 0
    assert srv.outcomes() == ["done"] * len(queries)
    _assert_identical(results, seq)


def test_server_retry_exhaustion_resolves_as_errors(uniform):
    idx, queries, _ = uniform
    inj = faults.FaultInjector("transient@launch:1000000", seed=0)
    srv = server_lib.ContinuousBatchingServer(
        idx, max_batch=4, max_queue=1024, injector=inj, max_retries=2,
        retry_backoff_ms=0.1)
    results = asyncio.run(srv.run(queries, [0.0] * len(queries)))
    assert all(r is None for r in results)
    outs = srv.outcomes()
    assert set(outs) == {"error"} and len(outs) == len(queries)
    assert srv.metrics.n_errors == len(queries)
    assert srv.metrics.n_retries > 0


def test_server_persistent_error_never_hangs(uniform):
    idx, queries, _ = uniform
    inj = faults.FaultInjector("error@launch:1000000", seed=0)
    srv = server_lib.ContinuousBatchingServer(
        idx, max_batch=4, max_queue=1024, injector=inj)
    results = asyncio.run(srv.run(queries, [0.0] * len(queries)))
    assert all(r is None for r in results)
    assert srv.outcomes() == ["error"] * len(queries)
    assert srv.metrics.n_flushes >= 2


def test_server_collect_seam_fault_resolves_as_errors(uniform):
    idx, queries, seq = uniform
    inj = faults.FaultInjector("error@collect:1", seed=0)
    srv = server_lib.ContinuousBatchingServer(
        idx, max_batch=4, max_queue=1024, injector=inj)
    results = asyncio.run(srv.run(queries, [0.0] * len(queries)))
    outs = srv.outcomes()
    assert "pending" not in outs
    assert outs.count("error") == 4              # exactly one failed flush
    assert outs.count("done") == len(queries) - 4
    done = [(r, w) for r, w, s in zip(results, seq, outs) if s == "done"]
    _assert_identical([r for r, _ in done], [w for _, w in done])


@pytest.mark.parametrize("seam", ["launch", "collect"])
def test_server_real_failure_propagates(uniform, seam, monkeypatch):
    """Only injected faults are served around: a real failure at either
    seam (here a RuntimeError, as a failed launch or a CUDA error would
    raise) ends the run instead of resolving its batch as errors, where
    the reference's server catches every exception."""
    idx, queries, _ = uniform

    def fail(*a, **kw):
        raise RuntimeError(f"a real failure at {seam}")

    if seam == "launch":
        monkeypatch.setattr(server_lib.ContinuousBatchingServer, "_launch",
                            fail)
    else:
        monkeypatch.setattr(server_lib.batch_lib, "collect_batch", fail)
    srv = server_lib.ContinuousBatchingServer(idx, max_batch=4,
                                              max_queue=1024)
    with pytest.raises(RuntimeError, match=f"a real failure at {seam}"):
        asyncio.run(srv.run(queries, [0.0] * len(queries)))
    assert srv.metrics.n_errors == 0 and srv.metrics.n_faults == 0


def test_server_degrades_and_repromotes_to_zero_compiles(uniform):
    """The breaker steps down under a fault burst, promotes back after the
    cooldown, and steady-state serving after re-promotion launches no new
    program signature (the port's compile count is always available)."""
    idx, queries, seq = uniform
    inj = faults.FaultInjector("transient@launch:4", seed=0)
    stats: dict = {}
    srv = server_lib.ContinuousBatchingServer(
        idx, max_batch=4, max_queue=1024, injector=inj, max_retries=8,
        retry_backoff_ms=0.1, breaker_threshold=2, cooldown_ms=0.0,
        stats=stats)
    server_lib.warm_server(srv, queries)
    results = asyncio.run(srv.run(queries, [0.0] * len(queries)))
    m = srv.metrics
    assert m.n_faults == 4 and m.n_retries == 4
    assert srv.ladder.n_degradations >= 1
    assert srv.ladder.n_promotions >= 1
    assert srv.ladder.level == 0
    assert m.degraded_flushes >= 1
    assert srv.outcomes() == ["done"] * len(queries)
    _assert_identical(results, seq)
    stats.pop("n_compiles", None)
    results2 = asyncio.run(srv.run(queries, [0.0] * len(queries)))
    assert stats.get("n_compiles", 0) == 0
    assert srv.outcomes() == ["done"] * len(queries)
    _assert_identical(results2, seq)


def test_server_timeout_outcomes_counted(uniform):
    idx, queries, _ = uniform
    srv = server_lib.ContinuousBatchingServer(
        idx, max_batch=4, max_queue=1024, timeout_ms=1e-4)
    results = asyncio.run(srv.run(queries, [0.0] * len(queries)))
    assert all(r is None for r in results)
    assert srv.outcomes() == ["timeout"] * len(queries)
    assert srv.metrics.n_timeout == len(queries)
    s = srv.metrics.summary()
    assert s["n_timeout"] == len(queries) and s["n_done"] == 0
