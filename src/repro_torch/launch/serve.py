"""Serving launcher for the port: conjunctive-query serving, sequential or
batched, live or on a mutable, durable index; greedy generation on the
LMs, dense and MoE; batched scoring on the recsys models.

Port of the paper-index path of ``src/repro/launch/serve.py``
(``coerce_index_flags``, ``serve_index`` with its sequential, ``--batch``,
``--resident``, ``--pipeline``, ``--shards``, ``--qps`` and ``--mutate``
branches, ``serve_index_live``, ``serve_index_mutable`` and their
``--wal`` / ``--chaos`` helpers), of its LM path (``serve_lm``) and of its
recsys path (``serve_recsys``).
It synthesizes the corpus, builds the HYB+M2 index (B=16, two parts) on the
device, warms, and serves every query once more under the clock.
``--batch N`` (N > 1) serves through the batched engine
(``index.batch.execute_batch``) in batches of N, fused into megagroup
programs unless ``--no-fuse`` is given; ``--warmup`` warms the fused family
ladder with ``batch.warmup`` first.  ``--resident`` warms a
``source.ResidentPool`` (and prints its stats) that the engine serves
from; ``--pipeline D`` serves through ``index.pipeline.execute_pipelined``
with D batches in flight and prints the stage breakdown; ``--shards N``
places the index's parts (max(N, 2) of them) on N shards, prints the
placement map (shard → device → parts) and serves through
``index.shard.execute_sharded``.  ``coerce_index_flags`` turns the implied
flags on, with a warning each (``--pipeline`` implies ``--batch 32`` and
``--resident``; ``--shards`` also ``--pipeline 2``).  Hits equal the
sequential serve's in every mode.

``--qps Q`` serves the queries open loop at Q requests/s through the
continuous-batching server (``launch.server``), with ``--timeout-ms``
deadlines and ``--chaos`` faults, and checks every answered request
against direct execution.  ``--mutate N`` bootstraps a
``segments.MutableIndex``, applies N adds (sealing half way) and
``--delete-frac``·N tombstones, serves while a background merge runs, and
checks every answer against a rebuild from scratch; with ``--qps`` the
live server serves it.  ``--wal DIR`` journals every mutation in a
``durability.DurableLog`` and ends with a recovery check (an injected
``--chaos crash@wal.*`` cuts the stream, recovers and serves on).
``--seed`` seeds the fault schedule and the arrival gaps, as the
reference's does; ``--corpus-seed`` seeds the corpus (the reference fixes
it at 5).

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 20
  PYTHONPATH=src python -m repro_torch.launch.serve --queries 20 --cache \\
      --shared-vocab --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --batch 32 --warmup
  PYTHONPATH=src python -m repro_torch.launch.serve --codec auto --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --resident --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --pipeline 2
  PYTHONPATH=src python -m repro_torch.launch.serve --shards 2
  PYTHONPATH=src python -m repro_torch.launch.serve --qps 500 --batch 16 \\
      --warmup
  PYTHONPATH=src python -m repro_torch.launch.serve --mutate 120 \\
      --delete-frac 0.2 --batch 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --qps 500 --wal DIR \\
      --mutate 64 --chaos crash@wal.append.add:40 --batch 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --device cpu --tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch kimi-k2-1t-a32b \\
      --device cpu --tokens 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec --device cpu

``--arch <lm id>`` (gemma-7b, phi3-medium-14b, internlm2-1.8b, and the MoE
LMs granite-moe-1b-a400m and kimi-k2-1t-a32b) runs prefill and greedy
decode on the smoke-reduced model, as the reference's ``serve_lm`` does:
random weights from seed 0, a batch of ``--batch`` (default 4) 16-token
prompts from seed 1, ``--tokens`` new tokens.  ``--arch <recsys id>``
(din, sasrec, bert4rec, mind) scores a batch of ``--batch`` (default 4)
from the arch's batch maker with numpy seed 0 on the smoke-reduced model
(params from seed 0), once to warm and once under the clock, as the
reference's ``serve_recsys`` does.  The GNN (graphsage-reddit) has no
serving mode, as in the reference: it exits with "no serving mode for
family gnn" (``repro_torch.launch.train`` trains it).

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
there is no card.
"""

from __future__ import annotations

import argparse
import time

import torch

import numpy as np

from repro_torch.configs.base import NOT_YET_PORTED, get_config
from repro_torch.kernels import ops

# --codec flag value -> builder codec name ("auto" goes to the storage
# autotuner; everything else pins one family index-wide)
_CODEC_NAMES = {"auto": "auto", "bitpack": "bp-d1",
                "streamvbyte": "streamvbyte-d1", "composite": "composite-d1",
                "fastpfor": "fastpfor-d1", "varint": "varint"}


def check_ported(args) -> None:
    """Raise NotImplementedError for an arch the port does not have yet
    (``configs.base.NOT_YET_PORTED``, empty now that the GNN is ported).
    Every flag of the reference's serve is ported."""
    arch = getattr(args, "arch", "paper-index")
    if arch in NOT_YET_PORTED:
        raise NotImplementedError(f"arch {arch!r} ({NOT_YET_PORTED[arch]}) "
                                  f"is not yet ported")


def coerce_index_flags(args) -> list[str]:
    """Normalise paper-index flag interactions, returning one warning line
    per coerced or ignored flag (the reference's table, whole).  ``args``
    is changed in place so the serving paths read the effective values."""
    warnings = []
    if getattr(args, "wal", None) and not getattr(args, "mutate", 0):
        warnings.append("--wal implies the mutable index: --mutate 0 -> 256")
        args.mutate = 256
    if getattr(args, "chaos", None) and not getattr(args, "wal", None):
        warnings.append("--chaos without --wal: durability crash points "
                        "(wal.*/snapshot.*/merge.*) have no durable "
                        "directory to recover from — only launch/collect "
                        "seam faults can fire safely")
    if (getattr(args, "timeout_ms", None) is not None
            and not getattr(args, "qps", 0)):
        warnings.append("--timeout-ms ignored without --qps (offline and "
                        "drain serving have no per-request deadlines)")
        args.timeout_ms = None
    if getattr(args, "qps", 0):
        if args.pipeline:
            warnings.append("--pipeline ignored with --qps (the live "
                            "server bounds in-flight batches itself)")
            args.pipeline = 0
        if args.shards:
            warnings.append("--shards ignored with --qps (live sharded "
                            "serving is the live server's own mode)")
            args.shards = 0
        if args.batch <= 1:
            warnings.append(f"--qps implies batched mode: "
                            f"--batch {args.batch} -> 32")
            args.batch = 32
    if getattr(args, "mutate", 0):
        if args.batch <= 1:
            warnings.append(f"--mutate implies batched mode: "
                            f"--batch {args.batch} -> 32")
            args.batch = 32
        if args.pipeline:
            warnings.append("--pipeline ignored with --mutate (the mutable "
                            "path batches against generation snapshots)")
            args.pipeline = 0
        if args.cache:
            warnings.append("--cache ignored with --mutate (decoded "
                            "results change as the corpus mutates)")
            args.cache = False
        if not args.resident:
            warnings.append("--mutate implies the device-resident index: "
                            "--resident on (each generation owns a warmed "
                            "ResidentPool)")
            args.resident = True
        return warnings
    if getattr(args, "delete_frac", None) is not None:
        warnings.append("--delete-frac ignored without --mutate")
        args.delete_frac = None
    if args.shards:
        if args.batch <= 1:
            warnings.append(f"--shards implies batched mode: "
                            f"--batch {args.batch} -> 32")
            args.batch = 32
        if not args.pipeline:
            warnings.append("--shards implies pipelined serving: "
                            "--pipeline 0 -> 2")
            args.pipeline = 2
        if args.cache:
            warnings.append("--cache ignored with --shards (per-shard "
                            "device residency supersedes the decode cache)")
            args.cache = False
        if not args.resident:
            warnings.append("--shards implies the device-resident index: "
                            "--resident on")
            args.resident = True
    elif args.pipeline:
        if args.batch <= 1:
            warnings.append(f"--pipeline implies batched mode: "
                            f"--batch {args.batch} -> 32")
            args.batch = 32
        if not args.resident:
            warnings.append("--pipeline implies the device-resident index: "
                            "--resident on")
            args.resident = True
    if args.warmup and not args.fuse:
        warnings.append("--warmup warms the fused family ladder; with "
                        "--no-fuse the signature fixed-point loop covers it")
    return warnings


def serve_queries(idx, queries, *, cache=None, skip: bool = True,
                  pool=None) -> dict:
    """Serve ``queries`` sequentially as the reference's serve loop does:
    warm passes first (two when a cache or a pool changes how terms
    resolve, else one), then one timed pass that ends on the host with
    every answer read back.  Returns the results, the wall time and the
    engine's counters."""
    from repro_torch.index import engine
    for _ in range(2 if (cache is not None or pool is not None) else 1):
        for q in queries:
            engine.query(idx, q, cache=cache, skip=skip, pool=pool)
    stats: dict = {}
    t0 = time.perf_counter()
    results = [engine.query(idx, q, cache=cache, skip=skip, stats=stats,
                            pool=pool)
               for q in queries]
    dt = time.perf_counter() - t0
    return {"results": results, "seconds": dt, "stats": stats,
            "hits": sum(r.count for r in results)}


def serve_batched(idx, queries, *, batch: int, fuse: bool = True,
                  warmup: bool = False, cache=None, skip: bool = True,
                  plan=None, pool=None, depth: int = 0) -> dict:
    """Serve ``queries`` through ``batch.execute_batch`` in batches of
    ``batch`` (with ``depth`` > 0, through ``pipeline.execute_pipelined``
    with that many batches in flight), as the reference's ``--batch`` loop
    does: warm first (``batch.warmup`` over the query stream with
    ``warmup`` and ``fuse``, else passes until no new program signature
    appears), then one timed pass that ends with every answer on the host.
    ``plan`` is the serving session's FusionPlan (a new one when None;
    unused unfused); ``pool`` a ResidentPool to serve from.  Returns the
    results, the wall time, the counters of the timed pass, the warmup's
    report and, pipelined, the timed pass's ``StageTimings``."""
    from repro_torch.index import batch as batch_lib
    from repro_torch.index import pipeline as pipe_lib
    if not fuse:
        plan = None
    elif plan is None:
        plan = batch_lib.FusionPlan()

    def run_all(stats=None, timings=None):
        stats = {} if stats is None else stats
        if depth:
            return pipe_lib.execute_pipelined(
                idx, queries, batch_size=batch, depth=depth, cache=cache,
                skip=skip, pool=pool, fuse=fuse, plan=plan, stats=stats,
                timings=timings), stats
        out = []
        for lo in range(0, len(queries), batch):
            out.extend(batch_lib.execute_batch(
                idx, queries[lo: lo + batch], cache=cache, skip=skip,
                pool=pool, fuse=fuse, plan=plan, stats=stats))
        return out, stats

    wu = None
    if warmup and fuse:
        wu = batch_lib.warmup(idx, queries, plan=plan, batch_size=batch,
                              pool=pool, cache=cache, skip=skip)
        print(f"[serve] warmup: {wu['n_compiles']} compiles over "
              f"{wu['n_signatures']} signatures in {wu['passes']} "
              f"passes ({wu['time_s']:.2f}s)")
        converged = wu["converged"]
    else:
        n_sigs, passes, converged = batch_lib.warm_to_fixed_point(
            lambda s: run_all(stats=s))
    if not converged:
        print("[serve] warning: the warm loop stopped at max_passes before "
              "the signature ladder reached a fixed point — the timed run "
              "may launch new programs")
    timings = pipe_lib.StageTimings() if depth else None
    t0 = time.perf_counter()
    results, stats = run_all(timings=timings)
    dt = time.perf_counter() - t0
    return {"results": results, "seconds": dt, "stats": stats,
            "hits": sum(r.count for r in results), "warmup": wu,
            "timings": timings}


def serve_sharded(sharded, queries, *, batch: int, depth: int,
                  fuse: bool = True, plan=None) -> dict:
    """Serve ``queries`` through ``shard.execute_sharded`` as the
    reference's ``--shards`` loop does: passes until no new program
    signature appears, then one timed pass with its ``StageTimings``.
    Returns what ``serve_batched`` returns (``warmup``: (signatures,
    passes, converged) of the warm loop)."""
    from repro_torch.index import batch as batch_lib
    from repro_torch.index import pipeline as pipe_lib
    from repro_torch.index import shard as shard_lib
    if not fuse:
        plan = None
    elif plan is None:
        plan = batch_lib.FusionPlan()

    def run_all(stats=None, timings=None):
        return shard_lib.execute_sharded(
            sharded, queries, batch_size=batch, depth=depth, fuse=fuse,
            plan=plan, stats=stats, timings=timings)

    warm = batch_lib.warm_to_fixed_point(lambda s: run_all(stats=s))
    if not warm[2]:
        print(f"[serve] warning: signature warm loop stopped at max_passes "
              f"({warm[1]} passes, {warm[0]} signatures) without converging "
              f"— the timed run may launch new programs")
    timings = pipe_lib.StageTimings()
    stats: dict = {}
    t0 = time.perf_counter()
    results = run_all(stats=stats, timings=timings)
    dt = time.perf_counter() - t0
    return {"results": results, "seconds": dt, "stats": stats,
            "hits": sum(r.count for r in results), "warmup": warm,
            "timings": timings}


def stage_line(timings) -> str:
    """The stage breakdown of a pipelined pass: each stage's milliseconds
    and share of their sum."""
    tot = max(timings.stage + timings.assemble + timings.dispatch
              + timings.block, 1e-9)
    return ", ".join(f"{name} {t * 1e3:.1f} ms ({t / tot:.0%})" for name, t in (
        ("stage", timings.stage), ("assemble", timings.assemble),
        ("dispatch", timings.dispatch), ("block", timings.block))) + \
        f" over {timings.batches} batches"


def _batched_line(mode: str, n: int, rep: dict, n_batches: int) -> str:
    """The reference's summary line of a batched, pipelined or sharded
    serve; ``mode`` names the path, e.g. "--batch 32 (cuda, fused)"."""
    dt, stats = rep["seconds"], rep["stats"]
    nd = stats.get("n_dispatches", 0)
    return (f"[serve] paper-index {mode}: {n} queries, {n / dt:.1f} q/s ({dt / n * 1e3:.2f} ms/query), "
            f"{rep['hits']} hits, {nd} dispatches "
            f"({nd / n_batches:.1f}/batch, "
            f"{len(stats.get('signatures', ()))} programs, "
            f"{stats.get('n_compiles', 0)} compiles), "
            f"{stats.get('decoded_ints', 0) / n:.0f} decoded ints/query "
            f"({stats.get('skip_folds', 0)} skip folds, "
            f"{stats.get('resident_hits', 0)} resident hits)")


def _codec_line(codec: str, idx, device) -> str:
    """The storage report beside a build: bytes/int and lists by family."""
    st = idx.stats()
    counts = " ".join(f"{k}:{v}" for k, v in sorted(st["codec_counts"].items()))
    return (f"[serve] index codec {codec} on {device}: "
            f"{st['bytes_per_int']:.2f} bytes/int "
            f"({st['bits_per_int']:.2f} bits/int) [{counts}]")


def serve_index(args, *, n_docs: int = 1 << 16) -> dict:
    """Build the index for ``args`` and serve its queries; prints the
    reference's summary lines and returns the serving report."""
    from repro_torch.index import builder, corpus as corpus_lib, engine, source
    for w in coerce_index_flags(args):
        print(f"[serve] warning: {w}")
    check_ported(args)
    device = ops.resolve_device(args.device)
    corpus = corpus_lib.synthesize(n_docs=n_docs, n_queries=args.queries,
                                   seed=args.corpus_seed,
                                   shared_vocab=args.shared_vocab)
    if args.qps:
        return serve_index_live(args, corpus, device)
    if args.mutate:
        return serve_index_mutable(args, corpus, device)
    codec_name = _CODEC_NAMES[args.codec]
    n = len(corpus.queries)
    n_batches = max((n + args.batch - 1) // max(args.batch, 1), 1)
    fused = "fused" if args.fuse else "unfused"
    if args.shards:
        t0 = time.perf_counter()
        sharded = builder.build_sharded(
            corpus.postings, corpus.n_docs, n_shards=args.shards,
            codec_name=codec_name, B=16, n_parts=max(args.shards, 2),
            device=device)
        print(_codec_line(args.codec, sharded.index, device))
        st = sharded.stats()
        print(f"[serve] sharded index: {st['n_shards']} shards on "
              f"{st['n_devices']} devices, warmed in "
              f"{time.perf_counter() - t0:.2f}s")
        for sh in st["shards"]:
            print(f"[serve]   shard {sh['shard']} -> {sh['device']}: "
                  f"parts {sh['parts']}, {sh['resident_lists']} lists "
                  f"({sh['resident_ints']} ints) resident")
        rep = serve_sharded(sharded, corpus.queries, batch=args.batch,
                            depth=args.pipeline, fuse=args.fuse)
        print(_batched_line(f"--shards {args.shards} (batch {args.batch}, "
                            f"depth {args.pipeline}, {device.type}, "
                            f"{fused})", n, rep, n_batches))
        print(f"[serve]   {stage_line(rep['timings'])}")
        return rep
    idx = builder.build(corpus.postings, corpus.n_docs, codec_name=codec_name,
                        B=16, n_parts=2, device=device)
    st = idx.stats()
    print(_codec_line(args.codec, idx, device))
    cache = engine.DecodeCache() if args.cache else None
    pool = None
    if args.resident:
        pool = source.ResidentPool(device=device)
        t0 = time.perf_counter()
        ps = pool.warm(idx)
        print(f"[serve] resident index: staged {ps['staged_lists']} lists "
              f"({ps['staged_ints']} ints) in {time.perf_counter() - t0:.2f}s"
              f"; {ps['device_ints']} device ints of {pool.capacity}, "
              f"{ps['evicted_lists']} evicted")

    def note():
        out = ""
        if cache is not None:
            out += f", cache hit rate {cache.hit_rate:.2f}"
        if pool is not None:
            ps = pool.stats()
            out += (f", pool {ps['resident_lists']} lists resident "
                    f"({ps['evicted_lists']} evicted, {ps['device_ints']} "
                    f"device ints)")
        return out

    if args.batch > 1:
        rep = serve_batched(idx, corpus.queries, batch=args.batch,
                            fuse=args.fuse, warmup=args.warmup, cache=cache,
                            pool=pool, depth=args.pipeline)
        mode = (f"--pipeline {args.pipeline} (batch {args.batch}, "
                if args.pipeline else f"--batch {args.batch} (")
        print(_batched_line(f"{mode}{device.type}, {fused})", n, rep,
                            n_batches)
              + f", {st['bits_per_int']:.2f} bits/int{note()}")
        if rep["timings"] is not None:
            print(f"[serve]   pipeline depth {args.pipeline}: "
                  f"{stage_line(rep['timings'])}")
        return rep
    rep = serve_queries(idx, corpus.queries, cache=cache, pool=pool)
    dt, stats = rep["seconds"], rep["stats"]
    print(f"[serve] paper-index: {n} queries, {n / dt:.1f} q/s "
          f"({dt / n * 1e3:.2f} ms/query), {rep['hits']} hits, "
          f"{stats.get('decoded_ints', 0) / n:.0f} decoded ints/query "
          f"({stats.get('skip_folds', 0)} skip folds), "
          f"{st['bits_per_int']:.2f} bits/int{note()}")
    return rep


def _injector(args):
    """The chaos FaultInjector from --chaos (None when unarmed)."""
    spec = getattr(args, "chaos", None)
    if not spec:
        return None
    from repro_torch.launch import faults as faults_lib
    return faults_lib.FaultInjector(spec, seed=args.seed)


def _bootstrap_mutable(args, corpus, device, injector=None):
    """The --mutate bootstrap: build the MutableIndex on ``device`` (with a
    WAL under --wal), apply the add/seal/delete stream, and — if an
    injected crash fires mid-stream — recover from the WAL directory and go
    on with the recovered state.  Returns (index, tombstones asked for)."""
    from repro_torch.index import segments
    log = None
    if getattr(args, "wal", None):
        from repro_torch.index import durability
        log = durability.DurableLog(args.wal, injector=injector)
    n_mut = args.mutate
    del_frac = 0.1 if args.delete_frac is None else args.delete_frac
    t0 = time.perf_counter()
    mi = segments.MutableIndex.from_postings(
        corpus.postings, corpus.n_docs, codec_name=_CODEC_NAMES[args.codec],
        B=16, n_parts=2, n_shards=args.shards, wal=log, device=device)
    print(f"[serve] mutable index bootstrapped: {corpus.n_docs} docs "
          f"sealed in {time.perf_counter() - t0:.2f}s on {device}"
          + (f", {args.shards} shards" if args.shards else "")
          + (f", WAL at {args.wal}" if log is not None else ""))

    queries = corpus.queries
    rng = np.random.default_rng(7)
    term_pool = sorted({t for q in queries for t in q})
    n_del = int(del_frac * n_mut)
    crashed = False
    try:
        for i in range(n_mut):
            k = int(rng.integers(1, 4))
            mi.add(sorted(rng.choice(term_pool, size=k,
                                     replace=False).tolist()))
            if n_mut > 1 and i == n_mut // 2:
                mi.seal()               # live stream: seal mid-mutation
        if n_del:
            for d in rng.choice(mi.next_doc_id, size=n_del, replace=False):
                mi.delete(int(d))
    except Exception as e:              # noqa: BLE001 — the chaos crash path
        from repro_torch.launch import faults as faults_lib
        if not isinstance(e, faults_lib.InjectedCrash) or log is None:
            raise
        # the injected "process death": what was not applied is lost;
        # recovery replays snapshot + WAL tail and serving resumes
        print(f"[serve] chaos: {e} — recovering from {args.wal}")
        crashed = True
        injector.disarm_all()
        t0 = time.perf_counter()
        mi = segments.MutableIndex.recover(args.wal, injector=injector,
                                           device=device)
        print(f"[serve] recovered in {time.perf_counter() - t0:.2f}s: "
              f"replayed {mi._wal_replayed} WAL records, "
              f"{mi.counters()['n_segments']} segments, "
              f"{mi.counters()['mutable_docs']} mutable docs")
    c = mi.counters()
    stream = (f"crash cut the +{n_mut}/-{n_del} mutation stream short"
              if crashed else f"+{n_mut} docs / -{n_del} tombstones")
    print(f"[serve] mutable index: {stream} -> "
          f"generation {c['generation']}, {c['n_segments']} sealed "
          f"segments + {c['mutable_docs']} mutable docs, "
          f"{c['tombstones']} tombstones, {c['n_seals']} seals, "
          f"vocab {c['vocab']}")
    return mi, n_del


def _recovery_differential(args, mi, queries, device) -> float:
    """--wal epilogue: recover a second index from the durable directory
    and assert it answers as the live one.  Returns the recovery seconds."""
    from repro_torch.index import segments
    t0 = time.perf_counter()
    ri = segments.MutableIndex.recover(args.wal, device=device)
    dt = time.perf_counter() - t0
    got = mi.execute_batch(queries, fuse=args.fuse)
    rec = ri.execute_batch(queries, fuse=args.fuse)
    for q, g, r in zip(queries, got, rec):
        assert g.count == r.count and np.array_equal(g.docs, r.docs), \
            f"recovery mismatch on {q}"
    print(f"[serve] recovery check: replayed {ri._wal_replayed} WAL "
          f"records in {dt:.2f}s; {len(queries)} queries byte-identical "
          f"to the live index")
    return dt


def serve_index_mutable(args, corpus, device) -> dict:
    """--mutate N: live-corpus serving over the segmented mutable index.

    Bootstraps a MutableIndex from the corpus, applies N adds (with a
    mid-stream seal) and ``--delete-frac``·N tombstones, warms to the
    signature fixed point, then serves the query stream in a loop while a
    background merge compacts the sealed segments (the printed q/s is
    throughput during the merge), and ends with a differential check
    against a rebuild from scratch; with --wal also a recovery check."""
    from repro_torch.index import batch as batch_lib, builder, engine
    injector = _injector(args)
    n_mut = args.mutate
    del_frac = 0.1 if args.delete_frac is None else args.delete_frac
    mi, n_del = _bootstrap_mutable(args, corpus, device, injector)
    queries = corpus.queries
    fused = "fused" if args.fuse else "unfused"

    def run_all(stats=None):
        stats = {} if stats is None else stats
        out = []
        for lo in range(0, len(queries), args.batch):
            out.extend(mi.execute_batch(queries[lo: lo + args.batch],
                                        fuse=args.fuse, stats=stats))
        return out, stats

    t0 = time.perf_counter()
    c0 = batch_lib._compile_count()
    n_sigs, passes, converged = batch_lib.warm_to_fixed_point(
        lambda s: run_all(stats=s))
    if args.warmup:
        print(f"[serve] warmup: {batch_lib._compile_count() - c0} compiles "
              f"over {n_sigs} signatures in {passes} passes "
              f"({time.perf_counter() - t0:.2f}s)")
    if not converged:
        print("[serve] warning: signature warm loop stopped at max_passes "
              "without converging — the timed run may launch new programs")

    # timed loop under a live background merge: the candidate generation
    # pre-warms through the shared sticky plan before the swap; --chaos
    # merge.* points fire through the stage hook
    merge_hook = injector.merge_hook() if injector is not None else None
    merge_thread = mi.merge_async(warm_queries=queries, hook=merge_hook)
    stats: dict = {}
    t0 = time.perf_counter()
    loops = 0
    while loops == 0 or (merge_thread.is_alive() and loops < 64):
        results, _ = run_all(stats=stats)
        loops += 1
    dt = time.perf_counter() - t0
    merge_thread.join()
    n_q = loops * len(queries)
    hits = sum(r.count for r in results)
    c = mi.counters()
    print(f"[serve] paper-index --mutate {n_mut} "
          f"--delete-frac {del_frac:g} ({device.type}, {fused}, "
          f"batch {args.batch}): {n_q} queries in {loops} loops during "
          f"background merge, {n_q / dt:.1f} q/s "
          f"({dt / n_q * 1e3:.2f} ms/query), {hits} hits, "
          f"{stats.get('n_compiles', 0)} compiles")
    print(f"[serve]   post-merge: generation {c['generation']}, "
          f"{c['n_segments']} segments, {c['n_merges']} merges, "
          f"{c['next_doc_id']} doc ids ({c['tombstones']} tombstoned)")
    if c.get("merge_failures"):
        print(f"[serve]   merge retries: {c['merge_failures']} failed "
              f"attempts, last error: {c['last_merge_error'] or 'cleared'}")
    # merge_async retries whatever failed; only --chaos merge.* faults may
    injected = (sum(n for k, n in injector.counts().items() if "@merge." in k)
                if injector is not None else 0)
    if c["merge_failures"] > injected:
        raise RuntimeError(
            f"the background merge failed {c['merge_failures']} times, "
            f"{injected} of them injected; last error: "
            f"{c['last_merge_error'] or 'cleared'}")

    # differential: the served state against a rebuild from scratch
    idx = builder.build(mi.live_postings(), max(mi.next_doc_id, 1),
                        codec_name=_CODEC_NAMES[args.codec], B=16, n_parts=2,
                        device=device)
    final, _ = run_all()
    for q, got in zip(queries, final):
        want = engine.query(idx, q)
        assert got.count == want.count and \
            np.array_equal(got.docs, want.docs), f"mismatch on {q}"
    print(f"[serve] differential check: {len(queries)} queries "
          f"byte-identical to rebuild-from-scratch")
    rep = {"results": final, "hits": sum(r.count for r in final),
           "seconds": dt, "stats": stats, "counters": c}
    if getattr(args, "wal", None):
        rep["recovery_s"] = _recovery_differential(args, mi, queries, device)
    if injector is not None:
        print(f"[serve] chaos: {injector.counts()}")
    return rep


def serve_index_live(args, corpus, device) -> dict:
    """--qps Q: open-loop live serving through the continuous-batching
    server (``launch.server``) with per-request deadlines (--timeout-ms),
    injected faults (--chaos) and a durable mutable corpus (--mutate,
    --wal).  Every submitted request resolves to exactly one of done /
    shed / timeout / error; the epilogue audits that, checks every answered
    request against direct execution on the final state, and under --wal
    runs the recovery check."""
    from repro_torch.index import batch as batch_lib, builder, source
    from repro_torch.launch import server as server_lib
    injector = _injector(args)
    queries = corpus.queries
    kw = dict(max_batch=args.batch, fuse=args.fuse,
              timeout_ms=getattr(args, "timeout_ms", None),
              injector=injector)
    mi = idx = None
    if getattr(args, "mutate", 0):
        mi, _ = _bootstrap_mutable(args, corpus, device, injector)
        kw["mutable"] = mi
    else:
        idx = builder.build(corpus.postings, corpus.n_docs,
                            codec_name=_CODEC_NAMES[args.codec], B=16,
                            n_parts=2, device=device)
        print(_codec_line(args.codec, idx, device))
        if args.resident:
            pool = source.ResidentPool(device=device)
            pool.warm(idx)
            kw["pool"] = pool
    results, server = server_lib.serve_open_loop(
        idx, queries, qps=args.qps, warmup=args.warmup,
        seed=args.seed, **kw)
    s = server.metrics.summary()
    outs = server.outcomes()
    assert len(outs) == len(queries) and "pending" not in outs, \
        "unresolved requests after run()"
    lad = server.ladder
    print(f"[serve] paper-index --qps {args.qps:g} ({device.type}"
          f"{', fused' if args.fuse else ', unfused'}, "
          f"batch {args.batch}"
          + (f", timeout {args.timeout_ms:g} ms"
             if getattr(args, "timeout_ms", None) is not None else "")
          + f"): {s['n_done']} done / {s['n_shed']} shed / "
          f"{s['n_timeout']} timed out / {s['n_errors']} errored, "
          f"{s['qps']:.1f} q/s, p50 {s['p50_ms']:.2f} ms, "
          f"p99 {s['p99_ms']:.2f} ms")
    print(f"[serve]   resilience: {s['n_faults']} faults, "
          f"{s['n_retries']} retries, {s['degraded_flushes']} degraded "
          f"flushes, {lad.n_degradations} degradations / "
          f"{lad.n_promotions} promotions, final rung "
          f"{'fused' if lad.current else 'unfused'}")
    if injector is not None:
        print(f"[serve] chaos: {injector.counts()}")
    # every answered request must match a clean re-execution against the
    # same (final) corpus state, degraded or retried flushes included
    served = [(q, r) for q, r in zip(queries, results) if r is not None]
    if served:
        qs = [q for q, _ in served]
        if mi is not None:
            want = mi.execute_batch(qs, fuse=args.fuse)
        else:
            want = batch_lib.execute_batch(idx, qs, fuse=args.fuse)
        for (q, got), w in zip(served, want):
            assert got.count == w.count and \
                np.array_equal(got.docs, w.docs), f"mismatch on {q}"
        print(f"[serve] differential check: {len(served)} answered "
              f"queries byte-identical to direct execution")
    rep = {"results": results, "hits": sum(r.count for _, r in served),
           "summary": s, "outcomes": outs}
    if mi is not None and getattr(args, "wal", None):
        rep["recovery_s"] = _recovery_differential(args, mi, queries, device)
    return rep


def serve_lm(args, spec) -> dict:
    """Prefill + greedy decode of ``--tokens`` tokens on the smoke-reduced
    ``spec``; prints the reference's summary line and returns the tokens
    and the wall time."""
    from repro_torch.models.transformer import init_params
    from repro_torch.serve.steps import greedy_generate
    check_ported(args)
    device = ops.resolve_device(args.device)
    cfg = spec.smoke_config()
    params = init_params(torch.Generator(device).manual_seed(0), cfg, device)
    batch = args.batch or 4
    prompt = torch.randint(0, cfg.vocab, (batch, 16), dtype=torch.int32,
                           generator=torch.Generator(device).manual_seed(1),
                           device=device)
    t0 = time.perf_counter()
    out = greedy_generate(params, cfg, prompt, max_new=args.tokens,
                          cache_len=16 + args.tokens).cpu()
    dt = time.perf_counter() - t0
    print(f"[serve] {spec.arch_id}: batch={batch} generated "
          f"{args.tokens} tokens in {dt:.2f}s "
          f"({batch * args.tokens / dt:.1f} tok/s); sample: "
          f"{out[0, :8].tolist()}")
    return {"tokens": out, "seconds": dt}


def serve_recsys(args, spec) -> dict:
    """Score one batch of ``--batch`` (default 4) on the smoke-reduced
    ``spec``, warm, then under the clock; prints the reference's summary
    line and returns the scores and the wall time."""
    from repro_torch.data import recsys_data
    from repro_torch.models import recsys
    from repro_torch.serve.steps import make_recsys_score_step
    device = ops.resolve_device(args.device)
    cfg = spec.smoke_config()
    params = recsys.INIT[cfg.arch](torch.Generator(device).manual_seed(0),
                                   cfg, device)
    rng = np.random.default_rng(0)
    mk = {"din": recsys_data.din_batch, "sasrec": recsys_data.seq_batch,
          "bert4rec": recsys_data.bert4rec_batch,
          "mind": recsys_data.mind_batch}[cfg.arch]
    batch = args.batch or 4
    b = {k: torch.from_numpy(v).to(device)
         for k, v in mk(rng, cfg, batch).items()}
    score = make_recsys_score_step(cfg)
    score(params, b)                        # warm
    t0 = time.perf_counter()
    s = score(params, b).cpu()
    dt = time.perf_counter() - t0
    print(f"[serve] {spec.arch_id}: scored batch={batch} in "
          f"{dt * 1e3:.2f} ms; mean score {float(s.mean()):.4f}")
    return {"scores": s, "seconds": dt}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-index",
                    help="paper-index (default); an LM: gemma-7b, "
                         "phi3-medium-14b, internlm2-1.8b, "
                         "granite-moe-1b-a400m, kimi-k2-1t-a32b; or a "
                         "recsys model: din, sasrec, bert4rec, mind")
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--codec", choices=list(_CODEC_NAMES), default="fastpfor",
                    help="posting-list codec family (auto = the cost-model "
                         "storage autotuner picks codec + skip policy per "
                         "list)")
    ap.add_argument("--cache", action="store_true",
                    help="serve with a DecodeCache and report its hit rate")
    ap.add_argument("--shared-vocab", action="store_true",
                    help="Zipf-shared query term ids (realistic cache hits)")
    ap.add_argument("--seed", type=int, default=0,
                    help="paper-index: seed for --chaos fault schedules "
                         "and --qps arrival gaps")
    ap.add_argument("--corpus-seed", type=int, default=5,
                    help="corpus and query-log seed (the reference's serve "
                         "fixes it at 5)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batch", type=int, default=0,
                    help="paper-index: > 1 serves through the batched "
                         "engine in batches of this size; LM and recsys: "
                         "the batch size (default 4)")
    ap.add_argument("--tokens", type=int, default=16,
                    help="LM: new tokens to generate")
    ap.add_argument("--fuse", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="with --batch: fuse each batch's groups into "
                         "megagroup programs (--no-fuse: one program per "
                         "shape signature)")
    ap.add_argument("--warmup", action="store_true",
                    help="with --batch and --fuse: warm the fused family "
                         "ladder with batch.warmup before the timed run")
    ap.add_argument("--resident", action="store_true",
                    help="paper-index: warm the device-resident index "
                         "(source.ResidentPool) and serve from it")
    ap.add_argument("--pipeline", type=int, default=0, metavar="DEPTH",
                    help="paper-index: pipelined serving with DEPTH batches "
                         "in flight (implies --resident and, without "
                         "--batch, --batch 32; 0 = off)")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="paper-index: serve the index on N data-parallel "
                         "shards (implies --batch 32, --pipeline 2 and "
                         "--resident where not given; 0 = off)")
    ap.add_argument("--mutate", type=int, default=0, metavar="N",
                    help="paper-index: live corpus — apply N adds (with a "
                         "mid-stream seal) and --delete-frac tombstones to "
                         "a segmented mutable index, serve during a "
                         "background merge and check against a rebuild "
                         "(implies --batch 32 and --resident)")
    ap.add_argument("--delete-frac", type=float, default=None, metavar="F",
                    help="paper-index: fraction of --mutate adds to "
                         "tombstone (default 0.1; needs --mutate)")
    ap.add_argument("--wal", default=None, metavar="DIR",
                    help="paper-index: durable mutable index — journal "
                         "every add/delete/seal to a write-ahead log in "
                         "DIR, checkpoint snapshots, and end with a "
                         "recovery check (implies --mutate 256)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="paper-index: deterministic fault injection, "
                         "comma-separated kind@point[:arg] rules, e.g. "
                         "'crash@wal.append.add:40' or "
                         "'transient@launch:0.05' (launch/faults.py)")
    ap.add_argument("--timeout-ms", type=float, default=None, metavar="MS",
                    help="paper-index: per-request deadline for --qps live "
                         "serving")
    ap.add_argument("--qps", type=float, default=0.0, metavar="Q",
                    help="paper-index: open-loop live serving at offered "
                         "load Q through the continuous-batching server "
                         "(0 = offline; composes with --mutate, --wal, "
                         "--chaos, --timeout-ms)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.arch == "paper-index":
        return serve_index(args)
    spec = get_config(args.arch)
    if spec.family == "lm":
        return serve_lm(args, spec)
    if spec.family == "recsys":
        return serve_recsys(args, spec)
    raise SystemExit(f"no serving mode for family {spec.family}")


if __name__ == "__main__":
    main()
