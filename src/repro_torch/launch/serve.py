"""Serving launcher for the port: conjunctive-query serving, sequential or
batched, and greedy generation on the dense LMs.

Port of the paper-index path of ``src/repro/launch/serve.py``
(``serve_index``, its sequential and single-device ``--batch`` branches)
and of its LM path (``serve_lm``).
It synthesizes the corpus, builds the HYB+M2 index (B=16, two parts) on the
device, warms, and serves every query once more under the clock.
``--batch N`` (N > 1) serves through the batched engine
(``index.batch.execute_batch``) in batches of N, fused into megagroup
programs unless ``--no-fuse`` is given; ``--warmup`` warms the fused family
ladder with ``batch.warmup`` first.  Hits equal the sequential serve's.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 20
  PYTHONPATH=src python -m repro_torch.launch.serve --queries 20 --cache \\
      --shared-vocab --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --batch 32 --warmup
  PYTHONPATH=src python -m repro_torch.launch.serve --codec auto --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --device cpu --tokens 4

``--arch <lm id>`` (gemma-7b, phi3-medium-14b, internlm2-1.8b) runs prefill
and greedy decode on the smoke-reduced model, as the reference's
``serve_lm`` does: random weights from seed 0, a batch of ``--batch``
(default 4) 16-token prompts from seed 1, ``--tokens`` new tokens.  The
other archs of the reference (MoE, recsys, GNN) raise "not yet ported".

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
there is no card.  The flags of later slices (``--pipeline``, ``--shards``,
``--mutate``, ``--qps``, ``--wal``, ``--chaos``, ``--resident``) raise "not
yet ported".
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels import ops

# --codec flag value -> builder codec name ("auto" goes to the storage
# autotuner; everything else pins one family index-wide)
_CODEC_NAMES = {"auto": "auto", "bitpack": "bp-d1",
                "streamvbyte": "streamvbyte-d1", "composite": "composite-d1",
                "fastpfor": "fastpfor-d1", "varint": "varint"}
_LATER_SLICES = ("pipeline", "shards", "mutate", "qps", "wal", "chaos",
                 "resident")


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag of a later slice."""
    for flag in _LATER_SLICES:
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag} is not yet ported")


def serve_queries(idx, queries, *, cache=None, skip: bool = True) -> dict:
    """Serve ``queries`` sequentially as the reference's serve loop does:
    warm passes first (two when a cache changes how terms resolve, else
    one), then one timed pass that ends on the host with every answer read
    back.  Returns the results, the wall time and the engine's counters."""
    from repro_torch.index import engine
    for _ in range(2 if cache is not None else 1):
        for q in queries:
            engine.query(idx, q, cache=cache, skip=skip)
    stats: dict = {}
    t0 = time.perf_counter()
    results = [engine.query(idx, q, cache=cache, skip=skip, stats=stats)
               for q in queries]
    dt = time.perf_counter() - t0
    return {"results": results, "seconds": dt, "stats": stats,
            "hits": sum(r.count for r in results)}


def serve_batched(idx, queries, *, batch: int, fuse: bool = True,
                  warmup: bool = False, cache=None, skip: bool = True,
                  plan=None) -> dict:
    """Serve ``queries`` through ``batch.execute_batch`` in batches of
    ``batch``, as the reference's ``--batch`` loop does: warm first
    (``batch.warmup`` over the query stream with ``warmup`` and ``fuse``,
    else passes until no new program signature appears), then one timed
    pass that ends with every answer on the host.  ``plan`` is the serving
    session's FusionPlan (a new one when None; unused unfused).  Returns
    the results, the wall time, the counters of the timed pass and the
    warmup's report."""
    from repro_torch.index import batch as batch_lib
    if not fuse:
        plan = None
    elif plan is None:
        plan = batch_lib.FusionPlan()

    def run_all(stats=None):
        stats = {} if stats is None else stats
        out = []
        for lo in range(0, len(queries), batch):
            out.extend(batch_lib.execute_batch(
                idx, queries[lo: lo + batch], cache=cache, skip=skip,
                fuse=fuse, plan=plan, stats=stats))
        return out, stats

    wu = None
    if warmup and fuse:
        wu = batch_lib.warmup(idx, queries, plan=plan, batch_size=batch,
                              cache=cache, skip=skip)
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
    t0 = time.perf_counter()
    results, stats = run_all()
    dt = time.perf_counter() - t0
    return {"results": results, "seconds": dt, "stats": stats,
            "hits": sum(r.count for r in results), "warmup": wu}


def serve_index(args, *, n_docs: int = 1 << 16) -> dict:
    """Build the index for ``args`` and serve its queries; prints the
    reference's summary line and returns ``serve_queries``' report."""
    from repro_torch.index import builder, corpus as corpus_lib, engine
    check_ported(args)
    device = ops.resolve_device(args.device)
    corpus = corpus_lib.synthesize(n_docs=n_docs, n_queries=args.queries,
                                   seed=args.seed,
                                   shared_vocab=args.shared_vocab)
    idx = builder.build(corpus.postings, corpus.n_docs,
                        codec_name=_CODEC_NAMES[args.codec], B=16, n_parts=2,
                        device=device)
    st = idx.stats()
    counts = " ".join(f"{k}:{v}" for k, v in sorted(st["codec_counts"].items()))
    print(f"[serve] index codec {args.codec} on {device}: "
          f"{st['bytes_per_int']:.2f} bytes/int "
          f"({st['bits_per_int']:.2f} bits/int) [{counts}]")
    cache = engine.DecodeCache() if args.cache else None
    n = len(corpus.queries)
    note = lambda: (f", cache hit rate {cache.hit_rate:.2f}"
                    if cache is not None else "")
    if args.batch > 1:
        rep = serve_batched(idx, corpus.queries, batch=args.batch,
                            fuse=args.fuse, warmup=args.warmup, cache=cache)
        dt, stats = rep["seconds"], rep["stats"]
        nd = stats.get("n_dispatches", 0)
        n_batches = max((n + args.batch - 1) // args.batch, 1)
        print(f"[serve] paper-index --batch {args.batch} ({device.type}"
              f"{', fused' if args.fuse else ', unfused'}): "
              f"{n} queries, {n / dt:.1f} q/s ({dt / n * 1e3:.2f} ms/query), "
              f"{rep['hits']} hits, {nd} dispatches "
              f"({nd / n_batches:.1f}/batch, "
              f"{len(stats.get('signatures', ()))} programs, "
              f"{stats.get('n_compiles', 0)} compiles), "
              f"{stats.get('decoded_ints', 0) / n:.0f} decoded ints/query "
              f"({stats.get('skip_folds', 0)} skip folds, "
              f"{stats.get('resident_hits', 0)} resident hits), "
              f"{st['bits_per_int']:.2f} bits/int{note()}")
        return rep
    rep = serve_queries(idx, corpus.queries, cache=cache)
    dt, stats = rep["seconds"], rep["stats"]
    print(f"[serve] paper-index: {n} queries, {n / dt:.1f} q/s "
          f"({dt / n * 1e3:.2f} ms/query), {rep['hits']} hits, "
          f"{stats.get('decoded_ints', 0) / n:.0f} decoded ints/query "
          f"({stats.get('skip_folds', 0)} skip folds), "
          f"{st['bits_per_int']:.2f} bits/int{note()}")
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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-index",
                    help="paper-index (default), or an LM: gemma-7b, "
                         "phi3-medium-14b, internlm2-1.8b")
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--codec", choices=list(_CODEC_NAMES), default="fastpfor",
                    help="posting-list codec family (auto = the cost-model "
                         "storage autotuner picks codec + skip policy per "
                         "list)")
    ap.add_argument("--cache", action="store_true",
                    help="serve with a DecodeCache and report its hit rate")
    ap.add_argument("--shared-vocab", action="store_true",
                    help="Zipf-shared query term ids (realistic cache hits)")
    ap.add_argument("--seed", type=int, default=5,
                    help="corpus and query-log seed (the reference's serve "
                         "fixes it at 5)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batch", type=int, default=0,
                    help="paper-index: > 1 serves through the batched "
                         "engine in batches of this size; LM: the batch "
                         "size (default 4)")
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
    for flag in _LATER_SLICES:
        kind = {"pipeline": int, "shards": int, "mutate": int, "qps": float,
                "wal": str, "chaos": str}.get(flag)
        if kind is None:
            ap.add_argument(f"--{flag}", action="store_true",
                            help="not yet ported")
        else:
            ap.add_argument(f"--{flag}", type=kind, default=None,
                            help="not yet ported")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.arch == "paper-index":
        return serve_index(args)
    spec = get_config(args.arch)
    if spec.family == "lm":
        return serve_lm(args, spec)
    raise SystemExit(f"no serving mode for family {spec.family}")


if __name__ == "__main__":
    main()
