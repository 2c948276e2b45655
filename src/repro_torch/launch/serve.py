"""Serving launcher for the port: sequential conjunctive-query serving.

Port of the sequential paper-index path of ``src/repro/launch/serve.py``
(``serve_index``, the non-batch branch).  It synthesizes the corpus, builds
the HYB+M2 index (B=16, two parts) on the device, warms, and serves every
query once more under the clock.

  PYTHONPATH=src python -m repro_torch.launch.serve --queries 20
  PYTHONPATH=src python -m repro_torch.launch.serve --queries 20 --cache \\
      --shared-vocab --device cpu

It runs on the CUDA card unless ``--device cpu`` is given, and raises where
there is no card.  The flags of later slices (``--batch > 1``,
``--pipeline``, ``--shards``, ``--mutate``, ``--qps``, ``--wal``,
``--chaos``, ``--resident``) raise "not yet ported".
"""

from __future__ import annotations

import argparse
import time

from repro_torch.kernels import ops

# --codec flag value -> builder codec name (the ported families)
_CODEC_NAMES = {"bitpack": "bp-d1", "fastpfor": "fastpfor-d1",
                "varint": "varint"}
_LATER_SLICES = ("pipeline", "shards", "mutate", "qps", "wal", "chaos",
                 "resident")


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag of a later slice."""
    if args.batch > 1:
        raise NotImplementedError("--batch > 1 (the batched engine) is not "
                                  "yet ported")
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
    rep = serve_queries(idx, corpus.queries, cache=cache)
    n, dt, stats = len(corpus.queries), rep["seconds"], rep["stats"]
    note = f", cache hit rate {cache.hit_rate:.2f}" if cache is not None else ""
    print(f"[serve] paper-index: {n} queries, {n / dt:.1f} q/s "
          f"({dt / n * 1e3:.2f} ms/query), {rep['hits']} hits, "
          f"{stats.get('decoded_ints', 0) / n:.0f} decoded ints/query "
          f"({stats.get('skip_folds', 0)} skip folds), "
          f"{st['bits_per_int']:.2f} bits/int{note}")
    return rep


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=["paper-index"], default="paper-index")
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--codec", choices=sorted(_CODEC_NAMES), default="fastpfor",
                    help="posting-list codec family")
    ap.add_argument("--cache", action="store_true",
                    help="serve with a DecodeCache and report its hit rate")
    ap.add_argument("--shared-vocab", action="store_true",
                    help="Zipf-shared query term ids (realistic cache hits)")
    ap.add_argument("--seed", type=int, default=5,
                    help="corpus and query-log seed (the reference's serve "
                         "fixes it at 5)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--batch", type=int, default=0,
                    help="> 1 selects the batched engine: not yet ported")
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
    return serve_index(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
