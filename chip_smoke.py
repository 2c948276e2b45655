"""Smoke run of the PyTorch/CUDA port on one CUDA card (sm_90, an H100).

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build the hand kernels from
     src/repro_torch/kernels/csrc with nvcc (timed);
  2. each kernel against its plain PyTorch version on the card, exact
     (torch.equal): K1 over widths 0–32 × six modes, K2a/K2b over M 128…2**16
     and N 128…2**24 with all-SENTINEL and no-match rows, K3 over modes,
     FastPFOR exceptions, pad ids and C 8…256;
  3. the main path at ClueWeb09 Category B scale: a 50,000,000-document
     corpus with 64 queries (shared vocabulary), built as fastpfor-d1 and
     as bp-d1 (B=16, two parts) on the card and served through
     ``serve.serve_queries`` / ``engine.query`` in three regimes — default,
     DecodeCache, skip=False — with every answer checked against numpy brute
     force and the launch counts of K1, K2 and K3 checked, then one more
     default pass of each build under torch.profiler (device idle share);
  4. each kernel timed with CUDA events at the largest shape the main path
     gave it, beside its plain version, a library call where one computes
     the same function, and its bound (bytes over 3.35 TB/s, or 32-bit
     operations over 67 T/s, the larger).
The last two lines are the kernels' JSON record and the device line.  It
exits nonzero, printing no result, where there is no CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
OPS_PER_S = 67e12              # H100 SXM 32-bit operations outside tensor cores
N_DOCS = 50_000_000            # ClueWeb09 Category B (corpus.TABLE2_DOCS)
N_QUERIES = 64
SENT = 2**31 - 1
REPLACES = {
    "unpack_blocks": ("src/repro_torch/kernels/csrc/unpack_blocks.cu",
                      "src/repro/kernels/bitunpack.py:162"),
    "gallop_tiles": ("src/repro_torch/kernels/csrc/gallop.cuh",
                     "src/repro/kernels/intersect_gallop.py:76"),
    "gallop_tiles_batched": ("src/repro_torch/kernels/csrc/gallop.cuh",
                             "src/repro/kernels/intersect_gallop.py:103"),
    "packed_gallop_batched": ("src/repro_torch/kernels/csrc/packed_gallop.cu",
                              "src/repro/kernels/intersect_gallop.py:171"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _t(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False)).to(device)


def expect_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version")


# --------------------------------------------------------------------------
# phase 2: kernels vs plain versions at test shapes
# --------------------------------------------------------------------------

def check_k1(dev, longest: list) -> None:
    """K1 vs plain over the width sweep and on each (label, PackedList) of
    ``longest``."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import bitunpack
    rng = np.random.default_rng(1)
    for rows in (32, 8):
        packed = []
        for b in range(33):
            d = rng.integers(0, 1 << b, size=(rows, 128), dtype=np.uint64)
            d[0, 0] = (1 << b) - 1
            packed.append(bitpack.pack_block_np(d.astype(np.uint32), b))
        widths = np.arange(33, dtype=np.int32)
        offs = np.concatenate([[0], np.cumsum(widths[:-1])]).astype(np.int32)
        seeds = rng.integers(0, 1 << 32, 33, dtype=np.uint64).astype(np.uint32)
        args = [_t(a, dev) for a in (np.concatenate(packed), offs, widths,
                                     seeds)]
        for mode in ("none", "d1", "d2", "d4", "dm", "dv"):
            expect_equal(f"K1 widths 0-32 {mode} rows={rows}",
                         bitunpack.unpack_blocks(*args, mode, rows),
                         bitunpack.unpack_blocks_plain(*args, mode, rows))
    for what, pl in longest:
        args = (pl.flat_words, pl.offsets, pl.widths, bitpack.seeds_of(pl),
                pl.mode, pl.block_rows)
        expect_equal(f"K1 {what}", bitunpack.unpack_blocks(*args),
                     bitunpack.unpack_blocks_plain(*args))
        log(f"K1 equal to plain on the {what} ({pl.n} ints, "
            f"{pl.num_blocks} blocks)")
    log("K1 equal to plain: widths 0-32 x 6 modes x rows 32/8")


def gallop_case(rng, B, M, N, kind):
    r = np.full((B, M), SENT, np.int32)
    f = np.full((B, N), SENT, np.int32)
    for b in range(B):
        fv = np.unique(rng.integers(0, 1 << 30, N // 2))
        f[b, : fv.size] = fv
        if kind == "all_sentinel":
            continue
        rv = np.unique(rng.integers(0, 1 << 30, M // 2))
        if kind == "no_match":
            rv = np.setdiff1d(rv, fv)
        else:
            rv = np.union1d(rv[: M // 4], rng.choice(fv, M // 4))
        r[b, : rv.size] = rv
    return r, f


def check_k2(dev) -> None:
    from repro_torch.core import intersect as its
    from repro_torch.kernels import ops
    rng = np.random.default_rng(2)
    cases = [(128, 128, "mixed"), (1024, 1 << 16, "mixed"),
             (1 << 16, 1 << 24, "mixed"), (4096, 1 << 20, "all_sentinel"),
             (1 << 16, 1 << 20, "no_match"), (1000, 3000, "mixed")]
    for M, N, kind in cases:
        r, f = gallop_case(rng, 2, M, N, kind)
        tr, tf = _t(r, dev), _t(f, dev)
        want = its.intersect_gallop(tr, tf)
        expect_equal(f"K2b M={M} N={N} {kind}",
                     ops.intersect_gallop_batch(tr, tf), want)
        expect_equal(f"K2a M={M} N={N} {kind}",
                     ops.intersect_gallop(tr[0].contiguous(),
                                          tf[0].contiguous()), want[0])
    log(f"K2a/K2b equal to plain on {len(cases)} (M, N) cases up to "
        f"M=2**16, N=2**24, with all-SENTINEL and no-match rows")


def packed_operands(encs, rs, c_pad, dev):
    """K3 operands (in wrapper order) for rows of encoded lists and their
    candidates; each row's candidate ids are cut to c_pad - 1 and padded."""
    from repro_torch.core import bitpack, intersect as its
    from repro_torch.index import source
    k_pad = max(bitpack.self_pads(e)[0] for e in encs)
    t_pad = max(bitpack.self_pads(e)[1] for e in encs)
    e_pad = max(max(bitpack.self_pads(e)[2] for e in encs), 1)
    cols = {k: [] for k in ("r", "words", "widths", "offsets", "maxes", "blk",
                            "exc_pos", "exc_add")}
    m = its.pow2_bucket(max(len(r) for r in rs))
    for enc, r in zip(encs, rs):
        lay = bitpack.layout_np(enc, k_pad, t_pad, e_pad)
        blk = bitpack.candidate_block_ids(lay.maxes[: enc.num_blocks], r)
        blk = blk[: c_pad - 1]
        cols["r"].append(its.pad_to(r[r <= lay.maxes[blk[-1]]], m))
        cols["blk"].append(source.pad_block_ids(blk, c_pad, k_pad))
        for k in ("words", "widths", "offsets", "maxes", "exc_pos", "exc_add"):
            cols[k].append(getattr(lay, k))
    return [_t(np.stack(v), dev) for v in cols.values()]


def check_k3(dev) -> None:
    from repro_torch.core import bitpack, fastpfor, intersect as its
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    n = 256 * 4096 + 1000
    gaps = np.where(rng.random(n) < 0.02, rng.integers(1, 1 << 16, n),
                    rng.integers(1, 30, n))
    f = np.cumsum(gaps).astype(np.int64)
    dense = np.union1d(rng.choice(f, 20000), rng.integers(0, int(f[-1]), 20000))
    sparse = np.union1d(rng.choice(f[:40000], 300), rng.integers(0, 40000, 50))
    n_checks = 0
    for mode in ("d1", "d2", "d4", "dm", "dv"):
        for codec in ("bp", "fastpfor"):
            enc = (fastpfor.encode(f, mode=mode) if codec == "fastpfor"
                   else bitpack.encode(f, mode=mode))
            for c_pad, r in ((8, sparse), (256, dense)):
                args = packed_operands([enc, enc], [r, r[::2]], c_pad, dev)
                want = its.intersect_packed_batch(*args, mode=mode,
                                                  block_rows=enc.block_rows)
                got = ops.intersect_packed_batch(*args, mode=mode,
                                                 block_rows=enc.block_rows)
                expect_equal(f"K3 {codec}-{mode} C={c_pad}", got, want)
                if not bool(want.any()):
                    raise AssertionError(f"K3 {codec}-{mode}: no matches")
                n_checks += 1
            if codec == "fastpfor" and enc.exc_pos.shape[0] == 0:
                raise AssertionError("K3 check has no FastPFOR exceptions")
    log(f"K3 equal to plain on {n_checks} cases: modes d1/d2/d4/dm/dv, bp and "
        f"fastpfor (with exceptions), pad ids, C = 8 and 256")


# --------------------------------------------------------------------------
# phase 3: the main path at full size
# --------------------------------------------------------------------------

class Recorder:
    """Wraps a kernel wrapper and keeps the inputs of its largest call on the
    main path, so phase 4 times the kernel at a main-path shape."""

    def __init__(self, module, name, size):
        self.module, self.name, self.size = module, name, size
        self.inner = getattr(module, name)
        self.best, self.best_size = None, -1
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        s = self.size(*args, **kwargs)
        if s > self.best_size:
            self.best, self.best_size = (args, kwargs), s
        return self.inner(*args, **kwargs)

    def restore(self):
        setattr(self.module, self.name, self.inner)


def run_main_path(dev, corpus, truth) -> dict:
    from repro_torch.index import builder, engine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    totals = {k: 0 for k in ops.launches()}
    per_regime = {}
    longest = None
    for codec in ("fastpfor-d1", "bp-d1"):
        t0 = time.perf_counter()
        idx = builder.build(corpus.postings, corpus.n_docs, codec_name=codec,
                            B=16, n_parts=2, device=dev)
        torch.cuda.synchronize()
        st = idx.stats()
        log(f"{codec}: built in {time.perf_counter() - t0:.2f} s, "
            f"{st['bytes_per_int']:.4f} bytes/int, {st['postings']} postings, "
            f"{idx.device_bytes()} index bytes on the card, "
            f"lists {st['codec_counts']}")
        for regime, cache, skip in (("default", None, True),
                                    ("cache", engine.DecodeCache(), True),
                                    ("noskip", None, False)):
            ops.reset_launches()
            rep = serve.serve_queries(idx, corpus.queries, cache=cache,
                                      skip=skip)
            counts = ops.launches()
            for k, v in counts.items():
                totals[k] += v
            for q, res, want in zip(corpus.queries, rep["results"], truth):
                if res.count != len(want) or not np.array_equal(
                        np.sort(res.docs), want[: len(res.docs)]):
                    raise AssertionError(f"{codec}/{regime}: query {q} gave "
                                         f"{res.count}, brute force "
                                         f"{len(want)}")
            n, dt = len(corpus.queries), rep["seconds"]
            passes = 3 if cache is not None else 2
            per_regime[(codec, regime)] = counts
            note = (f", cache hit rate {cache.hit_rate:.3f}"
                    if cache is not None else "")
            log(f"{codec}/{regime}: {n} queries all equal to brute force; "
                f"{n / dt:.2f} q/s, {dt / n * 1e3:.3f} ms/query, "
                f"{rep['stats'].get('decoded_ints', 0) / n:.0f} decoded "
                f"ints/query, {rep['stats'].get('skip_folds', 0)} skip folds, "
                f"{rep['hits']} hits{note}; launches over {passes} passes "
                + ", ".join(f"{k} {v} ({v / (n * passes):.3f}/query)"
                            for k, v in counts.items()))
        profile_pass(idx, corpus.queries, codec)
        if codec == "bp-d1":
            longest = max((tp.payload for p in idx.parts
                           for tp in p.terms.values()
                           if tp.kind == "list" and hasattr(tp.payload, "maxes")),
                          key=lambda pl: pl.n)
        del idx
    for codec in ("fastpfor-d1", "bp-d1"):
        if per_regime[(codec, "default")]["packed_gallop_batched"] == 0:
            raise AssertionError(f"K3 never ran in {codec}/default")
    for regime in ("cache", "noskip"):
        if sum(per_regime[(c, regime)]["gallop_tiles"]
               for c in ("fastpfor-d1", "bp-d1")) == 0:
            raise AssertionError(f"K2 never ran in the {regime} regime")
    if sum(per_regime[("bp-d1", r)]["unpack_blocks"]
           for r in ("default", "cache", "noskip")) == 0:
        raise AssertionError("K1 never ran in the bp-d1 build")
    log(f"launch counts over the main path: {totals}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes")
    return {"launches": totals, "longest": longest}


def profile_pass(idx, queries, codec: str) -> None:
    """One more default-regime pass under torch.profiler: the device's busy
    time (the sum of its kernels' and copies' own times) against the wall
    time of the pass, and the ops that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.index import engine
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in queries:
            engine.query(idx, q)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
    busy_us = sum(dev(e) for e in events)
    if busy_us <= 0:
        log(f"{codec}/default profile: the profiler saw no device time "
            f"(device idle share not measured)")
        return
    top = sorted(events, key=dev, reverse=True)[:6]
    log(f"{codec}/default profile: wall {wall_us / 1e3:.3f} ms for "
        f"{len(queries)} queries under the profiler, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}; "
        f"top device time: " + "; ".join(
            f"{e.key[:60]} {dev(e) / 1e3:.3f} ms x{e.count}" for e in top))


# --------------------------------------------------------------------------
# phase 4: timing at main-path shapes
# --------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 30, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def bound(nbytes: float, nops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def time_k1(args, kwargs) -> dict:
    from repro_torch.kernels import bitunpack
    words, offsets, widths, seeds, mode, rows = args
    kern = lambda: bitunpack.unpack_blocks(*args, **kwargs)
    plain = lambda: bitunpack.unpack_blocks_plain(*args, **kwargs)
    K = widths.shape[0]
    nbytes = int(widths.to(torch.int64).sum()) * 512 + K * 12 + K * rows * 512
    b_ms, b_by = bound(nbytes, K * rows * 128 * 12)
    return {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"K={K} blocks x {rows} rows, mode {mode}"}


def _gallop_bytes_ops(M: int, N: int, B: int = 1):
    log2n = max((N - 1).bit_length(), 1)
    return B * (M * 4 + M + min(N, M * log2n) * 4), B * M * log2n * 4


def time_k2(args, kwargs, batched: int = 0) -> dict:
    from repro_torch.core import intersect as its
    from repro_torch.kernels import intersect_gallop
    r, f = args
    if batched:
        r = r[None].expand(batched, -1).contiguous()
        f = f[None].expand(batched, -1).contiguous()
        kern = lambda: intersect_gallop.gallop_tiles_batched(r, f)
    else:
        kern = lambda: intersect_gallop.gallop_tiles(r, f)
    plain = lambda: its.intersect_gallop(r, f)
    library = lambda: torch.searchsorted(f, r)
    M, N = r.shape[-1], f.shape[-1]
    b_ms, b_by = bound(*_gallop_bytes_ops(M, N, max(batched, 1)))
    return {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain, iters=10), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": cuda_ms(library),
            "shape": f"B={max(batched, 1)} M={M} N={N}"}


def time_k3(args, kwargs) -> dict:
    from repro_torch.core import intersect as its
    from repro_torch.kernels import intersect_gallop
    r, words, widths, offsets, maxes, blk, exc_pos, exc_add = args
    kern = lambda: intersect_gallop.packed_gallop_batched(*args, **kwargs)
    plain = lambda: its.intersect_packed_batch(*args, **kwargs)
    rows = kwargs["block_rows"]
    B, M = r.shape
    C, Kp = blk.shape[1], widths.shape[1]
    ids = blk.to(torch.int64)
    real = ids < Kp
    wid = torch.gather(widths.to(torch.int64), 1, ids.clamp(max=Kp - 1))
    per = rows * 128
    ep = exc_pos.to(torch.int64)
    touched = torch.zeros_like(ep, dtype=torch.bool)
    for b in range(B):
        eb = torch.div(ep[b], per, rounding_mode="floor")
        touched[b] = (ep[b] >= 0) & torch.isin(eb, ids[b][real[b]])
    nbytes = (int((wid * real).sum()) * 512 + int(real.sum()) * 16
              + int(touched.sum()) * 8 + B * M * 5)
    nops = int(real.sum()) * per * 12 + _gallop_bytes_ops(M, C * per, B)[1]
    b_ms, b_by = bound(nbytes, nops)
    return {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
            "plain_ms": cuda_ms(plain, iters=10), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"B={B} M={M} C={C} blocks x {rows} rows, Kp={Kp}, "
                     f"{int(real.sum())} real candidate blocks, mode "
                     f"{kwargs['mode']}"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{name}, compute capability {torch.cuda.get_device_capability(0)}")
    from repro_torch.core import bitpack
    from repro_torch.index import corpus as corpus_lib, engine
    from repro_torch.kernels import _build, bitunpack, intersect_gallop, ops
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    # a few queries through the CLI entry point, at its default size
    serve.main(["--queries", "8", "--cache", "--shared-vocab"])

    t0 = time.perf_counter()
    corpus = corpus_lib.synthesize(n_docs=N_DOCS, n_queries=N_QUERIES, seed=5,
                                   shared_vocab=True)
    truth = [engine.brute_force(corpus.postings, q) for q in corpus.queries]
    log(f"corpus: {corpus.n_docs} docs, {corpus.n_terms} terms, "
        f"{sum(len(p) for p in corpus.postings)} postings, longest list "
        f"{max(len(p) for p in corpus.postings)}, {len(corpus.queries)} "
        f"queries (no cut); synthesis + brute force "
        f"{time.perf_counter() - t0:.1f} s")

    check_k2(dev)
    check_k3(dev)

    recorders = [
        Recorder(bitunpack, "unpack_blocks", lambda *a, **k: a[2].shape[0]),
        Recorder(intersect_gallop, "gallop_tiles",
                 lambda r, f: r.shape[0] * max((f.shape[0] - 1).bit_length(), 1)),
        Recorder(intersect_gallop, "packed_gallop_batched",
                 lambda *a, **k: a[5].shape[1] * a[0].shape[1]),
    ]
    torch.cuda.reset_peak_memory_stats()
    main_path = run_main_path(dev, corpus, truth)
    for rec in recorders:
        rec.restore()
    longest = max(corpus.postings, key=len)
    check_k1(dev, [
        ("longest list of the bp-d1 index", main_path["longest"]),
        ("longest posting list of the corpus, encoded bp-d1",
         bitpack.encode(longest, mode="d1").to(dev))])

    rows = []
    timers = {"unpack_blocks": time_k1, "gallop_tiles": time_k2,
              "packed_gallop_batched": time_k3}
    for rec in recorders:
        res = timers[rec.name](*rec.best)
        rows.append((rec.name, res))
        if rec.name == "gallop_tiles":
            rows.append(("gallop_tiles_batched",
                         time_k2(*rec.best, batched=8)))
    kernels = []
    for kname, res in rows:
        if res["max_abs_err"] != 0:
            raise AssertionError(f"{kname}: kernel differs from plain at the "
                                 f"main-path shape")
        log(f"{kname} at {res.pop('shape')}: " + ", ".join(
            f"{k} {v}" for k, v in res.items()))
        source, replaces = REPLACES[kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": main_path["launches"][kname], **res})
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
