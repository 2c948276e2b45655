"""Kernel times on the card, through the wrappers a user calls.

For each kernel K1–K7 and ``compact_rows`` at an operand set (the main
path's, as ``chip_smoke.py`` records them), and K8 at one tile:

  ms         CUDA events around 30 back-to-back wrapper calls: host and
             device together, as a caller that does not batch launches sees
             them;
  graph_ms   the same call captured 20 times in one CUDA graph and replayed:
             the device's time alone;
  host_us    the host clock a wrapper call, over 200 calls at a one-block
             shape with no synchronise inside the loop: the launch path's
             cost (checks, allocation, the launch itself);
  bound_ms   the least time the card could take for the same work: the
             bytes (each input read once, each output written once) over
             3.35 TB/s against the 32-bit operations over 67 T/s, the larger;

beside the plain version's time and, where one PyTorch call computes the same
function, that call's time back to back (``library_ms``) and in a graph
(``library_graph_ms``).  The functions take the operands and call the
wrappers by name, so the same file times another tree's kernels when that
tree's ``src`` comes first on ``PYTHONPATH``; run as a script it times an
operand file that ``chip_smoke.py --save-operands DIR`` wrote:

    PYTHONPATH=<tree>/src python src/repro_torch/launch/kernel_times.py \\
        build/ab/operands.pt --label <tree>

and prints one JSON object.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time
import warnings

import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
OPS_PER_S = 67e12              # H100 SXM 32-bit operations outside tensor cores
SENT = 2**31 - 1


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


def graph_ms(fn, iters: int = 20) -> float:
    """Device time a call: ``iters`` calls captured in one CUDA graph and
    replayed, so the host's work per call is left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    return cuda_ms(graph.replay, iters=5, warm=1) / iters


NODE_KINDS = ("KERNEL", "MEMCPY", "MEMSET", "HOST", "GRAPH", "EMPTY",
              "EVENT_RECORD", "WAIT_EVENT", "MEM_ALLOC", "MEM_FREE",
              "BATCH_MEM_OP", "CONDITIONAL", "EXT_SEMAS_SIGNAL",
              "EXT_SEMAS_WAIT")


def graph_ops(fn) -> list[tuple[str, str]]:
    """What one call of ``fn`` puts on the stream: the nodes of a CUDA graph
    that captured it, as ``dot_nodes`` reads them.  Unlike a profiler trace,
    which can come back with no device event at all, a captured graph holds
    every operation the call enqueued."""
    from repro_torch.kernels import _build
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"graph-{os.getpid()}.dot"
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            graph.debug_dump(str(path))
        return dot_nodes(path.read_text())
    finally:
        path.unlink(missing_ok=True)


def dot_nodes(text: str) -> list[tuple[str, str]]:
    """The nodes of a ``cudaGraphDebugDotPrint`` dump, in its order and
    without its edges, as (kind, label): kind is the first node type of
    ``NODE_KINDS`` that the node's text names (KERNEL, MEMCPY, …; "?" if
    none), and the label of a kernel node holds the kernel's name."""
    nodes = []
    for body in re.findall(r'^"[^"\n]*node_\d+"\s*\[(.*?)\];', text,
                           re.M | re.S):
        m = re.search(r"\b(" + "|".join(NODE_KINDS) + r")\b", body)
        nodes.append((m.group(1) if m else "?", body))
    return nodes


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call over ``calls`` calls with no synchronise
    inside the loop (the device runs behind; 200 launches stay well inside
    the launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) \
        if a.numel() else 0


def bound(nbytes: float, nops: float,
          ops_per_s: float = OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _one(t: torch.Tensor, *index) -> torch.Tensor:
    return t[index].contiguous()


def time_k1(args, kwargs) -> dict:
    from repro_torch.kernels import bitunpack
    words, offsets, widths, seeds, mode, rows = args
    kern = lambda: bitunpack.unpack_blocks(*args, **kwargs)
    plain = lambda: bitunpack.unpack_blocks_plain(*args, **kwargs)
    one = (words, offsets[:1], widths[:1], seeds[:1], mode, rows)
    K = widths.shape[0]
    nbytes = int(widths.to(torch.int64).sum()) * 512 + K * 12 + K * rows * 512
    b_ms, b_by = bound(nbytes, K * rows * 128 * 12)
    return {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
            "graph_ms": graph_ms(kern),
            "host_us": host_us(lambda: bitunpack.unpack_blocks(*one)),
            "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "library_graph_ms": None,
            "shape": f"K={K} blocks x {rows} rows, mode {mode}, widths "
                     f"{int(widths.min())}-{int(widths.max())}"}


def _gallop_work(r: torch.Tensor, N: int) -> tuple[int, int]:
    """K2's bytes and operations as this run's data needs them: r read and
    the mask written whole; each valid (not SENTINEL) candidate of a row
    searches ceil(log2 N) rounds, touching at most min(N, valid · rounds)
    ints of the row's f.  SENTINEL candidates are never members."""
    rounds = max((N - 1).bit_length(), 1)
    valid = (r != SENT).reshape(-1, r.shape[-1]).sum(-1).to(torch.int64)
    touched = int(torch.clamp(valid * rounds, max=N).sum())
    return r.numel() * 5 + touched * 4, int(valid.sum()) * rounds * 4


def time_k2(args, kwargs, batched: int = 0) -> dict:
    """K2a (or, with ``batched`` = B, K2b on B copies of the row) beside
    ``torch.searchsorted`` (the lower bound alone: ``library_ms``) and the
    four-op chain that computes the same membership (searchsorted, gather,
    ==, != SENTINEL: ``library_chain_ms``)."""
    from repro_torch.core import intersect as its
    from repro_torch.kernels import intersect_gallop
    r, f = args
    if batched:
        r = r[None].expand(batched, -1).contiguous()
        f = f[None].expand(batched, -1).contiguous()
        wrapper = intersect_gallop.gallop_tiles_batched
        r1, f1 = _one(r, slice(0, 1), slice(0, 256)), _one(f, slice(0, 1))
    else:
        wrapper = intersect_gallop.gallop_tiles
        r1, f1 = _one(r, slice(0, 256)), f
    kern = lambda: wrapper(r, f)
    plain = lambda: its.intersect_gallop(r, f)
    library = lambda: torch.searchsorted(f, r)
    M, N = r.shape[-1], f.shape[-1]

    def chain():
        idx = torch.searchsorted(f, r).clamp_(max=N - 1)
        return (torch.gather(f, -1, idx) == r) & (r != SENT)

    want = plain()
    if not torch.equal(chain(), want):
        raise AssertionError("the four-op chain differs from the plain gallop")
    b_ms, b_by = bound(*_gallop_work(r, N))
    return {"max_abs_err": max_abs_err(kern(), want), "ms": cuda_ms(kern),
            "graph_ms": graph_ms(kern), "host_us": host_us(
                lambda: wrapper(r1, f1)),
            "plain_ms": cuda_ms(plain, iters=10), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": cuda_ms(library),
            "library_graph_ms": graph_ms(library),
            "library_chain_ms": cuda_ms(chain),
            "library_chain_graph_ms": graph_ms(chain),
            "r_valid": int((r != SENT).sum()) // max(batched, 1),
            "f_valid": int((f != SENT).sum()) // max(batched, 1),
            "shape": f"B={max(batched, 1)} M={M} N={N}"}


def time_k3(args, kwargs) -> dict:
    """K3.  Where the tree's K3 is the two-launch design (candidate decode
    into a window, then K2's gallop over it: its C entry takes the window),
    as in the trees before the one-launch design, the gallop launch alone is
    also timed on the same window, made by the plain decode, through K2b
    (``gallop_ms``, ``gallop_graph_ms``); the one-launch design has no such
    launch."""
    from repro_torch.core import intersect as its
    from repro_torch.kernels import _build, bitunpack, intersect_gallop
    r, words, widths, offsets, maxes, blk, exc_pos, exc_add = args
    kern = lambda: intersect_gallop.packed_gallop_batched(*args, **kwargs)
    plain = lambda: its.intersect_packed_batch(*args, **kwargs)
    one = [_one(r, slice(0, 1), slice(0, 128))] + [
        _one(t, slice(0, 1)) for t in (words, widths, offsets, maxes)] + [
        _one(blk, slice(0, 1), slice(0, 1))] + [
        _one(t, slice(0, 1)) for t in (exc_pos, exc_add)]
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
    nops = int(real.sum()) * per * 12 + _gallop_work(r, C * per)[1]
    b_ms, b_by = bound(nbytes, nops)
    out = {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
           "graph_ms": graph_ms(kern), "host_us": host_us(
               lambda: intersect_gallop.packed_gallop_batched(*one,
                                                              **kwargs)),
           "plain_ms": cuda_ms(plain, iters=10), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "library_graph_ms": None}
    # the two-launch entry took 19 arguments, the window among them
    if len(_build.SIGNATURES["repro_packed_gallop"][1]) == 19:
        window = torch.stack([bitunpack.decode_candidates(
            words[b], widths[b], offsets[b], maxes[b], blk[b], exc_pos[b],
            exc_add[b], **kwargs) for b in range(B)])
        gallop = lambda: intersect_gallop.gallop_tiles_batched(r, window)
        out.update(gallop_ms=cuda_ms(gallop), gallop_graph_ms=graph_ms(gallop))
    return {**out, "r_valid": int((r != SENT).sum()),
            "shape": f"B={B} M={M} C={C} blocks x {rows} rows, Kp={Kp}, "
                     f"{int(real.sum())} real candidate blocks, mode "
                     f"{kwargs['mode']}"}


def _fold_work(valid, active, hit, N: int) -> tuple[int, int, list]:
    """The search work of a mask fold as this run's data needs it: fold j
    searches only the candidates still valid in its active rows, each with
    ceil(log2 N) dependent loads, touching at most min(N, live · rounds)
    ints of the row's list.  ``hit(j)`` is fold j's (B, M) match mask.
    Returns (bytes of the lists touched, operations, live candidates
    searched by each fold)."""
    rounds = max((N - 1).bit_length(), 1)
    nbytes = nops = 0
    lives = []
    v = valid
    for j in range(active.shape[0]):
        act = active[j][:, None]
        live = (v & act).sum(-1).to(torch.int64)
        lives.append(int(live.sum()))
        nops += lives[-1] * rounds * 4
        nbytes += int(torch.clamp(live * rounds, max=N).sum()) * 4
        v = v & torch.where(act, hit(j), True)
    return nbytes, nops, lives


def time_k4(args, kwargs) -> dict:
    from repro_torch.core import intersect as its
    from repro_torch.kernels import megakernel
    r, valid, folds, active = args
    kern = lambda: megakernel.decoded_fold_batched(*args)
    plain = lambda: megakernel.decoded_fold_plain(*args)
    one = (_one(r, slice(0, 1), slice(0, 128)),
           _one(valid, slice(0, 1), slice(0, 128)),
           _one(folds, slice(None), slice(0, 1)),
           _one(active, slice(None), slice(0, 1)))
    J, B, N = folds.shape
    M = r.shape[1]
    fold_bytes, nops, lives = _fold_work(
        valid, active, lambda j: its.intersect_gallop(r, folds[j]), N)
    # r, valid and the mask once each, the active flags, the touched folds
    b_ms, b_by = bound(B * M * 6 + J * B + fold_bytes, nops)
    # the time depends on the live candidates (a dead one stops early), so
    # the shape note carries them; three rounds show the spread in one call
    rounds = [cuda_ms(kern) for _ in range(3)]
    return {"max_abs_err": max_abs_err(kern(), plain()),
            "ms": sorted(rounds)[1], "graph_ms": graph_ms(kern),
            "host_us": host_us(lambda: megakernel.decoded_fold_batched(*one)),
            "plain_ms": cuda_ms(plain, iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library_graph_ms": None,
            "shape": f"J={J} B={B} M={M} N={N}, "
                     f"{int(active.sum())} active slots, "
                     f"{int(valid.sum())} valid candidates, live per fold "
                     f"{lives}, rounds {rounds} ms"}


def time_k5(args, kwargs) -> dict:
    """K5.  Where the tree's K5 is the two-launch design (candidate decode
    into a window in device memory, then K4's fold over it), the window's
    size is also reported (``window_bytes``)."""
    from repro_torch.core import intersect as its
    from repro_torch.kernels import _build, megakernel
    (r, valid, words, widths, offsets, maxes, blk, exc_pos, exc_add,
     active) = args
    kern = lambda: megakernel.packed_fold_batched(*args, **kwargs)
    plain = lambda: megakernel.packed_fold_plain(*args, **kwargs)
    one = ([_one(r, slice(0, 1), slice(0, 128)),
            _one(valid, slice(0, 1), slice(0, 128))]
           + [_one(t, slice(None), slice(0, 1))
              for t in (words, widths, offsets, maxes)]
           + [_one(blk, slice(None), slice(0, 1), slice(0, 1))]
           + [_one(t, slice(None), slice(0, 1))
              for t in (exc_pos, exc_add, active)])
    rows = kwargs["block_rows"]
    per = rows * 128
    Jp, B, C = blk.shape
    M, Kp = r.shape[1], widths.shape[2]
    ids = blk.to(torch.int64)
    real = (ids < Kp) & active[:, :, None]
    wid = torch.gather(widths.to(torch.int64), 2, ids.clamp(max=Kp - 1))
    ep = exc_pos.to(torch.int64)
    touched = 0
    for j in range(Jp):
        for b in range(B):
            if bool(active[j, b]):
                eb = torch.div(ep[j, b], per, rounding_mode="floor")
                touched += int(((ep[j, b] >= 0)
                                & torch.isin(eb, ids[j, b][real[j, b]])).sum())
    _, fold_ops, lives = _fold_work(valid, active, lambda j: its.intersect_packed_batch(
        r, words[j], widths[j], offsets[j], maxes[j], blk[j], exc_pos[j],
        exc_add[j], **kwargs), C * per)
    # as for K3: the candidate blocks' words and metadata, their
    # exceptions, r, valid, the mask and the active flags
    nbytes = (int((wid * real).sum()) * 512 + int(real.sum()) * 16
              + touched * 8 + B * M * 6 + Jp * B)
    nops = int(real.sum()) * per * 12 + fold_ops
    b_ms, b_by = bound(nbytes, nops)
    out = {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
           "graph_ms": graph_ms(kern), "host_us": host_us(
               lambda: megakernel.packed_fold_batched(*one, **kwargs)),
           "plain_ms": cuda_ms(plain, iters=3, warm=1), "bound_ms": b_ms,
           "bound_by": b_by, "library_ms": None, "library_graph_ms": None}
    # the two-launch entry took 22 arguments, the window among them
    if len(_build.SIGNATURES["repro_packed_fold"][1]) == 22:
        out["window_bytes"] = Jp * B * C * per * 4
    return {**out,
            "shape": f"Jp={Jp} B={B} M={M} C={C} blocks x {rows} rows, "
                     f"Kp={Kp}, {int(active.sum())} active slots, "
                     f"{int(real.sum())} real candidate blocks, live per "
                     f"fold {lives}, mode {kwargs['mode']}"}


def time_k6(args, kwargs) -> dict:
    from repro_torch.kernels import bitpack_pack
    deltas, widths = args
    kern = lambda: bitpack_pack.pack_blocks_padded(deltas, widths)
    plain = lambda: bitpack_pack.pack_blocks_padded_plain(deltas, widths)
    one = (deltas[:1], widths[:1])
    K = deltas.shape[0]
    # a (32, 128) tile in and out, the width; per value a shift, an OR and
    # the spill test, shift and OR
    b_ms, b_by = bound(K * (2 * 32 * 512 + 4), K * 4096 * 6)
    return {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
            "graph_ms": graph_ms(kern),
            "host_us": host_us(lambda: bitpack_pack.pack_blocks_padded(*one)),
            "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "library_graph_ms": None,
            "shape": f"K={K} blocks x 32 rows, widths "
                     f"{int(widths.min())}-{int(widths.max())}"}


def time_k7(args, kwargs) -> dict:
    from repro_torch.kernels import svb_decode
    ctrl, data, doffs, seeds, mode, rows = args
    kern = lambda: svb_decode.unpack_svb_blocks(*args)
    plain = lambda: svb_decode.decode_svb(*args)
    one = (ctrl[:1], data, doffs[:1], seeds[:1], mode, rows)
    K, CW = ctrl.shape
    DW = data.shape[0]
    n = K * rows * 128
    # control words, data words, offsets and seeds in once, 4-byte values
    # out; per value some 16 operations (code, length, offset scan, two
    # loads, shift, mask, prefix sum)
    b_ms, b_by = bound(K * CW * 4 + DW * 4 + K * 8 + n * 4, n * 16)
    return {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
            "graph_ms": graph_ms(kern),
            "host_us": host_us(lambda: svb_decode.unpack_svb_blocks(*one)),
            "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "library_graph_ms": None,
            "shape": f"K={K} blocks x {rows} rows, DW={DW} data words, "
                     f"mode {mode}"}


def time_compact_rows(args, kwargs) -> dict:
    """``compact_rows``, the batched svs programs' last launch, beside the
    tail it replaced (``valid.sum``, ``torch.where``, ``torch.cat``: the
    M-wide row, not compacted, so not the same function)."""
    from repro_torch.kernels import compact_rows as kc
    r, valid, max_results = args
    kern = lambda: kc.compact_rows(r, valid, max_results)
    plain = lambda: kc.compact_rows_plain(r, valid, max_results)
    tail = lambda: torch.cat([torch.where(valid, r, SENT),
                              valid.sum(-1, dtype=torch.int32)[:, None]], 1)
    w = min(r.shape[1], kc.TILE)
    one = (_one(r, slice(0, 1), slice(0, w)),
           _one(valid, slice(0, 1), slice(0, w)), max_results)
    B, M = r.shape
    C = min(M, max_results)
    # valid once, r's 16-byte groups that hold a survivor, the output row;
    # per slot a test and a count.  ``bound_5b_ms``: r read whole (5 B a
    # slot), as the kernel reads it
    groups = int(torch.nn.functional.pad(valid, (0, -M % 4))
                 .reshape(B, -1, 4).any(-1).sum())
    row = 4 * B * (C + 1)
    b_ms, b_by = bound(B * M + 16 * groups + row, 2 * B * M)
    return {"max_abs_err": max_abs_err(kern(), plain()), "ms": cuda_ms(kern),
            "graph_ms": graph_ms(kern),
            "host_us": host_us(lambda: kc.compact_rows(*one)),
            "plain_ms": cuda_ms(plain, iters=5), "bound_ms": b_ms,
            "bound_by": b_by, "bound_5b_ms": bound(5 * B * M + row, 0)[0],
            "library_ms": None, "library_graph_ms": None,
            "old_tail_graph_ms": graph_ms(tail),
            "old_tail_host_us": host_us(tail),
            "shape": f"Bp={B}, M={M}, C={C}, {int(valid.sum())} survivors"}


def time_k8_launch(args, kwargs) -> dict:
    """K8 at one tile (``host_us``'s shape in ``chip_smoke.time_k8``): the
    launch path's host time a call, and the call back to back and in a
    graph, beside the plain version."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v = args
    kern = lambda: fa.flash_attention(q, k, v, **kwargs)
    plain = lambda: fa.flash_attention_plain(q, k, v, **kwargs)
    err = float((kern().float() - plain().float()).abs().max())
    return {"max_abs_err": err, "k8_route": fa._route(
                q, k, v, kwargs.get("causal", True), kwargs.get("kv_len")),
            "ms": cuda_ms(kern), "graph_ms": graph_ms(kern),
            "host_us": host_us(kern), "plain_ms": cuda_ms(plain, iters=5),
            "shape": f"q/k/v {tuple(q.shape)} {q.dtype}, {kwargs}"}


TIMERS = {"unpack_blocks": time_k1, "gallop_tiles": time_k2,
          "packed_gallop_batched": time_k3, "decoded_fold_batched": time_k4,
          "packed_fold_batched": time_k5, "pack_blocks_padded": time_k6,
          "unpack_svb_blocks": time_k7, "flash_attention": time_k8_launch,
          "compact_rows": time_compact_rows}


def time_saved(path: str) -> dict:
    """Time every operand set of an operand file (key → (kernel name, args,
    kwargs), tensors on the host) on the card; ``gallop_tiles`` is also
    timed as K2b on 8 copies of its row."""
    saved = torch.load(path)
    dev = torch.device("cuda")
    to = lambda a: a.to(dev) if isinstance(a, torch.Tensor) else a
    out = {}
    for key, (name, args, kwargs) in saved.items():
        args = tuple(to(a) for a in args)
        kwargs = {k: to(v) for k, v in kwargs.items()}
        out[key] = TIMERS[name](args, kwargs)
        if name == "gallop_tiles":
            out["gallop_tiles_batched"] = time_k2(args, kwargs, batched=8)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("operands", help="an operand file of chip_smoke.py "
                                    "--save-operands")
    p.add_argument("--label", default="", help="a name for this tree")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    res = time_saved(args.operands)
    for key, r in res.items():
        print(f"[kernel_times {args.label}] {key}: " + ", ".join(
            f"{k} {v}" for k, v in r.items()), flush=True)
    print(json.dumps({"label": args.label,
                      "device": torch.cuda.get_device_name(0),
                      "kernels": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
