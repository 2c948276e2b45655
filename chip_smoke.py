"""Smoke run of the PyTorch/CUDA port on one CUDA card (sm_90, an H100).

    python3 chip_smoke.py [--save-operands DIR] [--seed N]

Phases, each fatal on failure, each timed:
  1. the card's name and power limit; build the hand kernels from
     src/repro_torch/kernels/csrc with nvcc (one process per source, all at
     once); a few queries through the serve CLI, sequential and batched,
     and with ``--codec streamvbyte`` and ``--codec auto`` (hits equal to
     the default fastpfor serve's), ``--resident``, ``--pipeline 2`` and
     ``--shards 2``; ``serve --qps 500 --batch 16 --warmup``, ``serve
     --mutate 120 --delete-frac 0.2 --batch 16`` and ``serve --qps 500
     --wal DIR --mutate 64 --chaos crash@wal.append.add:40 --batch 16``,
     each printing its differential line (the last also its chaos and
     recovery lines); ``serve --arch <id> --tokens 4`` for gemma-7b,
     granite-moe-1b-a400m and kimi-k2-1t-a32b and ``serve --arch <id>``
     for din, sasrec, bert4rec and mind (the smoke-reduced models); the
     training launcher at smoke size (see phase 8);
  2. each kernel against its plain PyTorch version on the card, exact
     (torch.equal): K1 over widths 0–32, K = 1, 3, WARPS ± 1 blocks and
     clamped word reads × six modes × rows 32/8, K2a/K2b over M 128…2**16
     and N 1…2**24 with whole SENTINEL warps after a valid prefix,
     all-SENTINEL and no-match rows, SENTINEL lanes between valid ones,
     unsorted r and one valid lane past whole warps, K3 over modes
     none–dv × bp/fastpfor (E = 0 and exceptions), C 8…1024 with pad ids
     (512 of 1024 at 8-row blocks), a row of pads only and candidates above
     the last candidate block, one launch a call and one kernel in a
     call captured in a CUDA graph, K4 over N 1…2**23 with
     SENTINEL and padded rows, holes in the incoming mask, inactive slots
     and J = 0, K5 over modes none–dv × bp/fastpfor
     (with and without exceptions), 32- and 8-row blocks, C 8…2048 with
     half the slots pads and candidates above the last candidate block, an
     active slot of pad ids only, inactive, empty and single-block slots,
     family-ceiling pads and Jp = 0, one launch a call and its kernel and
     the seed copy alone in a captured call; K4, K5, K6 and K8 refusing
     operands on two devices or of another dtype; K6
     over widths 0–32 × modes at K = 2**12 (and back through K1), K7 over
     modes × block_rows 1/2/8/32 × byte lengths 1–4 with pow2 pad blocks,
     clamped last-word reads, negative and int32-wrapping offsets,
     K = 1 … 2**15, one launch a call; K8 (flash attention) at the
     shapes of tests/test_torch_cuda.py, float32 within 1e-4 and bf16
     within 0.05 and elementwise within ``flash_attention.bf16_allowance``,
     each call on the route (tc, split or simt) that FLASH_CASES states,
     by K8's route counter, and every route run; K8's, K1's, K2's, K3's,
     K5's and K7's kernels' registers and spills, read by ``cuobjdump``
     (fatal if one of them spills);
  3. the main path at ClueWeb09 Category B scale: a 50,000,000-document
     corpus with 64 queries (shared vocabulary), built (two parts) on the
     card as fastpfor-d1 and as bp-d1 at B=16 in three regimes — default,
     DecodeCache, skip=False — and without bitmaps (B=0) in the default
     regime, and as streamvbyte-d1 and auto (the storage autotuner with
     the reference's cost table) at B=16 in the default regime:
     3.  sequentially through ``serve.serve_queries`` / ``engine.query``;
     3b. batched through ``serve.serve_batched`` / ``batch.execute_batch``
         at batch 32, fused, with one FusionPlan per build warmed by
         ``batch.warmup``;
     3c. (fastpfor-d1 B16 and B0, streamvbyte-d1 B16) a ResidentPool,
         pipelined at depths 1 and 2, the engines on the pool and two
         shards (``resident_paths``);
     3d. (fastpfor-d1 B16) the live server and the mutable, durable index
         (``live_paths``): ``server.warm_server`` (twice: the second
         launches no new signature), drain mode over the 64 queries cycled
         to 256 requests (its q/s is R), Poisson at 0.5·R and 2·R and with
         ``transient@launch:0.05`` at 0.5·R (512 requests each: outcomes,
         p50/p99, flush reasons, retries, ladder steps); then a
         ``segments.MutableIndex`` of the corpus with 4096 adds, a seal
         and 409 tombstones, served at 0.5·R while ``merge_async`` runs
         (K1 on the merge thread, counted apart) and checked against
         ``builder.build(live_postings())`` + ``engine.query``; then the
         same stream on the first 2**23 documents with a ``DurableLog``,
         a crash at the 3000th WAL add, ``recover``, tombstones, a merge
         and a second recovery (times and bytes on disk);
     every answer is checked against numpy brute force (and the batched
     ones against the sequential ones), and the launch counts of K1–K5 and
     K7 are checked; then one more default pass of each B=16 build and
     each path under torch.profiler (device idle share); then the pack
     pass: the deltas of the corpus's longest lists packed on the card
     through ``ops.pack_blocks`` (K6), held against the host encoder's
     words and unpacked back through K1;
  4. each kernel K1–K7 timed at the largest shape the main path gave it
     (``repro_torch/launch/kernel_times.py``): ``ms`` back to back with
     CUDA events, ``graph_ms`` replayed from a CUDA graph (the device
     alone), ``host_us`` the host's time a call at a one-block shape,
     beside its plain version, a library call where one computes the same
     function (back to back and in a graph; for K2 also the four-op chain
     searchsorted, gather, ==, != SENTINEL, and the valid lanes of r and
     f), and its bound (bytes over 3.35 TB/s, or 32-bit operations over 67
     T/s, the larger); K1, K3, K5 and K7 also at the largest call of their
     most frequent size, with their calls by size (K, or C for K3 and K5,
     to the next power of two); with
     ``--save-operands DIR`` every timed kernel's operands, and one tile of
     K8's, go to DIR/operands.pt, for ``kernel_times.py`` to time another
     tree's kernels on; then the index is freed;
  5. the served LM at full width: gemma-7b as registered (28 layers,
     d_model 3072, 16 heads of 256, d_ff 24576, vocab 256000; 8,537,677,824
     float32 parameters from a seeded generator on the card, bf16 compute)
     serves 4 requests of 1024 prompt tokens and 32 new tokens through
     ``serve.steps.greedy_generate``, after one warm generation of 2
     tokens (``serve_lm_checked``, as phase 6): finite logits, the first decode step
     against a prefill over the prompt and its token, tokens/s and peak
     memory, a profile of one prefill and one decode step; the same
     weights cut to 2 layers in float32 on the card and on the CPU (logits
     within 1e-3, |a - b| <= 1e-3 (1 + |b|), tokens equal); K8 through
     ``ops.flash_attention`` on layer 0's prefill operands (against
     ``layers.attention_full``, on the tc route), on the last decode step's
     operands (against ``layers.attention_decode``, on the split route) and
     on a phi3-medium-14b-wide GQA shape (tc), each within 0.05 and, against
     the plain version, within ``bf16_allowance``; then K8 timed at those
     three shapes beside the SIMT route's kernel at the same shape, its
     plain version, ``scaled_dot_product_attention`` (timed only, back to
     back and in a CUDA graph, also under its FlashAttention-2 backend
     alone), its host time a call at one 64-token tile, and its bound
     (bytes over 3.35 TB/s, or FLOPs over 989 TFLOP/s for bf16 operands
     and 67 TFLOP/s for float32);
  6. the MoE LMs at full width, after gemma-7b is freed: granite-moe-1b-
     a400m as registered (24 layers, 32 experts, top-8, 1,334,640,640
     float32 parameters) serves the same 4 x (1024 + 32) requests: finite
     logits, tokens in range, prefill tok/s, decode ms/step, peak memory;
     two prefills bit-equal, the slots dropped in a prefill and a decode
     step, a profile of each (idle share, launches); the first decode step
     against a prefill over the prompt and its token with capacity_factor
     E/top_k (nothing dropped) within LM_DECODE_TOL; the 2-layer float32
     cut on the card and the CPU (logits within 1e-3, tokens equal) and
     each MoE layer's experts routed on both from the card's layer input
     (equal sets except at a CPU margin under 1e-5, counted); then
     kimi-k2-1t-a32b at its registered widths cut to 2 of 61 layers (1
     where 2 does not fit; the cut run is printed): the same requests,
     bit-equal repeat prefills, dropped slots (C = 107 in a prefill, 1 in
     a decode step), profiles;
  7. in a child process with expandable segments (``run_recsys_phase``),
     din, sasrec, bert4rec and mind at their registered widths, params
     from a seed: serve_p99 (512 rows) and serve_bulk (262144; bert4rec
     65536) scored, retrieval_cand (2**20 candidates; din 2**18) scored
     and cut to the top 100, each timed (ms a batch, items/s, peak memory)
     and held against the port's CPU path on the same params and batch,
     run in row chunks: scores within 1e-4, top-100 values within 1e-4
     and indices equal outside tie groups;
  8. in a child process with expandable segments (``run_train_phase``),
     training: graphsage-reddit at its registered widths (2 layers,
     d_hidden 128; d_feat, classes and task per shape) on its four shapes
     (``train_gnn_shape``: minibatch_lg on a 232,965-node power-law graph
     of about 117M edges made on the card (``card_graph``), 1024 seeds at
     fanout (15, 10); full_graph_sm, 2708 nodes (``synthetic_graph``);
     ogb_products, 2,449,029 nodes and about 64M edges (``card_graph``);
     molecule, 128 graphs of 30 nodes), each a warm step and 3 timed
     steps of ``make_gnn_train_step`` with AdamW (ms a step, seeds/s or
     nodes/s, peak memory, finite losses); one step of full_graph_sm,
     molecule and minibatch_lg (its hops drawn on the card, moved) held
     against the CPU path (``step_against_cpu``: loss within 1e-4, each
     gradient leaf within 1e-4 in norm, then both devices apply the card's
     gradients, params and moments within 1e-6); resume through
     ``Trainer`` bitwise (``resume_is_bitwise``: 4 steps against 2 +
     checkpoint + restore + 2, torch.equal) for minibatch_lg and
     full_graph_sm; K1 in the data path
     (``k1_in_the_data_path``): a ``CompressedCSR`` of a 60,000-node graph
     and ``grad_compress.decode_wire`` of the top 2**16 of 2**24
     coordinates decoded on the card, equal to the host decode, the
     Reddit-size graph refused past the codec's 2**32 domain (K1's launches
     here are added to its count); internlm2-1.8b at full width
     (``train_lm_full``: 1,889,107,968 float32 parameters, bf16 compute,
     remat dots, AdamW) a warm step and 3 timed steps on 1 x 4096 tokens
     (tok/s, ms a step, peak memory, a profiled step's idle share), the
     2-layer float32 cut against the CPU at 128 tokens (within 1e-3), and
     bitwise resume at the smoke widths (vocab 512); din, sasrec, bert4rec
     (cut to 2**13 rows) and mind on train_batch (65,536 rows) at their
     registered widths (``train_recsys``), each timed and profiled, and
     one step on 2**11 rows held against the CPU path.  Phase 1 also runs
     ``python -m repro_torch.launch.train --arch <id> --steps 20
     --ckpt-every 10`` for graphsage-reddit, internlm2-1.8b and din
     (``train_launcher_cli``);
  9. in a process group of its own (``run_mesh_phase``: one NCCL rank a
     visible card, world = the card count, a (data, model) = (1, world)
     mesh on the cards and the same mesh on the CPU over gloo), the
     multi-card layer: one MoE layer of granite-moe-1b-a400m (d 1024,
     d_ff 512, 32 experts, top-8, float32 weights) and of kimi-k2-1t-a32b
     (d 7168, d_ff 2048, 384 experts, top-8, bf16 weights, 33.8e9 bytes)
     on 4 x 1024 bf16 tokens from ``--seed`` through
     ``moe.moe_ffn_sharded`` (``mesh_moe``): against ``moe_ffn_local`` on
     the card at a factor where nothing drops (within LM_DECODE_TOL, no
     slot dropped), against the same function on the CPU mesh in float32
     at the config's factor 1.25 (the same drops; tokens routed apart at
     a near tie left out and counted), two runs bit-equal, ms a layer of
     both paths, the all-to-alls' bytes and device ms from the profiler
     (with one card they are copies within it); then granite's whole
     tree placed by ``lm_param_spec`` (tp), saved and restored through
     ``restore(shardings=)``, torch.equal (``mesh_restore``);
 10. the last modules of the reference (``run_examples_phase``): the five
     examples of ``repro_torch.examples`` on the card at the reference
     scripts' sizes (quickstart, search_engine at 2**17 documents and 40
     queries, recsys_retrieval, gnn_sampling's 60 steps, train_lm's 300
     steps with checkpoints under build/), each with its launches by
     kernel (counts set to 0 just before it), search_engine's ms/query a
     build; fatal if quickstart does not launch K1, K2 and K3 or an
     example's own check fails.  Meanwhile, in two child processes
     (``dryrun_child``), the dry-run of internlm2-1.8b decode_32k on the
     2×16×16 mesh and paper-index svs_batch on the 16×16 one over a fake
     process group: each must exit 0, print OK, write its record and not
     initialise CUDA; their roofline rows (H100 SXM 700 W data-sheet
     constants: an analysis, not a measurement) are printed.
The last two lines are the kernels' JSON record and the device line.  It
exits nonzero, printing no result, where there is no CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.launch.kernel_times import (  # noqa: E402
    OPS_PER_S, TIMERS, bound, cuda_ms, graph_ms, graph_ops, host_us,
    time_k2)

BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 dense tensor cores (data sheet)
N_DOCS = 50_000_000            # ClueWeb09 Category B (corpus.TABLE2_DOCS)
N_QUERIES = 64
BATCH = 32
# Index configurations over the one corpus: (codec, name, bitmap threshold
# B, regimes).  B=16 is HYB+M2 as the serving default builds it; B=0 (no
# bitmaps) is the paper's other end of the B sweep (Tables 4/5, B ∈ {0, 8,
# 16, 32}).  The batched scheduler skip-probes a list only when it is over
# 32× the seed's whole list in a part (source.SKIP_MIN_RATIO); at B=16 every
# list that long is a bitmap, so the batched skip path (K5) runs at B=0.
# streamvbyte-d1 stores every list of 1024 postings or more as StreamVByte
# (K7 decodes them); auto is the storage autotuner with the reference's
# cost table.
CELLS = tuple((codec, wname, B, regimes)
              for codec in ("fastpfor-d1", "bp-d1")
              for wname, B, regimes in (
                  ("B16", 16, ("default", "cache", "noskip")),
                  ("B0", 0, ("default",)))) + (
    ("streamvbyte-d1", "B16", 16, ("default",)),
    ("auto", "B16", 16, ("default",)))
LONGEST_LISTS = 4              # lists of the K6 pack pass
# phase 3c: the device-resident index, pipelined and sharded serving, on
# these builds of CELLS; the pool's capacity (4 GiB of ints) holds their
# working set, arenas included, so the timed passes rebuild no arena
RESIDENT_BUILDS = (("fastpfor-d1", "B16"), ("fastpfor-d1", "B0"),
                   ("streamvbyte-d1", "B16"))
RESIDENT_CAPACITY = 1 << 30
DEPTHS = (1, 2)
SHARDS = 2
# phase 3d: the live server and the mutable, durable index on fastpfor-d1
# B16, at the reference server's defaults (batch 32, depth 2, 2 ms wait, a
# queue of 256); drain mode serves the 64 queries cycled to LIVE_REQUESTS,
# each open-loop run OPEN_REQUESTS; the mutable stream is MUTATE_ADDS adds
# (sealed half way) and a tenth as many tombstones; the durable part runs
# on the corpus's first DURABLE_DOCS documents (PERF.md §4 says why), and
# its WAL crash comes at add CRASH_AT
LIVE = dict(max_batch=32, depth=2, max_wait_ms=2.0, max_queue=256)
LIVE_REQUESTS = 256
OPEN_REQUESTS = 512
CHAOS = "transient@launch:0.05"
MUTATE_ADDS = 4096
DURABLE_DOCS = 1 << 23
CRASH_AT = 3000
ROOT = Path(__file__).resolve().parent
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
    "decoded_fold_batched": ("src/repro_torch/kernels/csrc/decoded_fold.cu",
                             "src/repro/kernels/megakernel.py:88"),
    "packed_fold_batched": ("src/repro_torch/kernels/csrc/packed_fold.cu",
                            "src/repro/kernels/megakernel.py:162"),
    "pack_blocks_padded": ("src/repro_torch/kernels/csrc/bitpack_pack.cu",
                           "src/repro/kernels/bitpack_pack.py:58"),
    "unpack_svb_blocks": ("src/repro_torch/kernels/csrc/svb_decode.cu",
                          "src/repro/kernels/svb_decode.py:112"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:104"),
}
# phase 5: the served LM (gemma-7b as registered) and its request shape
LM_ARCH = "gemma-7b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1024, 32
LM_PARAMS = 8_537_677_824
# K8 at phi3-medium-14b's attention width: B, Sq, Sk, H, Hkv, D
GQA_SHAPE = (4, 1024, 1024, 40, 10, 128)
# the first decode step against a prefill over the prompt and its token, in
# bf16: the two paths sum their products in other orders (a 1-row product
# against a 1025-row one), so the residual stream, rounded to bf16 (2**-9
# of a value at most) after each of 56 sublayers, drifts apart like a
# random walk of about sqrt(56) * 2**-9 ≈ 0.015 per path; the logits' RMS
# difference must stay within 0.05 of their RMS
LM_DECODE_TOL = 0.05
# phase 6: the MoE LMs at full width (the same 4 x (1024 + 32) requests)
MOE_ARCH = "granite-moe-1b-a400m"
MOE_PARAMS = 1_334_640_640
KIMI_ARCH = "kimi-k2-1t-a32b"
# kimi's layers are all one MoE layer, so a layer is a whole period: 2 of
# 61 (72.8e9 bytes of bf16 weights), or 1 where the peak does not fit
KIMI_CUTS = (2, 1)
# the 2-layer float32 cut routes on the card and the CPU from the same
# layer input; float32 sums in another order move a probability by ~1e-7,
# so experts may differ only where the k-th and (k+1)-th are this close
NEAR_TIE = 1e-5
# phase 7: the recsys archs at their registered widths, at the serve shapes
# of configs/recsys_shapes.py; the cuts keep one materialised tensor under
# the card's 80 GB: bert4rec's (B, 2, 200, 200) float32 attention scores
# are 84e9 bytes at 262144 rows, din's per-candidate target attention
# builds (C, 100, 144) float32, 60e9 bytes at 2**20 candidates
RECSYS_ARCHS = ("din", "sasrec", "bert4rec", "mind")
RECSYS_CUTS = {("serve_bulk", "bert4rec"): 1 << 16,
               ("retrieval_cand", "din"): 1 << 18}
# card against the CPU path in float32 (rtol and atol): the same products
# summed in another order
RECSYS_TOL = 1e-4
CPU_CHUNK = 1 << 14            # rows (or candidates) a CPU call
# K8 at phase 2's shapes (tests/test_torch_cuda.py's FLASH_CASES): B, Sq,
# Sk, H, Hkv, D, causal, kv_len, bq, bk, and the route the bf16 call takes
# by kernels/flash_attention.py's route table (float32 calls take simt)
FLASH_CASES = [
    (2, 256, 256, 4, 2, 64, True, None, 128, 128, "tc"),
    (1, 512, 512, 8, 8, 128, True, None, 256, 256, "tc"),
    (2, 256, 512, 4, 1, 64, False, 450, 128, 128, "tc"),
    (1, 128, 1024, 2, 2, 256, False, None, 128, 512, "tc"),
    (1, 256, 256, 4, 4, 64, True, 200, 64, 64, "tc"),
    (2, 256, 256, 2, 2, 256, True, None, 512, 512, "tc"),
    (4, 1, 1056, 16, 16, 256, False, 1055, 512, 1056, "split"),
    (2, 1, 512, 4, 2, 128, False, 1, 512, 512, "split"),
    (1, 64, 128, 2, 1, 64, False, 0, 64, 64, "simt"),
    (1, 128, 256, 4, 2, 64, True, None, 128, 256, "tc"),
    (2, 96, 160, 4, 2, 64, True, 150, 32, 32, "tc"),
    (2, 32, 32, 4, 2, 16, True, None, 512, 512, "simt"),
    (1, 80, 80, 2, 2, 80, True, None, 16, 16, "simt"),
    (1, 48, 48, 2, 1, 20, False, 40, 16, 16, "simt"),
    (1, 256, 256, 40, 10, 128, True, None, 128, 128, "tc"),
    # K8's Hopper routes (tests/test_torch_cuda.py's FLASH_ROUTE_CASES):
    # ragged Sq and Sk at D = 128, Sq > Sk and Sq < Sk causal at D = 256,
    # kv_len mid-tile with causal, decode against an 8192-long cache at
    # kv_len 1, 4097 and 8192, 4:1 GQA decode at D = 128, gemma-7b prefill
    (1, 200, 200, 2, 1, 128, True, None, 512, 512, "tc"),
    (2, 96, 160, 4, 2, 128, True, None, 512, 512, "tc"),
    (1, 320, 192, 2, 2, 256, True, None, 512, 512, "tc"),
    (1, 130, 384, 2, 2, 256, True, None, 512, 512, "tc"),
    (2, 192, 256, 4, 2, 64, True, 100, 512, 512, "tc"),
    (2, 1, 8192, 4, 4, 256, False, 1, 512, 512, "split"),
    (2, 1, 8192, 4, 4, 256, False, 4097, 512, 512, "split"),
    (2, 1, 8192, 4, 4, 256, False, 8192, 512, 512, "split"),
    (2, 1, 2048, 8, 2, 128, False, 2000, 512, 512, "split"),
    (4, 1024, 1024, 16, 16, 256, True, None, 512, 512, "tc"),
]


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

def k1_blocks(rng, widths, rows: int) -> list:
    """Blocks packed at ``widths`` (each holding its width's maximum), laid
    out flat as ``bitpack.encode`` lays them out: [words, offsets, widths,
    seeds] as numpy arrays."""
    from repro_torch.core import bitpack
    widths = np.asarray(widths, np.int32)
    packed = []
    for b in widths:
        d = rng.integers(0, 1 << int(b), size=(rows, 128), dtype=np.uint64)
        d[0, 0] = (1 << int(b)) - 1
        packed.append(bitpack.pack_block_np(d.astype(np.uint32), int(b)))
    per = [(rows * int(b) + 31) // 32 for b in widths]
    words = (np.concatenate(packed) if sum(per)
             else np.zeros((1, 128), np.uint32))
    offs = np.concatenate([[0], np.cumsum(per[:-1])]).astype(np.int32)
    seeds = rng.integers(0, 1 << 32, len(widths),
                         dtype=np.uint64).astype(np.uint32)
    return [words, offs, widths, seeds]


def check_k1(dev, longest: list) -> None:
    """K1 vs plain over the width sweep, K = 1, 3, WARPS ± 1 blocks of
    random widths, clamped word reads, and on each (label, PackedList) of
    ``longest``."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import bitunpack
    rng = np.random.default_rng(1)
    W = bitunpack.WARPS
    for rows in (32, 8):
        cases = {"widths 0-32": k1_blocks(rng, np.arange(33), rows)}
        for K in (1, 3, W - 1, W + 1):
            cases[f"K={K}"] = k1_blocks(rng, rng.integers(0, 33, K), rows)
        words = cases["widths 0-32"][0]
        T = words.shape[0]
        cases["clamped word reads"] = [
            words, np.array([T - 3, T - 1, -2, T - 20, 0], np.int32),
            np.array([17, 32, 9, 31, 0], np.int32),
            np.array([7, 0xFFFFFFF0, 1, 2**31, 5], np.uint32)]
        for what, arrays in cases.items():
            args = [_t(a, dev) for a in arrays]
            for mode in ("none", "d1", "d2", "d4", "dm", "dv"):
                expect_equal(f"K1 {what} {mode} rows={rows}",
                             bitunpack.unpack_blocks(*args, mode, rows),
                             bitunpack.unpack_blocks_plain(*args, mode, rows))
    for what, pl in longest:
        args = (pl.flat_words, pl.offsets, pl.widths, bitpack.seeds_of(pl),
                pl.mode, pl.block_rows)
        expect_equal(f"K1 {what}", bitunpack.unpack_blocks(*args),
                     bitunpack.unpack_blocks_plain(*args))
        log(f"K1 equal to plain on the {what} ({pl.n} ints, "
            f"{pl.num_blocks} blocks)")
    log(f"K1 equal to plain: widths 0-32, K = 1, 3, {W - 1}, {W + 1} blocks "
        f"of random widths and clamped word reads x 6 modes x rows 32/8")


def gallop_case(rng, B, M, N, kind):
    """(r, f) rows: f sorted, its values in front, SENTINEL behind; r by
    ``kind``: a sorted valid prefix then SENTINEL (mixed, no_match), all
    SENTINEL, 'holes' (SENTINEL lanes between valid ones), 'unsorted',
    'tail_one' (a prefix of 5 warps and one lane, all members)."""
    r = np.full((B, M), SENT, np.int32)
    f = np.full((B, N), SENT, np.int32)
    for b in range(B):
        fv = np.unique(rng.integers(0, 1 << 30, max(N // 2, 1)))
        f[b, : fv.size] = fv
        if kind == "all_sentinel":
            continue
        if kind == "tail_one":
            r[b, :161] = fv[:161]
            continue
        rv = np.unique(rng.integers(0, 1 << 30, M // 2))
        if kind == "no_match":
            rv = np.setdiff1d(rv, fv)
        else:
            rv = np.union1d(rv[: M // 4], rng.choice(fv, M // 4))
        if kind == "holes":
            r[b, np.sort(rng.choice(M, rv.size, replace=False))] = rv
        elif kind == "unsorted":
            r[b, : rv.size] = rng.permutation(rv)
        else:
            r[b, : rv.size] = rv
    return r, f


def check_k2(dev) -> None:
    from repro_torch.core import intersect as its
    from repro_torch.kernels import ops
    rng = np.random.default_rng(2)
    cases = [(128, 128, "mixed"), (1024, 1 << 16, "mixed"),
             (1 << 16, 1 << 24, "mixed"), (4096, 1 << 20, "all_sentinel"),
             (1 << 16, 1 << 20, "no_match"), (1000, 3000, "mixed"),
             (1 << 16, 1 << 21, "tail_one"), (777, 1000, "holes"),
             (1 << 15, 3001, "unsorted"), (300, 1, "mixed"),
             (130, 1, "all_sentinel"), (100003, 1 << 20, "holes")]
    for M, N, kind in cases:
        r, f = gallop_case(rng, 2, M, N, kind)
        tr, tf = _t(r, dev), _t(f, dev)
        want = its.intersect_gallop(tr, tf)
        expect_equal(f"K2b M={M} N={N} {kind}",
                     ops.intersect_gallop_batch(tr, tf), want)
        expect_equal(f"K2a M={M} N={N} {kind}",
                     ops.intersect_gallop(tr[0].contiguous(),
                                          tf[0].contiguous()), want[0])
        if kind not in ("all_sentinel", "no_match") and not bool(want.any()):
            raise AssertionError(f"K2 M={M} N={N} {kind}: no matches")
    log(f"K2a/K2b equal to plain on {len(cases)} (M, N) cases up to "
        f"M=2**16, N=2**24: valid prefixes then whole SENTINEL warps, "
        f"all-SENTINEL and no-match rows, SENTINEL lanes between valid "
        f"ones, unsorted r, one valid lane past whole warps, M not a "
        f"multiple of 32, N = 1 and N not a power of two")


def packed_operands(encs, rs, c_pad, dev, *, real=None, pad_row=False):
    """K3 operands (in wrapper order) for rows of encoded lists and their
    candidates: each row's candidate ids are its candidates' blocks cut to
    ``real`` (c_pad - 1 by default) and padded, so candidates above the last
    candidate block stay in r (the kernel writes them false); ``pad_row``
    adds a row whose slots are all pads."""
    from repro_torch.core import bitpack, intersect as its
    from repro_torch.index import source
    k_pad = max(bitpack.self_pads(e)[0] for e in encs)
    t_pad = max(bitpack.self_pads(e)[1] for e in encs)
    e_pad = max(max(bitpack.self_pads(e)[2] for e in encs), 1)
    cols = {k: [] for k in ("r", "words", "widths", "offsets", "maxes", "blk",
                            "exc_pos", "exc_add")}
    # at least one whole SENTINEL warp after every row's valid prefix
    m = its.pow2_bucket(max(len(r) for r in rs) + 32)
    rows = list(zip(encs, rs)) + ([(encs[0], rs[0])] if pad_row else [])
    for i, (enc, r) in enumerate(rows):
        lay = bitpack.layout_np(enc, k_pad, t_pad, e_pad)
        blk = bitpack.candidate_block_ids(lay.maxes[: enc.num_blocks], r)
        blk = blk[: (c_pad - 1 if real is None else real)]
        if (r > lay.maxes[blk[-1]]).sum() == 0:
            raise AssertionError("K3 check: no candidate above the last "
                                 "candidate block")
        cols["r"].append(its.pad_to(r, m))
        cols["blk"].append(source.pad_block_ids(
            blk if i < len(encs) else blk[:0], c_pad, k_pad))
        for k in ("words", "widths", "offsets", "maxes", "exc_pos", "exc_add"):
            cols[k].append(getattr(lay, k))
    return [_t(np.stack(v), dev) for v in cols.values()]


def check_k3(dev) -> dict:
    """K3 vs plain, one launch a call, one kernel in a captured call;
    returns the encoded lists and candidates for K5's check."""
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
    encs = {}

    def check(what, args, mode, rows):
        nonlocal n_checks
        if not bool((args[0].reshape(args[0].shape[0], -1, 32) == SENT)
                    .all(-1).any(-1).all()):
            raise AssertionError("K3 check: a row without whole SENTINEL "
                                 "warps")
        want = its.intersect_packed_batch(*args, mode=mode, block_rows=rows)
        before = ops.launches()["packed_gallop_batched"]
        got = ops.intersect_packed_batch(*args, mode=mode, block_rows=rows)
        expect_equal(f"K3 {what}", got, want)
        if ops.launches()["packed_gallop_batched"] != before + 1:
            raise AssertionError(f"K3 {what}: not one launch a call")
        if not bool(want[:2].any()) or bool(want[2:].any()):
            raise AssertionError(f"K3 {what}: no matches, or a match in the "
                                 f"row of pads")
        n_checks += 1

    for mode in ("none", "d1", "d2", "d4", "dm", "dv"):
        for codec in ("bp", "fastpfor"):
            enc = (fastpfor.encode(f, mode=mode) if codec == "fastpfor"
                   else bitpack.encode(f, mode=mode))
            if mode != "none":
                encs[(codec, mode)] = enc
            for c_pad, r in ((8, sparse), (256, dense)):
                args = packed_operands([enc, enc], [r, r[::2]], c_pad, dev,
                                       pad_row=True)
                check(f"{codec}-{mode} C={c_pad}", args, mode, enc.block_rows)
            if (codec == "fastpfor" and mode != "none"
                    and enc.exc_pos.shape[0] == 0):
                raise AssertionError("K3 check has no FastPFOR exceptions")
    # the main path's C = 1024 with half the slots pads, 8-row blocks
    for codec in ("bp", "fastpfor"):
        enc = (fastpfor.encode(f, mode="d1", block_rows=8)
               if codec == "fastpfor" else
               bitpack.encode(f, mode="d1", block_rows=8))
        args = packed_operands([enc, enc], [dense, dense[1::3]], 1024, dev,
                               real=512, pad_row=True)
        check(f"{codec}-d1 C=1024, 512 pad slots, rows=8", args, "d1", 8)
        if codec == "fastpfor":
            nodes = graph_ops(lambda: ops.intersect_packed_batch(
                *args, mode="d1", block_rows=8))
            if ([k for k, _ in nodes] != ["KERNEL"]
                    or "packed_gallop_kernel" not in nodes[0][1]):
                raise AssertionError(f"K3 enqueued other operations than its "
                                     f"kernel in a captured call: "
                                     f"{[(k, t[:300]) for k, t in nodes]}")
    log(f"K3 equal to plain on {n_checks} cases, one launch a call: modes "
        f"none/d1/d2/d4/dm/dv, bp and fastpfor (with exceptions), pad ids, "
        f"C = 8, 256 and 1024 (512 pads, rows 8), a row of pads only, "
        f"candidates above the last candidate block, every row's valid "
        f"prefix followed by whole SENTINEL warps; a call captured in a "
        f"CUDA graph enqueues packed_gallop_kernel alone")
    return {"encs": encs, "f": f, "dense": dense, "sparse": sparse}


def fold_case(rng, B, M, N, J, b_real):
    """K4 operands: rows b >= b_real are batch padding (all SENTINEL,
    invalid, inactive); real rows are SENTINEL-tailed, with holes in the
    incoming mask, and folds that share some of their values."""
    r = np.full((B, M), SENT, np.int32)
    folds = np.full((J, B, N), SENT, np.int32)
    for b in range(b_real):
        rv = np.unique(rng.integers(0, 1 << 30, 3 * M // 4))
        r[b, : rv.size] = rv
        for j in range(J):
            fv = np.union1d(rng.choice(rv, rv.size // 2),
                            rng.integers(0, 1 << 30, N // 2))[: N - 1]
            folds[j, b, : fv.size] = fv
    act = rng.random((J, B)) < 0.75
    act[:, b_real:] = False
    act[0, 0] = True
    valid = (r != SENT) & (rng.random((B, M)) < 0.9)
    return r, valid, folds, act


def _tb(a: np.ndarray, device) -> torch.Tensor:
    return (torch.from_numpy(a).to(device) if a.dtype == np.bool_
            else _t(a, device))


def check_k4(dev) -> None:
    from repro_torch.kernels import megakernel, ops
    rng = np.random.default_rng(4)
    cases = [(3, 256, 1024, 3, 3), (4, 1000, 4099, 2, 3),
             (6, 4096, 1 << 16, 4, 4), (2, 1 << 14, 1 << 23, 2, 2),
             (2, 300, 1, 1, 1)]
    for B, M, N, J, b_real in cases:
        args = [_tb(a, dev) for a in fold_case(rng, B, M, N, J, b_real)]
        want = megakernel.decoded_fold_plain(*args)
        expect_equal(f"K4 B={B} M={M} N={N} J={J}",
                     ops.intersect_fold_batch(*args), want)
        expect_equal(f"K4 J=0 B={B} M={M}",
                     ops.intersect_fold_batch(args[0], args[1], args[2][:0],
                                              args[3][:0]), args[1])
        if N > 1 and not bool(want.any()):
            raise AssertionError(f"K4 B={B} M={M} N={N}: no matches")
    log(f"K4 equal to plain on {len(cases)} cases, N = 1 … 2**23 (N not a "
        f"power of two too), SENTINEL and padded rows, holes in the incoming "
        f"mask, inactive slots, and J = 0")


def packed_fold_operands(grid, r_rows, dev, *, M=None, k_pad=None,
                         t_pad=None, c_pad=None, e_pad=None, bp=None,
                         real=None, pad_only=()):
    """K5 operands, laid out as index/batch.py stacks them, for a (Jp, B)
    grid of optional encoded lists and each row's candidates; the pads may
    be raised past the payloads as a fused family key raises them.  With
    ``real`` each slot keeps its first ``real`` candidate blocks (so
    candidates above the last one stay in r); the (j, b) of ``pad_only``
    are active with pad ids alone.  Returns (r, valid, pk tuple, active) on
    ``dev``, valid with holes."""
    from repro_torch.core import bitpack, intersect as its
    from repro_torch.index import source
    Jp, B = len(grid), len(grid[0])
    encs = {(j, b): e for j, row in enumerate(grid)
            for b, e in enumerate(row) if e is not None}
    pads = [max(bitpack.self_pads(e)[i] for e in encs.values())
            for i in range(3)]
    k_pad, t_pad, e_pad = (k_pad or pads[0], t_pad or pads[1],
                           pads[2] if e_pad is None else e_pad)
    blks = {k: bitpack.candidate_block_ids(
                bitpack.layout_np(e, k_pad, t_pad, e_pad).maxes[
                    : e.num_blocks], r_rows[k[1]]) for k, e in encs.items()}
    c_pad = c_pad or its.pow2_bucket(max(len(v) for v in blks.values()),
                                     floor=source.CAND_FLOOR)
    Bp = bp or B
    M = M or its.pow2_bucket(max(len(r) for r in r_rows))
    cols = {"words": np.zeros((Jp, Bp, t_pad, 128), np.uint32),
            "widths": np.zeros((Jp, Bp, k_pad), np.int32),
            "offsets": np.zeros((Jp, Bp, k_pad), np.int32),
            "maxes": np.zeros((Jp, Bp, k_pad), np.uint32),
            "blk": np.full((Jp, Bp, c_pad), k_pad, np.int32),
            "exc_pos": np.full((Jp, Bp, e_pad), -1, np.int32),
            "exc_add": np.zeros((Jp, Bp, e_pad), np.uint32)}
    active = np.zeros((Jp, Bp), bool)
    for (j, b), e in encs.items():
        lay = bitpack.layout_np(e, k_pad, t_pad, e_pad)
        for k in ("words", "widths", "offsets", "maxes", "exc_pos", "exc_add"):
            cols[k][j, b] = getattr(lay, k)
        ids = blks[(j, b)][:0 if (j, b) in pad_only else real]
        cols["blk"][j, b] = source.pad_block_ids(ids, c_pad, k_pad)
        active[j, b] = True
    r = np.full((Bp, M), SENT, np.int32)
    for b, rv in enumerate(r_rows):
        r[b, : len(rv)] = rv
    valid = (r != SENT) & (r % 7 != 3)
    return (_tb(r, dev), _tb(valid, dev),
            tuple(_tb(v, dev) for v in cols.values()), _tb(active, dev))


def check_k5(dev, k3: dict) -> tuple:
    """K5 vs plain, one launch a call, one kernel and the seed
    copy in a captured call; returns one case's operands (r, valid, pk,
    active, mode, rows) for ``check_lean_refusals``."""
    from repro_torch.core import bitpack, fastpfor
    from repro_torch.kernels import megakernel, ops
    rng = np.random.default_rng(5)
    f, dense, sparse = k3["f"], k3["dense"], k3["sparse"]
    n_checks = 0

    def check(what, r, valid, pk, active, mode, rows, want_hits=True):
        nonlocal n_checks
        want = megakernel.packed_fold_plain(r, valid, *pk, active, mode=mode,
                                            block_rows=rows)
        before = ops.launches()["packed_fold_batched"]
        got = megakernel.packed_fold_batched(r, valid, *pk, active, mode=mode,
                                             block_rows=rows)
        expect_equal(f"K5 {what}", got, want)
        if ops.launches()["packed_fold_batched"] != before + 1:
            raise AssertionError(f"K5 {what}: not one launch a call")
        expect_equal(f"K5 {what} (ops)", ops.intersect_packed_fold(
            r, valid, pk, active, mode=mode, block_rows=rows), want)
        if want_hits and not bool(want.any()):
            raise AssertionError(f"K5 {what}: no matches")
        n_checks += 1
        return want

    # modes × codecs (bp: E = 0; fastpfor: exceptions), an inactive slot
    for (codec, mode), enc in k3["encs"].items():
        grid = [[enc, enc, enc], [enc, enc, None]]
        ops_ = packed_fold_operands(grid, [dense, sparse, dense[::2]], dev)
        check(f"{codec}-{mode}", *ops_, mode, enc.block_rows)
        if codec == "fastpfor" and not bool((ops_[2][5] >= 0).any()):
            raise AssertionError("K5 check has no FastPFOR exceptions")
    # C = 8, 256 and 2048 with pad ids: every slot cut to half its bucket
    # (candidates above the last candidate block), a slot of pad ids only
    # (its row comes out empty), mode none; C = 2048 over a list of 2300
    # 8-row blocks
    n2 = 2300 * 1024
    f2 = np.cumsum(rng.integers(1, 40, n2)).astype(np.int64)
    dense2 = np.union1d(rng.choice(f2, 40000), rng.integers(0, int(f2[-1]),
                                                            20000))
    for codec in ("bp", "fastpfor"):
        encode = fastpfor.encode if codec == "fastpfor" else bitpack.encode
        enc, enc8 = encode(f, mode="none"), encode(f2, mode="none",
                                                   block_rows=8)
        for c_pad, e, rs, rows in (
                (8, enc, [sparse, dense[::3], dense], 32),
                (256, enc, [dense, dense[1::2], dense[::5]], 32),
                (2048, enc8, [dense2, dense2[1::2], dense2[::3]], 8)):
            ops_ = packed_fold_operands([[e, e, e], [e, e, e]], rs, dev,
                                        c_pad=c_pad, real=c_pad // 2,
                                        pad_only={(1, 2)})
            r, valid, pk, _ = ops_
            last = pk[3][0, 0][pk[4][0, 0, c_pad // 2 - 1]]
            if not bool((r[0][valid[0]] > last).any()):
                raise AssertionError("K5 check: no candidate above the last "
                                     "candidate block")
            want = check(f"{codec}-none C={c_pad} rows={rows}, half the "
                         f"slots pads, a slot of pads only", *ops_, "none",
                         rows)
            if bool(want[2].any()):
                raise AssertionError("K5: a row whose active slot has no "
                                     "real block kept a candidate")
        if codec == "fastpfor":
            r, valid, pk, active = ops_
            nodes = graph_ops(lambda: ops.intersect_packed_fold(
                r, valid, pk, active, mode="none", block_rows=8))
            kernels = [t for k, t in nodes if k == "KERNEL"]
            if (sorted(k for k, _ in nodes) != ["KERNEL", "MEMCPY"]
                    or "packed_fold_kernel" not in kernels[0]):
                raise AssertionError(
                    f"K5 enqueued other operations than its seed copy and "
                    f"kernel in a captured call: "
                    f"{[(k, t[:300]) for k, t in nodes]}")
    # 8-row blocks; a single-block list; an empty (disjoint) row
    short = f[:200000]
    tiny = np.sort(rng.choice(1 << 12, 500, replace=False)).astype(np.int64)
    evens = 2 * np.sort(rng.choice(1 << 20, 3000, replace=False))
    for codec in ("bp", "fastpfor"):
        enc = (fastpfor.encode(short, mode="d1", block_rows=8)
               if codec == "fastpfor" else
               bitpack.encode(short, mode="d1", block_rows=8))
        one = bitpack.encode(tiny, mode="d1", block_rows=8)
        odd = bitpack.encode(evens.astype(np.int64), mode="d1", block_rows=8)
        if one.num_blocks != 1:
            raise AssertionError("K5 check lacks a single-block list")
        ops_ = packed_fold_operands(
            [[enc, one, odd]], [dense[dense < short[-1]], tiny[:64],
                                evens[:64] + 1], dev)
        want = check(f"{codec}-d1 rows=8, single-block and empty slots",
                     *ops_, "d1", 8)
        if bool(want[2].any()) or not bool(want[1].any()):
            raise AssertionError("K5 single-block / empty slots are wrong")
    # family-ceiling pads: k/t/c/e raised, Jp = 4, Bp = 4 > B = 1
    enc = k3["encs"][("fastpfor", "dm")]
    tight = check("fastpfor-dm tight", *packed_fold_operands(
        [[enc]], [dense], dev), "dm", 32)
    k_pad, t_pad, e_pad = bitpack.self_pads(enc)
    grid = [[enc, None, None, None]] + [[None] * 4 for _ in range(3)]
    ops_ = packed_fold_operands(grid, [dense], dev, k_pad=4 * k_pad,
                                t_pad=2 * t_pad, c_pad=1024,
                                e_pad=2 * max(e_pad, 4), bp=4)
    ceil = check("fastpfor-dm family-ceiling pads", *ops_, "dm", 32)
    if not torch.equal(ceil[0], tight[0]) or bool(ceil[1:].any()):
        raise AssertionError("K5 family-ceiling pads change the result")
    # Jp = 0
    r, valid, pk, active = ops_
    expect_equal("K5 Jp=0", ops.intersect_packed_fold(
        r, valid, tuple(a[:0] for a in pk), active[:0], mode="dm",
        block_rows=32), valid)
    log(f"K5 equal to plain on {n_checks} cases, one launch a call: modes none/d1/d2/d4/dm/dv x bp (E = 0) and fastpfor "
        f"(exceptions), 32- and 8-row blocks, C = 8, 256 and 2048 with half "
        f"the slots pads and candidates above the last candidate block, an "
        f"active slot of pad ids only, inactive, single-block and empty "
        f"slots, family-ceiling pads (Bp > B), and Jp = 0; a call captured "
        f"in a CUDA graph enqueues the seed copy and packed_fold_kernel "
        f"alone")
    return r, valid, pk, active, "dm", 32


def check_lean_refusals(dev, k5_args) -> None:
    """K4's, K5's, K6's and K8's wrappers raise on operands on two devices
    and on a dtype they do not take, launching nothing, and take the plain
    versions for CPU tensors without counting a launch (as phase 2's K1,
    K2, K3 and K7 checks do for theirs)."""
    from repro_torch.kernels import (bitpack_pack, flash_attention as fa,
                                     megakernel, ops)
    rng = np.random.default_rng(9)
    r, valid, folds, act = (_tb(a, dev) for a in fold_case(
        rng, 2, 256, 512, 2, 2))
    d = torch.zeros((2, 32, 128), dtype=torch.int32, device=dev)
    w = torch.tensor([3, 0], dtype=torch.int32, device=dev)
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev)
    k5_r, k5_valid, pk, k5_active, mode, rows = k5_args
    calls = {
        "K4": (megakernel.decoded_fold_batched, [r, valid, folds, act], {}),
        "K5": (megakernel.packed_fold_batched,
               [k5_r, k5_valid, *pk, k5_active],
               dict(mode=mode, block_rows=rows)),
        "K6": (bitpack_pack.pack_blocks_padded, [d, w], {}),
        "K8": (fa.flash_attention, [q, q, q], {}),
    }
    before = ops.launches()
    for what, (fn, args, kw) in calls.items():
        for i in range(len(args)):
            for bad in (args[i].cpu(), args[i].to(torch.int64)):
                try:
                    fn(*args[:i], bad, *args[i + 1:], **kw)
                except ValueError:
                    continue
                raise AssertionError(f"{what} took a bad operand {i}")
        fn(*(a.cpu() for a in args), **kw)
    if ops.launches() != before:
        raise AssertionError("a refused or CPU call counted a launch")
    log("K4, K5, K6 and K8 refuse operands on two devices or of another "
        "dtype and count no launch for them or for CPU tensors")


def svb_operands(rng, K: int, rows: int, DW: int, dev) -> list:
    """Random K7 operands: every 2-bit code (byte lengths 1–4), data offsets
    at 0, inside and at the last bytes of the stream (clamped reads), one
    negative and one that wraps int32, random seeds."""
    ctrl = rng.integers(0, 1 << 32, (K, 8 * rows), dtype=np.uint64)
    data = rng.integers(0, 1 << 32, DW, dtype=np.uint64)
    doffs = rng.integers(0, 4 * DW, K)
    doffs[::3] = 4 * DW - 1 - rng.integers(0, 8, doffs[::3].size)
    doffs[0] = 0
    if K > 2:
        doffs[1:3] = (-7, 2**31 - 40)
    seeds = rng.integers(0, 1 << 32, K, dtype=np.uint64)
    return [_t(ctrl.astype(np.uint32), dev), _t(data.astype(np.uint32), dev),
            _t(doffs.astype(np.int32), dev), _t(seeds.astype(np.uint32), dev)]


def check_k7(dev) -> None:
    """K7 vs plain, one launch a call, over modes × block_rows {1, 2, 8,
    32}: random operands (byte lengths 1–4, clamped last-word reads,
    negative and wrapping offsets) at K = 1, 3001 and (rows ≤ 8) 2**15, and
    encoded lists (gaps of 1–4 bytes) through their pow2-padded operands,
    pad blocks included."""
    from repro_torch.core import streamvbyte
    from repro_torch.kernels import ops, svb_decode
    rng = np.random.default_rng(7)
    n_checks = 0
    for rows in (1, 2, 8, 32):
        shapes = [(1, 1), (1, 33), (3001, 3001 * rows * 40 + 3)]
        if rows <= 8:
            shapes.append((1 << 15, (1 << 15) * rows * 50))
        cases = [svb_operands(rng, K, rows, DW, dev) for K, DW in shapes]
        n_random = len(cases)
        for mode in ("none", "d1", "d2", "d4", "dm", "dv"):
            for n in (1, 120, 5000 * rows + 77):
                gaps = (2.0 ** rng.uniform(0, 25 if n <= 120 else 18, n))
                sl = streamvbyte.encode(np.cumsum(gaps.astype(np.int64)),
                                        mode=mode, block_rows=rows).to(dev)
                cases.append(svb_decode.bucketed_operands(sl))
            for args in cases[-3:] + cases[:n_random]:
                want = svb_decode.decode_svb(*args, mode, rows)
                before = ops.launches()["unpack_svb_blocks"]
                expect_equal(f"K7 {mode} rows={rows} K={args[0].shape[0]}",
                             ops.unpack_svb_blocks(*args, mode, rows), want)
                if ops.launches()["unpack_svb_blocks"] != before + 1:
                    raise AssertionError("K7: not one launch a call")
                n_checks += 1
    log(f"K7 equal to plain on {n_checks} cases, one launch a call: modes "
        f"none/d1/d2/d4/dm/dv x block_rows 1/2/8/32, byte lengths 1-4, pow2 "
        f"pad blocks, clamped last-word reads, negative and wrapping "
        f"offsets, K = 1 ... 2**15")


def check_k6(dev) -> None:
    """K6 vs plain over widths 0–32 at K = 2**12, and ``ops.pack_blocks``
    per mode on sorted values, its words back through K1."""
    from repro_torch.core import deltas
    from repro_torch.kernels import bitpack_pack, ops
    rng = np.random.default_rng(6)
    K = 1 << 12
    widths = (np.arange(K) % 33).astype(np.int32)
    hi = (np.ones(K, np.uint64) << widths.astype(np.uint64))
    d = (rng.integers(0, 1 << 62, (K, 32, 128), dtype=np.uint64)
         % hi[:, None, None]).astype(np.uint32)
    d[:, 0, 0] = (hi - 1).astype(np.uint32)
    td, tw = _t(d, dev), _t(widths, dev)
    expect_equal("K6 widths 0-32, K=2**12",
                 bitpack_pack.pack_blocks_padded(td, tw),
                 bitpack_pack.pack_blocks_padded_plain(td, tw))
    gaps = (2.0 ** rng.uniform(0, 8, K * 4096)).astype(np.int64)
    gaps[rng.random(K * 4096) < 1e-4] = 1 << 20
    vals = np.cumsum(gaps)
    if vals[-1] >= 1 << 32:
        raise AssertionError("K6 check values overflow 32 bits")
    tv = _t(vals.astype(np.uint32), dev).reshape(K, 32, 128)
    seeds = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       tv[:-1, -1, -1]])
    for mode in ("none", "d1", "d2", "d4", "dm", "dv"):
        dl = deltas.encode_deltas(tv, seeds, mode)
        w = _t(np.array([int(m).bit_length() for m in
                         dl.amax(dim=(1, 2)).cpu().numpy()], np.int32), dev)
        got = ops.pack_blocks(tv, seeds, w, mode)
        expect_equal(f"K6 ops.pack_blocks {mode}", got,
                     bitpack_pack.pack_blocks_padded_plain(deltas.to_i32(dl),
                                                           w))
        expect_equal(f"K6 {mode} back through K1",
                     ops.unpack_blocks(got, w, seeds, mode), tv)
    log(f"K6 equal to plain: widths 0-32 at K=2**12, and ops.pack_blocks x "
        f"6 modes at K=2**12 (widths "
        f"{int(w.min())}-{int(w.max())} in dv), back through K1")


def max_float_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def expect_close(name: str, got: torch.Tensor, want: torch.Tensor,
                 tol: float) -> float:
    """max |got - want| over the elements, which must be at most ``tol``."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                             f"against {want.dtype} {tuple(want.shape)}")
    err = max_float_err(got, want)
    if not err <= tol:
        raise AssertionError(f"{name}: max abs difference {err} > {tol}")
    return err


def flash_inputs(seed: int, shape: tuple, dtype, dev) -> list:
    """q (B, Sq, H, D), k and v (B, Sk, Hkv, D), standard normal from a
    numpy seed."""
    B, Sq, Sk, H, Hkv, D = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(dtype).to(dev)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def flash_routed(what: str, want_route: str, q, k, v, **kw) -> torch.Tensor:
    """``ops.flash_attention`` on the card, which must take ``want_route``
    (by K8's route counter) and launch once."""
    from repro_torch.kernels import ops
    before, routes = ops.launches()["flash_attention"], ops.flash_routes()
    out = ops.flash_attention(q, k, v, **kw)
    routes[want_route] += 1
    if (ops.flash_routes() != routes
            or ops.launches()["flash_attention"] != before + 1):
        raise AssertionError(f"K8 {what}: routes {ops.flash_routes()} and "
                             f"launches {ops.launches()['flash_attention']}"
                             f", want one {want_route!r} call")
    return out


def expect_k8(name: str, got: torch.Tensor, want: torch.Tensor, v,
              rounded_p: bool) -> tuple[float, float]:
    """K8's bf16 output against ``want`` elementwise within
    ``flash_attention.bf16_allowance`` → (max |got - want|, the largest
    share of its allowance an element takes)."""
    from repro_torch.kernels import flash_attention as fa
    err = expect_close(name, got, want, 0.05)
    allow = fa.bf16_allowance(want, v, rounded_p=rounded_p)
    share = float(((got.float() - want.float()).abs() / allow).max())
    if not share <= 1.0:
        raise AssertionError(f"{name}: an element is {share} times its "
                             f"allowance (max abs difference {err})")
    return err, share


def check_k8(dev) -> None:
    """K8 against its plain version on the card at FLASH_CASES: float32
    within 1e-4 (sums in another order); bf16 within 0.05 (the reference's
    bf16 tolerance) and elementwise within ``bf16_allowance`` (the tc route
    rounds p to bf16, split and simt do not).  Each call must take the
    route FLASH_CASES states (float32: simt), and every route must run."""
    from repro_torch.kernels import flash_attention as fa
    worst = {"float32": 0.0, "tc": [0.0, 0.0], "split": [0.0, 0.0],
             "simt": [0.0, 0.0]}
    seen = {"tc": 0, "split": 0, "simt": 0}
    for i, case in enumerate(FLASH_CASES):
        causal, kv_len, bq, bk, bf16_route = case[6:]
        kw = dict(causal=causal, kv_len=kv_len, bq=bq, bk=bk)
        for dtype, route in ((torch.float32, "simt"),
                             (torch.bfloat16, bf16_route)):
            q, k, v = flash_inputs(80 + i, case[:6], dtype, dev)
            name = f"K8 {case[:10]} {dtype} ({route})"
            got = flash_routed(name, route, q, k, v, **kw)
            want = fa.flash_attention_plain(q, k, v, **kw)
            if dtype == torch.float32:
                worst["float32"] = max(worst["float32"],
                                       expect_close(name, got, want, 1e-4))
            else:
                err, share = expect_k8(name, got, want, v, route == "tc")
                worst[route] = [max(worst[route][0], err),
                                max(worst[route][1], share)]
            seen[route] += 1
    if not all(seen.values()):
        raise AssertionError(f"K8: a route never ran in phase 2: {seen}")
    log(f"K8 within tolerance of plain on {len(FLASH_CASES)} cases x float32 "
        f"and bf16 (GQA 1-4:1, causal and full, kv_len 0/1/ragged, Sq = 1, "
        f"D 16-256, ragged tiles, caches of 8192), each on its stated "
        f"route: float32 max abs error {worst['float32']} (tolerance 1e-4); "
        f"bf16 max abs error and largest share of the elementwise allowance "
        f"by route {worst}; calls by route {seen}")
    log(k8_resources())


def kernel_resources(stem: str, names: dict) -> list:
    """(kind, kernel, REG, STACK, LOCAL) of each kernel of library ``stem``
    whose mangled name contains a key of ``names`` (kind = its value), as
    ``cuobjdump --dump-resource-usage`` reads them from the built library,
    demangled where ``cu++filt`` is there; fatal where one uses a stack
    frame or local memory (spilled registers)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    dump = subprocess.run(
        [str(tool), "--dump-resource-usage", str(_build.lib_path(stem))],
        capture_output=True, text=True, check=True).stdout
    rows, fn = [], None
    for line in dump.splitlines():
        m = re.search(r"Function (\S+?):(\s|$)", line)
        if m:
            fn = m.group(1)
        regs = re.search(r"REG:(\d+) STACK:(\d+) .*LOCAL:(\d+)", line)
        if regs and fn:
            kind = next((v for k, v in names.items() if k in fn), None)
            if kind:
                rows.append((kind, fn, *map(int, regs.groups())))
            fn = None
    if {r[0] for r in rows} != set(names.values()):
        raise AssertionError(f"{stem}: kernels {sorted(names.values())} not "
                             f"all in the resource dump:\n{dump[:2000]}")
    filt = Path(_build._nvcc()).parent / "cu++filt"
    if filt.exists():               # demangled, without the parameter list
        plain = subprocess.run([str(filt)], input="\n".join(r[1] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        if len(plain) == len(rows):
            rows = [(r[0], n[:n.rfind("(")] if n.endswith(")") else n,
                     *r[2:]) for r, n in zip(rows, plain)]
    for kind, fn, reg, stack, local in rows:
        if stack or local:
            raise AssertionError(f"{stem} {kind} kernel {fn} spills: STACK "
                                 f"{stack}, LOCAL {local}")
    return rows


def resources_line(what: str, rows: list) -> str:
    return f"{what} kernels' resources (cuobjdump): " + "; ".join(
        f"{kind} {fn}: REG {reg} STACK {stack} LOCAL {local}"
        for kind, fn, reg, stack, local in rows)


def k8_resources() -> str:
    """K8's tc and split kernels' registers (``kernel_resources``)."""
    return resources_line("K8", kernel_resources("flash_attention", {
        "flash_tc_kernel": "tc", "partial_kernel": "split partials",
        "combine_kernel": "split combine"}))


def index_resources() -> str:
    """K1's, K2's, K3's, K5's and K7's kernels' registers
    (``kernel_resources``)."""
    return resources_line("K1/K2/K3/K5/K7", [
        *kernel_resources("unpack_blocks", {"unpack_blocks_kernel": "K1"}),
        *kernel_resources("gallop_tiles", {"gallop_kernel": "K2"}),
        *kernel_resources("packed_gallop", {"packed_gallop_kernel": "K3"}),
        *kernel_resources("packed_fold", {"packed_fold_kernel": "K5"}),
        *kernel_resources("svb_decode", {"svb_decode_kernel": "K7"})])


# --------------------------------------------------------------------------
# phase 3: the main path at full size
# --------------------------------------------------------------------------

class Recorder:
    """Wraps a kernel wrapper and keeps the inputs of its largest call on the
    main path, so phase 4 times the kernel at a main-path shape.  With
    ``bucket`` it also counts the calls by ``bucket(*args)`` (a size to the
    next power of two, named ``by``) and keeps the largest call of each
    bucket."""

    def __init__(self, module, name, size, bucket=None, by="K"):
        self.module, self.name, self.size = module, name, size
        self.inner = getattr(module, name)
        self.best, self.best_size = None, -1
        self.bucket, self.counts, self.by_bucket = bucket, {}, {}
        self.by = by
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        s = self.size(*args, **kwargs)
        if s > self.best_size:
            self.best, self.best_size = (args, kwargs), s
        if self.bucket is not None:
            b = self.bucket(*args, **kwargs)
            self.counts[b] = self.counts.get(b, 0) + 1
            if s >= self.by_bucket.get(b, (None, -1))[1]:
                self.by_bucket[b] = ((args, kwargs), s)
        return self.inner(*args, **kwargs)

    def most_frequent(self) -> tuple:
        """(bucket, its largest call's (args, kwargs)) of the bucket with the
        most calls."""
        b = max(self.counts, key=lambda k: (self.counts[k], -k))
        return b, self.by_bucket[b][0]

    def restore(self):
        setattr(self.module, self.name, self.inner)


def _check_answers(what, results, truth, corpus) -> None:
    for q, res, want in zip(corpus.queries, results, truth):
        if res.count != len(want) or not np.array_equal(
                np.sort(res.docs), want[: len(res.docs)]):
            raise AssertionError(f"{what}: query {q} gave {res.count}, "
                                 f"brute force {len(want)}")


def serve_regime(idx, what, corpus, truth, regime, plan) -> tuple:
    """Phase 3 then 3b on one index in one regime: the sequential serve and
    the batched one, each with the launch counts set to 0 just before it
    and read just after.  Returns (sequential counts, batched counts,
    seconds of each)."""
    from repro_torch.index import engine
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    n = len(corpus.queries)
    n_batches = (n + BATCH - 1) // BATCH
    skip = regime != "noskip"
    t0 = time.perf_counter()
    cache = engine.DecodeCache() if regime == "cache" else None
    ops.reset_launches()
    rep = serve.serve_queries(idx, corpus.queries, cache=cache, skip=skip)
    torch.cuda.synchronize()
    counts = ops.launches()
    _check_answers(what, rep["results"], truth, corpus)
    dt = rep["seconds"]
    passes = 3 if cache is not None else 2
    note = (f", cache hit rate {cache.hit_rate:.3f}"
            if cache is not None else "")
    log(f"{what}: {n} queries all equal to brute force; "
        f"{n / dt:.2f} q/s, {dt / n * 1e3:.3f} ms/query, "
        f"{rep['stats'].get('decoded_ints', 0) / n:.0f} decoded "
        f"ints/query, {rep['stats'].get('skip_folds', 0)} skip folds, "
        f"{rep['hits']} hits{note}; launches over {passes} passes "
        + ", ".join(f"{k} {v} ({v / (n * passes):.3f}/query)"
                    for k, v in counts.items() if v))
    t_seq = time.perf_counter() - t0
    t0 = time.perf_counter()
    bcache = engine.DecodeCache() if regime == "cache" else None
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    brep = serve.serve_batched(idx, corpus.queries, batch=BATCH, fuse=True,
                               warmup=True, cache=bcache, skip=skip,
                               plan=plan)
    torch.cuda.synchronize()
    bcounts = ops.launches()
    _check_answers(f"{what}/batched", brep["results"], truth, corpus)
    for q, a, b in zip(corpus.queries, brep["results"], rep["results"]):
        if a.count != b.count or not np.array_equal(a.docs, b.docs):
            raise AssertionError(f"{what}: batched answer to {q} differs "
                                 f"from the sequential one")
    bst, wu, bdt = brep["stats"], brep["warmup"], brep["seconds"]
    bpasses = wu["passes"] + 1
    note = (f", cache hit rate {bcache.hit_rate:.3f}"
            if bcache is not None else "")
    log(f"{what}/batched: {n} queries all equal to brute force and to the "
        f"sequential answers; batch {BATCH} fused, {n / bdt:.2f} q/s, "
        f"{bdt / n * 1e3:.3f} ms/query, "
        f"{bst.get('n_dispatches', 0) / n_batches:.2f} dispatches/batch, "
        f"{len(bst.get('signatures', ()))} programs, "
        f"{bst.get('n_compiles', 0)} compiles in the timed pass (warmup: "
        f"{wu['n_compiles']} over {wu['n_signatures']} signatures in "
        f"{wu['passes']} passes, {wu['time_s']:.2f} s, converged "
        f"{wu['converged']}), {bst.get('decoded_ints', 0) / n:.0f} decoded "
        f"ints/query, {bst.get('skip_folds', 0)} skip folds, "
        f"{brep['hits']} hits{note}; peak device memory "
        f"{torch.cuda.max_memory_allocated()} bytes; launches over "
        f"{bpasses} passes " + ", ".join(
            f"{k} {v} ({v / (n * bpasses):.3f}/query)"
            for k, v in bcounts.items() if v))
    return (counts, bcounts, t_seq, time.perf_counter() - t0,
            rep["results"], n / bdt)


def _check_same(what, results, seq, truth, corpus) -> None:
    """Answers equal to brute force and to the sequential engine's."""
    _check_answers(what, results, truth, corpus)
    for q, a, b in zip(corpus.queries, results, seq):
        if a.count != b.count or not np.array_equal(a.docs, b.docs):
            raise AssertionError(f"{what}: answer to {q} differs from the "
                                 f"sequential one")


def resident_paths(dev, idx, what, corpus, truth, seq, batched_qps) -> dict:
    """Phase 3c on one build: a ResidentPool warmed on the card, then
    ``execute_pipelined`` at each of ``DEPTHS``, the sequential engine and
    the batched engine at 32 (fused, after ``batch.warmup``) with that
    pool, and ``execute_sharded`` over ``SHARDS`` shards (one per part) at
    depth 2, each with the launch counts set to 0 just before it and read
    just after (warm passes included), every answer against brute force
    and the sequential answers ``seq``; then depths 1 and 2 in turns
    (``in_turns``) and one depth-2 pass under torch.profiler.
    ``batched_qps`` is phase 3b's default batched pass of this build.
    Returns the launch counts by path."""
    from repro_torch.core import bitpack, codecs as codec_lib
    from repro_torch.index import pipeline as pipe_lib
    from repro_torch.index import shard as shard_lib, source
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    n = len(corpus.queries)
    fams = {codec_lib.family_of(tp.payload) for p in idx.parts
            for tp in p.terms.values() if tp.kind == "list"
            and not (bitpack.skip_capable(tp.payload) and tp.skip_ok
                     and tp.payload.widths.shape[0]
                     >= source.SKIP_MIN_BLOCKS)}
    counts = {}
    t0 = time.perf_counter()
    ops.reset_launches()
    pool = source.ResidentPool(capacity_ints=RESIDENT_CAPACITY, device=dev)
    ps = pool.warm(idx)
    torch.cuda.synchronize()
    counts["warm"] = ops.launches()
    log(f"{what}/resident: warm staged {ps['staged_lists']} lists "
        f"({ps['staged_ints']} ints) in {time.perf_counter() - t0:.2f} s; "
        f"lists it decodes: {sorted(fams) or 'none'}; launches "
        + ", ".join(f"{k} {v}" for k, v in counts["warm"].items() if v))
    for kernel, need in (("unpack_blocks", {"bp", "bp8", "fastpfor"}),
                         ("unpack_svb_blocks", {"streamvbyte"})):
        if fams & need and counts["warm"][kernel] == 0:
            raise AssertionError(f"{what}: {kernel} never ran during warm, "
                                 f"which decodes {sorted(fams & need)} lists")

    def path(name, run):
        ops.reset_launches()
        rep = run()
        torch.cuda.synchronize()
        counts[name] = ops.launches()
        _check_same(f"{what}/{name}", rep["results"], seq, truth, corpus)
        return rep

    # the pipelined passes first, on the pool as warm leaves it: a list
    # that any pass decodes (a seed, or a fold under the skip ratio) stays
    # resident and is served decoded from then on, so K5 is left only the
    # long lists that no pass decodes
    reps = {}
    for d in DEPTHS:
        reps[f"depth {d}"] = path(f"depth {d}", lambda d=d: (
            serve.serve_batched(idx, corpus.queries, batch=BATCH, pool=pool,
                                depth=d)))
    reps["sequential"] = path("sequential", lambda: serve.serve_queries(
        idx, corpus.queries, pool=pool))
    reps["batched"] = path("batched", lambda: serve.serve_batched(
        idx, corpus.queries, batch=BATCH, warmup=True, pool=pool))
    t1 = time.perf_counter()
    sharded = shard_lib.shard_index(idx, SHARDS,
                                    capacity_ints=RESIDENT_CAPACITY)
    st = sharded.stats()
    log(f"{what}/sharded: {SHARDS} shards on {st['n_devices']} device(s), "
        f"warmed in {time.perf_counter() - t1:.2f} s; placement " + "; ".join(
            f"shard {sh['shard']} -> {sh['device']}: parts {sh['parts']}, "
            f"{sh['resident_lists']} lists, {sh['device_ints']} device ints"
            for sh in st["shards"]))
    reps["sharded"] = path("sharded", lambda: serve.serve_sharded(
        sharded, corpus.queries, batch=BATCH, depth=2))
    for name, rep in reps.items():
        line = (f"{what}/resident {name}: {n} queries all equal to brute "
                f"force and to the sequential answers; "
                f"{n / rep['seconds']:.2f} q/s (phase 3b batched "
                f"{batched_qps:.2f}), "
                f"{rep['stats'].get('resident_hits', 0)} resident hits, "
                f"{rep['stats'].get('decoded_ints', 0) / n:.0f} decoded "
                f"ints/query, {rep['stats'].get('n_dispatches', 0)} "
                f"dispatches, {rep['stats'].get('n_compiles', 0)} compiles "
                f"in the timed pass")
        if rep.get("timings") is not None:
            line += f"; stages {rep['timings'].as_dict()}"
        log(line + "; launches " + ", ".join(
            f"{k} {v}" for k, v in counts[name].items() if v))
    ps = pool.stats()
    log(f"{what}/resident pool: {ps['resident_lists']} lists, "
        f"{ps['device_ints']} device ints of {RESIDENT_CAPACITY} "
        f"({ps['arena_ints']} in {ps['arenas']} arenas), "
        f"{ps['evicted_lists']} evicted, {ps['hits']} hits, {ps['misses']} "
        f"misses")
    in_turns(idx, what, pool, corpus, truth, seq)
    profile_report(f"{what}/resident depth 2", lambda: pipe_lib.execute_pipelined(
        idx, corpus.queries, batch_size=BATCH, depth=2, pool=pool),
        f"{n} queries")
    del sharded, pool
    return counts


def in_turns(idx, what, pool, corpus, truth, seq) -> None:
    """Depths 1 and 2 on the warm pool in turns (1, 2, 2, 1, twice): q/s of
    each pass, its stages, and its ``block`` split into the wait for the
    card (the result copies' events) and the host's aggregation after it.
    Fatal if a pass rebuilds an arena where the pool evicted nothing."""
    from repro_torch.index import batch as batch_lib
    from repro_torch.index import pipeline as pipe_lib
    n = len(corpus.queries)
    collect, waits = batch_lib.collect_batch, []

    def collect_timed(pending):
        t = time.perf_counter()
        for _, _, copies in pending.launched:
            for _, event in copies:
                if event is not None:
                    event.synchronize()
        waits.append(time.perf_counter() - t)
        return collect(pending)

    builds, turns = pool.arena_builds(), {1: [], 2: []}
    batch_lib.collect_batch = collect_timed
    try:
        for d in (1, 2, 2, 1, 1, 2, 2, 1):
            tm = pipe_lib.StageTimings()
            waits.clear()
            t0 = time.perf_counter()
            out = pipe_lib.execute_pipelined(idx, corpus.queries,
                                             batch_size=BATCH, depth=d,
                                             pool=pool, timings=tm)
            dt = time.perf_counter() - t0
            _check_same(f"{what}/depth {d} in turns", out, seq, truth, corpus)
            turns[d].append((n / dt, tm, sum(waits)))
    finally:
        batch_lib.collect_batch = collect
    for d, runs in turns.items():
        log(f"{what}/resident depth {d} in turns: q/s "
            + ", ".join(f"{q:.2f}" for q, _, _ in runs) + "; ms stage / "
            "assemble / dispatch / block (wait for the card + host "
            "aggregation) " + "; ".join(
                f"{tm.stage * 1e3:.2f} / {tm.assemble * 1e3:.2f} / "
                f"{tm.dispatch * 1e3:.2f} / {tm.block * 1e3:.2f} "
                f"({w * 1e3:.2f} + {(tm.block - w) * 1e3:.2f})"
                for _, tm, w in runs))
    if pool.stats()["evicted_lists"] == 0 and pool.arena_builds() != builds:
        raise AssertionError(f"{what}: a warm pipelined pass rebuilt an "
                             f"arena")


def _served_equal(what, results, queries, want, truth) -> int:
    """Every answered request (None where shed or failed) equal to the
    offline answer ``want[i]`` of ``queries[i]`` and, where ``truth`` is
    given, to brute force.  Returns the number answered."""
    n = 0
    for i, (q, r) in enumerate(zip(queries, results)):
        if r is None:
            continue
        w = want[i]
        if r.count != w.count or not np.array_equal(r.docs, w.docs):
            raise AssertionError(f"{what}: request {i} ({q}) differs from "
                                 f"the offline answer")
        if truth is not None and (r.count != len(truth[i]) or not
                                  np.array_equal(r.docs, truth[i][:r.count])):
            raise AssertionError(f"{what}: request {i} ({q}) differs from "
                                 f"brute force")
        n += 1
    return n


def _live_run(what, srv, queries, qps, seed, want, truth) -> dict:
    """One run of ``srv`` over ``queries`` (open loop at ``qps``, or drain
    at 0), with fresh metrics and counters and the launch counts set to 0
    just before it; every answered request checked.  Fatal if a request is
    left unresolved, a flush failed (``n_errors``), a done request has no
    answer, a kernel library is built, or the seams saw another number of
    faults than ``srv.injector`` fired in this run (0 without one).  A
    failure that is not injected is not caught: it ends the run.  Returns
    the summary with its launch counts and outcomes."""
    import asyncio
    from repro_torch.kernels import _build, ops
    from repro_torch.launch import server as server_lib
    srv.metrics = server_lib.ServerMetrics()
    srv.stats = {}
    srv.drain = qps <= 0
    gaps = server_lib.arrival_gaps(len(queries), qps, "poisson", seed=seed)
    builds = _build.BUILDS
    # this thread's launches alone: the schedule/launch seam runs here (a
    # merge thread may launch at the same time; the collector launches
    # nothing)
    fired = len(srv.injector.fired) if srv.injector is not None else 0
    ops.reset_launches()
    tally = ops.thread_tally()
    results = asyncio.run(srv.run(queries, gaps))
    torch.cuda.synchronize()
    counts = dict(tally)
    outs = srv.outcomes()
    if len(outs) != len(queries) or "pending" in outs:
        raise AssertionError(f"{what}: a request was left unresolved")
    if _build.BUILDS != builds:
        raise AssertionError(f"{what}: nvcc ran while serving")
    n = _served_equal(what, results, queries, want, truth)
    s = srv.metrics.summary()
    if s["n_errors"] or n != s["n_done"]:
        raise AssertionError(f"{what}: {s['n_errors']} requests errored, "
                             f"{n} answered of {s['n_done']} done")
    if srv.injector is not None:
        fired = len(srv.injector.fired) - fired
    if s["n_faults"] != fired:
        raise AssertionError(f"{what}: {s['n_faults']} faults seen, "
                             f"{fired} injected")
    # how late the event loop let each arrival in: a flush's schedule and
    # launch hold the loop, and latency is timed from the due time
    lag = np.asarray(srv.arrival_lag_s or [0.0]) * 1e3
    s.update(launches=counts, answered=n, offered_qps=qps,
             lag_p50_ms=float(np.percentile(lag, 50)),
             lag_p99_ms=float(np.percentile(lag, 99)),
             lag_max_ms=float(lag.max()),
             outcomes={o: outs.count(o) for o in set(outs)},
             dispatches=srv.stats.get("n_dispatches", 0),
             compiles=srv.stats.get("n_compiles", 0),
             _latency_s=list(srv.metrics.latency_s))
    log(f"{what}: {len(queries)} requests, "
        + (f"{qps:.2f} q/s offered (Poisson), arrival lag p50 "
           f"{s['lag_p50_ms']:.3f} / p99 {s['lag_p99_ms']:.3f} / max "
           f"{s['lag_max_ms']:.3f} ms" if qps > 0 else "drain")
        + f": {s['n_done']} done / {s['n_shed']} shed / {s['n_timeout']} "
        f"timeout / {s['n_errors']} error, {n} answers equal to the offline "
        f"ones" + (" and to brute force" if truth is not None else "")
        + f"; {s['qps']:.2f} q/s served, latency p50 {s['p50_ms']:.3f} ms / "
        f"p99 {s['p99_ms']:.3f} ms / p99.9 {s['p999_ms']:.3f} ms, queue wait "
        f"p99 {s['wait_p99_ms']:.3f} ms; flushes {s['n_flushes']} (full "
        f"{s['flush_full']}, deadline {s['flush_deadline']}, drain "
        f"{s['flush_drain']}; aligned {s['aligned_flushes']}, unaligned "
        f"{s['unaligned_flushes']}), {s['dispatches']} dispatches, "
        f"{s['compiles']} new program signatures, 0 nvcc builds; faults "
        f"{s['n_faults']}, retries {s['n_retries']}, degraded flushes "
        f"{s['degraded_flushes']}; launches "
        + ", ".join(f"{k} {v}" for k, v in counts.items() if v))
    return s


def live_paths(dev, idx, corpus, truth) -> dict:
    """Phase 3d on the fastpfor-d1 B16 build: the continuous-batching
    server on a warmed ResidentPool (``warm_server`` twice, drain mode for
    its rate R, Poisson at 0.5·R and 2·R, chaos at 0.5·R); then a
    MutableIndex at the corpus's size through MUTATE_ADDS adds, a seal and
    tombstones, served at 0.5·R while ``merge_async`` runs (K1 launches on
    the merge thread counted apart), checked against a rebuild; then the
    durable stream on the first DURABLE_DOCS documents with a WAL crash and
    recovery.  Every answer is checked.  Returns the launch counts by
    part."""
    from repro_torch.index import (batch as batch_lib, builder, durability,
                                   engine, segments, source)
    from repro_torch.kernels import ops
    from repro_torch.launch import faults, server as server_lib
    queries = corpus.queries
    n = len(queries)
    cyc = lambda k: [queries[i % n] for i in range(k)]          # noqa: E731
    cyc_truth = lambda k: [truth[i % n] for i in range(k)]      # noqa: E731
    counts, t_all = {}, time.perf_counter()

    pool = source.ResidentPool(capacity_ints=RESIDENT_CAPACITY, device=dev)
    pool.warm(idx)
    srv = server_lib.ContinuousBatchingServer(idx, pool=pool, **LIVE)
    wu = server_lib.warm_server(srv, queries)
    wu2 = server_lib.warm_server(srv, queries)
    log(f"phase 3d warm_server: {wu['n_signatures']} signatures, "
        f"{wu['n_compiles']} compiles in {wu['passes']} passes, "
        f"{wu['time_s']:.2f} s, converged {wu['converged']}; a second warm: "
        f"{wu2['n_compiles']} compiles")
    if not wu["converged"] or wu2["n_compiles"] != 0:
        raise AssertionError("phase 3d: warm_server did not reach a fixed "
                             "point")
    offline = batch_lib.execute_batch(idx, queries, pool=pool, plan=srv.plan)
    _check_answers("phase 3d offline", offline, truth, corpus)
    rec = {"warm": wu, "warm_again": wu2}
    rec["drain"] = _live_run("phase 3d drain", srv, cyc(LIVE_REQUESTS), 0.0,
                             0, [offline[i % n] for i in range(LIVE_REQUESTS)],
                             cyc_truth(LIVE_REQUESTS))
    R = rec["drain"]["qps"]
    want = [offline[i % n] for i in range(OPEN_REQUESTS)]
    for name, rate in (("half", 0.5 * R), ("double", 2.0 * R)):
        rec[name] = _live_run(f"phase 3d Poisson {rate / R:g}·R", srv,
                              cyc(OPEN_REQUESTS), rate, 1, want,
                              cyc_truth(OPEN_REQUESTS))
    injector = faults.FaultInjector(CHAOS, seed=0)
    csrv = server_lib.ContinuousBatchingServer(idx, pool=pool, plan=srv.plan,
                                               injector=injector, **LIVE)
    rec["chaos"] = _live_run(f"phase 3d chaos {CHAOS} at 0.5·R", csrv,
                             cyc(OPEN_REQUESTS), 0.5 * R, 2, want,
                             cyc_truth(OPEN_REQUESTS))
    lad = csrv.ladder
    rec["chaos"].update(fired=injector.counts(),
                        degradations=lad.n_degradations,
                        promotions=lad.n_promotions)
    log(f"phase 3d chaos: fired {injector.counts()}, ladder "
        f"{lad.n_degradations} degradations / {lad.n_promotions} "
        f"promotions, final rung {'fused' if lad.current else 'unfused'}")
    for k in ("drain", "half", "double", "chaos"):
        counts[f"live {k}"] = rec[k]["launches"]
    del srv, csrv, pool

    # the mutable index at the corpus's size, served during a merge
    t0 = time.perf_counter()
    ops.reset_launches()
    mi = segments.MutableIndex.from_postings(
        corpus.postings, corpus.n_docs, codec_name="fastpfor-d1", B=16,
        n_parts=2, capacity_ints=RESIDENT_CAPACITY, device=dev)
    boot_s = time.perf_counter() - t0
    rng = np.random.default_rng(7)
    terms = sorted({t for q in queries for t in q})
    stream = [sorted(rng.choice(terms, size=int(rng.integers(1, 4)),
                                replace=False).tolist())
              for _ in range(MUTATE_ADDS)]
    t0 = time.perf_counter()
    for i, doc in enumerate(stream):
        mi.add(doc)
        if i == MUTATE_ADDS // 2:
            mi.seal()
    victims = rng.choice(mi.next_doc_id, size=MUTATE_ADDS // 10,
                         replace=False)
    for d in victims:
        mi.delete(int(d))
    torch.cuda.synchronize()
    counts["mutable build"] = ops.launches()
    mut_s = time.perf_counter() - t0
    msrv = server_lib.ContinuousBatchingServer(mutable=mi, **LIVE)
    mwu = server_lib.warm_server(msrv, queries)
    moff = mi.execute_batch(queries)
    log(f"phase 3d mutable: bootstrapped {corpus.n_docs} docs in "
        f"{boot_s:.2f} s; +{MUTATE_ADDS} adds (a seal half way) and "
        f"-{len(victims)} tombstones in {mut_s:.2f} s; counters "
        f"{mi.counters()}; warm_server {mwu['n_signatures']} signatures in "
        f"{mwu['time_s']:.2f} s")
    tally = {}

    def hook(stage):
        if stage == "snapshot":
            tally.update(t0=time.perf_counter(), launches=ops.thread_tally())
        tally[stage] = time.perf_counter()

    t0 = time.perf_counter()
    thread = mi.merge_async(warm_queries=queries, hook=hook)
    during = []
    while thread.is_alive() or not during:
        during.append(_live_run(
            f"phase 3d mutable, during merge (pass {len(during)})", msrv,
            cyc(LIVE_REQUESTS), 0.5 * R, 10 + len(during),
            [moff[i % n] for i in range(LIVE_REQUESTS)], None))
        if len(during) >= 64:
            break
    thread.join()
    join_s = time.perf_counter() - t0
    lat = np.asarray([x for d in during for x in d["_latency_s"]])
    log(f"phase 3d mutable, during the merge: {len(during)} passes, "
        f"{lat.size} requests, latency p50 {np.percentile(lat, 50) * 1e3:.3f}"
        f" ms / p99 {np.percentile(lat, 99) * 1e3:.3f} ms over all of them; "
        f"served q/s by pass "
        + ", ".join(f"{d['qps']:.2f}" for d in during))
    c = mi.counters()
    stages = {s: round(tally[s] - tally["t0"], 3) for s in
              ("snapshot", "decode", "build", "stage", "warm", "swap")
              if s in tally}
    merge_s = tally.get("swap", t0) - t0
    log(f"phase 3d merge: {merge_s:.2f} s from merge_async to the swap "
        f"(stages at {stages} s after the snapshot; joined after "
        f"{join_s:.2f} s, at the end of a serving pass), counters {c}; "
        f"launches on the merge thread {tally.get('launches')}; "
        f"{len(during)} serving passes during it")
    if (c["n_merges"] != 1 or c["merge_failures"]
            or c["last_merge_error"] is not None):
        raise AssertionError(f"phase 3d: the merge failed: {c}")
    if tally["launches"].get("unpack_blocks", 0) == 0:
        raise AssertionError("phase 3d: K1 never ran on the merge thread")
    after = _live_run("phase 3d mutable, after the merge", msrv,
                      cyc(LIVE_REQUESTS), 0.5 * R, 99,
                      [moff[i % n] for i in range(LIVE_REQUESTS)], None)
    t0 = time.perf_counter()
    live = mi.live_postings()
    ridx = builder.build(live, mi.next_doc_id, codec_name="fastpfor-d1",
                         B=16, n_parts=2, device=dev)
    rebuilt = [engine.query(ridx, q) for q in queries]
    brute = [engine.brute_force(live, q) for q in queries]
    final = mi.execute_batch(queries)
    _served_equal("phase 3d mutable vs the rebuild", final, queries, rebuilt,
                  brute)
    _served_equal("phase 3d mutable vs offline before the merge", final,
                  queries, moff, None)
    log(f"phase 3d mutable: {n} queries equal to builder.build("
        f"live_postings()) + engine.query and to brute force "
        f"({time.perf_counter() - t0:.2f} s)")
    counts["merge thread"] = tally["launches"]
    for i, d in enumerate(during):
        counts[f"during merge {i}"] = d["launches"]
    counts["after merge"] = after["launches"]
    rec.update(mutable={"boot_s": boot_s, "mutate_s": mut_s,
                        "merge_s": merge_s, "stages": stages,
                        "during_p50_ms": float(np.percentile(lat, 50)) * 1e3,
                        "during_p99_ms": float(np.percentile(lat, 99)) * 1e3,
                        "merge_launches": tally["launches"],
                        "during": during, "after": after, "counters": c})
    del msrv, mi, ridx, live

    # the durable stream, on the corpus's first DURABLE_DOCS documents
    sub = [p[p < DURABLE_DOCS] for p in corpus.postings]
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="wal-", dir=ROOT / "build")
    try:
        injector = faults.FaultInjector(f"crash@wal.append.add:{CRASH_AT}")
        kw = dict(codec_name="fastpfor-d1", B=16, n_parts=2,
                  capacity_ints=RESIDENT_CAPACITY, device=dev)
        t0 = time.perf_counter()
        ops.reset_launches()
        dmi = segments.MutableIndex.from_postings(
            sub, DURABLE_DOCS, wal=durability.DurableLog(tmp,
                                                         injector=injector),
            **kw)
        boot_s = time.perf_counter() - t0
        twin = segments.MutableIndex.from_postings(sub, DURABLE_DOCS, **kw)
        crashed_at = None
        try:
            for i, doc in enumerate(stream):
                dmi.add(doc)
                twin.add(doc)
                if i == MUTATE_ADDS // 2:
                    dmi.seal()
                    twin.seal()
        except faults.InjectedCrash:
            crashed_at = i
        if crashed_at is None:
            raise AssertionError("phase 3d: the WAL crash never fired")
        injector.disarm_all()
        t0 = time.perf_counter()
        rmi = segments.MutableIndex.recover(tmp, injector=injector,
                                            device=dev)
        rec_s = time.perf_counter() - t0
        replayed = rmi._wal_replayed
        _served_equal("phase 3d recovered vs the index that never crashed",
                      rmi.execute_batch(queries), queries,
                      twin.execute_batch(queries), None)
        for d in np.random.default_rng(8).choice(
                rmi.next_doc_id, size=MUTATE_ADDS // 10, replace=False):
            rmi.delete(int(d))
            twin.delete(int(d))
        rmi.seal()
        t0 = time.perf_counter()
        rmi.merge()
        dmerge_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = segments.MutableIndex.recover(tmp, device=dev)
        rec2_s = time.perf_counter() - t0
        live = rmi.live_postings()
        ridx = builder.build(live, rmi.next_doc_id, codec_name="fastpfor-d1",
                             B=16, n_parts=2, device=dev)
        got = rmi.execute_batch(queries)
        _served_equal("phase 3d durable vs the rebuild", got, queries,
                      [engine.query(ridx, q) for q in queries],
                      [engine.brute_force(live, q) for q in queries])
        _served_equal("phase 3d durable vs the index that never crashed",
                      got, queries, twin.execute_batch(queries), None)
        _served_equal("phase 3d second recovery vs the live index",
                      again.execute_batch(queries), queries, got, None)
        torch.cuda.synchronize()
        counts["durable"] = ops.launches()
        disk = sum(f.stat().st_size for f in Path(tmp).rglob("*")
                   if f.is_file())
        log(f"phase 3d durable ({DURABLE_DOCS} docs): bootstrapped with "
            f"its WAL in {boot_s:.2f} s; crash@wal.append.add:{CRASH_AT} "
            f"cut the stream at add {crashed_at}; recovered in {rec_s:.2f} s "
            f"({replayed} WAL records replayed), equal to the index that "
            f"never crashed; then {MUTATE_ADDS // 10} tombstones, a seal and "
            f"a merge ({dmerge_s:.2f} s), a second recovery in {rec2_s:.2f} "
            f"s, every answer equal to the rebuild, to brute force and to "
            f"the live index; {disk} bytes on disk")
        rec["durable"] = {"docs": DURABLE_DOCS, "boot_s": boot_s,
                          "crashed_at": crashed_at, "recovery_s": rec_s,
                          "replayed": replayed, "merge_s": dmerge_s,
                          "recovery2_s": rec2_s, "bytes_on_disk": disk}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 3d done in {time.perf_counter() - t_all:.1f} s: "
        + json.dumps({k: {f: x for f, x in v.items() if f[0] != "_"}
                      for k, v in rec.items()
                      if k in ("drain", "half", "double", "chaos")},
                     default=str))
    return counts


def run_main_path(dev, corpus, truth) -> dict:
    """Phases 3 and 3b for every build of ``CELLS``; ``truth`` holds the
    brute-force answers."""
    from repro_torch.index import batch as batch_lib, builder
    from repro_torch.kernels import ops
    totals = {k: 0 for k in ops.launches()}
    per_regime = {}
    seconds = {"build": 0.0, "sequential": 0.0, "batched": 0.0,
               "profile": 0.0}
    longest = None
    resident = {}
    for codec, wname, B, regimes in CELLS:
        t0 = time.perf_counter()
        idx = builder.build(corpus.postings, corpus.n_docs,
                            codec_name=codec, B=B, n_parts=2, device=dev)
        torch.cuda.synchronize()
        st = idx.stats()
        seconds["build"] += time.perf_counter() - t0
        log(f"{codec} {wname}: built in {time.perf_counter() - t0:.2f} s, "
            f"{st['bytes_per_int']:.4f} bytes/int, {st['postings']} "
            f"postings, {idx.device_bytes()} index bytes on the card, "
            f"lists {st['codec_counts']}")
        plan = batch_lib.FusionPlan()    # one serving session per build
        for regime in regimes:
            counts, bcounts, t_seq, t_bat, seq, bqps = serve_regime(
                idx, f"{codec}/{wname}/{regime}", corpus, truth, regime, plan)
            seconds["sequential"] += t_seq
            seconds["batched"] += t_bat
            for path, c in (("sequential", counts), ("batched", bcounts)):
                per_regime[(codec, wname, regime, path)] = c
                for k, v in c.items():
                    totals[k] += v
            if regime == "default" and (codec, wname) in RESIDENT_BUILDS:
                t0 = time.perf_counter()
                resident[(codec, wname)] = resident_paths(
                    dev, idx, f"{codec}/{wname}", corpus, truth, seq, bqps)
                seconds["resident"] = (seconds.get("resident", 0.0)
                                       + time.perf_counter() - t0)
                for c in resident[(codec, wname)].values():
                    for k, v in c.items():
                        totals[k] += v
            if regime == "default" and (codec, wname) == ("fastpfor-d1",
                                                          "B16"):
                t0 = time.perf_counter()
                for c in live_paths(dev, idx, corpus, truth).values():
                    for k, v in c.items():
                        totals[k] += v
                seconds["live"] = time.perf_counter() - t0
        if wname == "B16":
            t0 = time.perf_counter()
            profile_pass(idx, corpus.queries, codec)
            profile_pass(idx, corpus.queries, codec, plan=plan)
            seconds["profile"] += time.perf_counter() - t0
            if codec == "bp-d1":
                longest = max(
                    (tp.payload for p in idx.parts
                     for tp in p.terms.values()
                     if tp.kind == "list" and hasattr(tp.payload, "maxes")),
                    key=lambda pl: pl.n)
        del idx
    for codec in ("fastpfor-d1", "bp-d1"):
        for wname in ("B16", "B0"):
            if per_regime[(codec, wname, "default", "sequential")][
                    "packed_gallop_batched"] == 0:
                raise AssertionError(f"K3 never ran in {codec}/{wname}/default")
        if per_regime[(codec, "B0", "default", "batched")][
                "packed_fold_batched"] == 0:
            raise AssertionError(f"K5 never ran in {codec}/B0/default/batched")
    for regime in ("cache", "noskip"):
        if sum(per_regime[(c, "B16", regime, "sequential")]["gallop_tiles"]
               for c in ("fastpfor-d1", "bp-d1")) == 0:
            raise AssertionError(f"K2 never ran in the {regime} regime")
        if sum(per_regime[(c, "B16", regime, "batched")]["decoded_fold_batched"]
               for c in ("fastpfor-d1", "bp-d1")) == 0:
            raise AssertionError(f"K4 never ran in the {regime}/batched "
                                 f"regime")
    for (codec, wname), c in resident.items():
        pooled = [v for k, v in c.items() if k not in ("warm", "sequential")]
        if sum(v["decoded_fold_batched"] for v in pooled) == 0:
            raise AssertionError(f"K4 never ran in {codec}/{wname}'s "
                                 f"resident, pipelined or sharded passes")
        # at this size warm decodes no fastpfor list (each is over 4 blocks
        # and skip-served), so K1 decodes them on the pool's misses
        if codec == "fastpfor-d1" and sum(
                v["unpack_blocks"] for v in pooled) == 0:
            raise AssertionError(f"K1 never ran on {codec}/{wname}'s pool "
                                 f"misses")
    if sum(resident[("fastpfor-d1", "B0")][f"depth {d}"]
           ["packed_fold_batched"] for d in DEPTHS) == 0:
        raise AssertionError("K5 never ran in fastpfor-d1/B0 pipelined")
    if sum(v["unpack_blocks"] for k, v in per_regime.items()
           if k[0] == "bp-d1") == 0:
        raise AssertionError("K1 never ran in the bp-d1 build")
    for path in ("sequential", "batched"):
        if per_regime[("streamvbyte-d1", "B16", "default", path)][
                "unpack_svb_blocks"] == 0:
            raise AssertionError(f"K7 never ran in streamvbyte-d1/B16/"
                                 f"default/{path}")
    log(f"launch counts over the main path (sequential + batched): {totals}; "
        f"seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return {"launches": totals, "longest": longest}


def pack_pass(dev, corpus) -> int:
    """The K6 path: the corpus's longest lists, blocked as the host encoder
    blocks them (32 rows, the tail padded with the last value), packed on
    the card through ``ops.pack_blocks`` with the encoder's widths and
    seeds; the words must equal ``bitpack.encode``'s, padded per block, and
    K1 must decode them back to the values.  Returns K6's launches, counted
    over the packing only."""
    from repro_torch.core import bitpack
    from repro_torch.kernels import ops
    lists = sorted(corpus.postings, key=len)[-LONGEST_LISTS:]
    launches = 0
    for v in lists:
        enc = bitpack.encode(v, mode="d1").to(dev)
        K, rows = enc.num_blocks, enc.block_rows
        vals = np.concatenate([v, np.full(K * rows * 128 - len(v), v[-1])])
        vals = _t(vals.astype(np.uint32), dev).reshape(K, rows, 128)
        seeds = bitpack.seeds_of(enc)
        ops.reset_launches()
        packed = ops.pack_blocks(vals, seeds, enc.widths, "d1")
        torch.cuda.synchronize()
        launches += ops.launches()["pack_blocks_padded"]
        r = torch.arange(rows, device=dev)
        idx = (enc.offsets[:, None] + r).clamp(max=enc.flat_words.shape[0] - 1)
        want = torch.where((r < enc.widths[:, None])[..., None],
                           enc.flat_words[idx.long()], 0)
        expect_equal(f"K6 pack of a {len(v)}-posting list against the host "
                     f"encoder", packed, want)
        expect_equal(f"K6 words of a {len(v)}-posting list back through K1",
                     ops.unpack_blocks(packed, enc.widths, seeds, "d1"), vals)
    if launches == 0:
        raise AssertionError("K6 never ran in the pack pass")
    log(f"pack pass: the {LONGEST_LISTS} longest lists "
        f"({', '.join(str(len(v)) for v in lists)} postings) packed by K6 "
        f"equal to the host encoder's words and decode back through K1; "
        f"K6 launches {launches}")
    return launches


def profile_pass(idx, queries, codec: str, plan=None) -> None:
    """One more default-regime pass under torch.profiler — sequential, or
    batched with ``plan`` (see ``profile_report``)."""
    from repro_torch.index import batch as batch_lib, engine
    what = f"{codec}/default" + ("/batched" if plan is not None else "")

    def run():
        if plan is None:
            for q in queries:
                engine.query(idx, q)
        else:
            for lo in range(0, len(queries), BATCH):
                batch_lib.execute_batch(idx, queries[lo: lo + BATCH],
                                        plan=plan)
    profile_report(what, run, f"{len(queries)} queries")


def profile_report(what: str, run, items: str) -> None:
    """``run()`` under torch.profiler: the device's busy time against the
    wall time, the kernels and copies that take most of it, and the host
    ops that launched most of it.  Busy time adds up only the device's own
    events (kernels, copies, memsets): a host op's self device time is the
    same kernels seen again from the op that launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    dev = lambda e: e.self_device_time_total
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev(e) for e in on_dev)
    if busy_us <= 0:
        log(f"{what} profile: the profiler saw no device time (device idle "
            f"share not measured)")
        return
    top = sorted(on_dev, key=dev, reverse=True)[:6]
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=dev, reverse=True)[:4]
    api = {k: sum(e.count for e in events if e.key == k)
           for k in ("cudaStreamSynchronize", "cudaMemcpyAsync",
                     "cudaLaunchKernel")}
    log(f"{what} profile: wall {wall_us / 1e3:.3f} ms for "
        f"{items} under the profiler, device busy "
        f"{busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}; "
        f"host API calls {api}; "
        f"top device time: " + "; ".join(
            f"{e.key[:60]} {dev(e) / 1e3:.3f} ms x{e.count}" for e in top)
        + "; launched by: " + "; ".join(
            f"{e.key[:40]} {dev(e) / 1e3:.3f} ms x{e.count}" for e in host))


# --------------------------------------------------------------------------
# phase 4: timing at main-path shapes
# --------------------------------------------------------------------------

def flash_work(q, k, causal: bool, kv_len) -> tuple[int, int]:
    """K8's bytes (q, k, v and the output once each) and FLOPs (4 B H D
    per visible (query, key) pair: QK^T and PV, a multiply and an add
    each) for this call's masks."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    rows = np.arange(Sq)
    visible = np.minimum(rows + 1, Sk) if causal else np.full(Sq, Sk)
    if kv_len is not None:
        visible = np.minimum(visible, max(kv_len, 0))
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * B * H * D * int(visible.sum())


def time_k8(q, k, v, *, causal: bool, kv_len, bk: int) -> dict:
    """K8 on its route beside the SIMT route's kernel at the same shape, its
    plain version, torch's scaled_dot_product_attention (timed only;
    top-left causal as the reference's mask; also under its
    FlashAttention-2 backend alone) and its bound.  ``ms`` times
    back-to-back wrapper calls; ``graph_ms`` the same calls replayed from a
    CUDA graph (the device's time alone)."""
    from repro_torch.kernels import flash_attention as fa
    kw = dict(causal=causal, kv_len=kv_len, bk=bk)
    kern = lambda: fa.flash_attention(q, k, v, **kw)
    simt = lambda: fa._launch(q, k, v, q.get_device(), route="simt",
                              causal=causal, kv_len=kv_len)
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if kv_len is not None:
        mask = (torch.arange(k.shape[1], device=q.device) < kv_len)[None, None,
                                                                     None]
    gqa = dict(enable_gqa=True) if q.shape[2] != k.shape[2] else {}
    library = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None, **gqa)
    nbytes, flops = flash_work(q, k, causal, kv_len)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else OPS_PER_S
    b_ms, b_by = bound(nbytes, flops, peak)
    # SDPA held to its FlashAttention-2 backend, an mma.sync kernel like the
    # tc route's (null where the backend declines the call, as with a mask)
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION), warnings.catch_warnings():
        warnings.simplefilter("ignore")         # why the backend declines
        try:
            fa2_ms = cuda_ms(library)
        except RuntimeError:
            fa2_ms = None
    # the launch path's host time: a call at one tile of queries and keys
    q1, k1, v1 = (t[:1, :64].contiguous() for t in (q, k, v))
    kv1 = None if kv_len is None else min(kv_len, 64)
    return {"max_abs_err": max_float_err(kern(), plain()),
            "k8_route": fa._route(q, k, v, causal, kv_len),
            "ms": cuda_ms(kern), "graph_ms": graph_ms(kern),
            "host_us": host_us(lambda: fa.flash_attention(
                q1, k1, v1, causal=causal, kv_len=kv1, bk=bk)),
            "simt_ms": cuda_ms(simt, iters=10),
            "plain_ms": cuda_ms(plain, iters=5),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": cuda_ms(library),
            "library_graph_ms": graph_ms(library), "library_fa2_ms": fa2_ms,
            "shape": f"q {tuple(q.shape)}, k/v {tuple(k.shape)}, {q.dtype}, "
                     f"causal {causal}, kv_len {kv_len}, {flops} FLOPs, "
                     f"{nbytes} bytes"}


class StepTimer:
    """Wraps ``serve.steps``' prefill and decode_step while a generation
    runs: the synchronised host time of each, every step's logits, and the
    last decode call's (token, pos, cache)."""

    def __init__(self, steps):
        self.steps = steps
        self.inner = {"prefill": steps.prefill,
                      "decode_step": steps.decode_step}
        self.seconds = {"prefill": 0.0, "decode_step": 0.0}
        self.logits, self.last = [], None
        steps.prefill = lambda *a: self._run("prefill", *a)
        steps.decode_step = lambda *a: self._run("decode_step", *a)

    def _run(self, what, *args):
        if what == "decode_step":
            self.last = args[1:4]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner[what](*args)
        torch.cuda.synchronize()
        self.seconds[what] += time.perf_counter() - t0
        self.logits.append(out[0])
        return out

    def restore(self):
        self.steps.prefill = self.inner["prefill"]
        self.steps.decode_step = self.inner["decode_step"]


def generate(steps, params, cfg, prompt, max_new: int) -> tuple:
    """``steps.greedy_generate`` under a StepTimer → (tokens, timer)."""
    timer = StepTimer(steps)
    try:
        out = steps.greedy_generate(params, cfg, prompt, max_new,
                                    prompt.shape[1] + max_new)
        torch.cuda.synchronize()
    finally:
        timer.restore()
    return out, timer


def serve_lm_checked(steps, params, cfg, prompt, what: str) -> tuple:
    """``greedy_generate`` of LM_NEW tokens under a StepTimer, after one
    warm generation of 2 tokens at the same shapes, with finite logits and
    tokens in range; logs prefill tok/s, decode ms/step and peak memory.
    Returns (tokens, timer, numbers)."""
    generate(steps, params, cfg, prompt, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, timer = generate(steps, params, cfg, prompt, LM_NEW)
    wall = time.perf_counter() - t0
    logits = torch.stack(timer.logits, 1)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: non-finite logits")
    B, S = prompt.shape
    if tuple(out.shape) != (B, LM_NEW) or not bool(
            ((out >= 0) & (out < cfg.vocab)).all()):
        raise AssertionError(f"{what}: bad tokens {tuple(out.shape)}")
    t_pre, t_dec = timer.seconds["prefill"], timer.seconds["decode_step"]
    rec = {"prefill_tok_s": B * S / t_pre,
           "decode_ms_step": t_dec / (LM_NEW - 1) * 1e3,
           "decode_tok_s": B * (LM_NEW - 1) / t_dec,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"{what} served {B} requests x ({S} prompt + {LM_NEW} new) tokens in "
        f"{wall:.3f} s: prefill {t_pre:.4f} s ({rec['prefill_tok_s']:.1f} "
        f"tok/s), {LM_NEW - 1} decode steps {t_dec:.4f} s "
        f"({rec['decode_tok_s']:.1f} tok/s, {rec['decode_ms_step']:.2f} "
        f"ms/step); peak device memory {rec['peak_bytes']} bytes; logits "
        f"finite, |max| {float(logits.abs().max())}; tokens of request 0 "
        f"{out[0, :8].tolist()}")
    return out, timer, rec


def two_layer_cut(steps, params, cfg, prompt, record=contextlib.nullcontext):
    """The same weights cut to 2 layers in float32, on the card and the
    CPU, over the first 64 prompt tokens and 4 new: logits within 1e-3
    (|a - b| <= 1e-3 (1 + |b|)) at every step, tokens equal.  ``record``
    wraps the card's run.  Returns (per-step max |a - b| / (1 + |b|), the
    card's tokens, what ``record`` yielded)."""
    from repro_torch.models import transformer as tfm
    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    small = tfm.LM(cfg2, device="meta")
    small.embed, small.final_norm = params.embed, params.final_norm
    small.layers = torch.nn.ModuleList(list(params.layers[:2]))
    on_cpu = tfm.LM(cfg2, device="cpu")
    on_cpu.load_state_dict(small.state_dict())
    p64 = prompt[:, :64]
    with record() as seen:
        got, t_card = generate(steps, small, cfg2, p64, 4)
    want, t_cpu = generate(steps, on_cpu, cfg2, p64.cpu(), 4)
    errs = [float(((a.cpu() - b).abs() / (1 + b.abs())).max())
            for a, b in zip(t_card.logits, t_cpu.logits)]
    if not (max(errs) <= 1e-3 and torch.equal(got.cpu(), want)):
        raise AssertionError(f"{cfg.name} 2-layer float32 card vs CPU: "
                             f"per-step |a - b| / (1 + |b|) {errs}, tokens "
                             f"{got.tolist()} vs {want.tolist()}")
    return errs, got, seen


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def serve_full_width(dev) -> dict:
    """Phase 5: gemma-7b as registered, served on the card; the 2-layer
    float32 cut against the CPU; K8 on the model's operands.  Returns K8's
    launches over the phase and the operands phase 4 times it on."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa, ops
    from repro_torch.models import layers as L, transformer as tfm
    from repro_torch.serve import steps
    cfg = get_config(LM_ARCH).config
    if cfg.param_count() != LM_PARAMS:
        raise AssertionError(f"{LM_ARCH} is not the registered full width")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    # param_count, as the reference's, leaves out the final norm's d_model
    n = sum(p.numel() for p in params.parameters())
    if n != LM_PARAMS + cfg.d_model:
        raise AssertionError(f"{n} parameters, want {LM_PARAMS} + "
                             f"{cfg.d_model}")
    log(f"{LM_ARCH}: {LM_PARAMS} {cfg.param_dtype} parameters (and the "
        f"final norm's {cfg.d_model}; {n * 4} bytes) made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    out, timer, _ = serve_lm_checked(steps, params, cfg, prompt, LM_ARCH)

    # the first decode step against a prefill over the prompt and its token
    again, _ = tfm.prefill(params, torch.cat([prompt, out[:, :1]], 1), cfg)
    dec0 = timer.logits[1]
    err = rel_rms(dec0, again)
    same = int((dec0.argmax(-1) == again.argmax(-1)).sum())
    log(f"first decode step against prefill over prompt + token: RMS "
        f"difference {err:.5f} of the logits' RMS (tolerance "
        f"{LM_DECODE_TOL}), max abs {max_float_err(dec0, again)}, argmax "
        f"equal in {same}/{LM_BATCH} rows")
    if not err <= LM_DECODE_TOL:
        raise AssertionError(f"decode step differs from prefill by {err}")
    del again

    # K8 on the operands of the model's own attention calls
    x = tfm.embed_tokens(params, prompt, cfg)
    cos, sin = tfm.rope_tables(torch.arange(LM_PROMPT, device=dev),
                               LM_BATCH, cfg)
    q, k, v = tfm.layer_qkv(params.layers[0], x, cos, sin, cfg)
    # against the models' attention (which rounds p to bf16 too) within the
    # reference's 0.05; against the plain version within bf16_allowance
    got = flash_routed("layer 0 prefill", "tc", q, k, v, causal=True)
    e_pre = expect_close("K8 on layer 0's prefill operands vs attention_full",
                         got, L.attention_full(q, k, v), 0.05)
    e_pre_plain = expect_k8("K8 on layer 0's prefill operands vs plain", got,
                            fa.flash_attention_plain(q, k, v, causal=True), v,
                            True)
    cache, token, pos = timer.last
    xd = tfm.embed_tokens(params, token[:, None], cfg)
    cos, sin = tfm.rope_tables(torch.tensor([pos], device=dev), LM_BATCH, cfg)
    qd = tfm.layer_qkv(params.layers[0], xd, cos, sin, cfg)[0]
    kc, vc = cache["k"][0], cache["v"][0]
    dkw = dict(causal=False, kv_len=pos + 1, bk=kc.shape[1])
    got = flash_routed("last decode step", "split", qd, kc, vc, **dkw)
    e_dec = expect_close(
        "K8 on the last decode step's operands vs attention_decode", got,
        L.attention_decode(qd, kc, vc, pos + 1), 0.05)
    e_dec_plain = expect_k8(
        "K8 on the last decode step's operands vs plain", got,
        fa.flash_attention_plain(qd, kc, vc, **dkw), vc, False)
    gq, gk, gv = flash_inputs(85, GQA_SHAPE, torch.bfloat16, dev)
    got = flash_routed("GQA 40:10 prefill", "tc", gq, gk, gv, causal=True)
    e_gqa = expect_close("K8 at phi3-medium-14b's GQA width vs attention_full",
                         got, L.attention_full(gq, gk, gv), 0.05)
    e_gqa_plain = expect_k8(
        "K8 at phi3-medium-14b's GQA width vs plain", got,
        fa.flash_attention_plain(gq, gk, gv, causal=True), gv, True)
    del got
    launches = ops.launches()["flash_attention"]
    if launches == 0:
        raise AssertionError("K8 never ran in phase 5")
    log(f"K8 on the model's operands (bf16): prefill q {tuple(q.shape)} vs "
        f"attention_full max abs {e_pre} (tolerance 0.05), vs plain (max "
        f"abs, share of the allowance) {e_pre_plain}; decode q "
        f"{tuple(qd.shape)} over the {kc.shape[1]}-long cache, kv_len "
        f"{pos + 1}, vs attention_decode {e_dec}, vs plain {e_dec_plain}; "
        f"GQA 40:10 at D=128 vs attention_full {e_gqa}, vs plain "
        f"{e_gqa_plain}; K8 launches {launches}, calls by route "
        f"{ops.flash_routes()}")
    timed = {"prefill": (q, k, v, dict(causal=True, kv_len=None, bk=512)),
             "decode": (qd, kc.clone(), vc.clone(), dkw),
             "gqa_prefill": (gq, gk, gv, dict(causal=True, kv_len=None,
                                              bk=512))}
    # where a request's time goes: one more prefill, and the last decode
    # step once more on its own cache
    profile_report(f"{LM_ARCH} prefill", lambda: tfm.prefill(params, prompt,
                                                             cfg),
                   f"{LM_BATCH} x {LM_PROMPT} tokens")
    profile_report(f"{LM_ARCH} decode step",
                   lambda: tfm.decode_step(params, cache, token, pos, cfg),
                   f"{LM_BATCH} tokens at position {pos}")
    del cache, timer, x, xd

    t0 = time.perf_counter()
    errs, got, _ = two_layer_cut(steps, params, cfg, prompt)
    log(f"{LM_ARCH} cut to 2 layers, float32, 64-token prompt, 4 new tokens: "
        f"card and CPU logits within 1e-3 (max |a - b| / (1 + |b|) per step "
        f"{errs}), tokens equal {got[0].tolist()} ({time.perf_counter() - t0:.1f} s)")
    del params
    return {"launches": launches, "timed": timed}


# --------------------------------------------------------------------------
# phase 6: the MoE LMs at full width
# --------------------------------------------------------------------------

@contextlib.contextmanager
def moe_inputs():
    """Record each ``moe.moe_ffn`` call's (layer weights, layer input) while
    the block runs (the transformer looks the function up at each call)."""
    from repro_torch.models import moe
    seen, inner = [], moe.moe_ffn

    def record(p, h, **kw):
        seen.append((p, h))
        return inner(p, h, **kw)
    moe.moe_ffn = record
    try:
        yield seen
    finally:
        moe.moe_ffn = inner


def dropped_slots(seen, cfg) -> tuple[int, int]:
    """(slots past capacity over the recorded MoE calls, C of the last)."""
    from repro_torch.models import moe
    total = C = 0
    for p, h in seen:
        hf = h.reshape(-1, h.shape[-1])
        ids = moe._route(p.router, hf, cfg.top_k, cfg.n_experts)[1]
        gsz = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
        C = moe.capacity(hf.shape[0], cfg.top_k, cfg.n_experts,
                         cfg.capacity_factor)
        total += int((gsz - C).clamp_min(0).sum())
    return total, C


def expert_ids_agree(seen, cfg) -> tuple[int, int]:
    """Each recorded layer input routed on the card and, copied, on the
    CPU: the sets of k experts must be equal for every token, except where
    the CPU's k-th and (k+1)-th probabilities are within NEAR_TIE.  Returns
    (tokens whose sets differ at such a near tie, tokens at a near tie)."""
    from repro_torch.models import moe
    k, E = cfg.top_k, cfg.n_experts
    differ_near = near = 0
    for p, h in seen:
        hf = h.reshape(-1, h.shape[-1])
        card = moe._route(p.router, hf, k, E)[1].sort(1).values.cpu()
        _, ids, probs = moe._route(p.router.cpu(), hf.cpu(), k, E)
        top = probs.sort(-1, descending=True).values
        tie = (top[:, k - 1] - top[:, k]) < NEAR_TIE
        differ = (card != ids.sort(1).values).any(1)
        if bool((differ & ~tie).any()):
            raise AssertionError(f"{int((differ & ~tie).sum())} tokens "
                                 f"routed to other experts on the card than "
                                 f"on the CPU at no near tie")
        differ_near += int(differ.sum())
        near += int(tie.sum())
    return differ_near, near


def moe_repeat_and_drops(params, cfg, prompt, timer, what: str) -> None:
    """Two prefills give bit-equal logits; the slots dropped in a prefill
    and in the last decode step (run again on its own cache); a profile
    of each (idle share, launches)."""
    from repro_torch.models import transformer as tfm
    with moe_inputs() as seen:
        first, _ = tfm.prefill(params, prompt, cfg)
    drop_pre, c_pre = dropped_slots(seen, cfg)
    del seen
    again, _ = tfm.prefill(params, prompt, cfg)
    if not torch.equal(first, again):
        raise AssertionError(f"{what}: two prefills differ, max abs "
                             f"{max_float_err(first, again)}")
    del first, again
    cache, token, pos = timer.last
    with moe_inputs() as seen:
        tfm.decode_step(params, cache, token, pos, cfg)
    drop_dec, c_dec = dropped_slots(seen, cfg)
    del seen
    slots = prompt.numel() * cfg.top_k * cfg.n_layers
    log(f"{what}: two prefills give bit-equal logits; dropped slots: "
        f"{drop_pre} of {slots} in a prefill (C = {c_pre}), {drop_dec} of "
        f"{token.numel() * cfg.top_k * cfg.n_layers} in a decode step "
        f"(C = {c_dec})")
    B, S = prompt.shape
    profile_report(f"{what} prefill", lambda: tfm.prefill(params, prompt,
                                                          cfg),
                   f"{B} x {S} tokens")
    profile_report(f"{what} decode step",
                   lambda: tfm.decode_step(params, cache, token, pos, cfg),
                   f"{B} tokens at position {pos}")


def serve_moe(dev) -> dict:
    """Phase 6: granite-moe-1b-a400m as registered (serve, checks a–c),
    then kimi-k2-1t-a32b at its full width, cut in depth."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import steps
    out = {}
    cfg = get_config(MOE_ARCH).config
    if cfg.param_count() != MOE_PARAMS:
        raise AssertionError(f"{MOE_ARCH} is not the registered full width")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    if n != MOE_PARAMS + cfg.d_model:
        raise AssertionError(f"{n} parameters, want {MOE_PARAMS} + "
                             f"{cfg.d_model}")
    log(f"{MOE_ARCH}: {MOE_PARAMS} {cfg.param_dtype} parameters (and the "
        f"final norm's {cfg.d_model}), {cfg.n_layers} layers of "
        f"{cfg.n_experts} experts, top-{cfg.top_k}, made on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    tokens, timer, out[MOE_ARCH] = serve_lm_checked(steps, params, cfg,
                                                    prompt, MOE_ARCH)
    # (c) bit-equal repeats, and what the registered config drops
    moe_repeat_and_drops(params, cfg, prompt, timer, MOE_ARCH)
    del timer

    # (b) the first decode step against a prefill over the prompt and its
    # token, where no slot is dropped (C = N): a B-token decode and a
    # B·(S+1)-token prefill drop different slots by design otherwise
    nd = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    first, nd_timer = generate(steps, params, nd, prompt, 2)
    full, _ = tfm.prefill(params, torch.cat([prompt, first[:, :1]], 1), nd)
    dec0 = nd_timer.logits[1]
    err = rel_rms(dec0, full)
    log(f"{MOE_ARCH} with capacity_factor {nd.capacity_factor:g} (no slot "
        f"dropped): first decode step against prefill over prompt + token: "
        f"RMS difference {err:.5f} of the logits' RMS (tolerance "
        f"{LM_DECODE_TOL}), max abs {max_float_err(dec0, full)}, argmax "
        f"equal in {int((dec0.argmax(-1) == full.argmax(-1)).sum())}/"
        f"{LM_BATCH} rows")
    if not err <= LM_DECODE_TOL:
        raise AssertionError(f"{MOE_ARCH}: decode step differs from prefill "
                             f"by {err}")
    del first, nd_timer, full, dec0

    # (a) the 2-layer float32 cut on the card and the CPU, and each MoE
    # layer's experts for the card's layer input on both
    t0 = time.perf_counter()
    errs, got, seen = two_layer_cut(steps, params, cfg, prompt, moe_inputs)
    differ, near = expert_ids_agree(seen, dataclasses.replace(
        cfg, compute_dtype="float32"))
    log(f"{MOE_ARCH} cut to 2 layers, float32, 64-token prompt, 4 new "
        f"tokens: card and CPU logits within 1e-3 (max |a - b| / (1 + |b|) "
        f"per step {errs}), tokens equal {got[0].tolist()}; experts of "
        f"{len(seen)} MoE calls routed on the card and the CPU from the "
        f"card's layer inputs: equal sets but for {differ} tokens at a near "
        f"tie ({near} tokens with a CPU margin under {NEAR_TIE}) "
        f"({time.perf_counter() - t0:.1f} s)")
    del seen, params
    gc.collect()
    torch.cuda.empty_cache()

    # kimi-k2 at its full width: every layer is the same MoE layer, so one
    # layer is a whole period; the cut is the deepest that fits
    for layers in KIMI_CUTS:
        try:
            out[KIMI_ARCH] = serve_kimi(dev, layers)
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"{KIMI_ARCH} cut to {layers} layers does not fit the card: "
                f"{str(e).splitlines()[0]}")
        gc.collect()
        torch.cuda.empty_cache()
    else:
        raise AssertionError(f"{KIMI_ARCH} fits the card at no cut "
                             f"{KIMI_CUTS}")
    return out


def serve_kimi(dev, layers: int) -> dict:
    """kimi-k2-1t-a32b at the registered widths cut to ``layers`` of its 61
    layers: serve, bit-equal repeat prefills, dropped slots, profiles."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import steps
    full = get_config(KIMI_ARCH).config
    cfg = dataclasses.replace(full, n_layers=layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tfm.init_params(torch.Generator(dev).manual_seed(0), cfg, dev)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    if n != cfg.param_count() + cfg.d_model:
        raise AssertionError(f"{n} parameters, want {cfg.param_count()} + "
                             f"{cfg.d_model}")
    log(f"{KIMI_ARCH} cut to {layers} of {full.n_layers} layers (the cut "
        f"run): {cfg.param_count()} {cfg.param_dtype} parameters "
        f"({sum(p.numel() * p.element_size() for p in params.parameters())}"
        f" bytes; router float32), d_model {cfg.d_model}, {cfg.n_experts} "
        f"experts of d_ff {cfg.d_ff}, top-{cfg.top_k}, vocab {cfg.vocab}, "
        f"made on the card in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated()} bytes allocated")
    prompt = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                           dtype=torch.int32, device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    what = f"{KIMI_ARCH} ({layers} layers)"
    _, timer, rec = serve_lm_checked(steps, params, cfg, prompt, what)
    moe_repeat_and_drops(params, cfg, prompt, timer, what)
    rec["layers"] = layers
    return rec


# --------------------------------------------------------------------------
# phase 7: recsys scoring and retrieval at the registered widths
# --------------------------------------------------------------------------

def params_to_cpu(params):
    """A detached copy of a params tree (or an LM module) on the CPU."""
    from repro_torch.models import transformer
    if isinstance(params, transformer.LM):
        cpu = transformer.LM(params.cfg, "cpu")
        cpu.load_state_dict(params.state_dict())
        return cpu
    if isinstance(params, dict):
        return {k: params_to_cpu(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_cpu(v) for v in params]
    return params.detach().to("cpu", copy=True)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(tree_numel(v) for v in tree)
    return tree.numel()


def expect_allclose(what: str, got: torch.Tensor, want: torch.Tensor,
                    tol: float = RECSYS_TOL) -> float:
    """|got - want| <= tol + tol·|want| elementwise; returns max |got - want|."""
    got = got.cpu()
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} against "
                             f"{tuple(want.shape)}")
    bad = (got - want).abs() > tol + tol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {int(bad.sum())} of {got.numel()} "
                             f"outside {tol} (max abs "
                             f"{max_float_err(got, want)})")
    return max_float_err(got, want)


def top_k_agree(what, values, indices, want_values, want_indices,
                tol: float = RECSYS_TOL) -> int:
    """Top-k values within ``tol``; indices equal outside tie groups (runs
    of CPU values closer than 2·tol), a group's index set equal where it
    ends before rank k.  Returns the ranks compared one to one."""
    expect_allclose(f"{what} top-k values", values, want_values, tol)
    v, i, wi = want_values.numpy(), indices.cpu().numpy(), want_indices.numpy()
    k = len(v)
    starts = np.flatnonzero(np.r_[True, np.abs(np.diff(v)) > 2 * tol])
    single = 0
    for lo, hi in zip(starts, np.r_[starts[1:], k]):
        if hi == k and hi - lo > 1:
            continue
        if sorted(i[lo:hi]) != sorted(wi[lo:hi]):
            raise AssertionError(f"{what}: top-k indices differ at ranks "
                                 f"{lo}..{hi - 1}")
        single += hi - lo == 1
    return single


def _on_cpu_in_chunks(fn, batch: dict, n: int, keys) -> torch.Tensor:
    """``fn`` on the CPU over row chunks of ``batch``'s ``keys`` (the rest
    whole): each row's score depends on its own row alone."""
    out = []
    for lo in range(0, n, CPU_CHUNK):
        part = {k: (v[lo:lo + CPU_CHUNK] if k in keys else v)
                for k, v in batch.items()}
        with torch.no_grad():
            out.append(fn(part))
    return torch.cat(out)


def timed_step(fn, reps: int) -> float:
    """Seconds a call: ``fn()`` once to warm, then ``reps`` calls, host
    clock around work that ends in a synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


# Phase 7 runs in a process of its own, with expandable segments: its
# bert4rec bulk batch frees and asks again for 21e9-byte score tensors 12e9
# bytes short of the card's memory.  In the process of phases 1-6, with
# the default segments, it ran out of memory with 17 GiB cached in pieces
# of such blocks that smaller tensors had split; with blocks kept whole
# (max_split_size_mb) it re-allocated them every call, at twice the time.
RECSYS_ALLOC_CONF = "expandable_segments:True"


def recsys_child() -> None:
    """Phase 7's process: ``serve_recsys_full`` on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"phase 7 in its own process (PYTORCH_CUDA_ALLOC_CONF="
        f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')})")
    serve_recsys_full(torch.device("cuda"))
    log(f"phase 7's process done in {time.perf_counter() - t0:.1f} s")


def run_recsys_phase() -> None:
    """Phase 7 in a child process with RECSYS_ALLOC_CONF, after this
    process has given back its cached memory; fails if the child does."""
    gc.collect()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=RECSYS_ALLOC_CONF)
    subprocess.run([sys.executable, "-c",
                    "import chip_smoke; chip_smoke.recsys_child()"],
                   cwd=ROOT, env=env, check=True, timeout=900)


def serve_recsys_full(dev) -> dict:
    """Phase 7: din, sasrec, bert4rec and mind at the registered widths,
    params from a seed: serve_p99 and serve_bulk scored, retrieval_cand
    scored and cut to the top 100 on the card, each held against the
    port's CPU path on the same params and batch."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import recsys_data as rd
    from repro_torch.models import recsys
    from repro_torch.serve import steps
    makers = {"din": rd.din_batch, "sasrec": rd.seq_batch,
              "bert4rec": rd.bert4rec_batch, "mind": rd.mind_batch}
    rec = {}
    for seed, arch in enumerate(RECSYS_ARCHS):
        spec = get_config(arch)
        cfg = spec.config
        t0 = time.perf_counter()
        params = recsys.INIT[arch](torch.Generator(dev).manual_seed(seed),
                                   cfg, dev)
        on_cpu = params_to_cpu(params)
        log(f"{arch}: {tree_numel(params)} float32 parameters at the "
            f"registered widths from seed {seed} in "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(100 + seed)
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
            want = spec.shapes[shape]
            retrieval = want["kind"] == "retrieval"
            full_n = want["n_candidates"] if retrieval else want["batch"]
            n = RECSYS_CUTS.get((shape, arch), full_n)
            b_np = (rd.retrieval_batch(rng, cfg, n) if retrieval
                    else makers[arch](rng, cfg, n))
            b = {k: torch.from_numpy(v).to(dev) for k, v in b_np.items()}
            b_cpu = {k: torch.from_numpy(v) for k, v in b_np.items()}
            torch.cuda.reset_peak_memory_stats()
            if retrieval:
                step = steps.make_recsys_retrieval_step(cfg, want["top_k"])
                sec = timed_step(lambda: step(params, b), 3)
                vals, idx = step(params, b)
                with torch.no_grad():
                    scores = recsys.RETRIEVAL[arch](params, b, cfg)
                cpu = _on_cpu_in_chunks(
                    lambda part: recsys.RETRIEVAL[arch](on_cpu, part, cfg),
                    b_cpu, n, ("cand_items", "cand_cates"))
                err = expect_allclose(f"{arch} {shape} scores", scores, cpu)
                cv, ci = torch.topk(cpu, want["top_k"])
                single = top_k_agree(f"{arch} {shape}", vals, idx, cv, ci)
                note = (f"top-{want['top_k']} values within {RECSYS_TOL}, "
                        f"indices equal ({single} ranks one to one, the "
                        f"rest in tie groups of repeated ids)")
                del scores, vals, idx
            else:
                step = steps.make_recsys_score_step(cfg)
                sec = timed_step(lambda: step(params, b), 3)
                got = step(params, b)
                cpu = _on_cpu_in_chunks(
                    lambda part: recsys.SCORE[arch](on_cpu, part, cfg),
                    b_cpu, n, b_cpu.keys())
                err = expect_allclose(f"{arch} {shape} scores", got, cpu)
                note = f"mean score {float(got.mean()):.4f}"
                del got
            peak = torch.cuda.max_memory_allocated()
            cut = "" if n == full_n else f" (cut from {full_n})"
            rec[f"{arch}/{shape}"] = {"n": n, "ms": sec * 1e3,
                                      "items_s": n / sec, "peak_bytes": peak}
            items = "candidates" if retrieval else "rows"
            log(f"{arch} {shape}: {n}{cut} {items} in {sec * 1e3:.3f} ms a "
                f"batch ({n / sec:.1f} items/s), "
                f"peak device memory {peak} bytes; card against the CPU path "
                f"within {RECSYS_TOL} (max abs {err}); {note}")
            del b, b_cpu, cpu
            torch.cuda.empty_cache()
        del params, on_cpu
        gc.collect()
        torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------
# phase 8: training (graphsage-reddit, internlm2-1.8b, the recsys archs)
# --------------------------------------------------------------------------

GNN_ARCH = "graphsage-reddit"
# avg_degree of synthetic_graph for each registered graph: chosen so the
# symmetrised, deduplicated edges come near the registered n_edges
GNN_DEGREE = {"full_graph_sm": 2, "minibatch_lg": 266, "ogb_products": 13}
GNN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg", "ogb_products")
GNN_AGAINST_CPU = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_RESUME = ("full_graph_sm", "minibatch_lg")
TRAIN_STEPS = 3                # timed steps, after one warm step
RESUME_N = 2                   # 2N steps against N, a checkpoint, N more
# a step against the CPU path: the loss within TRAIN_TOL·(1 + |loss|), each
# gradient leaf normwise, ||g_card - g_cpu|| <= TRAIN_TOL·||g_cpu|| (float32
# sums in another order; an entry whose terms cancel, such as bert4rec's
# pos_embed, a sum over the batch, is off by more than TRAIN_TOL of the
# leaf's largest entry: 3.48e-6 against 0.012 at 2048 rows, so the norm
# weighs each entry by its share of the leaf).  AdamW divides each
# coordinate by its own scale, so a gradient at rounding level would move
# its parameter by up to lr: the update is held apart, both devices apply
# the card's gradients, and the parameters and moments must agree within
# UPDATE_TOL·(1 + |p|).
TRAIN_TOL = 1e-4
LM_TRAIN_TOL = 1e-3            # the 2-layer float32 LM cut, 92544-way softmax
UPDATE_TOL = 1e-6
LM_TRAIN_ARCH = "internlm2-1.8b"
LM_TRAIN_SEQ = 4096            # one sequence of train_4k
LM_CUT_SEQ = 128               # the 2-layer cut held against the CPU
RECSYS_TRAIN_CUTS = {"bert4rec": 1 << 13}
# rows of the recsys step held against the CPU path: the weight gradients
# sum rows x seq_len products (409,600 for bert4rec), and float32 sums of
# that length in two orders agree to about sqrt(n)·2**-24 of their terms
RECSYS_CHECK_ROWS = 1 << 11
CSR_GRAPH = (60000, 8)         # within the codec's 2**32 domain
GRAD_N, GRAD_K = 1 << 24, 1 << 16
TRAIN_ALLOC_CONF = "expandable_segments:True"
TRAIN_RESULT = ROOT / "build" / "phase8.json"


def _finite(what: str, loss) -> float:
    v = float(loss)
    if not np.isfinite(v):
        raise AssertionError(f"{what}: loss {v} is not finite")
    return v


def step_against_cpu(what, loss_fn, params, opt, batch, opt_cfg,
                     tol: float = TRAIN_TOL) -> dict:
    """One step on the card held against the port's CPU path from the same
    params, optimizer state and batch: loss and gradients (normwise) within
    ``tol`` (see TRAIN_TOL), then each device applies the card's gradients
    and the params and moments agree within UPDATE_TOL.  The card's params
    and ``opt`` take the step."""
    from repro_torch import tree
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    p_cpu = params_to_cpu(params)
    o_cpu = {k: params_to_cpu(v) for k, v in opt.items()}
    b_cpu = {k: v.cpu() for k, v in batch.items()}
    loss_k, _, g_k = train_steps.loss_and_grads(loss_fn, params, batch)
    loss_c, _, g_c = train_steps.loss_and_grads(loss_fn, p_cpu, b_cpu)
    lk, lc = float(loss_k), float(loss_c)
    if not abs(lk - lc) <= tol * (1 + abs(lc)):
        raise AssertionError(f"{what}: loss {lk} on the card, {lc} on the "
                             f"CPU")
    worst = 0.0
    for (path, _), a, b in zip(tree.items(params), g_k, g_c):
        norm = float(torch.linalg.vector_norm(b))
        err = float(torch.linalg.vector_norm(a.cpu() - b))
        if not err <= tol * norm + 1e-12:
            raise AssertionError(f"{what}: gradient {path} differs by {err} "
                                 f"in norm (its norm {norm})")
        worst = max(worst, err / norm if norm else 0.0)
    with torch.no_grad():
        adamw.update(g_k, opt, params, opt_cfg)
        adamw.update([g.cpu() for g in g_k], o_cpu, p_cpu, opt_cfg)
    upd = 0.0
    for a, b in zip(tree.leaves(params) + opt["mu"] + opt["nu"],
                    tree.leaves(p_cpu) + o_cpu["mu"] + o_cpu["nu"]):
        upd = max(upd, expect_allclose(f"{what} after the step", a.detach(),
                                       b.detach(), UPDATE_TOL))
    log(f"{what}: one step against the CPU path: loss {lk} / {lc}, "
        f"gradients within {worst:.2e} of each leaf's norm (tolerance "
        f"{tol}), params and moments after the card's gradients within "
        f"{upd:.2e} (tolerance {UPDATE_TOL}·(1 + |p|))")
    return {"loss_card": lk, "loss_cpu": lc, "grad_rel_err": worst,
            "update_err": upd}


def resume_is_bitwise(what, make_trainer, n: int = RESUME_N) -> None:
    """2n steps through ``Trainer`` against n steps, a checkpoint, a fresh
    Trainer restored from it and n more: params, optimizer state and the
    generator's state torch.equal.  ``make_trainer(ckpt_dir, total, skip)``
    builds a Trainer from fresh seeded state whose data skips ``skip``
    batches."""
    from repro_torch import tree
    (ROOT / "build").mkdir(exist_ok=True)
    top = Path(tempfile.mkdtemp(prefix="train-", dir=ROOT / "build"))
    try:
        a = make_trainer(str(top / "a"), 2 * n, 0)
        a.run()
        b = make_trainer(str(top / "b"), n, 0)
        b.run()
        b.mgr.wait()
        c = make_trainer(str(top / "b"), 2 * n, n)
        start = c.try_restore()
        if start != n:
            raise AssertionError(f"{what}: restored step {start}, not {n}")
        c.run(start)
        want = tree.leaves({"p": a.params, "o": a.opt_state,
                            "g": a.generator.get_state()})
        got = tree.leaves({"p": c.params, "o": c.opt_state,
                           "g": c.generator.get_state()})
        bad = [i for i, (x, y) in enumerate(zip(got, want))
               if not torch.equal(x, y)]
        if len(got) != len(want) or bad:
            raise AssertionError(f"{what}: resume not bitwise: leaves {bad} "
                                 f"of {len(want)} differ")
        log(f"{what}: resume bitwise ({2 * n} steps against {n} + "
            f"checkpoint + restore + {n}; {len(want)} leaves torch.equal)")
    finally:
        shutil.rmtree(top, ignore_errors=True)


def _device_batch(b: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in b.items()}


def card_graph(n_nodes: int, avg_degree: int, seed: int, d_feat: int,
               n_classes: int, dev) -> dict:
    """``graph_data.synthetic_graph``'s construction with torch draws on the
    card: src uniform, dst from the same power-law cdf (numpy's
    ``choice(p=w)`` is a right searchsorted of uniform draws in it),
    self-loops dropped, both directions, deduplicated and sorted (CSR
    order), features normal, labels the argmax of the first n_classes
    features.  Another generator than numpy's, so other bits than
    ``synthetic_graph``'s; made here because numpy took 587 s on the card's
    host for Reddit's 62M draws and 117M edges."""
    g = torch.Generator(dev).manual_seed(seed)
    n_edges = n_nodes * avg_degree
    w = (1.0 / (torch.arange(n_nodes, dtype=torch.float64, device=dev)
                + 1.0)) ** 0.8
    cdf = torch.cumsum(w / w.sum(), 0)
    cdf /= cdf[-1].clone()
    src = torch.randint(0, n_nodes, (n_edges,), generator=g, device=dev)
    u = torch.rand(n_edges, generator=g, dtype=torch.float64, device=dev)
    dst = torch.searchsorted(cdf, u, right=True).clamp_max_(n_nodes - 1)
    del u
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.unique(torch.cat([src * n_nodes + dst, dst * n_nodes + src]))
    del src, dst, keep
    src = (key // n_nodes).to(torch.int32)
    dst = (key % n_nodes).to(torch.int32)
    del key
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n_nodes), 0)
    x = torch.randn(n_nodes, d_feat, generator=g, device=dev)
    return {"indptr": indptr.to(torch.int32), "indices": dst,
            "edge_src": src, "edge_dst": dst, "x": x,
            "labels": torch.argmax(x[:, :n_classes], dim=1).to(torch.int32),
            "train_mask": torch.rand(n_nodes, generator=g, device=dev) < 0.5}


def gnn_data(name: str, sh: dict, dev) -> dict:
    """The shape's graph (or molecule batch) on the card, from seed 8:
    Cora's and the molecules from the port's numpy makers, the two large
    graphs from ``card_graph``."""
    from repro_torch.data import graph_data
    t0 = time.perf_counter()
    if sh["kind"] == "molecule":
        mb = graph_data.molecule_batch(np.random.default_rng(8), sh["batch"],
                                       sh["n_nodes"], sh["n_edges"],
                                       sh["d_feat"])
        log(f"{GNN_ARCH} {name}: {sh['batch']} graphs x {sh['n_nodes']} "
            f"nodes x {sh['n_edges']} edges")
        return {"batch": _device_batch(mb, dev)}
    args = (sh["n_nodes"], GNN_DEGREE[name], 8, sh["d_feat"],
            sh["n_classes"])
    if name == "full_graph_sm":
        g = _device_batch(graph_data.synthetic_graph(*args), dev)
        how = "synthetic_graph"
    else:
        g = card_graph(*args, dev)
        torch.cuda.synchronize()
        how = "card_graph"
    log(f"{GNN_ARCH} {name}: {how}({sh['n_nodes']}, {GNN_DEGREE[name]}) "
        f"gave {len(g['indices'])} edges (registered {sh['n_edges']}), "
        f"d_feat {sh['d_feat']}, {sh['n_classes']} classes, in "
        f"{time.perf_counter() - t0:.1f} s")
    if sh["kind"] == "full":
        return {"batch": {k: g[k] for k in ("x", "edge_src", "edge_dst",
                                           "labels", "train_mask")}}
    return {"graph": {"feats": g["x"], "indptr": g["indptr"],
                      "indices": g["indices"]}, "labels": g["labels"]}


def gnn_batches(data: dict, sh: dict, seed: int):
    """The shape's batches: the whole graph (or molecule batch) each step;
    for the minibatch, batch_nodes seeds a step from a numpy seed."""
    if "batch" in data:
        while True:
            yield data["batch"]
    rng = np.random.default_rng(seed)
    g, labels = data["graph"], data["labels"]
    while True:
        seeds = torch.from_numpy(rng.integers(
            0, sh["n_nodes"], size=sh["batch_nodes"]).astype(np.int32)).to(
            labels.device)
        yield {**g, "seeds": seeds, "labels": labels[seeds.long()]}


def ogb_reckoning(sh: dict, cfg) -> int:
    """Peak bytes reckoned for a full-graph step: the gathered messages of
    the widest layer (E x max(d_feat, d_hidden) float32) beside the
    features, the hidden states, the edge lists and both sort plans."""
    N, E = sh["n_nodes"], sh["n_edges"]
    d = max(sh["d_feat"], cfg.d_hidden)
    return (E * d * 4 + N * sh["d_feat"] * 4 + 6 * N * cfg.d_hidden * 4
            + 2 * E * 4 + 6 * E * 8)


def train_gnn_shape(dev, name: str, data=None) -> dict:
    """graphsage-reddit on one registered shape: a warm step, TRAIN_STEPS
    timed steps (ms a step, seeds/s or nodes/s, peak memory, finite
    losses), the step against the CPU path, resume through Trainer."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import gnn
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    from repro_torch.train.trainer import Trainer, TrainerConfig
    spec = get_config(GNN_ARCH)
    sh = spec.shapes[name]
    cfg = dataclasses.replace(
        spec.config, d_feat=sh["d_feat"], n_classes=sh["n_classes"],
        task="graph" if sh["kind"] == "molecule" else "node")
    variant = {"full": "full", "minibatch": "minibatch",
               "molecule": "molecule"}[sh["kind"]]
    fanout = sh.get("fanout", (15, 10))
    opt_cfg = adamw.AdamWConfig(weight_decay=0.0)
    if name == "ogb_products":
        log(f"{GNN_ARCH} {name}: reckoned peak {ogb_reckoning(sh, cfg)} "
            f"bytes of {torch.cuda.get_device_properties(0).total_memory}: "
            f"no cut")
    data = data or gnn_data(name, sh, dev)
    step = train_steps.make_gnn_train_step(cfg, variant, opt_cfg,
                                           fanout=fanout)

    def fresh(seed=0):
        p = gnn.init_params(torch.Generator(dev).manual_seed(seed), cfg, dev)
        return p, adamw.init(p, opt_cfg)

    params, opt = fresh()
    gen = torch.Generator(dev).manual_seed(1)
    it = gnn_batches(data, sh, seed=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params, opt, m = step(params, opt, next(it), gen)
    losses = [_finite(f"{name} warm step", m["loss"])]
    batches = [next(it) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        params, opt, m = step(params, opt, b, gen)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [_finite(f"{name} step", v) for v in losses]
    if sh["kind"] == "minibatch":
        rate = f"{sh['batch_nodes'] / sec:.1f} seeds/s"
    elif sh["kind"] == "molecule":
        rate = f"{sh['batch'] * sh['n_nodes'] / sec:.1f} nodes/s"
    else:
        rate = f"{sh['n_nodes'] / sec:.1f} nodes/s"
    log(f"{GNN_ARCH} {name} ({variant}, d_feat {cfg.d_feat}, d_hidden "
        f"{cfg.d_hidden}, {cfg.n_classes} classes): {sec * 1e3:.3f} ms a "
        f"step, {rate}, peak device memory {peak} bytes ({peak - base} "
        f"above the {base} allocated before the first step), losses "
        f"{[round(v, 5) for v in losses]} (finite)")
    rec = {"ms": sec * 1e3, "rate": rate, "peak_bytes": peak,
           "base_bytes": base, "losses": losses}
    del batches
    if name in GNN_AGAINST_CPU:
        b = next(it)
        if variant == "minibatch":
            l1, l2 = gnn.sample_hops(gen, b["indptr"], b["indices"],
                                     b["seeds"], fanout)
            b = {"feats": b["feats"], "seeds": b["seeds"],
                 "labels": b["labels"], "l1": l1, "l2": l2}
            loss_fn = lambda p, bb: gnn.minibatch_loss(p, bb, None, cfg,
                                                       fanout)
        elif variant == "full":
            loss_fn = lambda p, bb: gnn.node_loss(p, bb, cfg)
        else:
            loss_fn = lambda p, bb: gnn.molecule_loss(p, bb, cfg)
        rec["against_cpu"] = step_against_cpu(f"{GNN_ARCH} {name}", loss_fn,
                                              params, opt, b, opt_cfg)
    if name in GNN_RESUME:
        def make_trainer(ckpt_dir, total, skip):
            p, o = fresh()
            it2 = gnn_batches(data, sh, seed=3)
            for _ in range(skip):
                next(it2)
            return Trainer(step, p, o, it2, TrainerConfig(
                total_steps=total, ckpt_every=RESUME_N, ckpt_dir=ckpt_dir),
                generator=torch.Generator(dev).manual_seed(4))
        resume_is_bitwise(f"{GNN_ARCH} {name}", make_trainer)
    return rec


def k1_in_the_data_path(dev, reddit: dict) -> int:
    """CompressedCSR and the gradient wire decode through K1 on the card,
    equal to the host decode; the Reddit-size graph is refused.  Returns
    K1's launches here."""
    from repro_torch.data import graph_data
    from repro_torch.distributed import grad_compress
    from repro_torch.kernels import ops
    n0 = ops.launches()["unpack_blocks"]
    n, deg = CSR_GRAPH
    g = graph_data.synthetic_graph(n, deg, seed=1)
    csr = graph_data.CompressedCSR.compress(g["indptr"], g["indices"], n)
    host = csr.decompress()
    t0 = time.perf_counter()
    got = csr.to(dev).decompress()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    want = torch.from_numpy(g["indices"])
    if not (torch.equal(got.cpu(), want) and torch.equal(host, want)):
        raise AssertionError("CompressedCSR: the card's decode differs")
    log(f"CompressedCSR of synthetic_graph({n}, {deg}): {len(want)} edges, "
        f"{csr.bits_per_edge():.3f} bits/edge, decoded on the card in "
        f"{ms:.3f} ms, equal to indices and to the host decode")
    N = len(reddit["indptr"]) - 1
    try:
        graph_data.CompressedCSR.compress(reddit["indptr"].cpu().numpy(),
                                          reddit["indices"].cpu().numpy(), N)
    except ValueError as e:
        log(f"CompressedCSR of the {N}-node graph refused: {e}")
    else:
        raise AssertionError(f"CompressedCSR compressed {N} nodes past "
                             f"the codec's 2**32 domain")
    gen = torch.Generator(dev).manual_seed(6)
    grad = torch.randn(GRAD_N, generator=gen, device=dev)
    idx, vals, res = grad_compress.sparsify(grad, torch.zeros_like(grad),
                                            GRAD_K)
    packed, vals16 = grad_compress.encode_wire(idx, vals)
    h_idx, h_vals = grad_compress.decode_wire(packed, vals16)
    d_idx, d_vals = grad_compress.decode_wire(packed.to(dev), vals16.to(dev))
    if not (torch.equal(d_idx.cpu(), idx.cpu())
            and torch.equal(h_idx, idx.cpu())
            and torch.equal(d_vals.cpu(), h_vals)):
        raise AssertionError("grad_compress: the card's decode_wire differs")
    ratio = grad_compress.compress_ratio(GRAD_N, GRAD_K, packed)
    log(f"grad_compress: top {GRAD_K} of {GRAD_N} coordinates, "
        f"{grad_compress.wire_bits_per_coord(packed):.3f} bits a coordinate "
        f"on the wire, ratio {ratio:.1f}; decode_wire on the card gave the "
        f"indices exactly")
    k1 = ops.launches()["unpack_blocks"] - n0
    if k1 < 2:
        raise AssertionError(f"K1 launched {k1} times for the two decodes")
    return k1


def train_lm_full(dev) -> dict:
    """internlm2-1.8b at full width (float32 params, bf16 compute, remat
    dots): a warm step, then TRAIN_STEPS timed steps on 1 x 4096 tokens and
    one profiled; the 2-layer float32 cut against the CPU at 128 tokens;
    resume through Trainer at the smoke widths."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.lm_data import TokenStream
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    from repro_torch.train.trainer import Trainer, TrainerConfig
    spec = get_config(LM_TRAIN_ARCH)
    cfg = spec.config
    opt_cfg = adamw.AdamWConfig()
    t0 = time.perf_counter()
    lm = transformer.init_params(torch.Generator(dev).manual_seed(0), cfg,
                                 dev)
    opt = adamw.init(lm, opt_cfg)
    log(f"{LM_TRAIN_ARCH}: {cfg.param_count()} float32 parameters "
        f"({cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}) and AdamW state on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    stream = TokenStream(cfg.vocab, seed=0)
    batches = [_device_batch(stream.batch(1, LM_TRAIN_SEQ), dev)
               for _ in range(TRAIN_STEPS + 2)]
    step = train_steps.make_lm_train_step(cfg, opt_cfg)
    torch.cuda.reset_peak_memory_stats()
    lm, opt, m = step(lm, opt, batches[0])
    losses = [_finite("internlm2 warm step", m["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[1:TRAIN_STEPS + 1]:
        lm, opt, m = step(lm, opt, b)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    losses = [_finite("internlm2 step", v) for v in losses]
    log(f"{LM_TRAIN_ARCH} train_4k (1 x {LM_TRAIN_SEQ}): {sec * 1e3:.3f} ms "
        f"a step, {LM_TRAIN_SEQ / sec:.1f} tok/s, peak device memory {peak} "
        f"bytes, losses {[round(v, 4) for v in losses]} (finite)")
    profile_report(f"{LM_TRAIN_ARCH} train step",
                   lambda: step(lm, opt, batches[-1]),
                   f"one step of {LM_TRAIN_SEQ} tokens")
    rec = {"ms": sec * 1e3, "tok_s": LM_TRAIN_SEQ / sec, "peak_bytes": peak,
           "losses": losses}
    del lm, opt, batches, m
    gc.collect()
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    lm = transformer.init_params(torch.Generator(dev).manual_seed(1), cut,
                                 dev)
    opt = adamw.init(lm, opt_cfg)
    b = _device_batch(TokenStream(cfg.vocab, seed=1).batch(1, LM_CUT_SEQ),
                      dev)
    rec["cut_against_cpu"] = step_against_cpu(
        f"{LM_TRAIN_ARCH} cut to 2 layers, float32, 1 x {LM_CUT_SEQ}",
        lambda p, bb: transformer.lm_loss(p, bb, cut), lm, opt, b, opt_cfg,
        LM_TRAIN_TOL)
    del lm, opt
    gc.collect()
    torch.cuda.empty_cache()

    small = spec.smoke_config()
    small_opt = adamw.AdamWConfig(lr=3e-3)
    small_step = train_steps.make_lm_train_step(small, small_opt)

    def make_trainer(ckpt_dir, total, skip):
        p = transformer.init_params(torch.Generator(dev).manual_seed(0),
                                    small, dev)
        s = TokenStream(small.vocab, seed=0)

        def it():
            while True:
                yield _device_batch(s.batch(8, 64), dev)
        data = it()
        for _ in range(skip):
            next(data)
        return Trainer(small_step, p, adamw.init(p, small_opt), data,
                       TrainerConfig(total_steps=total, ckpt_every=RESUME_N,
                                     ckpt_dir=ckpt_dir))
    resume_is_bitwise(f"{LM_TRAIN_ARCH} smoke widths (vocab "
                      f"{small.vocab}, 8 x 64 tokens)", make_trainer)
    return rec


def train_recsys(dev) -> dict:
    """din, sasrec, bert4rec and mind at their registered widths on the
    train_batch shape (bert4rec cut): a warm step, TRAIN_STEPS timed steps
    and a profiled one on one batch (made once: numpy's batch makers are
    slow on the card's host), then one step on a batch of
    RECSYS_CHECK_ROWS rows held against the CPU path on the same batch."""
    from repro_torch.configs.base import get_config
    from repro_torch.data import recsys_data as rd
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    makers = {"din": rd.din_batch, "sasrec": rd.seq_batch,
              "bert4rec": rd.bert4rec_batch, "mind": rd.mind_batch}
    out = {}
    for seed, arch in enumerate(RECSYS_ARCHS):
        spec = get_config(arch)
        cfg = spec.config
        full_n = spec.shapes["train_batch"]["batch"]
        n = RECSYS_TRAIN_CUTS.get(arch, full_n)
        opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
        params = recsys.INIT[arch](torch.Generator(dev).manual_seed(seed),
                                   cfg, dev)
        opt = adamw.init(params, opt_cfg)
        rng = np.random.default_rng(200 + seed)
        batch = _device_batch(makers[arch](rng, cfg, n), dev)
        check = _device_batch(makers[arch](rng, cfg, RECSYS_CHECK_ROWS), dev)
        step = train_steps.make_recsys_train_step(cfg, opt_cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params, opt, m = step(params, opt, batch)
        losses = [_finite(f"{arch} warm step", m["loss"])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            params, opt, m = step(params, opt, batch)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated()
        losses = [_finite(f"{arch} step", v) for v in losses]
        cut_note = "" if n == full_n else f" (cut from {full_n})"
        log(f"{arch} train_batch: {n}{cut_note} rows, {tree_numel(params)} "
            f"parameters: {sec * 1e3:.3f} ms a step, {n / sec:.1f} rows/s, "
            f"peak device memory {peak} bytes, losses "
            f"{[round(v, 5) for v in losses]} (finite)")
        out[arch] = {"n": n, "ms": sec * 1e3, "rows_s": n / sec,
                     "peak_bytes": peak, "losses": losses}
        profile_report(f"{arch} train step",
                       lambda: step(params, opt, batch),
                       f"one step of {n} rows")
        out[arch]["against_cpu"] = step_against_cpu(
            f"{arch} train_batch, a batch of {RECSYS_CHECK_ROWS} rows",
            lambda p, bb: recsys.LOSS[arch](p, bb, cfg), params, opt, check,
            opt_cfg)
        del params, opt, batch, check, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_full(dev) -> dict:
    """Phase 8 (in its own process): graphsage-reddit on its four shapes
    with K1 in its data path, internlm2-1.8b at full width, the recsys
    archs on train_batch."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    ops.reset_launches()
    rec = {}
    t0 = time.perf_counter()
    spec = get_config(GNN_ARCH)
    reddit = gnn_data("minibatch_lg", spec.shapes["minibatch_lg"], dev)
    rec["k1_launches"] = k1_in_the_data_path(dev, reddit["graph"])
    for name in GNN_SHAPES:
        rec[name] = train_gnn_shape(dev, name,
                                    reddit if name == "minibatch_lg" else None)
        if name == "minibatch_lg":
            del reddit
        gc.collect()
        torch.cuda.empty_cache()
    log(f"phase 8 GNN done in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    rec[LM_TRAIN_ARCH] = train_lm_full(dev)
    log(f"phase 8 LM done in {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    rec["recsys"] = train_recsys(dev)
    log(f"phase 8 recsys done in {time.perf_counter() - t1:.1f} s")
    launches = ops.launches()
    if launches["unpack_blocks"] < rec["k1_launches"]:
        raise AssertionError(f"phase 8: K1 counted {launches} after "
                             f"{rec['k1_launches']} data-path decodes")
    return rec


def train_child() -> None:
    """Phase 8's process: ``train_full`` on the card; its K1 launches and
    seconds go to TRAIN_RESULT for the parent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log(f"phase 8 in its own process (PYTORCH_CUDA_ALLOC_CONF="
        f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')})")
    rec = train_full(torch.device("cuda"))
    rec["seconds"] = time.perf_counter() - t0
    TRAIN_RESULT.write_text(json.dumps(rec))
    log(f"phase 8's process done in {rec['seconds']:.1f} s")


def run_train_phase() -> dict:
    """Phase 8 in a child process with TRAIN_ALLOC_CONF, after this
    process has given back its cached memory; fails if the child does.
    Returns the child's record."""
    gc.collect()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    TRAIN_RESULT.parent.mkdir(exist_ok=True)
    TRAIN_RESULT.unlink(missing_ok=True)
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=TRAIN_ALLOC_CONF)
    subprocess.run([sys.executable, "-c",
                    "import chip_smoke; chip_smoke.train_child()"],
                   cwd=ROOT, env=env, check=True, timeout=600)
    return json.loads(TRAIN_RESULT.read_text())


def train_launcher_cli() -> None:
    """Phase 1's training launcher at smoke size: 20 steps with a
    checkpoint every 10 for one arch of each family; each prints its
    result dict with two finite losses."""
    from repro_torch.launch import train
    (ROOT / "build").mkdir(exist_ok=True)
    top = tempfile.mkdtemp(prefix="launch-", dir=ROOT / "build")
    try:
        for arch in (GNN_ARCH, LM_TRAIN_ARCH, "din"):
            res = train.main(["--arch", arch, "--steps", "20",
                              "--ckpt-every", "10",
                              "--ckpt-dir", str(Path(top) / arch)])
            if res["step"] != 20 or len(res["history"]) != 2 or not \
                    np.isfinite(res["history"]).all():
                raise AssertionError(f"train --arch {arch} gave {res}")
    finally:
        shutil.rmtree(top, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 9: the multi-card layer (expert-parallel MoE over a DeviceMesh)
# --------------------------------------------------------------------------

MESH_ARCHS = (MOE_ARCH, KIMI_ARCH)
MESH_REPS = 5                  # timed calls of each path, after a warm one
MESH_TIMEOUT = 600             # seconds for the phase's process group
MESH_RESULT = ROOT / "build" / "phase9.json"
MESH_CKPT = ROOT / "build" / "phase9-ckpt"


def _rank0_log(msg: str) -> None:
    import torch.distributed as dist
    if dist.get_rank() == 0:
        log(msg)


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh_phase(seed: int) -> dict:
    """Phase 9 in a process group of its own, one NCCL rank a visible card
    (``mesh_child``), after this process has given back its cached
    memory; fails if a rank does or the group outlives MESH_TIMEOUT.
    Returns rank 0's record."""
    gc.collect()
    torch.cuda.empty_cache()
    sys.stdout.flush()
    MESH_RESULT.parent.mkdir(exist_ok=True)
    MESH_RESULT.unlink(missing_ok=True)
    world = torch.cuda.device_count()
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.mesh_child("
                               f"{r}, {world}, {port}, {seed})"], cwd=ROOT)
        for r in range(world)]
    try:
        deadline = time.monotonic() + MESH_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise AssertionError(f"phase 9: ranks exited with {bad}")
    return json.loads(MESH_RESULT.read_text())


def mesh_child(rank: int, world: int, port: int, seed: int) -> None:
    """Phase 9's rank ``rank`` of ``world``: a (1, world) mesh on the cards
    (NCCL) and the same mesh on the CPU (gloo), ``mesh_moe`` for each of
    MESH_ARCHS and ``mesh_restore``; rank 0 writes MESH_RESULT."""
    import datetime
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(rank)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = torch.device("cuda", rank)
    dist.init_process_group(
        "cpu:gloo,cuda:nccl", init_method=f"tcp://localhost:{port}",
        rank=rank, world_size=world, device_id=dev,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT))
    try:
        t0 = time.perf_counter()
        card = make_local_mesh(1, world)
        cpu = make_local_mesh(1, world, device_type="cpu")
        _rank0_log(f"phase 9: {world} NCCL rank(s), meshes (data, model) = "
                   f"(1, {world}) on the cards and on the CPU (gloo)")
        rec = {"world": world}
        for arch in MESH_ARCHS:
            rec[arch] = mesh_moe(arch, card, cpu, seed, dev)
            gc.collect()
            torch.cuda.empty_cache()
        rec["restore"] = mesh_restore(card, seed, dev)
        rec["seconds"] = time.perf_counter() - t0
        if rank == 0:
            MESH_RESULT.write_text(json.dumps(rec))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def no_drop_factor(ids: torch.Tensor, n_experts: int, M: int) -> float:
    """A capacity factor at which neither stage of ``moe_ffn_sharded`` nor
    ``moe_ffn_local`` drops a slot, for expert ids (B, S, k) of x placed
    P('data', 'model', None) over a (1, M) mesh: every rank's send load to
    every rank fits ``cap`` and every expert's load fits ``cap2``."""
    B, S, k = ids.shape
    e_loc = n_experts // M
    per_rank = ids.reshape(B, M, S // M, k).transpose(0, 1).reshape(M, -1)
    sends = max(int(torch.bincount(r // e_loc, minlength=M).max())
                for r in per_rank)
    expert = int(torch.bincount(ids.reshape(-1), minlength=n_experts).max())
    cap = max(sends, -(-expert * e_loc // M))
    return cap * M / per_rank.shape[1]


def nccl_profile(run) -> tuple[float, float, list]:
    """``run()`` under torch.profiler: the device ms inside NCCL's ranges
    (its kernels, or the copies it makes for a rank's own block), the
    device ms of every device-to-device copy in the run (those copies
    among them), and the events' names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    nccl = [e for e in ev if "nccl" in e.key.lower()]
    copies = [e for e in ev if "dtod" in e.key.lower()]
    return (sum(e.self_device_time_total for e in nccl) / 1e3,
            sum(e.self_device_time_total for e in copies) / 1e3,
            sorted({f"{e.key[:60]} x{e.count}" for e in nccl + copies}))


@torch.no_grad()
def mesh_moe(arch: str, card, cpu, seed: int, dev) -> dict:
    """One MoE layer of ``arch`` at its registered widths on 4 × 1024
    tokens drawn from ``seed``: ``moe_ffn_sharded`` on the card mesh (a)
    against ``moe_ffn_local`` at a factor where nothing drops, (b) at the
    config's factor against the same function on the CPU mesh in float32
    (tokens routed apart at a near tie, and the slots their routing moved
    across a capacity, left out and counted), (c) two runs bit-equal;
    ms per layer of both paths and the all-to-alls' device ms and bytes."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    cfg = get_config(arch).config
    d, E, k = cfg.d_model, cfg.n_experts, cfg.top_k
    M = sharding.axis_sizes(card)["model"]
    x_spec = sharding._spec((sharding.batch_axes(card), "model", None))
    e_spec = ("model", None, None)
    t0 = time.perf_counter()
    gen = torch.Generator(dev).manual_seed(seed)
    whole = moe.init_moe_params(
        gen, d, cfg.d_ff, E, device=dev,
        dtype={"float32": torch.float32,
               "bfloat16": torch.bfloat16}[cfg.param_dtype])
    x = torch.randn((LM_BATCH, LM_PROMPT, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    placed = types.SimpleNamespace(**{
        n: sharding.distribute(getattr(whole, n), sharding.Sharding(
            card, () if n == "router" else e_spec))
        for n in ("router", "w_in", "w_gate", "w_out")})
    x_dt = sharding.distribute(x, sharding.Sharding(card, x_spec))
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in whole.parameters())
    _rank0_log(f"phase 9 {arch}: one MoE layer, d {d}, d_ff {cfg.d_ff}, "
               f"{E} experts ({E // M} a card), top-{k}, {cfg.param_dtype} "
               f"weights ({weight_bytes} bytes), bf16 x of {LM_BATCH} x "
               f"{LM_PROMPT} tokens from seed {seed}, made in "
               f"{time.perf_counter() - t0:.1f} s")
    kw = dict(top_k=k, act=cfg.act, mesh=card)
    group = sharding.mesh_group(card)

    def total(*ts) -> list:
        v = torch.stack([torch.as_tensor(t, device=dev) for t in ts])
        dist.all_reduce(v, group=group)
        return [int(a) for a in v.tolist()]

    # (a) against the local path where nothing drops
    ids = moe._route(whole.router, x.reshape(-1, d), k, E)[1]
    nd = no_drop_factor(ids.reshape(LM_BATCH, LM_PROMPT, k), E, M)
    st = {}
    out_nd, _ = moe.moe_ffn_sharded(placed, x_dt, capacity_factor=nd,
                                    stats=st, **kw)
    local_nd, _ = moe.moe_ffn_local(whole, x, top_k=k, capacity_factor=nd,
                                    act=cfg.act)
    C = moe.capacity(ids.shape[0], k, E, nd)
    local_drop = int((torch.bincount(ids.reshape(-1), minlength=E) - C)
                     .clamp_min(0).sum())
    drops = total(st["send_dropped"], st["expert_dropped"])
    mine = sharding.block(local_nd, card, x_spec)
    err_nd = rel_rms(out_nd.to_local(), mine)
    _rank0_log(f"phase 9 {arch} (a) capacity factor {nd:.4f} (nothing "
               f"dropped: send {drops[0]}, expert {drops[1]}, local "
               f"{local_drop}): sharded against moe_ffn_local on the card, "
               f"RMS difference {err_nd:.6f} of the output's RMS "
               f"(tolerance {LM_DECODE_TOL}), max abs "
               f"{max_float_err(out_nd.to_local(), mine)}")
    if drops != [0, 0] or local_drop or not err_nd <= LM_DECODE_TOL:
        raise AssertionError(f"phase 9 {arch}: sharded against local at "
                             f"factor {nd}: drops {drops}, local "
                             f"{local_drop}, error {err_nd}")
    del out_nd, local_nd, mine, st

    # (c) two runs at the config's factor, bit-equal; their times
    cf = cfg.capacity_factor
    st = {}
    out, aux = moe.moe_ffn_sharded(placed, x_dt, capacity_factor=cf,
                                   stats=st, **kw)
    again, _ = moe.moe_ffn_sharded(placed, x_dt, capacity_factor=cf, **kw)
    if not torch.equal(out.to_local(), again.to_local()):
        raise AssertionError(f"phase 9 {arch}: two sharded runs differ")
    del again
    sharded_ms = 1e3 * timed_step(lambda: moe.moe_ffn_sharded(
        placed, x_dt, capacity_factor=cf, **kw), MESH_REPS)
    local_ms = 1e3 * timed_step(lambda: moe.moe_ffn_local(
        whole, x, top_k=k, capacity_factor=cf, act=cfg.act), MESH_REPS)
    a2a_ms, copy_ms, a2a_kernels = nccl_profile(
        lambda: moe.moe_ffn_sharded(placed, x_dt, capacity_factor=cf, **kw))
    for what, run in (("sharded", lambda: moe.moe_ffn_sharded(
            placed, x_dt, capacity_factor=cf, **kw)),
            ("local", lambda: moe.moe_ffn_local(
                whole, x, top_k=k, capacity_factor=cf, act=cfg.act))):
        if dist.get_rank() == 0:
            profile_report(f"phase 9 {arch} {what}", run,
                           f"{x.shape[0] * x.shape[1]} tokens")
        else:
            run()
    n_loc = x_dt.to_local().shape[0] * x_dt.to_local().shape[1]
    cap = max(int(np.ceil(n_loc * k / M * cf)), 1)
    a2a_bytes = M * cap * (2 * d * x.element_size() + 4)
    sent = total(st["send_dropped"], st["expert_dropped"])
    _rank0_log(f"phase 9 {arch} (c) capacity factor {cf}: two sharded runs "
               f"bit-equal; {sharded_ms:.3f} ms a layer sharded, "
               f"{local_ms:.3f} ms local (host clock over {MESH_REPS} "
               f"calls after a warm one); dropped slots send {sent[0]}, "
               f"expert {sent[1]} of {x.shape[0] * x.shape[1] * k}")
    _rank0_log(f"phase 9 {arch} all-to-alls: {a2a_bytes} bytes a rank a "
               f"layer (tokens out, results back, expert ids), device "
               f"{a2a_ms:.3f} ms inside NCCL's ranges under the profiler "
               f"(device-to-device copies of the whole layer: {copy_ms:.3f} "
               f"ms): {a2a_kernels}; " + (
                   "one card: the exchange was a copy within the card, no "
                   "bytes crossed between cards" if M == 1 else
                   f"{(M - 1) / M:.3f} of them cross to the other {M - 1} "
                   f"card(s)"))

    # (b) the same function on the CPU mesh, in float32
    t1 = time.perf_counter()
    xb = sharding.block(x, card, x_spec).float().cpu()
    w = [sharding.block(getattr(whole, n), card, e_spec).cpu()
         for n in ("w_in", "w_gate", "w_out")]
    cst = {}
    out_cpu, aux_cpu = moe.moe_ffn_sharded_local(
        whole.router.cpu(), *w, xb, top_k=k, capacity_factor=cf,
        act=cfg.act, model_group=cpu.get_group("model"),
        mesh_group=sharding.mesh_group(cpu), stats=cst)
    del w
    flat = xb.reshape(-1, d)
    card_ids = moe._route(placed.router.to_local(), flat.to(dev), k,
                          E)[1].sort(1).values.cpu()
    _, cpu_ids, probs = moe._route(whole.router.cpu(), flat, k, E)
    top = probs.sort(-1, descending=True).values
    tie = (top[:, k - 1] - top[:, k]) < NEAR_TIE
    apart = (card_ids != cpu_ids.sort(1).values).any(1)
    if bool((apart & ~tie).any()):
        raise AssertionError(f"phase 9 {arch}: {int((apart & ~tie).sum())} "
                             f"tokens routed apart on the card and the CPU "
                             f"at no near tie")
    shifted = (st["kept"].cpu() != cst["kept"]).any(1) & ~apart
    n_apart, n_shifted, n_tie = total(apart.sum(), shifted.sum(), tie.sum())
    cpu_drops = total(cst["send_dropped"], cst["expert_dropped"])
    moved = 4 * k * n_apart       # a slot moved shifts <= 2 groups x 2 stages
    if n_shifted > moved or sum(abs(a - b) for a, b in
                                zip(sent, cpu_drops)) > moved:
        raise AssertionError(f"phase 9 {arch}: card drops {sent}, CPU "
                             f"{cpu_drops}, {n_shifted} tokens kept apart, "
                             f"{n_apart} routed apart")
    keep = ~(apart | shifted)
    got = out.to_local().reshape(-1, d).cpu()[keep]
    err = rel_rms(got, out_cpu.reshape(-1, d)[keep])
    aux_err = abs(float(aux.to_local()) - float(aux_cpu))
    _rank0_log(f"phase 9 {arch} (b) against the CPU (gloo, float32) at "
               f"factor {cf}: drops card {sent}, CPU {cpu_drops}; "
               f"{n_apart} tokens routed apart at a near tie ({n_tie} with "
               f"a CPU margin under {NEAR_TIE}) and {n_shifted} whose kept "
               f"slots moved with them, left out; RMS difference {err:.6f} "
               f"of the output's RMS (tolerance {LM_DECODE_TOL}), max abs "
               f"{max_float_err(got, out_cpu.reshape(-1, d)[keep])}; aux "
               f"{float(aux.to_local())} against {float(aux_cpu)} "
               f"({time.perf_counter() - t1:.1f} s on the CPU)")
    if not err <= LM_DECODE_TOL or not aux_err <= 1e-3 * abs(float(aux_cpu)):
        raise AssertionError(f"phase 9 {arch}: card against CPU: error "
                             f"{err}, aux {aux_err}")
    return {"no_drop_factor": nd, "no_drop_err": err_nd,
            "sharded_ms": sharded_ms, "local_ms": local_ms,
            "a2a_device_ms": a2a_ms, "dtod_copy_ms": copy_ms,
            "a2a_kernels": a2a_kernels,
            "a2a_bytes": a2a_bytes, "drops": sent, "cpu_drops": cpu_drops,
            "apart": n_apart, "shifted": n_shifted, "cpu_err": err,
            "aux": float(aux.to_local()), "aux_cpu": float(aux_cpu)}


def mesh_restore(card, seed: int, dev) -> dict:
    """granite-moe-1b-a400m's whole parameter tree placed on the card mesh
    by ``lm_param_spec`` (preset tp), saved, and restored through
    ``restore(shardings=)`` into a fresh module: every leaf a DTensor with
    the saved placements and torch.equal local blocks."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import transformer as tfm
    cfg = get_config(MOE_ARCH).config
    params = tfm.init_params(torch.Generator(dev).manual_seed(seed), cfg,
                             dev)
    rule = sharding.lm_param_spec
    sharding.distribute_tree(params, sharding.tree_param_shardings(
        params, card, rule))
    group = sharding.mesh_group(card)
    if dist.get_rank() == 0:
        shutil.rmtree(MESH_CKPT, ignore_errors=True)
    dist.barrier(group=group)
    try:
        mgr = CheckpointManager(str(MESH_CKPT))
        t0 = time.perf_counter()
        mgr.save(1, params)
        t1 = time.perf_counter()
        template = tfm.LM(cfg, "meta")
        got, step = mgr.restore(template, shardings=sharding.
                                tree_param_shardings(template, card, rule))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        leaves = sharded = 0
        for (name, a), (_, b) in zip(params.named_parameters(),
                                     got.named_parameters()):
            if not (sharding.is_dtensor(b) and b.placements == a.placements
                    and torch.equal(a.to_local(), b.to_local())):
                raise AssertionError(f"phase 9 restore: {name} differs")
            leaves += 1
            sharded += any(p.is_shard() for p in b.placements)
        n_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        if step != 1 or leaves != len(list(template.parameters())):
            raise AssertionError(f"phase 9 restore: step {step}, {leaves} "
                                 f"leaves")
        _rank0_log(f"phase 9 restore: {MOE_ARCH}'s {leaves} leaves "
                   f"({n_bytes} bytes, {sharded} sharded by lm_param_spec "
                   f"tp) saved in {t1 - t0:.1f} s and restored onto the "
                   f"mesh in {t2 - t1:.1f} s: every leaf a DTensor with its "
                   f"placements and torch.equal local blocks")
        return {"leaves": leaves, "sharded": sharded, "bytes": n_bytes,
                "save_s": t1 - t0, "restore_s": t2 - t1}
    finally:
        dist.barrier(group=group)
        if dist.get_rank() == 0:
            shutil.rmtree(MESH_CKPT, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 10: the examples on the card, the dry-run in child processes
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart", "search_engine", "recsys_retrieval",
            "gnn_sampling", "train_lm")
QUICKSTART_KERNELS = ("unpack_blocks", "gallop_tiles",
                      "packed_gallop_batched")       # K1, K2, K3
DRYRUN_CELLS = (("internlm2-1.8b", "decode_32k", "multipod"),
                ("paper-index", "svs_batch", "pod"))
DRYRUN_OUT = ROOT / "build" / "phase10-dryrun"
LM_DEMO_CKPT = ROOT / "build" / "phase10-lm-demo"
DRYRUN_TIMEOUT = 300


def dryrun_child() -> None:
    """One dry-run cell in this process (argv: arch shape mesh out dir),
    then fatal if it initialised CUDA."""
    from repro_torch.launch import dryrun
    arch, shape, mesh, out = sys.argv[1:5]
    dryrun.run_cell(arch, shape, mesh, out)
    if torch.cuda.is_initialized():
        raise SystemExit(f"the dry-run of {arch} {shape} initialised CUDA")
    print("cuda initialised: False", flush=True)


def run_examples_phase(dev) -> dict:
    """Phase 10 (see the module docstring)."""
    import importlib
    from repro_torch.kernels import ops
    from repro_torch.launch import roofline
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    shutil.rmtree(LM_DEMO_CKPT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = [(cell, subprocess.Popen(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.dryrun_child()",
         *cell, str(DRYRUN_OUT)], cwd=ROOT, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        for cell in DRYRUN_CELLS]
    out = {}
    try:
        for name in EXAMPLES:
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            kw = {"ckpt_dir": str(LM_DEMO_CKPT)} if name == "train_lm" else {}
            ops.reset_launches()
            t0 = time.perf_counter()
            res = mod.main(dev, **kw)
            torch.cuda.synchronize()
            took = time.perf_counter() - t0
            launched = {k: v for k, v in ops.launches().items() if v}
            out[name] = {"s": took, "launches": launched}
            log(f"phase 10: example {name}: {took:.1f} s, launches "
                f"{launched}")
            if name == "quickstart":
                missing = [k for k in QUICKSTART_KERNELS
                           if not launched.get(k)]
                if missing:
                    raise AssertionError(f"quickstart launched no "
                                         f"{missing} on the card")
            if name == "search_engine":
                for (codec, B), r in res.items():
                    log(f"phase 10: search_engine {codec} B={B}: "
                        f"{r['ms_per_query']} ms/query, {r['hits']} hits, "
                        f"{r['bits_per_int']} bits/int")
        log(f"phase 10: card {nvidia_smi_line()}")
        for cell, child in children:
            stdout, stderr = child.communicate(timeout=DRYRUN_TIMEOUT)
            print(stdout, end="", flush=True)
            record = DRYRUN_OUT / f"{cell[0]}__{cell[1]}__{cell[2]}.json"
            if child.returncode != 0 or "OK" not in stdout or \
                    "cuda initialised: False" not in stdout or \
                    not record.exists():
                raise AssertionError(f"the dry-run of {cell} failed "
                                     f"(exit {child.returncode}):\n"
                                     f"{stderr[-3000:]}")
    finally:
        for _, child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        shutil.rmtree(LM_DEMO_CKPT, ignore_errors=True)
    log("phase 10: the dry-run's roofline rows (analysis with H100 SXM "
        "700 W data-sheet constants, not a measurement):\n"
        + roofline.format_table(roofline.load_results(str(DRYRUN_OUT))))
    return out


def phase_done(k: int, t0: float) -> float:
    now = time.perf_counter()
    log(f"phase {k} done in {now - t0:.1f} s")
    return now


def time_kernels(recorders, launches: dict, save_dir=None) -> list:
    """Phase 4: each recorded kernel timed at its largest main-path call
    (K1, K3, K5 and K7 also at the largest call of their most frequent
    size, with their calls by size), K2b on 8 copies of K2a's row; each
    must equal its plain version there.  Returns
    the ``kernels`` records; with ``save_dir`` also saves every recorded
    kernel's operands and one tile of K8's."""
    rows, saved = [], {}
    for rec in recorders:
        if rec.best is None:
            raise AssertionError(f"{rec.name} was never called on the main "
                                 f"path")
        res = TIMERS[rec.name](*rec.best)
        rows.append((rec.name, res))
        if rec.name == "gallop_tiles":
            rows.append(("gallop_tiles_batched",
                         time_k2(*rec.best, batched=8)))
        saved[rec.name] = (rec.name, *rec.best)
        if rec.bucket is None:
            continue
        bucket, freq_args = rec.most_frequent()
        freq = TIMERS[rec.name](*freq_args)
        if freq["max_abs_err"]:
            raise AssertionError(f"{rec.name}: kernel differs from plain at "
                                 f"the most frequent main-path call size")
        key = f"{rec.by.lower()}_histogram"
        res[key] = {str(k): v for k, v in sorted(rec.counts.items())}
        res["frequent"] = freq
        saved[f"{rec.name}@{rec.by}={bucket}"] = (rec.name, *freq_args)
        log(f"{rec.name} calls over phase 3 by {rec.by} (the next power of "
            f"two): {res[key]}; most frequent {rec.by} <= {bucket}, timed at "
            f"{freq.pop('shape')}: " + ", ".join(f"{k} {v}"
                                                  for k, v in freq.items()))
    if save_dir is not None:
        # K8's launch path at one tile of gemma-7b's heads, for host_us
        q1, k1, v1 = flash_inputs(8, (1, 64, 64, 16, 16, 256), torch.bfloat16,
                                  torch.device("cuda"))
        saved["flash_attention@tile"] = ("flash_attention", (q1, k1, v1),
                                         {"causal": True})
        save_operands(save_dir, saved)
    kernels = []
    for kname, res in rows:
        if res["max_abs_err"]:
            raise AssertionError(f"{kname}: kernel differs from plain at the "
                                 f"main-path shape: {res['max_abs_err']}")
        notes = {k: res.pop(k) for k in ("shape", "window_bytes") if k in res}
        log(f"{kname} at {notes.pop('shape')}: " + ", ".join(
            f"{k} {v}" for k, v in {**res, **notes}.items()))
        source, replaces = REPLACES[kname]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": launches[kname], **res})
    return kernels


def save_operands(save_dir: str, entries: dict) -> None:
    """Write phase 4's operand sets (key → (kernel name, args, kwargs)) to
    ``save_dir/operands.pt``, tensors on the host, for
    ``repro_torch/launch/kernel_times.py`` to time other trees' kernels on."""
    host = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
    out = {key: (name, tuple(host(a) for a in args),
                 {k: host(v) for k, v in kwargs.items()})
           for key, (name, args, kwargs) in entries.items()}
    Path(save_dir).mkdir(parents=True, exist_ok=True)
    torch.save(out, Path(save_dir) / "operands.pt")
    log(f"phase 4 operands of {sorted(out)} saved to {save_dir}/operands.pt")


def serve_live_cli() -> None:
    """Phase 1's live server, mutable index and durable index through the
    serve CLI, at its default size; each must print its differential line,
    the durable one also its chaos and recovery lines."""
    from repro_torch.launch import serve
    (ROOT / "build").mkdir(exist_ok=True)
    wal_dir = tempfile.mkdtemp(prefix="wal-", dir=ROOT / "build")
    try:
        for flags, lines in (
                (["--qps", "500", "--batch", "16", "--warmup"],
                 ["[serve] differential check:"]),
                (["--mutate", "120", "--delete-frac", "0.2", "--batch", "16"],
                 ["[serve] differential check:"]),
                (["--qps", "500", "--wal", str(Path(wal_dir) / "wal"),
                  "--mutate", "64", "--chaos", "crash@wal.append.add:40",
                  "--batch", "16"],
                 ["[serve] chaos: injected crash",
                  "[serve] differential check:", "[serve] recovery check:"])):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                serve.main(flags)
            print(out.getvalue(), end="", flush=True)
            for line in lines:
                if line not in out.getvalue():
                    raise AssertionError(f"serve {' '.join(flags)} printed "
                                         f"no {line!r} line")
    finally:
        shutil.rmtree(wal_dir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Smoke run of the port on one "
                                            "CUDA card.")
    p.add_argument("--save-operands", metavar="DIR", default=None,
                   help="also write the operands phase 4 times the kernels "
                        "on to DIR/operands.pt")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of phase 9's MoE layers and their input")
    args = p.parse_args(argv)
    save_dir = args.save_operands
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on the card",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    # float32 products in full float32 on the card (no TF32), as on the CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{name}, compute capability {torch.cuda.get_device_capability(0)}")
    from repro_torch.core import bitpack
    from repro_torch.index import corpus as corpus_lib, engine
    from repro_torch.kernels import (_build, bitpack_pack, bitunpack,
                                     intersect_gallop, megakernel, svb_decode)
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"built {sorted(libs)} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")

    # a few queries through the CLI entry point, at its default size
    seq = serve.main(["--queries", "8", "--cache", "--shared-vocab"])
    bat = serve.main(["--queries", "8", "--cache", "--shared-vocab",
                      "--batch", "4", "--warmup"])
    if bat["hits"] != seq["hits"]:
        raise AssertionError("serve --batch gave other hits than the "
                             "sequential serve")
    for codec in ("streamvbyte", "auto"):
        alt = serve.main(["--queries", "8", "--cache", "--shared-vocab",
                          "--codec", codec])
        if alt["hits"] != seq["hits"]:
            raise AssertionError(f"serve --codec {codec} gave other hits "
                                 f"than the fastpfor serve")
    for flags in (["--resident"], ["--pipeline", "2"], ["--shards", "2"]):
        alt = serve.main(["--queries", "8", "--cache", "--shared-vocab",
                          *flags])
        if alt["hits"] != seq["hits"]:
            raise AssertionError(f"serve {' '.join(flags)} gave other hits "
                                 f"than the sequential serve")
    serve_live_cli()
    for arch in (LM_ARCH, MOE_ARCH, KIMI_ARCH):
        lm = serve.main(["--arch", arch, "--tokens", "4"])
        if tuple(lm["tokens"].shape) != (4, 4):
            raise AssertionError(f"serve --arch {arch} gave tokens of shape "
                                 f"{tuple(lm['tokens'].shape)}")
    for arch in RECSYS_ARCHS:
        rs = serve.main(["--arch", arch])
        if tuple(rs["scores"].shape) != (4,) or not bool(
                torch.isfinite(rs["scores"]).all()):
            raise AssertionError(f"serve --arch {arch} gave scores "
                                 f"{rs['scores']}")
    train_launcher_cli()
    t_phase = phase_done(1, t_phase)

    t0 = time.perf_counter()
    corpus = corpus_lib.synthesize(n_docs=N_DOCS, n_queries=N_QUERIES,
                                   seed=5, shared_vocab=True)
    truth = [engine.brute_force(corpus.postings, q) for q in corpus.queries]
    lens = sorted(len(p) for p in corpus.postings)
    log(f"corpus: {corpus.n_docs} docs, {corpus.n_terms} terms, "
        f"{sum(lens)} postings, lists {lens[0]} … {lens[-1]}, "
        f"{len(corpus.queries)} queries (no cut); synthesis + brute force "
        f"{time.perf_counter() - t0:.1f} s")

    check_k2(dev)
    k3 = check_k3(dev)
    check_k4(dev)
    check_lean_refusals(dev, check_k5(dev, k3))
    del k3
    check_k6(dev)
    check_k7(dev)
    check_k8(dev)
    log(index_resources())
    t_phase = phase_done(2, t_phase)

    recorders = [
        Recorder(bitunpack, "unpack_blocks", lambda *a, **k: a[2].shape[0],
                 bucket=lambda *a, **k: 1 << max(a[2].shape[0] - 1, 0)
                 .bit_length()),
        Recorder(intersect_gallop, "gallop_tiles",
                 lambda r, f: r.shape[0] * max((f.shape[0] - 1).bit_length(), 1)),
        Recorder(intersect_gallop, "packed_gallop_batched",
                 lambda *a, **k: a[5].shape[1] * a[0].shape[1],
                 bucket=lambda *a, **k: a[5].shape[1], by="C"),
        Recorder(megakernel, "decoded_fold_batched",
                 lambda r, v, f, a: f.shape[0] * r.numel()
                 * max((f.shape[2] - 1).bit_length(), 1)),
        Recorder(megakernel, "packed_fold_batched",
                 lambda *a, **k: a[6].numel(),
                 bucket=lambda *a, **k: a[6].shape[2], by="C"),
        Recorder(svb_decode, "unpack_svb_blocks",
                 lambda *a, **k: a[0].numel(),
                 bucket=lambda *a, **k: 1 << max(a[0].shape[0] - 1, 0)
                 .bit_length()),
    ]
    torch.cuda.reset_peak_memory_stats()
    main_path = run_main_path(dev, corpus, truth)
    for rec in recorders:
        rec.restore()
    recorders.append(Recorder(bitpack_pack, "pack_blocks_padded",
                              lambda d, w: d.shape[0]))
    main_path["launches"]["pack_blocks_padded"] += pack_pass(dev, corpus)
    recorders[-1].restore()
    longest = max(corpus.postings, key=len)
    check_k1(dev, [
        ("longest list of the bp-d1 index", main_path["longest"]),
        ("longest posting list of the corpus, encoded bp-d1",
         bitpack.encode(longest, mode="d1").to(dev))])
    t_phase = phase_done(3, t_phase)

    kernels = time_kernels(recorders, main_path["launches"], save_dir)
    t_phase = phase_done(4, t_phase)

    # free the index and its recorded operands before the LM
    del recorders, main_path, corpus, truth, longest
    gc.collect()
    torch.cuda.empty_cache()
    lm_path = serve_full_width(dev)
    k8 = {}
    for what, (q, k, v, kw) in lm_path.pop("timed").items():
        k8[what] = time_k8(q, k, v, **kw)
        if not k8[what]["max_abs_err"] <= 0.05:
            raise AssertionError(f"K8 differs from plain at the {what} shape")
        log(f"flash_attention ({what}) at {k8[what].pop('shape')}: " + ", ".join(
            f"{key} {val}" for key, val in k8[what].items()))
    source, replaces = REPLACES["flash_attention"]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": source, "replaces": replaces,
                    "launches": lm_path["launches"], **k8.pop("prefill"),
                    "other_shapes": k8})
    t_phase = phase_done(5, t_phase)

    # free gemma-7b before the MoE LMs
    del lm_path, q, k, v
    gc.collect()
    torch.cuda.empty_cache()
    log(f"after phase 5: {torch.cuda.memory_allocated()} bytes allocated")
    serve_moe(dev)
    t_phase = phase_done(6, t_phase)
    run_recsys_phase()
    t_phase = phase_done(7, t_phase)
    train = run_train_phase()
    k1 = next(k for k in kernels if k["name"] == "unpack_blocks")
    k1["launches"] += train["k1_launches"]
    log(f"phase 8: K1 launched {train['k1_launches']} times in the data "
        f"path (added to K1's main-path launches, now {k1['launches']})")
    t_phase = phase_done(8, t_phase)
    run_mesh_phase(args.seed)
    t_phase = phase_done(9, t_phase)
    run_examples_phase(dev)
    phase_done(10, t_phase)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
