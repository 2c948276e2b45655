"""Sorted-list intersection (paper §5).

Port of ``src/repro/core/intersect.py``.  Every function takes
SENTINEL-padded int32 tensors and returns a match mask over ``r``; matches
are compacted with ``compact``.

  intersect_gallop  all |r| branchless binary searches in parallel (plain
                    version of the K2 kernel; the reference's is a jnp
                    searchsorted, which computes the same mask)
  intersect_tiled   the V1/V3 tile walk (ratio ≤ TILED_MAX_RATIO)
  intersect_packed_candidates / _batch
                    skip-aware partial decode of a compressed long list:
                    decode only candidate blocks, then gallop (the plain
                    version of K3, whose kernel searches each candidate in
                    the one block that can hold it)
  intersect_auto    the host-side ratio dispatch
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.bitunpack import decode_candidates

SENTINEL = np.int32(2**31 - 1)

# ratio threshold of the dispatcher (paper: V1 <50:1, V3 <1000:1, then
# galloping); the reference's value, which changes no result
TILED_MAX_RATIO = 32.0


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def pad_to(values: np.ndarray, size: int) -> np.ndarray:
    v = np.asarray(values, dtype=np.int32)
    out = np.full(size, SENTINEL, dtype=np.int32)
    out[: len(v)] = v
    return out


def pad_to_tensor(values: torch.Tensor, size: int) -> torch.Tensor:
    """Device counterpart of ``pad_to``: int32 values + SENTINEL tail."""
    out = torch.full((size,), int(SENTINEL), dtype=torch.int32,
                     device=values.device)
    out[: values.shape[0]] = values
    return out


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, without waiting for the
    device: a CUDA upload is staged in pinned memory and copied with
    ``non_blocking=True`` (a plain ``.to`` synchronises the stream)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def pow2_bucket(n: int, floor: int = 128) -> int:
    size = floor
    while size < n:
        size *= 2
    return size


def compact(vals: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Compact matched values to the front of a SENTINEL-filled buffer of the
    same length.  Returns (padded vals, count); the count is a host int (the
    reference returns a device scalar that every caller converts)."""
    kept = vals[mask]
    out = torch.full_like(vals, int(SENTINEL))
    out[: kept.shape[0]] = kept
    return out, int(kept.shape[0])


# --------------------------------------------------------------------------
# galloping: branchless lower bound, all lanes in parallel
# --------------------------------------------------------------------------

def intersect_gallop(r: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Membership of each r in sorted f, SENTINEL lanes false.  r (..., M)
    and f (..., N) share leading dims; N ≥ 1 need not be a power of two.
    Round k probes ``lo + 2**k`` and keeps it when ``f[probe] < r``, as the
    reference kernel's ``_gallop_body`` and the CUDA kernel do."""
    N = f.shape[-1]
    r64 = r.to(torch.int64)
    f64 = f.to(torch.int64)
    lo = torch.full(r.shape, -1, dtype=torch.int64, device=r.device)
    for k in range((N - 1).bit_length() - 1, -1, -1):     # ⌈log2 N⌉ rounds
        probe = lo + (1 << k)
        v = torch.gather(f64, -1, probe.clamp(max=N - 1))
        lo = torch.where((probe < N) & (v < r64), probe, lo)
    pos = (lo + 1).clamp(max=N - 1)
    hit = torch.gather(f64, -1, pos) == r64
    return hit & (r != int(SENTINEL))


# --------------------------------------------------------------------------
# tiled merge (V1/V3 analogue)
# --------------------------------------------------------------------------

# Host waits for the card in one ``intersect_tiled`` on CUDA: ``torch.isin``
# takes its sort path at these sizes (``_unique`` of each operand), which
# waits 3 times (torch 2.11, read under ``set_sync_debug_mode("warn")``).
ISIN_SYNCS = 3

def intersect_tiled(r: torch.Tensor, f: torch.Tensor, tile_r: int = 128,
                    tile_f: int = 1024) -> torch.Tensor:
    """Mask of the tile-granular two-pointer merge.

    The reference walks (tile_r, tile_f) windows, advancing the one whose max
    is not larger.  For r and f strictly increasing up to their SENTINEL tails
    (candidate buffers and decoded posting lists are) the walk meets every
    pair of tiles that share a value: leaving r's tile I before f's tile J
    would need max(I) ≤ max(j) < min(J) ≤ x ≤ max(I) for some j < J, and
    symmetrically.  So the walk's mask is exact membership, which this
    computes in one pass instead of a data-dependent host loop."""
    m, n = r.shape[0], f.shape[0]
    if m % tile_r or n % tile_f:
        raise ValueError("pad inputs to tile multiples")
    return torch.isin(r, f) & (r != int(SENTINEL))


# --------------------------------------------------------------------------
# candidate-block partial decode (posting-source layer)
# --------------------------------------------------------------------------

def intersect_packed_candidates(r, words, widths, offsets, maxes, blk_ids,
                                exc_pos, exc_add, mode: str,
                                block_rows: int = 32) -> torch.Tensor:
    """Skip-aware partial-decode intersection of padded candidates ``r``
    (M,) against one compressed list in the batch-uniform layout: decode the
    C candidate blocks (``decode_candidates``), then gallop over the
    C·block window."""
    flat = decode_candidates(words, widths, offsets, maxes, blk_ids,
                             exc_pos, exc_add, mode=mode,
                             block_rows=block_rows)
    return intersect_gallop(r, flat)


def intersect_packed_batch(r, words, widths, offsets, maxes, blk_ids,
                           exc_pos, exc_add, mode: str,
                           block_rows: int = 32) -> torch.Tensor:
    """Batched form: every operand has a leading batch axis — r (B, M),
    words (B, T, 128), widths/offsets/maxes (B, K), blk_ids (B, C),
    exc_pos/exc_add (B, E).  Returns a (B, M) mask."""
    rows = [intersect_packed_candidates(
        r[b], words[b], widths[b], offsets[b], maxes[b], blk_ids[b],
        exc_pos[b], exc_add[b], mode=mode, block_rows=block_rows)
        for b in range(r.shape[0])]
    if not rows:
        return torch.zeros(r.shape, dtype=torch.bool, device=r.device)
    return torch.stack(rows)


# --------------------------------------------------------------------------
# dispatcher (paper's heuristic, §5)
# --------------------------------------------------------------------------

def intersect_auto(r, f, r_count: int, f_count: int) -> torch.Tensor:
    """Host-side ratio dispatch (lengths are metadata, as in the paper)."""
    ratio = max(f_count, 1) / max(r_count, 1)
    if ratio <= TILED_MAX_RATIO:
        tile_r = min(128, r.shape[0])
        tile_f = min(1024, f.shape[0])
        return intersect_tiled(r, f, tile_r=tile_r, tile_f=tile_f)
    return intersect_gallop(r, f)
