"""Public wrappers around the hand-written Hopper kernels, and the path probe.

Port of ``src/repro/kernels/ops.py``.  Where the reference probes the JAX
backend for compiled or interpret Pallas, the port probes each call's
tensors (``kernel_path``): CUDA tensors on a card of compute capability
≥ (9, 0) launch the kernels, CPU tensors take the plain versions, and a
CUDA card below sm_90 raises.  There is no override that forces the plain
path on the card.

The reference's ``GALLOP_VMEM_CAP`` (f must fit 4 MiB of VMEM, else jnp)
has no Hopper counterpart: the kernels read their long operands from global
memory, so no size of a CUDA tensor leaves the kernel.  For the same reason
the fold entry points have no ``_fold_scan`` fallback: every CUDA fold stack
goes to K4 or K5 whole.

``launches()`` reads the per-kernel launch counts, ``flash_routes()`` K8's
calls by route, ``reset_launches()`` sets both to 0; ``thread_tally()``
counts the calling thread's launches alone.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack as core_bitpack
from repro_torch.core import deltas as core_deltas
from repro_torch.kernels import _build
from repro_torch.kernels import bitpack_pack as _bitpack_pack
from repro_torch.kernels import bitunpack as _bitunpack
from repro_torch.kernels import compact_rows as _compact_rows
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import intersect_gallop as _intersect_gallop
from repro_torch.kernels import megakernel as _megakernel
from repro_torch.kernels import svb_decode as _svb_decode

ROWS = _bitunpack.ROWS
LANES = _bitunpack.LANES

kernel_path = _build.kernel_path


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    asks for the CPU.  Raises RuntimeError when CUDA is wanted and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def launches() -> dict[str, int]:
    return dict(_build.LAUNCHES)


def reset_launches() -> None:
    """Set every launch count, and K8's count of calls by route, to 0."""
    with _build._count_lock:
        for k in _build.LAUNCHES:
            _build.LAUNCHES[k] = 0
    for k in _flash_attention.ROUTES:
        _flash_attention.ROUTES[k] = 0


thread_tally = _build.thread_tally


def flash_routes() -> dict[str, int]:
    """K8's calls on the card by route ("tc", "split", "simt")."""
    return dict(_flash_attention.ROUTES)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def unpack_blocks(padded_words, widths, seeds, mode: str = "d1"):
    """K1 on block-padded words, the reference's signature:
    padded_words (K, R, 128), widths/seeds (K,) → (K, R, 128) int32 bit
    patterns of the decoded uint32 values."""
    K, R, _ = padded_words.shape
    offsets = torch.arange(K, dtype=torch.int32,
                           device=padded_words.device) * R
    return _bitunpack.unpack_blocks(padded_words.reshape(K * R, LANES),
                                    offsets, widths, seeds, mode, R)


def decode_packed(plist: core_bitpack.PackedList) -> torch.Tensor:
    """K1 decode of a PackedList in place (flat words + row offsets) → flat
    padded values (padded_n,) as int32 bit patterns."""
    return core_bitpack.decode(plist)


def unpack_svb_blocks(ctrl, data, doffs, seeds, mode: str = "d1",
                      block_rows: int = 1):
    """K7: Stream VByte decode of (K, 8·block_rows) control words over the
    (DW,) data words → (K, block_rows, 128) int32 bit patterns."""
    return _svb_decode.unpack_svb_blocks(ctrl, data, doffs, seeds, mode,
                                         block_rows)


# --------------------------------------------------------------------------
# encode
# --------------------------------------------------------------------------

def pack_blocks(values, seeds, widths, mode: str = "d1"):
    """values: (K, 32, 128) sorted uint32 values (int32 bit patterns), seeds
    and widths (K,) → (K, 32, 128) block-padded packed words (int32 bit
    patterns): the deltas in torch ops, then K6, as the reference computes
    them in jnp before its Pallas kernel."""
    d = core_deltas.encode_deltas(values, seeds, mode)
    return _bitpack_pack.pack_blocks_padded(core_deltas.to_i32(d), widths)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True, kv_len=None,
                    bq: int = 512, bk: int = 512):
    """K8: flash attention forward (GQA-aware), q (B, Sq, H, D), k/v
    (B, Sk, Hkv, D) → (B, Sq, H, D) in q's dtype; see
    kernels/flash_attention.py."""
    return _flash_attention.flash_attention(q, k, v, causal=causal,
                                            kv_len=kv_len, bq=bq, bk=bk)


# --------------------------------------------------------------------------
# intersection
# --------------------------------------------------------------------------

def intersect_gallop(r, f):
    """K2: mask of r (M,) in sorted f (N,)."""
    return _intersect_gallop.gallop_tiles(r, f)


def intersect_gallop_batch(r, f):
    """K2, batched: r (B, M), f (B, N) → (B, M) mask."""
    return _intersect_gallop.gallop_tiles_batched(r, f)


def intersect_packed_batch(r, words, widths, offsets, maxes, blk_ids,
                           exc_pos, exc_add, mode: str, block_rows: int):
    """K3: decode only each row's candidate blocks and search each candidate
    in the one of them that can hold it (the plain version gallops over
    them all) → (B, M) mask."""
    return _intersect_gallop.packed_gallop_batched(
        r, words, widths, offsets, maxes, blk_ids, exc_pos, exc_add,
        mode=mode, block_rows=block_rows)


# --------------------------------------------------------------------------
# fused folds (K4, K5)
# --------------------------------------------------------------------------

def intersect_fold_batch(r, valid, folds, fold_active):
    """K4: AND the gallop hits of the whole (J, B, N) decoded fold stack into
    ``valid`` in one launch; J = 0 returns ``valid`` without one."""
    if folds.shape[0] == 0:
        return valid
    return _megakernel.decoded_fold_batched(r, valid, folds, fold_active)


def intersect_packed_fold(r, valid, pk, pk_active, mode: str,
                          block_rows: int):
    """K5: decode each (j, b) slot's candidate blocks and AND the gallop hits
    of the whole (Jp, B, ...) packed stack into ``valid``.  ``pk`` is the
    operand tuple in the reference's ``batch._compose_pk`` order (words,
    widths, offsets, maxes, blk_ids, exc_pos, exc_add), as
    ``index.batch._stack_packed`` returns it; Jp = 0 returns ``valid``."""
    words, widths, offsets, maxes, blk_ids, exc_pos, exc_add = pk
    if words.shape[0] == 0:
        return valid
    return _megakernel.packed_fold_batched(
        r, valid, words, widths, offsets, maxes, blk_ids, exc_pos, exc_add,
        pk_active, mode=mode, block_rows=block_rows)


# --------------------------------------------------------------------------
# result compaction
# --------------------------------------------------------------------------

def compact_rows(r, valid, max_results: int):
    """r (B, M) int32 and valid (B, M) bool → (B, C + 1) int32, C =
    min(M, max_results): each row's first min(count, C) survivors in order,
    SENTINEL after them, the full count in column C (see
    kernels/compact_rows.py)."""
    return _compact_rows.compact_rows(r, valid, max_results)
