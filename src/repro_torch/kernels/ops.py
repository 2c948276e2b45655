"""Public wrappers around the hand-written Hopper kernels, and the path probe.

Port of ``src/repro/kernels/ops.py``.  Where the reference probes the JAX
backend for compiled or interpret Pallas, the port probes each call's
tensors (``kernel_path``): CUDA tensors on a card of compute capability
≥ (9, 0) launch the kernels, CPU tensors take the plain versions, and a
CUDA card below sm_90 raises.  There is no override that forces the plain
path on the card.

The reference's ``GALLOP_VMEM_CAP`` (f must fit 4 MiB of VMEM, else jnp)
has no Hopper counterpart: the kernels read their long operands from global
memory, so no size of a CUDA tensor leaves the kernel.

``launches()`` reads the per-kernel launch counts, ``reset_launches()`` sets
them to 0.
"""

from __future__ import annotations

import torch

from repro_torch.core import bitpack as core_bitpack
from repro_torch.kernels import _build
from repro_torch.kernels import bitunpack as _bitunpack
from repro_torch.kernels import intersect_gallop as _intersect_gallop

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
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0


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
    """K3: decode only each row's candidate blocks, then gallop the
    candidates over them → (B, M) mask."""
    return _intersect_gallop.packed_gallop_batched(
        r, words, widths, offsets, maxes, blk_ids, exc_pos, exc_add,
        mode=mode, block_rows=block_rows)
