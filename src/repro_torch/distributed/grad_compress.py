"""Sparse gradient compression for the data-parallel axis — the paper's
codec as a distributed-training feature.

Port of ``src/repro/distributed/grad_compress.py``.  Per step a worker
sends only the top-k gradient coordinates; the sorted index list is
delta + bit-packed with the paper's codec (the port's ``core.bitpack``)
and the values ship as bf16.  An error-feedback accumulator keeps the
residual.

- ``sparsify`` / ``apply_sparse``: fixed-k top-k + error feedback on
  tensors.  Among equal magnitudes the lower index is kept, as
  ``lax.top_k`` keeps it (a stable descending sort, then the first k).
- ``encode_wire`` / ``decode_wire``: the (indices, values) pair on the
  wire.  ``decode_wire`` decodes where the ``PackedList`` lives: on a
  CUDA card through the integrated unpack kernel (K1).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitpack


def sparsify(grad_flat, residual, k: int):
    """Top-k magnitude selection with error feedback.

    Returns (indices (k,) int32 sorted, values (k,) float32,
    new_residual)."""
    acc = grad_flat + residual
    order = torch.sort(torch.abs(acc), descending=True, stable=True).indices
    idx = torch.sort(order[:k]).values
    vals = acc[idx]
    new_res = acc.clone()
    new_res[idx] = 0.0
    return idx.to(torch.int32), vals, new_res


def apply_sparse(shape_like, idx, vals):
    """Densify a sparse update onto zeros_like(shape_like)."""
    out = torch.zeros_like(shape_like)
    out[idx.long()] = vals.to(out.dtype)
    return out


def encode_wire(idx, vals):
    """Host-side wire format: bit-packed sorted indices (a ``PackedList`` of
    CPU tensors, encoded on the host) + bf16 values (a CPU tensor)."""
    idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else idx
    packed = bitpack.encode(np.asarray(idx), mode="d1")
    vals16 = torch.as_tensor(vals).detach().cpu().to(torch.bfloat16)
    return packed, vals16


def decode_wire(packed: bitpack.PackedList, vals16):
    """(indices int32, values float32), decoded on the PackedList's
    device."""
    idx = bitpack.decode(packed)[: packed.n]
    return idx.to(torch.int32), torch.as_tensor(vals16).float()


def wire_bits_per_coord(packed: bitpack.PackedList) -> float:
    """bits per transmitted coordinate: packed index + 16-bit value."""
    return bitpack.bits_per_int(packed) + 16.0


def compress_ratio(n_params: int, k: int,
                   packed: bitpack.PackedList) -> float:
    """Dense f32 all-reduce bytes vs sparse wire bytes."""
    dense_bits = n_params * 32
    sparse_bits = wire_bits_per_coord(packed) * k
    return dense_bits / max(sparse_bits, 1)
