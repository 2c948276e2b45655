"""Synthetic graphs + compressed CSR adjacency.

Port of ``src/repro/data/graph_data.py``.  ``synthetic_graph`` and
``molecule_batch`` are the reference's numpy draws, line for line, so the
same seed gives byte-equal arrays (the CSR row counts come from
``np.bincount`` where the reference calls ``np.add.at``: the same counts,
without ``np.add.at``'s per-element cost, which took minutes at Reddit's
117M edges on the card's host).  ``CompressedCSR`` stores the neighbour
array with the port's codec (``core.bitpack``, bp-d1 over the rows'
concatenation, row i's neighbour v coded as i * n_nodes + v), and
``decompress`` decodes where the ``PackedList`` lives: on a CUDA card
through the integrated unpack kernel (K1).

One deliberate difference: the codec takes values below 2**32, so
``compress`` raises ``ValueError`` where the largest coded value reaches
2**32 (from about 65,536 nodes on), where the reference wraps silently
and ``decompress`` returns wrong neighbours.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bitpack

CODE_LIMIT = 1 << 32          # the codec's domain: values below 2**32


def synthetic_graph(n_nodes: int, avg_degree: int, seed: int = 0,
                    d_feat: int = 32, n_classes: int = 8):
    """Returns dict with CSR (indptr, indices), edge list, features, labels."""
    rng = np.random.default_rng(seed)
    n_edges = n_nodes * avg_degree
    # power-law destination preference
    w = (1.0 / (np.arange(n_nodes) + 1.0)) ** 0.8
    w /= w.sum()
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = rng.choice(n_nodes, size=n_edges, p=w)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # symmetrize + dedup
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    key = s.astype(np.int64) * n_nodes + d
    key = np.unique(key)
    src = (key // n_nodes).astype(np.int32)
    dst = (key % n_nodes).astype(np.int32)
    # CSR
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.bincount(src, minlength=n_nodes)  # np.add.at's counts
    indptr = np.cumsum(indptr)
    feats = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    # learnable signal: label = argmax of the first n_classes feature dims
    labels = np.argmax(feats[:, :n_classes], axis=1).astype(np.int32)
    return {"indptr": indptr.astype(np.int32), "indices": dst,
            "edge_src": src, "edge_dst": dst,
            "x": feats, "labels": labels,
            "train_mask": (rng.random(n_nodes) < 0.5)}


@dataclasses.dataclass
class CompressedCSR:
    """CSR adjacency with the neighbor array stored via the paper's codec.

    Rows are sorted; row i's neighbors are coded in the stream as
    i * n_nodes + neighbor, making the concatenation globally sorted."""
    indptr: np.ndarray
    packed: bitpack.PackedList
    n_nodes: int

    @classmethod
    def compress(cls, indptr, indices, n_nodes, codec: str = "bp-d1"):
        """ValueError where the largest coded value is 2**32 or more (the
        codec's domain) or a row is not sorted and unique."""
        rows = np.repeat(np.arange(n_nodes, dtype=np.int64),
                         np.diff(indptr))
        stream = rows * n_nodes + np.asarray(indices).astype(np.int64)
        if stream.size and int(stream[-1]) >= CODE_LIMIT:
            raise ValueError(
                f"CompressedCSR: {n_nodes} nodes code neighbours up to "
                f"{int(stream[-1])}, past the codec's 2**32 domain")
        if not np.all(np.diff(stream) > 0):
            raise ValueError("CSR rows must be sorted/unique")
        return cls(indptr=np.asarray(indptr),
                   packed=bitpack.encode(stream, mode="d1"),
                   n_nodes=n_nodes)

    def to(self, device) -> "CompressedCSR":
        return dataclasses.replace(self, packed=self.packed.to(device))

    def decompress(self) -> torch.Tensor:
        """The neighbour array (int32) on the PackedList's device."""
        stream = bitpack.decode(self.packed)[: self.packed.n]
        return ((stream.long() & 0xFFFFFFFF) % self.n_nodes).to(torch.int32)

    def bits_per_edge(self) -> float:
        return bitpack.bits_per_int(self.packed)


def molecule_batch(rng: np.random.Generator, n_graphs: int, n_nodes: int,
                   n_edges: int, d_feat: int):
    x = rng.normal(size=(n_graphs, n_nodes, d_feat)).astype(np.float32)
    src = rng.integers(0, n_nodes, size=(n_graphs, n_edges)).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=(n_graphs, n_edges)).astype(np.int32)
    node_mask = np.ones((n_graphs, n_nodes), dtype=np.float32)
    targets = rng.normal(size=(n_graphs,)).astype(np.float32)
    return {"x": x, "edge_src": src, "edge_dst": dst,
            "node_mask": node_mask, "targets": targets}
