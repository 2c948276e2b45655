"""Carry an index built elsewhere into the port.

``index_from_numpy(tree, device)`` turns a nested dict of plain numpy arrays
and scalars, holding the fields of the reference's ``HybridIndex`` →
``IndexPart`` → ``TermPosting`` → payload, into the port's ``HybridIndex``
on ``device``.  It reads plain numpy only, so the port never imports the
reference; whoever holds a reference index writes its fields into the dict:

    {"n_docs", "B", "codec_name",
     "parts": [{"doc_lo", "doc_hi",
                "terms": {tid: {"kind", "n", "skip_ok", "payload"}}}]}

A payload is None (empty), the uint32 bitmap words (bitmap), or a dict of
the list's fields: ``flat_words, widths, offsets, maxes, n, mode,
block_rows`` (PackedList), those plus ``exc_pos, exc_add, format_bits``
(PatchedList), or ``data, n`` (VarintList).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitpack, fastpfor, varint
from repro_torch.index import builder, source
from repro_torch.kernels import ops


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.uint32).view(np.int32))


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.int32))


def payload_from_numpy(kind: str, p, device):
    if kind == "empty":
        return None
    if kind == "bitmap":
        return _u32(p).to(device)
    if "data" in p:
        return varint.VarintList(np.asarray(p["data"], np.uint8), int(p["n"]))
    common = dict(flat_words=_u32(p["flat_words"]), widths=_i32(p["widths"]),
                  offsets=_i32(p["offsets"]), maxes=_u32(p["maxes"]),
                  n=int(p["n"]), mode=str(p["mode"]),
                  block_rows=int(p["block_rows"]))
    if "exc_pos" in p:
        pl = fastpfor.PatchedList(exc_pos=_i32(p["exc_pos"]),
                                  exc_add=_u32(p["exc_add"]),
                                  format_bits=int(p["format_bits"]), **common)
    else:
        pl = bitpack.PackedList(**common)
    return pl.to(device)


def index_from_numpy(tree: dict, device=None) -> builder.HybridIndex:
    """The port's HybridIndex on ``device`` (None = the CUDA card) from the
    nested numpy dict described in the module docstring."""
    device = ops.resolve_device(device)
    parts = []
    for pt in tree["parts"]:
        terms = {}
        for tid, t in pt["terms"].items():
            terms[int(tid)] = builder.TermPosting(
                t["kind"], payload_from_numpy(t["kind"], t["payload"], device),
                int(t["n"]), skip_ok=bool(t.get("skip_ok", True)))
        parts.append(builder.IndexPart(int(pt["doc_lo"]), int(pt["doc_hi"]),
                                       terms, device=device))
    source.precompute_layouts(parts)
    return builder.HybridIndex(n_docs=int(tree["n_docs"]), B=int(tree["B"]),
                               codec_name=str(tree["codec_name"]), parts=parts)
