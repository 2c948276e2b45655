"""Recsys retrieval with inverted-index candidate generation: user
attributes → compressed posting lists → SvS intersection (the paper's
engine) → dense scoring with MIND multi-interest embeddings → top-k.

Port of ``examples/recsys_retrieval.py``, on the card unless asked for
the CPU:

  PYTHONPATH=src python -m repro_torch.examples.recsys_retrieval [--device cpu]

The posting lists, the candidates and the batch are the reference's
(numpy seed 7); MIND's weights are drawn from an explicit
``torch.Generator`` seeded 0, where the reference draws them from
``jax.random.PRNGKey(0)``, so the scores and the top 10 are the port's
own.  The intersection gallops with K2 on the card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bitpack
from repro_torch.core import intersect as its
from repro_torch.data import recsys_data
from repro_torch.examples.quickstart import intersect
from repro_torch.kernels import ops
from repro_torch.models import recsys


def main(device=None, n_items: int = 1 << 16) -> dict:
    device = ops.resolve_device(device)
    rng = np.random.default_rng(7)

    # --- offline: per-attribute posting lists (item ids are sorted ints) ---
    cate_of = rng.integers(0, 64, size=n_items)
    brand_of = rng.integers(0, 128, size=n_items)
    cate_lists = {c: np.nonzero(cate_of == c)[0].astype(np.int64)
                  for c in range(64)}
    brand_lists = {b: np.nonzero(brand_of == b)[0].astype(np.int64)
                   for b in range(128)}
    packed_cate = {c: bitpack.encode(v, mode="d1")
                   for c, v in cate_lists.items()}
    bits = np.mean([bitpack.bits_per_int(p) for p in packed_cate.values()])
    print(f"attribute posting lists compressed at {bits:.2f} bits/item")

    # --- online: candidate generation by intersection ----------------------
    user_cate, user_brand = 3, 17
    r = cate_lists[user_cate]
    f = brand_lists[user_brand]
    expect = np.intersect1d(r, f)
    rp = its.to_device(its.pad_to(r, its.pow2_bucket(len(r))), device)
    fp = its.to_device(its.pad_to(f, its.pow2_bucket(len(f), floor=1024)),
                       device)
    mask = intersect(rp, fp, len(r), len(f))
    got, cnt = its.compact(rp, mask)
    cands = got[:cnt].cpu().numpy()
    assert np.array_equal(cands, expect)
    print(f"candidate generation: |cate|={len(r)} ∩ |brand|={len(f)} → "
          f"{len(cands)} candidates (verified)")

    # --- dense scoring: MIND multi-interest --------------------------------
    cfg = recsys.RecsysConfig(name="mind-demo", arch="mind", n_items=n_items,
                              embed_dim=32, seq_len=32, n_neg=15)
    params = recsys.INIT["mind"](torch.Generator().manual_seed(0), cfg,
                                 device)
    batch = recsys_data.retrieval_batch(rng, cfg, len(cands))
    batch["cand_items"] = cands.astype(np.int32)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in batch.items()}
    scores = recsys.RETRIEVAL["mind"](params, batch, cfg)
    top_idx = torch.topk(scores, min(10, len(cands))).indices
    top = cands[top_idx.cpu().numpy()].tolist()
    print("top-10 item ids:", top)
    print("retrieval pipeline (intersection → multi-interest scoring) — "
          "done")
    return {"bits_per_item": float(bits), "candidates": cands, "top": top}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
