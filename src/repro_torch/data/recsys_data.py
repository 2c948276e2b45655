"""Synthetic recsys interaction data (Zipfian item popularity, per-user
category affinity so models have learnable signal).  User history item-id
lists, sorted-deduped, are stored compressed with the paper's codec in the
offline feature store (``compress_histories``).

Port of ``src/repro/data/recsys_data.py``: the same numpy draws in the same
order, so a seed gives the reference's batches byte for byte; the codecs
are the port's own ``core.bitpack`` and ``core.varint``."""

from __future__ import annotations

import numpy as np

from repro_torch.core import bitpack, varint


def _zipf_items(rng, n, size):
    x = rng.zipf(1.2, size=size)
    return (x % n).astype(np.int32)


def din_batch(rng, cfg, batch: int):
    L = cfg.seq_len
    hist_items = _zipf_items(rng, cfg.n_items, (batch, L))
    hist_cates = (hist_items % cfg.n_cates).astype(np.int32)
    lens = rng.integers(5, L + 1, size=batch)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    # positive targets share the user's dominant category half the time
    target_item = _zipf_items(rng, cfg.n_items, (batch,))
    labels = rng.random(batch) < 0.5
    dom = hist_items[:, 0]
    target_item = np.where(labels, dom, target_item).astype(np.int32)
    return {"hist_items": hist_items, "hist_cates": hist_cates,
            "hist_mask": mask, "target_item": target_item,
            "target_cate": (target_item % cfg.n_cates).astype(np.int32),
            "labels": labels.astype(np.int32)}


def seq_batch(rng, cfg, batch: int):
    """SASRec-style: hist, per-position next-item pos/neg."""
    L = cfg.seq_len
    hist = _zipf_items(rng, cfg.n_items, (batch, L))
    pos = np.roll(hist, -1, axis=1)
    neg = _zipf_items(rng, cfg.n_items, (batch, L))
    mask = np.ones((batch, L), dtype=np.float32)
    mask[:, -1] = 0
    return {"hist": hist, "pos": pos, "neg": neg, "hist_mask": mask,
            "target_item": hist[:, 0]}


def bert4rec_batch(rng, cfg, batch: int, n_masked: int = 8):
    L = cfg.seq_len
    hist = _zipf_items(rng, cfg.n_items, (batch, L))
    mask_pos = np.stack([rng.choice(L, size=n_masked, replace=False)
                         for _ in range(batch)]).astype(np.int32)
    true_ids = np.take_along_axis(hist, mask_pos, axis=1)
    hist_masked = hist.copy()
    np.put_along_axis(hist_masked, mask_pos,
                      np.int32(cfg.n_items + 1), axis=1)   # [MASK]
    negs = _zipf_items(rng, cfg.n_items, (batch, n_masked, cfg.n_neg))
    cands = np.concatenate([true_ids[..., None], negs], axis=-1)
    return {"hist": hist_masked, "hist_mask": np.ones((batch, L), np.float32),
            "mask_pos": mask_pos, "cands": cands,
            "mask_valid": np.ones((batch, n_masked), np.float32),
            "target_item": hist[:, 0]}


def mind_batch(rng, cfg, batch: int):
    L = cfg.seq_len
    hist = _zipf_items(rng, cfg.n_items, (batch, L))
    lens = rng.integers(5, L + 1, size=batch)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    true_ids = hist[:, 0]
    negs = _zipf_items(rng, cfg.n_items, (batch, cfg.n_neg))
    cands = np.concatenate([true_ids[:, None], negs], axis=-1)
    return {"hist": hist, "hist_mask": mask, "cands": cands,
            "target_item": true_ids}


def retrieval_batch(rng, cfg, n_candidates: int):
    L = cfg.seq_len
    hist = _zipf_items(rng, cfg.n_items, (L,))
    cand = _zipf_items(rng, cfg.n_items, (n_candidates,))
    return {"hist": hist, "hist_mask": np.ones((L,), np.float32),
            "hist_items": hist,
            "hist_cates": (hist % cfg.n_cates).astype(np.int32),
            "cand_items": cand,
            "cand_cates": (cand % cfg.n_cates).astype(np.int32)}


def compress_histories(histories: list[np.ndarray]):
    """Feature-store compression of sorted-unique user histories (paper codec
    applied to recsys substrate).  Paper-faithful codec choice: lists shorter
    than one block go to Varint (the paper's tail codec — block packing pays
    ~block_size/n × padding overhead there); longer lists are bit-packed.
    Returns (list of (kind, payload), bits/int)."""
    packed = []
    total_bits = 0.0
    total_n = 0
    for h in histories:
        u = np.unique(h)
        if u.size < 1024:
            enc = varint.encode(u)
            packed.append(("varint", enc))
            total_bits += varint.bits_per_int(enc) * enc.n
            total_n += enc.n
        else:
            enc = bitpack.encode(u, mode="d1")
            packed.append(("bp", enc))
            total_bits += bitpack.bits_per_int(enc) * enc.n
            total_n += enc.n
    return packed, total_bits / max(total_n, 1)
