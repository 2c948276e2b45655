"""Synthetic LM token pipeline.

Port of ``src/repro/data/lm_data.py``: the same numpy draws, so the same
seed gives byte-equal batches and shuffle orders.  Deterministic token
stream (Zipfian unigram mixture with Markov bigram structure so tiny
models have learnable signal); the epoch shuffle index map, a sorted
integer list, is stored compressed with the paper's codec (bp-d1, the
port's ``core.bitpack``).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import bitpack


class TokenStream:
    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.3):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        # bigram structure: token t likely followed by (t*7+3) % vocab
        self.next_map = (np.arange(vocab) * 7 + 3) % vocab

    def batch(self, batch_size: int, seq_len: int):
        B, S = batch_size, seq_len
        toks = np.empty((B, S), dtype=np.int32)
        toks[:, 0] = self.rng.zipf(1.3, size=B) % self.vocab
        for s in range(1, S):
            follow = self.rng.random(B) < 0.7
            rand = self.rng.zipf(1.3, size=B) % self.vocab
            toks[:, s] = np.where(follow, self.next_map[toks[:, s - 1]], rand)
        labels = np.roll(toks, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1
        return {"tokens": toks, "labels": labels}


def make_shuffle_index(n_samples: int, epoch: int, seed: int = 0):
    """Shuffled sample order; returns (order, compressed sorted unique ids)
    (a ``PackedList`` of CPU tensors)."""
    rng = np.random.default_rng(seed + epoch)
    order = rng.permutation(n_samples)
    packed = bitpack.encode(np.sort(order), mode="d1")
    return order, packed
