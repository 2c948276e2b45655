"""Serve-step factories: LM prefill and decode and the greedy host loop
that drives them; recsys scoring and retrieval (scores, then the top
``top_k`` candidates).

Port of ``src/repro/serve/steps.py``.
"""

from __future__ import annotations

import torch

from repro_torch.models import recsys as recsys_lib
from repro_torch.models.transformer import (LMConfig, decode_step,
                                            init_kv_cache, prefill)


def make_prefill_step(cfg: LMConfig):
    def step(params, tokens):
        return prefill(params, tokens, cfg)
    return step


def make_decode_step(cfg: LMConfig):
    """One new token against an existing KV cache."""
    def step(params, cache, token, pos):
        return decode_step(params, cache, token, pos, cfg)
    return step


def make_recsys_score_step(cfg: recsys_lib.RecsysConfig):
    score = recsys_lib.SCORE[cfg.arch]

    @torch.no_grad()
    def step(params, batch):
        return score(params, batch, cfg)
    return step


def make_recsys_retrieval_step(cfg: recsys_lib.RecsysConfig, top_k: int = 100):
    """Scores of every candidate, then ``torch.topk``: (values, indices),
    values descending.  Among equal scores the order of the indices is
    torch's, not ``lax.top_k``'s (which puts the lower index first)."""
    retr = recsys_lib.RETRIEVAL[cfg.arch]

    @torch.no_grad()
    def step(params, batch):
        return torch.topk(retr(params, batch, cfg), top_k)
    return step


def greedy_generate(params, cfg: LMConfig, prompt, max_new: int, cache_len):
    """Host loop driving prefill + decode_step: the prompt's cache is copied
    into the first S positions of a zeroed cache of ``cache_len``, then
    ``max_new`` tokens are picked greedily.  Returns (B, max_new) int32."""
    B, S = prompt.shape
    logits, pre_cache = prefill(params, prompt, cfg)
    cache = init_kv_cache(cfg, B, cache_len, device=prompt.device)
    for name in ("k", "v"):
        cache[name][:, :, :S] = pre_cache[name]
    out = [torch.argmax(logits, -1).to(torch.int32)]
    for i in range(max_new - 1):
        logits, cache = decode_step(params, cache, out[-1], S + i, cfg)
        out.append(torch.argmax(logits, -1).to(torch.int32))
    return torch.stack(out, dim=1)
