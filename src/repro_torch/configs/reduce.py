"""Reduced same-family configs for CPU smoke tests.

Port of the LM and recsys branches of ``src/repro/configs/reduce.py``; the
GNN branch comes with that model."""
import dataclasses


def reduced(spec):
    if spec.family == "lm":
        c = spec.config
        return dataclasses.replace(
            c, n_layers=2, d_model=64, n_heads=4,
            n_kv=4 if c.n_kv == c.n_heads else 2, d_ff=128, vocab=512,
            head_dim=16, n_experts=min(c.n_experts, 8) if c.is_moe else 0,
            top_k=min(c.top_k, 2) if c.is_moe else 0,
            param_dtype="float32", remat="none", full_attn_max_seq=256,
            attn_chunk=64)
    if spec.family == "recsys":
        c = spec.config
        return dataclasses.replace(c, n_items=1024, n_cates=64,
                                   seq_len=16, n_neg=7)
    return spec.config
