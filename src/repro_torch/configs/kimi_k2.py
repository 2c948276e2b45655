"""kimi-k2-1t-a32b [moe] 61L d_model=7168 64H (GQA kv=8) d_ff=2048 (expert),
vocab=163840, MoE 384e top-8 — trillion-param MoE (paper-table)
[arXiv:2501.kimi2; unverified].

Simplifications as in the reference: uniform MoE layers (the released
model has a dense first layer + 1 shared expert); params bf16 + fsdp
preset.

Port of ``src/repro/configs/kimi_k2.py``."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import LMConfig

SPEC = register(ArchSpec(
    arch_id="kimi-k2-1t-a32b",
    family="lm",
    config=LMConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv=8, d_ff=2048, vocab=163840, head_dim=112, act="swiglu",
        n_experts=384, top_k=8, param_dtype="bfloat16",
        capacity_factor=1.25, sharding_preset="fsdp", remat="full"),
    shapes=dict(LM_SHAPES),
    source="arXiv:2501.kimi2; unverified",
))
