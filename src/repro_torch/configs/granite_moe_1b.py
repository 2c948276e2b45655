"""granite-moe-1b-a400m [moe] 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32e top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

vocab padded 49155 → 49168 (next multiple of 16) for clean vocab sharding;
padded ids are never emitted by the pipeline.

Port of ``src/repro/configs/granite_moe_1b.py``."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import LMConfig

SPEC = register(ArchSpec(
    arch_id="granite-moe-1b-a400m",
    family="lm",
    config=LMConfig(
        name="granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
        n_kv=8, d_ff=512, vocab=49168, head_dim=64, act="swiglu",
        n_experts=32, top_k=8, tie_embeddings=True,
        sharding_preset="tp"),
    shapes=dict(LM_SHAPES),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
))
