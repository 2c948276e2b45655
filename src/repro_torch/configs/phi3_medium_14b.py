"""phi3-medium-14b [dense] 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

Port of ``src/repro/configs/phi3_medium_14b.py``."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import LMConfig

SPEC = register(ArchSpec(
    arch_id="phi3-medium-14b",
    family="lm",
    config=LMConfig(
        name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv=10, d_ff=17920, vocab=100352, head_dim=128, act="swiglu",
        rope_theta=10000.0, sharding_preset="tp"),
    shapes=dict(LM_SHAPES),
    source="arXiv:2404.14219; unverified",
))
