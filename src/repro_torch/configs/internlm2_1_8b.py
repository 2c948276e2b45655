"""internlm2-1.8b [dense] 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544 — GQA [arXiv:2403.17297; hf].

Port of ``src/repro/configs/internlm2_1_8b.py``."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import LMConfig

SPEC = register(ArchSpec(
    arch_id="internlm2-1.8b",
    family="lm",
    config=LMConfig(
        name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
        n_kv=8, d_ff=8192, vocab=92544, head_dim=128, act="swiglu",
        rope_theta=1000000.0, sharding_preset="tp"),
    shapes=dict(LM_SHAPES),
    source="arXiv:2403.17297; hf",
))
