"""gemma-7b [dense] 28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000
— GeGLU, head_dim=256 [arXiv:2403.08295; hf].

Port of ``src/repro/configs/gemma_7b.py``."""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, register
from repro_torch.models.transformer import LMConfig

SPEC = register(ArchSpec(
    arch_id="gemma-7b",
    family="lm",
    config=LMConfig(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16, n_kv=16,
        d_ff=24576, vocab=256000, head_dim=256, act="geglu",
        tie_embeddings=True, embed_scale=True, rope_theta=10000.0,
        sharding_preset="tp"),
    shapes=dict(LM_SHAPES),
    source="arXiv:2403.08295; hf",
))
