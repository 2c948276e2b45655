"""din [recsys] embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn [arXiv:1706.06978; paper].

Port of ``src/repro/configs/din.py``."""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

SPEC = register(ArchSpec(
    arch_id="din",
    family="recsys",
    config=RecsysConfig(
        name="din", arch="din", embed_dim=18, seq_len=100,
        attn_mlp=(80, 40), mlp=(200, 80), n_items=1 << 20, n_cates=1 << 12),
    shapes=dict(RECSYS_SHAPES),
    source="arXiv:1706.06978; paper",
))
