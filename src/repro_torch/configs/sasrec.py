"""sasrec [recsys] embed_dim=50 n_blocks=2 n_heads=1 seq_len=50
interaction=self-attn-seq [arXiv:1808.09781; paper].

Port of ``src/repro/configs/sasrec.py``."""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

SPEC = register(ArchSpec(
    arch_id="sasrec",
    family="recsys",
    config=RecsysConfig(
        name="sasrec", arch="sasrec", embed_dim=50, n_blocks=2, n_heads=1,
        seq_len=50, n_items=1 << 20),
    shapes=dict(RECSYS_SHAPES),
    source="arXiv:1808.09781; paper",
))
