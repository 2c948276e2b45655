"""bert4rec [recsys] embed_dim=64 n_blocks=2 n_heads=2 seq_len=200
interaction=bidir-seq [arXiv:1904.06690; paper].

Port of ``src/repro/configs/bert4rec.py``."""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

SPEC = register(ArchSpec(
    arch_id="bert4rec",
    family="recsys",
    config=RecsysConfig(
        name="bert4rec", arch="bert4rec", embed_dim=64, n_blocks=2,
        n_heads=2, seq_len=200, n_items=1 << 20),
    shapes=dict(RECSYS_SHAPES),
    source="arXiv:1904.06690; paper",
))
