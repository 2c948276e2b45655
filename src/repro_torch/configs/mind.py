"""mind [recsys] embed_dim=64 n_interests=4 capsule_iters=3
interaction=multi-interest [arXiv:1904.08030; unverified].

Port of ``src/repro/configs/mind.py``."""
from repro_torch.configs.base import ArchSpec, register
from repro_torch.models.recsys import RecsysConfig
from repro_torch.configs.recsys_shapes import RECSYS_SHAPES

SPEC = register(ArchSpec(
    arch_id="mind",
    family="recsys",
    config=RecsysConfig(
        name="mind", arch="mind", embed_dim=64, n_interests=4,
        capsule_iters=3, seq_len=50, n_items=1 << 23, n_neg=127),
    shapes=dict(RECSYS_SHAPES),
    source="arXiv:1904.08030; unverified",
))
