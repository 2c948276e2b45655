"""Architecture registry: every ported arch is a selectable config
(``--arch <id>``) with its input-shape set.

Port of ``src/repro/configs/base.py``.  The registry loads the archs the
port has: every arch the reference registers, the dense LMs (gemma-7b,
phi3-medium-14b, internlm2-1.8b), the MoE LMs (granite-moe-1b-a400m,
kimi-k2-1t-a32b), the GNN (graphsage-reddit), the recsys models (din,
sasrec, bert4rec, mind) and the paper's index.  An arch listed in
``NOT_YET_PORTED`` (none now) raises ``NotImplementedError``; an id that
neither package knows raises ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

_REGISTRY: dict[str, "ArchSpec"] = {}

# archs of the reference that later slices of the port bring: none left
NOT_YET_PORTED: dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                 # 'lm' | 'gnn' | 'recsys' | 'index'
    config: Any                 # LMConfig / GNNConfig / RecsysConfig / dict
    shapes: dict[str, dict]     # shape name → shape params
    source: str = ""            # citation tag from the assignment

    def smoke_config(self):
        """Reduced same-family config for CPU smoke tests."""
        from repro_torch.configs import reduce as reduce_lib
        return reduce_lib.reduced(self)


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_config(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id in NOT_YET_PORTED:
        raise NotImplementedError(f"arch {arch_id!r} ({NOT_YET_PORTED[arch_id]}) "
                                  f"is not yet ported")
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_arch_ids() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


_loaded = False


def _ensure_loaded():
    # a flag, not `if _REGISTRY`: importing one config module directly
    # registers one arch, which must not stop the rest from loading
    global _loaded
    if _loaded:
        return
    _loaded = True
    from repro_torch.configs import (  # noqa: F401
        gemma_7b, phi3_medium_14b, internlm2_1_8b, granite_moe_1b, kimi_k2,
        graphsage_reddit, mind, sasrec, din, bert4rec, paper_index)


# Canonical LM shape set (shared by all 5 LM archs)
LM_SHAPES = {
    "train_4k": {"kind": "train", "seq_len": 4096, "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768, "global_batch": 32},
    "decode_32k": {"kind": "decode", "seq_len": 32768, "global_batch": 128},
    "long_500k": {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}
