"""AdamW with global-norm clipping, as plain functions on parameter trees.

Port of ``src/repro/optim/adamw.py``.  The state is ``{"mu": [...], "nu":
[...], "step": int32 scalar}``, the moments a list in the order of
``tree.leaves(params)`` in ``moment_dtype``.  ``update`` keeps the
reference's arithmetic: the gradients scaled by min(1, clip_norm /
max(‖g‖, 1e-9)), float32 moments with bias correction, weight decay only
on leaves of two or more dimensions, and the learning rate times
``lr_scale``.  It writes the new parameters and moments into their
tensors in place (the reference returns new arrays) and returns them, so
that a model's tensors, a module's parameters included, stay the ones
that train.  Every scalar stays a tensor on the device: no host sync.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # bf16 for ~1T-param models


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init(params, cfg: AdamWConfig) -> dict:
    mdt = _dtype(cfg.moment_dtype)
    ps = tree.leaves(params)
    dev = ps[0].device if ps else None
    return {
        "mu": [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in ps],
        "nu": [torch.zeros(p.shape, dtype=mdt, device=p.device) for p in ps],
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors))


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    """grads: a list in the order of ``tree.leaves(params)``.  Returns
    (params, new_state, metrics); params and the moments are updated in
    place."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9),
                        max=1.0)
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    lr = cfg.lr * lr_scale

    for p, g, mu, nu in zip(tree.leaves(params), grads, state["mu"],
                            state["nu"]):
        g = g.float() * scale
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        upd = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        if p.ndim >= 2:                      # no decay on norms/biases
            upd = upd + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * upd)
        mu.copy_(mu32)
        nu.copy_(nu32)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        {"grad_norm": gnorm}


def cosine_schedule(step, base_lr=1.0, warmup: int = 100,
                    total: int = 10000, min_frac: float = 0.1):
    t = step.float()
    warm = t / max(warmup, 1)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.where(t < warmup, warm, cos)
