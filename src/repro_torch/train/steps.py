"""Train-step factories: (params, opt_state, batch, generator) →
(params, opt_state, metrics).

Port of ``src/repro/train/steps.py``.  A step takes a ``torch.Generator``
where the reference takes an rng key; only the GNN's minibatch loss draws
from it.  Gradients are ``torch.autograd.grad`` of the loss with respect
to ``tree.leaves(params)`` (each leaf set to require grad); the update is
``adamw.update`` with the reference's cosine schedule, in place.  With
``accum > 1`` every batch leaf has a leading (accum,) microbatch axis, and
the microbatches' float32 gradients and losses are summed in order and
divided by ``accum``, as the reference's ``lax.scan`` does.  Metrics stay
tensors on the device.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch import tree
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models.transformer import LMConfig, lm_loss
from repro_torch.optim import adamw


def loss_and_grads(loss_fn: Callable, params, *args):
    """``loss_fn(params, *args)`` → (loss, metrics) and the gradients with
    respect to ``tree.leaves(params)`` (zeros where a leaf is unused), all
    detached."""
    leaves = tree.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _make_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig,
               total_steps: int = 10000, warmup: int = 100,
               accum: int = 1, has_rng: bool = False):
    def grads_of(params, batch, generator):
        args = (batch, generator) if has_rng else (batch,)
        return loss_and_grads(loss_fn, params, *args)

    def train_step(params, opt_state, batch, generator=None):
        if accum == 1:
            loss, metrics, grads = grads_of(params, batch, generator)
        else:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree.leaves(params)]
            loss = None
            for i in range(accum):
                mb = {k: v[i] for k, v in batch.items()}
                l_i, _, g_i = grads_of(params, mb, generator)
                grads = [a + g for a, g in zip(grads, g_i)]
                loss = l_i.float() if loss is None else loss + l_i
            grads = [g / accum for g in grads]
            loss = loss / accum
            metrics = {}
        lr_scale = adamw.cosine_schedule(opt_state["step"], 1.0, warmup,
                                         total_steps)
        params, opt_state, om = adamw.update(grads, opt_state, params,
                                             opt_cfg, lr_scale)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


# ---------------------------------------------------------------------------
# per-family factories
# ---------------------------------------------------------------------------

def make_lm_train_step(cfg: LMConfig, opt_cfg=None, accum: int = 1, **kw):
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    return _make_step(lambda p, b: lm_loss(p, b, cfg), opt_cfg,
                      accum=accum, **kw)


def make_gnn_train_step(cfg: gnn_lib.GNNConfig, variant: str,
                        opt_cfg=None, fanout=(15, 10), **kw):
    opt_cfg = opt_cfg or adamw.AdamWConfig(weight_decay=0.0)
    if variant == "full":
        return _make_step(lambda p, b: gnn_lib.node_loss(p, b, cfg),
                          opt_cfg, **kw)
    if variant == "minibatch":
        return _make_step(
            lambda p, b, g: gnn_lib.minibatch_loss(p, b, g, cfg, fanout),
            opt_cfg, has_rng=True, **kw)
    if variant == "molecule":
        return _make_step(lambda p, b: gnn_lib.molecule_loss(p, b, cfg),
                          opt_cfg, **kw)
    raise ValueError(variant)


def make_recsys_train_step(cfg: recsys_lib.RecsysConfig, opt_cfg=None,
                           **kw):
    opt_cfg = opt_cfg or adamw.AdamWConfig(weight_decay=0.0)
    loss_fn = recsys_lib.LOSS[cfg.arch]
    return _make_step(lambda p, b: loss_fn(p, b, cfg), opt_cfg, **kw)
