"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

Port of the single-shard path of ``src/repro/models/moe.py``
(``moe_ffn_local``: router → top-k → stable sort by expert →
position-in-group → an (E, C, D) buffer → batched expert GEMMs → combine).
``moe_ffn`` is the reference's dispatcher; on one card it is the local
path.  The expert-parallel ``moe_ffn_sharded`` (an all-to-all over a
'model' mesh axis) is not ported.

Where the numerics could part from the reference's, the port pins them:
- top-k keeps the lower expert id first among equal probabilities, as
  ``lax.top_k`` does: a stable descending sort, then the first k;
- tokens are grouped by a stable sort (``jnp.argsort`` is stable), so the
  tokens past capacity that are dropped are the reference's;
- C is the reference's Python expression, ``capacity``;
- the buffer is filled by a gather (slot (e, c) reads the c-th token
  routed to e, or zero), and each token's output is the sum of its k
  slots, gathered: no scatter and no atomics, so two runs on the card give
  bit-equal outputs;
- the gate weights are rounded to x's dtype before the product, and the
  expert GEMMs run in x's dtype, as the reference's einsums do.  The
  router is float32 whatever ``param_dtype`` is.

Tokens beyond capacity are dropped; the Switch-style aux load-balancing
term is returned beside the output.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class MoE(nn.Module):
    """One MoE layer's weights: ``router`` (d, E) float32, ``w_in`` and
    ``w_gate`` (E, d, F) and ``w_out`` (E, F, d) in ``dtype``
    (uninitialised; see ``init_moe_params``)."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 dtype=torch.float32, device=None):
        super().__init__()

        def e(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                requires_grad=False)
        self.router = e(d_model, n_experts, dt=torch.float32)
        self.w_in = e(n_experts, d_model, d_ff)
        self.w_gate = e(n_experts, d_model, d_ff)
        self.w_out = e(n_experts, d_ff, d_model)


def fill_normal(p: torch.Tensor, generator: torch.Generator, scale: float,
                round_to: torch.dtype | None = None) -> None:
    """Fill ``p`` with normal draws from ``generator`` times ``scale``.  A
    stack of experts (3-D) is drawn one expert at a time, so the float32
    temporary is one expert's, not the stack's.  ``round_to`` rounds the
    draws through that dtype first (the reference makes the router in
    ``param_dtype`` and then casts it to float32)."""
    parts = p.unbind(0) if p.dim() == 3 else (p,)
    for part in parts:
        z = torch.randn(part.shape, generator=generator,
                        device=generator.device).mul_(scale)
        part.copy_(z if round_to is None else z.to(round_to))


@torch.no_grad()
def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32, device=None) -> MoE:
    """Random weights with the reference's scales (1/sqrt(d_model) for the
    router, ``w_in`` and ``w_gate``, 1/sqrt(d_ff) for ``w_out``)."""
    m = MoE(d_model, d_ff, n_experts, dtype, device)
    s_in = 1.0 / np.sqrt(d_model)
    fill_normal(m.router, generator, s_in)
    fill_normal(m.w_in, generator, s_in)
    fill_normal(m.w_gate, generator, s_in)
    fill_normal(m.w_out, generator, 1.0 / np.sqrt(d_ff))
    return m


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert: the reference's expression (``moe.py:106``)."""
    return max(int(np.ceil(n_tokens * top_k / n_experts * capacity_factor)),
               1)


def _route(router, xf, top_k: int, n_experts: int):
    """Shared router math: returns (weights (N,k), expert ids (N,k), probs).
    Among equal probabilities the lower expert id comes first."""
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, expert_idx = vals[:, :top_k], idx[:, :top_k]
    weights = weights / torch.clamp_min(weights.sum(-1, keepdim=True), 1e-9)
    return weights, expert_idx, probs


def _aux_loss(expert_idx, probs, n_experts: int):
    density = F.one_hot(expert_idx[:, 0], n_experts).float().mean(0)
    density_prob = probs.mean(0)
    return density, density_prob


def _group_positions(sorted_ids, n_groups: int):
    """Position of each element within its (sorted) group, and the group
    sizes (ids outside [0, n_groups) belong to no group)."""
    groups = torch.arange(n_groups, device=sorted_ids.device,
                          dtype=sorted_ids.dtype)
    gstart = torch.searchsorted(sorted_ids, groups)
    gsz = torch.searchsorted(sorted_ids, groups, right=True) - gstart
    pos = torch.arange(sorted_ids.shape[0], device=sorted_ids.device) \
        - gstart[sorted_ids.clamp(0, n_groups - 1)]
    return pos, gsz


def _expert_mlp(buf, w_in, w_gate, w_out, act: str):
    """(E, C, D) → (E, C, D): a GLU MLP per expert, in buf's dtype (GeGLU
    is ``jax.nn.gelu``'s tanh approximation)."""
    h = torch.bmm(buf, w_in.to(buf.dtype))
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    g = F.gelu(g, approximate="tanh") if act == "geglu" else F.silu(g)
    return torch.bmm(h * g, w_out.to(buf.dtype))


def moe_ffn_local(params: MoE, x, *, top_k: int,
                  capacity_factor: float = 1.25, act: str = "swiglu"):
    """x: (B, S, D) → (B, S, D), aux_loss (scalar)."""
    B, S, D = x.shape
    E = params.router.shape[1]
    N = B * S
    xf = x.reshape(N, D)
    weights, expert_idx, probs = _route(params.router, xf, top_k, E)
    density, density_prob = _aux_loss(expert_idx, probs, E)
    aux = torch.sum(density * density_prob) * E

    C = capacity(N, top_k, E, capacity_factor)
    ids = expert_idx.reshape(-1)                               # (N·k,)
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    pos, gsz = _group_positions(sorted_ids, E)
    token_of = order // top_k

    # slot (e, c) holds the c-th token routed to e, if any (a gather)
    c = torch.arange(C, device=x.device)
    filled = c[None, :] < gsz[:, None]                         # (E, C)
    src = (gsz.cumsum(0) - gsz)[:, None] + c[None, :]
    src = torch.where(filled, src, 0)
    buf = xf.index_select(0, token_of[src.reshape(-1)]).reshape(E, C, D)
    buf.masked_fill_(~filled[..., None], 0)
    out_buf = _expert_mlp(buf, params.w_in, params.w_gate, params.w_out, act)

    # each token's k slots, in its top-k order, gathered and summed
    pos_flat = torch.empty_like(pos)
    pos_flat[order] = pos
    keep = pos_flat < C
    slot_vals = out_buf[ids, torch.where(keep, pos_flat, 0)]   # (N·k, D)
    slot_vals.masked_fill_(~keep[:, None], 0)
    contrib = slot_vals * weights.reshape(-1)[:, None].to(x.dtype)
    out = contrib.reshape(N, top_k, D).sum(1)
    return out.reshape(B, S, D), aux


def moe_ffn(params: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
            act: str = "swiglu"):
    """The reference's dispatcher.  Its expert-parallel branch needs a
    'model' mesh axis, which one card does not have, so this is the local
    path."""
    return moe_ffn_local(params, x, top_k=top_k,
                         capacity_factor=capacity_factor, act=act)
