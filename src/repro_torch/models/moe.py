"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

Port of ``src/repro/models/moe.py``: two implementations with identical
semantics when nothing is dropped (tested against each other):

``moe_ffn_local`` — single-shard dispatch (router → top-k → stable sort by
expert → position-in-group → an (E, C, D) buffer → batched expert GEMMs →
combine).

``moe_ffn_sharded`` — the expert-parallel path over a ``DeviceMesh``.
Tokens stay in their (pod, data, model-SP) shard; each rank routes
locally, packs per-destination send buffers, and two all-to-alls over the
'model' group move tokens to their expert's rank and results back.
``moe_ffn_sharded_local`` is the reference's ``shard_map`` body on one
rank's blocks; ``moe_ffn_sharded`` is its ``in_specs`` / ``out_specs``:
DTensors (or whole tensors) in, the rank's blocks through the body, and
the output back in x's layout.

``moe_ffn`` is the reference's dispatcher: the sharded path where
``sharding.current_mesh()`` has a usable 'model' axis, else the local one.

Where the numerics could part from the reference's, the port pins them:
- top-k keeps the lower expert id first among equal probabilities, as
  ``lax.top_k`` does: a stable descending sort, then the first k;
- tokens are grouped by stable sorts (``jnp.argsort`` is stable), so the
  tokens past capacity that are dropped are the reference's;
- capacities are the reference's Python expressions (``capacity`` for the
  local path; ``cap`` and ``cap2`` in the sharded body);
- every buffer is filled by a gather (slot (g, c) reads the c-th item of
  group g, or zero), which writes exactly the kept slots that the
  reference's ``.at[...].add(mode="drop")`` writes; a permutation is
  undone by a gather through its inverse; each token's output is the sum
  of its k slots in k order: no scatter and no atomics, so two runs on
  the card give bit-equal outputs;
- the gate weights are rounded to x's dtype before the product, and the
  expert GEMMs run in x's dtype, as the reference's einsums do.  The
  router is float32 whatever ``param_dtype`` is.

Tokens beyond capacity are dropped; the Switch-style aux load-balancing
term is returned beside the output.
"""
from __future__ import annotations

import math

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


def _gather_groups(gsz, width: int):
    """For a buffer of ``len(gsz)`` groups of ``width`` slots, over items
    sorted by group (``gsz`` items a group): the sorted index of the item
    each slot holds (0 where empty) and whether it holds one (slot (g, c)
    holds the c-th item of group g)."""
    c = torch.arange(width, device=gsz.device)
    filled = c[None, :] < gsz[:, None]
    first = (gsz.cumsum(0) - gsz)[:, None] + c[None, :]
    return torch.where(filled, first, 0).reshape(-1), filled


def _inverse_positions(order, pos):
    """``pos`` (in sorted order) put back in the order before the sort
    (``order`` is a permutation: each index is written once)."""
    out = torch.empty_like(pos)
    out[order] = pos
    return out


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
    src, filled = _gather_groups(gsz, C)                       # (E, C)
    buf = xf.index_select(0, token_of[src]).reshape(E, C, D)
    buf.masked_fill_(~filled[..., None], 0)
    out_buf = _expert_mlp(buf, params.w_in, params.w_gate, params.w_out, act)

    # each token's k slots, in its top-k order, gathered and summed
    pos_flat = _inverse_positions(order, pos)
    keep = pos_flat < C
    slot_vals = out_buf[ids, torch.where(keep, pos_flat, 0)]   # (N·k, D)
    slot_vals.masked_fill_(~keep[:, None], 0)
    contrib = slot_vals * weights.reshape(-1)[:, None].to(x.dtype)
    out = contrib.reshape(N, top_k, D).sum(1)
    return out.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# expert-parallel path
# ---------------------------------------------------------------------------

def moe_ffn_sharded_local(router, w_in, w_gate, w_out, xb, *, top_k: int,
                          capacity_factor: float, act: str, model_group,
                          mesh_group, stats: dict | None = None):
    """One rank's part of the expert-parallel MoE (the reference's
    ``shard_map`` body, ``moe.py:145-212``): ``router`` (D, E) whole,
    this rank's ``E/M`` expert stacks, and its (B/dp, S/M, D) block of x.
    ``model_group`` is the rank's 'model' group, in mesh coordinate
    order; ``mesh_group`` holds every rank of the mesh.  Returns the
    block's output and the aux term, equal on every rank (its densities
    are means over the whole mesh).

    The collectives are autograd-aware, so gradients flow back through
    both all-to-alls; aux's gradient is that of a term each rank adds to
    its own loss.  With ``stats`` (a dict), it also gets ``kept``, a (B/dp
    · S/M, top_k) bool mask of the slots that reached an expert and came
    back, and the slots dropped on the send side (``send_dropped``) and by
    an expert's capacity (``expert_dropped``), as 0-d tensors."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn
    M = dist.get_world_size(model_group)
    W = dist.get_world_size(mesh_group)
    E = router.shape[1]
    E_loc = w_in.shape[0]
    if E_loc * M != E:
        raise ValueError(f"{E_loc} experts a rank on a model axis of {M}, "
                         f"router of {E}")
    N_loc = xb.shape[0] * xb.shape[1]
    D = xb.shape[2]
    xf = xb.reshape(N_loc, D)
    weights, expert_idx, probs = _route(router, xf, top_k, E)
    density, density_prob = _aux_loss(expert_idx, probs, E)
    aux = torch.sum(dnn.all_reduce(density, group=mesh_group) / W
                    * dnn.all_reduce(density_prob, group=mesh_group) / W) * E

    Nk = N_loc * top_k
    cap = max(int(np.ceil(Nk / M * capacity_factor)), 1)
    ids = expert_idx.reshape(-1)                    # (Nk,)
    dest = ids // E_loc                             # target model rank
    order = torch.argsort(dest, stable=True)
    pos, gsz = _group_positions(dest[order], M)
    at, filled = _gather_groups(gsz, cap)
    send = xf.index_select(0, (order // top_k)[at]).reshape(M, cap, D)
    send.masked_fill_(~filled[..., None], 0)
    send_eid = torch.where(filled.reshape(-1), (ids[order] % E_loc)[at],
                           E_loc).to(torch.int32)

    # === all-to-all #1: tokens → their expert's rank ===
    recv = dnn.all_to_all_single(torch.empty_like(send), send,
                                 group=model_group)
    re_id = torch.empty_like(send_eid)
    dist.all_to_all_single(re_id, send_eid, group=model_group)
    re = recv.reshape(M * cap, D)                   # re_id in [0, E_loc]

    # local grouped GEMM over my E_loc experts (E_loc = padding, last)
    cap2 = max(int(np.ceil(M * cap / max(E_loc, 1))), 1)
    order2 = torch.argsort(re_id, stable=True)
    pos2, gsz2 = _group_positions(re_id[order2], E_loc + 1)
    at2, filled2 = _gather_groups(gsz2[:E_loc], cap2)
    buf = re.index_select(0, order2[at2]).reshape(E_loc, cap2, D)
    buf.masked_fill_(~filled2[..., None], 0)
    ob = _expert_mlp(buf, w_in, w_gate, w_out, act)

    # each received row's result, in the order received (zero where it was
    # padding or dropped); all-to-all #2: results → token owners
    pos2_rows = _inverse_positions(order2, pos2)
    kept2 = (re_id < E_loc) & (pos2_rows < cap2)
    rows = ob[torch.where(kept2, re_id, 0), torch.where(kept2, pos2_rows, 0)]
    rows.masked_fill_(~kept2[:, None], 0)
    back = dnn.all_to_all_single(torch.empty_like(rows), rows,
                                 group=model_group)

    # each (token, k) slot's result from where it was sent, summed in k
    # order
    pos_flat = _inverse_positions(order, pos)
    sent = pos_flat < cap
    slot = torch.where(sent, dest * cap + pos_flat, 0)
    vals = back[slot]
    vals.masked_fill_(~sent[:, None], 0)
    contrib = vals * weights.reshape(-1)[:, None].to(xb.dtype)
    out = contrib.reshape(N_loc, top_k, D).sum(1)
    if stats is not None:
        came_back = torch.empty_like(re_id)
        dist.all_to_all_single(came_back, kept2.to(torch.int32),
                               group=model_group)
        kept = sent & (came_back[slot] != 0)
        stats.update(kept=kept.reshape(N_loc, top_k),
                     send_dropped=(~sent).sum(),
                     expert_dropped=(sent & ~kept).sum())
    return out.reshape(xb.shape), aux


class _OneValue(torch.autograd.Function):
    """The identity, whose gradient is divided by the ranks that hold the
    value: a replicated output is one value, as ``shard_map`` treats an
    out_spec of P() (its cotangent is split over the replicas)."""

    @staticmethod
    def forward(ctx, x, n: int):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _local(t, mesh, spec):
    """This rank's block of ``t`` under ``spec``: a DTensor's local tensor
    (laid out by ``spec`` first where it is not; the gradient of a
    replicated dim comes back partial), or a block of a whole tensor."""
    from repro_torch.distributed import sharding
    if not sharding.is_dtensor(t):
        return sharding.block(t, mesh, spec)
    from torch.distributed.tensor import Partial, Replicate
    want = sharding.placements(mesh, spec)
    if tuple(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local(grad_placements=[
        Partial() if isinstance(p, Replicate) else p for p in want])


def moe_ffn_sharded(params: MoE, x, *, top_k: int, capacity_factor: float,
                    act: str, mesh, stats: dict | None = None):
    """x: (B, S, D) placed P(dp, 'model', None) on ``mesh`` → the same
    layout, and aux, replicated.  The reference's ``shard_map`` specs:
    x over (dp, 'model'), the expert stacks' expert axis over 'model', the
    router replicated.  Each of ``params``' weights and x may be a DTensor
    (laid out anew where its layout differs) or the whole tensor on every
    rank (the rank takes its block).  For a DTensor x the output and aux
    are DTensors; for a whole x they are whole tensors on every rank.
    ``stats`` as in ``moe_ffn_sharded_local`` (this rank's slots)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed import sharding
    dp = sharding.batch_axes(mesh)
    x_spec = sharding._spec((dp, "model", None))
    e_spec = ("model", None, None)
    group = mesh.get_group("model")
    if dist.get_group_rank(group, dist.get_rank()) != \
            mesh.get_local_rank("model"):
        raise ValueError("the 'model' group's rank order is not the mesh's "
                         "model coordinate order")
    mgroup = sharding.mesh_group(mesh)
    out, aux = moe_ffn_sharded_local(
        _local(params.router, mesh, ()),
        *(_local(w, mesh, e_spec)
          for w in (params.w_in, params.w_gate, params.w_out)),
        _local(x, mesh, x_spec), top_k=top_k,
        capacity_factor=capacity_factor, act=act, model_group=group,
        mesh_group=mgroup, stats=stats)
    aux = _OneValue.apply(aux, dist.get_world_size(mgroup))
    out = DTensor.from_local(out, mesh, sharding.placements(mesh, x_spec),
                             shape=x.shape, stride=x.stride())
    if sharding.is_dtensor(x):
        return out, DTensor.from_local(aux, mesh,
                                       [Replicate()] * mesh.ndim)
    return out.full_tensor(), aux


def moe_ffn(params: MoE, x, *, top_k: int, capacity_factor: float = 1.25,
            act: str = "swiglu"):
    """Routes to the expert-parallel path when a mesh with a usable 'model'
    axis is bound and shapes divide; otherwise the local path (one card,
    decode steps with S=1 where the token count is trivial)."""
    from repro_torch.distributed import sharding
    mesh = sharding.current_mesh()
    B, S, D = x.shape
    if mesh is not None:
        sizes = sharding.axis_sizes(mesh)
        M = sizes.get("model", 1)
        dpn = math.prod(sizes[a] for a in sharding.batch_axes(mesh))
        E = params.router.shape[1]
        if M > 1 and E % M == 0 and S % M == 0 and B % max(dpn, 1) == 0:
            return moe_ffn_sharded(params, x, top_k=top_k,
                                   capacity_factor=capacity_factor,
                                   act=act, mesh=mesh)
    return moe_ffn_local(params, x, top_k=top_k,
                         capacity_factor=capacity_factor, act=act)
