"""GraphSAGE (mean aggregator) — full-batch, sampled-minibatch, and
batched-small-graph variants.

Port of ``src/repro/models/gnn.py``.  Parameters are the reference's tree
(``{"layers": [{"w_self", "w_neigh", "b"}, ...], "head"}``) of float32
tensors and every model is a plain function of (params, batch, cfg), as
in the reference and in the port's recsys models.

Message passing.  The reference sums messages with
``jax.ops.segment_sum(jnp.take(h, edge_src), edge_dst)``, a scatter-add.
On a card a scatter-add (``index_add_``) is atomics, and two runs of the
same step differ in the last bit.  The port sums over edges sorted by
destination instead (``segment.gather_segment_sum``: a two-level
``segment_reduce`` whose order of additions the data fixes, and whose
backward is the same reduction over edges sorted by source), so repeats
are bit-equal.

The sampler is split in two: ``sample_draws`` draws r uniformly in
[0, 2**30) from a ``torch.Generator`` (the reference draws with
``jax.random.randint``, whose bits a port cannot reproduce), and
``neighbors_from_draws`` is the reference's deterministic rest (``r %
max(deg, 1)``, the clip, the self-loop of a node of degree 0).  The
minibatch loss takes the sampled hops from the batch (``"l1"``, ``"l2"``)
where it has them, so a test can feed the reference's samples.

The molecule variant runs one pass over the G·n nodes of the batch, the
edge ids offset by each graph's first node, where the reference ``vmap``s
over graphs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.segment import (SegmentPlan, gather_segment_sum,
                                        segment_plan)

DRAW_HIGH = 1 << 30           # the sampler's draws are in [0, DRAW_HIGH)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 128
    d_feat: int = 602
    n_classes: int = 41
    aggregator: str = "mean"
    sample_sizes: tuple[int, ...] = (25, 10)
    task: str = "node"           # 'node' | 'graph'
    compute_dtype: str = "float32"


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: GNNConfig, device=None):
    """Seeded params with the reference's shapes and scales (normal draws
    from ``generator`` on its device, zero biases), on ``device`` (None =
    the CUDA card)."""
    from repro_torch.kernels import ops
    device = ops.resolve_device(device)

    def normal(shape, scale):
        z = torch.randn(shape, generator=generator, device=generator.device)
        return z.mul_(scale).to(device)

    params = {"layers": []}
    d_in = cfg.d_feat
    for _ in range(cfg.n_layers):
        s = 1.0 / np.sqrt(d_in)
        params["layers"].append({
            "w_self": normal((d_in, cfg.d_hidden), s),
            "w_neigh": normal((d_in, cfg.d_hidden), s),
            "b": torch.zeros(cfg.d_hidden, device=device),
        })
        d_in = cfg.d_hidden
    params["head"] = normal((d_in, cfg.n_classes), 1.0 / np.sqrt(d_in))
    return params


def _sage_layer(lp, h, h_neigh_mean, act=True):
    out = h @ lp["w_self"] + h_neigh_mean @ lp["w_neigh"] + lp["b"]
    if act:
        out = torch.relu(out)
    # L2-normalize as in the paper (GraphSAGE §3.1)
    norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    return out / torch.clamp_min(norm, 1e-6)


def _pick(logp, labels):
    """``take_along_axis(logp, labels[:, None], -1)[:, 0]`` as an indexed
    read, whose backward on a card is a sorted (deterministic) scatter."""
    rows = torch.arange(logp.shape[0], device=logp.device)
    return logp[rows, labels.long()]


def _propagate(params, x, plan: SegmentPlan, act_last: bool):
    inv_deg = 1.0 / torch.clamp_min(plan.in_degree.float(), 1.0)
    h = x
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        msg = gather_segment_sum(h, plan)
        h = _sage_layer(lp, h, msg * inv_deg[:, None],
                        act=act_last or i < n_layers - 1)
    return h


# ---------------------------------------------------------------------------
# full-batch (full_graph_sm / ogb_products)
# ---------------------------------------------------------------------------

def full_graph_forward(params, x, edge_src, edge_dst, cfg: GNNConfig):
    """x: (N, F); edge_src/dst: (E,) ints (messages flow src → dst)."""
    plan = segment_plan(edge_src, edge_dst, x.shape[0])
    return _propagate(params, x, plan, act_last=False) @ params["head"]


def node_loss(params, batch, cfg: GNNConfig):
    logits = full_graph_forward(params, batch["x"], batch["edge_src"],
                                batch["edge_dst"], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -_pick(logp, batch["labels"])
    mask = batch["train_mask"].float()
    return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0), {}


# ---------------------------------------------------------------------------
# neighbor sampler + sampled minibatch (minibatch_lg)
# ---------------------------------------------------------------------------

def sample_draws(generator: torch.Generator, shape) -> torch.Tensor:
    """r uniform in [0, 2**30), int64, on the generator's device."""
    return torch.randint(0, DRAW_HIGH, tuple(shape), generator=generator,
                         device=generator.device)


def neighbors_from_draws(indptr, indices, nodes, r):
    """The reference's ``sample_neighbors`` given its draws ``r`` (M,
    fanout): node i's neighbour ``r % max(deg, 1)`` of its CSR row, the
    read clipped into ``indices``, the node itself where its degree is 0."""
    nodes = nodes.long()
    start = indptr[nodes].long()
    deg = indptr[nodes + 1].long() - start
    off = r.long() % torch.clamp_min(deg, 1)[:, None]
    idx = torch.clamp(start[:, None] + off, 0, indices.shape[0] - 1)
    nbr = indices[idx].long()
    return torch.where(deg[:, None] > 0, nbr, nodes[:, None])


def sample_neighbors(generator, indptr, indices, nodes, fanout: int):
    """Uniform-with-replacement neighbor sampling from CSR: nodes (M,) →
    (M, fanout) neighbour ids (int64)."""
    r = sample_draws(generator, (nodes.shape[0], fanout))
    return neighbors_from_draws(indptr, indices, nodes, r)


def sample_hops(generator, indptr, indices, seeds, fanout):
    """The two hops of ``seeds`` (B,): l1 (B, f1), then l2 (B, f1, f2)."""
    B = seeds.shape[0]
    l1 = sample_neighbors(generator, indptr, indices, seeds, fanout[0])
    l2 = sample_neighbors(generator, indptr, indices, l1.reshape(-1),
                          fanout[1]).reshape(B, fanout[0], fanout[1])
    return l1, l2


def minibatch_forward(params, feats, seeds, l1, l2, cfg: GNNConfig):
    """2-hop sampled GraphSAGE forward for seed nodes given their hops.

    feats: (N, F) full feature table; seeds: (B,); l1 (B, f1); l2 (B, f1,
    f2)."""
    h_seed = feats[seeds.long()]                             # (B,F)
    h_l1 = feats[l1.long()]                                  # (B,f1,F)
    h_l2 = feats[l2.long()]                                  # (B,f1,f2,F)

    lp0, lp1 = params["layers"][0], params["layers"][1]
    # hop-2 → hop-1 (layer 0 applied to l1 nodes)
    h_l1_new = _sage_layer(lp0, h_l1, h_l2.mean(dim=2), act=True)
    # hop-1 → seeds (layer 0 applied to seeds)
    h_seed_new = _sage_layer(lp0, h_seed, h_l1.mean(dim=1), act=True)
    # layer 1 on seeds with aggregated new hop-1 states
    h_final = _sage_layer(lp1, h_seed_new, h_l1_new.mean(dim=1), act=False)
    return h_final @ params["head"]


def minibatch_loss(params, batch, generator, cfg: GNNConfig,
                   fanout: tuple[int, ...]):
    """Mean NLL of the seeds; the hops are ``batch["l1"]``, ``batch["l2"]``
    where the batch has them, else drawn from ``generator``."""
    if "l1" in batch:
        l1, l2 = batch["l1"], batch["l2"]
    else:
        l1, l2 = sample_hops(generator, batch["indptr"], batch["indices"],
                             batch["seeds"], fanout)
    logits = minibatch_forward(params, batch["feats"], batch["seeds"], l1,
                               l2, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    return -_pick(logp, batch["labels"]).mean(), {}


# ---------------------------------------------------------------------------
# batched small graphs (molecule)
# ---------------------------------------------------------------------------

def molecule_forward(params, x, edge_src, edge_dst, node_mask,
                     cfg: GNNConfig):
    """x: (G, n, F); edges: (G, e) per-graph local ids; node_mask (G, n)."""
    G, n, F = x.shape
    base = (torch.arange(G, device=x.device) * n)[:, None]
    plan = segment_plan((edge_src.long() + base).reshape(-1),
                        (edge_dst.long() + base).reshape(-1), G * n)
    h = _propagate(params, x.reshape(G * n, F), plan, act_last=True)
    h = h.reshape(G, n, -1)
    pooled = (h * node_mask[..., None]).sum(1) / torch.clamp_min(
        node_mask.sum(1), 1.0)[:, None]                     # (G, d)
    return pooled @ params["head"]


def molecule_loss(params, batch, cfg: GNNConfig):
    pred = molecule_forward(params, batch["x"], batch["edge_src"],
                            batch["edge_dst"], batch["node_mask"], cfg)
    err = (pred[:, 0] - batch["targets"]) ** 2
    return err.mean(), {}
