"""RecSys architectures: DIN, SASRec, BERT4Rec, MIND — scoring and
retrieval.

Port of ``src/repro/models/recsys.py``: ``INIT``, ``LOSS`` (the training
objectives, each returning (loss, metrics)), ``SCORE`` and ``RETRIEVAL``.
Parameters are the reference's trees, as dicts and lists of float32
tensors, and every model is a plain function of (params, batch, cfg), as
in the reference.  Each arch's tree is laid out once, in ``SPECS``: a
leaf is (kind, shape, scale), which ``INIT`` fills with seeded normal
draws (or zeros) and ``convert.recsys_params_from_numpy`` checks a
reference tree against.  Tables are padded to a multiple of 4096 rows
(``_table``), positional embeddings are not.  Gathers are
``segment.take`` on the ids as given (int32 or int64): its backward sums
each table row's gradients by a deterministic segmented reduction, where
``index_select``'s backward is atomics (measured on the H100: repeats
unequal) and an indexed read's is a sorted scatter that sums a Zipf-hot
row one term at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import segment


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    arch: str                       # 'din' | 'sasrec' | 'bert4rec' | 'mind'
    n_items: int = 1 << 20
    n_cates: int = 1 << 12
    embed_dim: int = 64
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    attn_mlp: tuple[int, ...] = (80, 40)     # DIN attention MLP
    mlp: tuple[int, ...] = (200, 80)         # DIN prediction MLP
    n_interests: int = 4                     # MIND
    capsule_iters: int = 3                   # MIND
    n_neg: int = 127                         # sampled-softmax negatives
    compute_dtype: str = "float32"


# ---------------------------------------------------------------------------
# embedding substrate
# ---------------------------------------------------------------------------

take = segment.take


def embedding_bag(table, ids, mask, mode: str = "mean"):
    """EmbeddingBag: (B, L) ids + (B, L) mask → (B, d): a gather and a
    masked reduce."""
    e = take(table, ids)                             # (B, L, d)
    m = mask[..., None].to(e.dtype)
    if mode == "sum":
        return (e * m).sum(dim=1)
    if mode == "max":
        return torch.where(m > 0, e, -torch.inf).amax(dim=1)
    return (e * m).sum(dim=1) / torch.clamp_min(m.sum(dim=1), 1.0)


def _mlp(params, x, act=torch.relu, final_act=False):
    n = len(params)
    for i, lp in enumerate(params):
        x = x @ lp["w"] + lp["b"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# parameter layouts and init
# ---------------------------------------------------------------------------

def _normal(shape, scale: float):
    return ("normal", tuple(shape), float(scale))


def _zeros(shape):
    return ("zeros", tuple(shape), 0.0)


def _mlp_spec(dims):
    return [{"w": _normal((dims[i], dims[i + 1]), 1.0 / np.sqrt(dims[i])),
             "b": _zeros((dims[i + 1],))} for i in range(len(dims) - 1)]


def _table(n: int, d: int):
    """Rows padded to a 4096 multiple, as the reference pads them (padded
    ids are never emitted by the pipeline)."""
    n_pad = int(np.ceil(n / 4096) * 4096)
    return _normal((n_pad, d), 1.0 / np.sqrt(d))


def _pos(n: int, d: int):
    """Positional embeddings: exact length, never padded."""
    return _normal((n, d), 1.0 / np.sqrt(d))


def _blocks_spec(n_blocks: int, d: int, d_ff: int):
    s = 1.0 / np.sqrt(d)
    return [{"wq": _normal((d, d), s), "wk": _normal((d, d), s),
             "wv": _normal((d, d), s), "wo": _normal((d, d), s),
             "ln1": _zeros((d,)), "ln2": _zeros((d,)),
             "ffn_in": _normal((d, d_ff), s),
             "ffn_out": _normal((d_ff, d), 1.0 / np.sqrt(d_ff))}
            for _ in range(n_blocks)]


def din_spec(cfg: RecsysConfig):
    d = cfg.embed_dim
    de = 2 * d                                    # item ⊕ cate
    return {"item_table": _table(cfg.n_items, d),
            "cate_table": _table(cfg.n_cates, d),
            "att_mlp": _mlp_spec((4 * de,) + cfg.attn_mlp + (1,)),
            "pred_mlp": _mlp_spec((3 * de,) + cfg.mlp + (1,))}


def sasrec_spec(cfg: RecsysConfig):
    d = cfg.embed_dim
    return {"item_table": _table(cfg.n_items + 1, d),       # +1 pad id
            "pos_embed": _pos(cfg.seq_len, d),
            "blocks": _blocks_spec(cfg.n_blocks, d, d)}


def bert4rec_spec(cfg: RecsysConfig):
    d = cfg.embed_dim
    return {"item_table": _table(cfg.n_items + 2, d),       # +pad +[MASK]
            "pos_embed": _pos(cfg.seq_len, d),
            "blocks": _blocks_spec(cfg.n_blocks, d, 4 * d)}


def mind_spec(cfg: RecsysConfig):
    d = cfg.embed_dim
    return {"item_table": _table(cfg.n_items, d),
            "w_caps": _normal((d, d), 1.0 / np.sqrt(d)),
            "route_init": _normal((cfg.seq_len, cfg.n_interests), 0.1)}


SPECS = {"din": din_spec, "sasrec": sasrec_spec, "bert4rec": bert4rec_spec,
         "mind": mind_spec}


def is_leaf(node) -> bool:
    return isinstance(node, tuple) and len(node) == 3 and \
        isinstance(node[0], str)


def map_spec(fn, spec):
    """Apply ``fn(leaf)`` over a layout tree, keeping its dicts and lists."""
    if is_leaf(spec):
        return fn(spec)
    if isinstance(spec, dict):
        return {k: map_spec(fn, v) for k, v in spec.items()}
    return [map_spec(fn, v) for v in spec]


def _init(arch: str):
    @torch.no_grad()
    def init(generator: torch.Generator, cfg: RecsysConfig, device=None):
        """Seeded params of ``cfg`` with the reference's shapes and scales,
        drawn on the generator's device, placed on ``device`` (None = the
        CUDA card)."""
        device = ops.resolve_device(device)

        def leaf(spec):
            kind, shape, scale = spec
            if kind == "zeros":
                return torch.zeros(shape, device=device)
            z = torch.randn(shape, generator=generator,
                            device=generator.device)
            return z.mul_(scale).to(device)
        return map_spec(leaf, SPECS[arch](cfg))
    init.__name__ = f"init_{arch}"
    return init


INIT = {arch: _init(arch) for arch in SPECS}


# ---------------------------------------------------------------------------
# DIN — target attention CTR (arXiv:1706.06978)
# ---------------------------------------------------------------------------

def _din_user_vec(params, hist_items, hist_cates, hist_mask, e_t):
    eh = torch.cat([take(params["item_table"], hist_items),
                    take(params["cate_table"], hist_cates)], -1)  # (B,L,2d)
    et = e_t[:, None, :]
    z = torch.cat([eh, et.expand_as(eh), eh - et, eh * et], -1)
    w = _mlp(params["att_mlp"], z, act=torch.sigmoid)[..., 0]      # (B,L)
    w = w * hist_mask                              # DIN: no softmax (paper §4)
    return torch.einsum("bl,bld->bd", w, eh)


def _din_target(params, items, cates):
    return torch.cat([take(params["item_table"], items),
                      take(params["cate_table"], cates)], -1)


def din_score(params, batch, cfg: RecsysConfig):
    e_t = _din_target(params, batch["target_item"], batch["target_cate"])
    user = _din_user_vec(params, batch["hist_items"], batch["hist_cates"],
                         batch["hist_mask"], e_t)
    z = torch.cat([user, e_t, user * e_t], -1)
    return _mlp(params["pred_mlp"], z)[..., 0]     # logits (B,)


def din_loss(params, batch, cfg: RecsysConfig):
    logits = din_score(params, batch, cfg)
    labels = batch["labels"].float()
    loss = torch.mean(
        torch.clamp_min(logits, 0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))
    return loss, {"logit_mean": logits.mean()}


def din_retrieval(params, batch, cfg: RecsysConfig):
    """1 user vs n_candidates: target attention per candidate."""
    e_t = _din_target(params, batch["cand_items"], batch["cand_cates"])
    C = e_t.shape[0]
    user = _din_user_vec(
        params, batch["hist_items"].expand(C, cfg.seq_len),
        batch["hist_cates"].expand(C, cfg.seq_len),
        batch["hist_mask"].expand(C, cfg.seq_len), e_t)
    z = torch.cat([user, e_t, user * e_t], -1)
    return _mlp(params["pred_mlp"], z)[..., 0]     # (C,)


# ---------------------------------------------------------------------------
# SASRec (arXiv:1808.09781) and BERT4Rec (arXiv:1904.06690)
# ---------------------------------------------------------------------------

def _attn_blocks(blocks, x, n_heads, causal):
    B, S, d = x.shape
    hd = d // n_heads
    for bp in blocks:
        h = L.rms_norm(x, bp["ln1"])
        q = (h @ bp["wq"]).reshape(B, S, n_heads, hd)
        k = (h @ bp["wk"]).reshape(B, S, n_heads, hd)
        v = (h @ bp["wv"]).reshape(B, S, n_heads, hd)
        a = L.attention_full(q, k, v, causal=causal)
        x = x + a.reshape(B, S, d) @ bp["wo"]
        h = L.rms_norm(x, bp["ln2"])
        x = x + torch.relu(h @ bp["ffn_in"]) @ bp["ffn_out"]
    return x


def sasrec_hidden(params, hist, mask, cfg: RecsysConfig):
    x = take(params["item_table"], hist) + params["pos_embed"][None]
    x = x * mask[..., None]
    return _attn_blocks(params["blocks"], x, cfg.n_heads, causal=True)


def bert4rec_hidden(params, hist, mask, cfg: RecsysConfig):
    x = take(params["item_table"], hist) + params["pos_embed"][None]
    x = x * mask[..., None]
    return _attn_blocks(params["blocks"], x, cfg.n_heads, causal=False)


def sasrec_loss(params, batch, cfg: RecsysConfig):
    """Per-position next-item with one sampled negative (paper's objective)."""
    h = sasrec_hidden(params, batch["hist"], batch["hist_mask"], cfg)
    s_pos = torch.sum(h * take(params["item_table"], batch["pos"]), -1)
    s_neg = torch.sum(h * take(params["item_table"], batch["neg"]), -1)
    m = batch["hist_mask"]
    loss = -(torch.log(torch.sigmoid(s_pos) + 1e-9)
             + torch.log(1 - torch.sigmoid(s_neg) + 1e-9)) * m
    return loss.sum() / torch.clamp_min(m.sum(), 1.0), {}


def bert4rec_loss(params, batch, cfg: RecsysConfig):
    """Cloze objective over sampled candidates (1 true + n_neg) at masked
    positions (sampled softmax, as the reference)."""
    h = bert4rec_hidden(params, batch["hist"], batch["hist_mask"], cfg)
    mpos = batch["mask_pos"].long()                # (B, M) positions
    rows = torch.arange(h.shape[0], device=h.device)[:, None]
    hm = h[rows, mpos]                             # (B, M, d)
    e_c = take(params["item_table"], batch["cands"])            # (B,M,C,d)
    logits = torch.einsum("bmd,bmcd->bmc", hm, e_c)
    logp = torch.log_softmax(logits, -1)
    m = batch["mask_valid"].float()                # (B, M)
    return -(logp[..., 0] * m).sum() / torch.clamp_min(m.sum(), 1.0), {}


def _seq_score(hidden):
    def score(params, batch, cfg: RecsysConfig):
        h = hidden(params, batch["hist"], batch["hist_mask"], cfg)
        e_t = take(params["item_table"], batch["target_item"])
        return torch.sum(h[:, -1] * e_t, -1)
    return score


def _seq_retrieval(hidden):
    def retrieval(params, batch, cfg: RecsysConfig):
        h = hidden(params, batch["hist"][None], batch["hist_mask"][None],
                   cfg)[0, -1]                         # (d,)
        e_c = take(params["item_table"], batch["cand_items"])
        return e_c @ h                                 # (C,)
    return retrieval


sasrec_score, sasrec_retrieval = (_seq_score(sasrec_hidden),
                                  _seq_retrieval(sasrec_hidden))
bert4rec_score, bert4rec_retrieval = (_seq_score(bert4rec_hidden),
                                      _seq_retrieval(bert4rec_hidden))


# ---------------------------------------------------------------------------
# MIND — multi-interest capsule routing (arXiv:1904.08030)
# ---------------------------------------------------------------------------

def _squash(s):
    n2 = torch.sum(s * s, -1, keepdim=True)
    return (n2 / (1 + n2)) * s / torch.sqrt(n2 + 1e-9)


def mind_interests(params, hist, mask, cfg: RecsysConfig):
    """Dynamic B2I routing (fixed shared init logits, ``capsule_iters``
    iterations; padded history positions masked with -1e9)."""
    eh = take(params["item_table"], hist) @ params["w_caps"]    # (B,L,d)
    B, Lh, d = eh.shape
    b = params["route_init"][None].expand(B, Lh, cfg.n_interests)
    neg = -1e9 * (1.0 - mask)[..., None]
    caps = None
    for _ in range(cfg.capsule_iters):
        c = torch.softmax(b + neg, dim=1)                # over history
        s = torch.einsum("blk,bld->bkd", c, eh)
        caps = _squash(s)                                # (B,K,d)
        b = b + torch.einsum("bkd,bld->blk", caps, eh)
    return caps


def mind_loss(params, batch, cfg: RecsysConfig):
    """Sampled softmax with label-aware max-interest scoring."""
    caps = mind_interests(params, batch["hist"], batch["hist_mask"], cfg)
    e_c = take(params["item_table"], batch["cands"])          # (B,C,d)
    scores = torch.einsum("bkd,bcd->bkc", caps, e_c).amax(dim=1)
    logp = torch.log_softmax(scores, -1)
    return -logp[:, 0].mean(), {}


def mind_score(params, batch, cfg: RecsysConfig):
    caps = mind_interests(params, batch["hist"], batch["hist_mask"], cfg)
    e_t = take(params["item_table"], batch["target_item"])
    return torch.einsum("bkd,bd->bk", caps, e_t).amax(-1)


def mind_retrieval(params, batch, cfg: RecsysConfig):
    caps = mind_interests(params, batch["hist"][None],
                          batch["hist_mask"][None], cfg)[0]   # (K,d)
    e_c = take(params["item_table"], batch["cand_items"])
    return (e_c @ caps.T).amax(-1)                            # (C,)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

LOSS = {"din": din_loss, "sasrec": sasrec_loss, "bert4rec": bert4rec_loss,
        "mind": mind_loss}
SCORE = {"din": din_score, "sasrec": sasrec_score, "bert4rec": bert4rec_score,
         "mind": mind_score}
RETRIEVAL = {"din": din_retrieval, "sasrec": sasrec_retrieval,
             "bert4rec": bert4rec_retrieval, "mind": mind_retrieval}
