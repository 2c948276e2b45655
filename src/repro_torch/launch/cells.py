"""Dry-run cell builder: (arch × shape × mesh) → a ``LoweringCell`` with the
step function, its inputs as shape-and-dtype records and their shardings.

Port of ``src/repro/launch/cells.py``: how each of the 40 assigned cells
(+ the paper index's two) is laid out on the production meshes, read by
``launch/dryrun.py``.

- ``mesh`` is a bare description, ``{"data": 16, "model": 16}`` or
  ``{"pod": 2, "data": 16, "model": 16}``, or a ``DeviceMesh`` with those
  names: the rules (``distributed/sharding.py``) read only names and
  sizes, so a cell is built with no process group.  Building a cell binds
  its activation hints to ``mesh`` (``sharding.set_hint_rules``), as the
  reference's does.
- ``in_specs`` are trees of shape-and-dtype records with no storage:
  tensors on the ``meta`` device (the reference's ``ShapeDtypeStruct``),
  an LM's parameters the port's ``LM`` module made on ``meta``; the other
  families' parameter shapes come from their own ``init_params`` under
  ``FakeTensorMode``.  An LM leaf is one layer's, so its sharding is the
  reference's spec of the stacked leaf with the layer entry dropped
  (``sharding.lm_param_spec``).  The optimizer state is the port's:
  moments listed in the order of ``tree.leaves(params)``.
- ``in_shardings`` are the port's ``Sharding``s; uint32 inputs of the
  reference are int32 bit patterns here, as everywhere in the port.
- The reference's ``(2,)`` uint32 PRNG key has no tensor counterpart: its
  slot holds ``GENERATOR``, and the dry-run passes a ``torch.Generator``
  made at run time (only the GNN minibatch step draws from it).
- ``out_shardings``, where set, are applied by the dry-run by laying out
  the step's outputs anew at its end.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchSpec
from repro_torch.distributed import sharding as shd
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as recsys_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.serve import steps as serve_steps
from repro_torch.train import steps as train_steps

# the slot of the reference's PRNG key: a torch.Generator made at run time
GENERATOR = "generator"


@dataclasses.dataclass
class LoweringCell:
    arch_id: str
    shape_name: str
    fn: Callable
    in_specs: tuple          # trees of meta tensors (shape and dtype)
    in_shardings: tuple      # matching trees of sharding.Sharding
    static_meta: dict        # model_flops etc. for the roofline
    out_shardings: object = None   # None → whatever the step returns


def _ns(mesh, *spec) -> shd.Sharding:
    return shd.Sharding(mesh, shd._spec(spec))


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _pad_to(n: int, mult: int) -> int:
    return int(np.ceil(n / mult) * mult)


def _mesh_size(mesh, axes) -> int:
    sizes = shd.axis_sizes(mesh)
    s = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        s *= sizes[a]
    return s


def _set_lm_hints(mesh, seq_parallel: bool = True):
    dp = shd.batch_axes(mesh)
    shd.set_hint_rules({
        # Megatron-style sequence parallelism: residuals shard S over 'model'
        "act_resid": (dp, "model" if seq_parallel else None, None),
        "act_qkv": (dp, None, "model", None),
        "kv_cache": (dp, "model", None, None),  # S-sharded, matches decode
        "act_kv": (dp, None, None, None),       # explicit SP→replicated AG
        "moe_buffer": ("model", dp, None),
        "logits": (dp, None, "model"),
    }, mesh)


def _meta_tree(init: Callable):
    """The tree ``init()`` makes, as meta tensors: ``init`` runs under
    ``FakeTensorMode``, so no draw is made and no memory is taken."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = init()
    return tree_lib.unflatten(
        tree, [_sds(t.shape, t.dtype) for t in tree_lib.leaves(tree)],
        replace=True)


def _opt_specs(pshape, pshard, opt_cfg, mesh):
    """The port's AdamW state (moments in the order of the parameters'
    leaves) and its shardings: each moment takes its parameter's."""
    oshape = adamw.init(pshape, opt_cfg)
    leaf_shard = tree_lib.matching(pshape, pshard)
    return oshape, {"mu": list(leaf_shard), "nu": list(leaf_shard),
                    "step": _ns(mesh)}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_param_shardings(cfg, mesh):
    pshape = tfm.LM(cfg, "meta")
    rule = lambda path, shape, m: shd.lm_param_spec(path, shape, m,
                                                    cfg.sharding_preset)
    return pshape, shd.tree_param_shardings(pshape, mesh, rule)


def _lm_cell(spec: ArchSpec, shape_name: str, mesh) -> LoweringCell:
    cfg = spec.config
    sh = spec.shapes[shape_name]
    dp = shd.batch_axes(mesh)
    _set_lm_hints(mesh)
    pshape, pshard = _lm_param_shardings(cfg, mesh)
    B, S = sh["global_batch"], sh["seq_len"]
    model_flops = 6 * cfg.active_param_count() * B * S

    if sh["kind"] == "train":
        opt_cfg = adamw.AdamWConfig(
            moment_dtype="bfloat16" if cfg.param_dtype == "bfloat16"
            else "float32")
        oshape, oshard = _opt_specs(pshape, pshard, opt_cfg, mesh)
        fn = train_steps.make_lm_train_step(cfg, opt_cfg)
        batch = {"tokens": _sds((B, S), torch.int32),
                 "labels": _sds((B, S), torch.int32)}
        bshard = {"tokens": _ns(mesh, dp, None), "labels": _ns(mesh, dp, None)}
        return LoweringCell(
            spec.arch_id, shape_name, fn,
            (pshape, oshape, batch, GENERATOR),
            (pshard, oshard, bshard, _ns(mesh)),
            {"model_flops": model_flops})

    if sh["kind"] == "prefill":
        fn = serve_steps.make_prefill_step(cfg)
        tokens = _sds((B, S), torch.int32)
        return LoweringCell(
            spec.arch_id, shape_name, fn, (pshape, tokens),
            (pshard, _ns(mesh, dp, None)),
            {"model_flops": 2 * cfg.active_param_count() * B * S})

    if sh["kind"] == "decode":
        fn = serve_steps.make_decode_step(cfg)
        cdt = tfm._dtype(cfg.compute_dtype)
        cache_shape = (cfg.n_layers, B, S, cfg.n_kv, cfg.hd)
        cache = {"k": _sds(cache_shape, cdt), "v": _sds(cache_shape, cdt)}
        # decode sharding: batch over dp when divisible, KV length over
        # 'model' (flash-decoding-style split-K)
        bdim = dp if B % _mesh_size(mesh, dp) == 0 else None
        sdims = "model"
        if B == 1 and S % _mesh_size(mesh, dp + ("model",)) == 0:
            sdims = dp + ("model",)          # long-context: whole-mesh SP
        # flash-decoding hints: q replicated over 'model', logits S-sharded
        shd.set_hint_rules({
            "decode_q": (bdim, None, None, None),
            "decode_logits": (bdim, None, None, sdims),
            "moe_buffer": ("model", dp, None),
        }, mesh)
        cspec = _ns(mesh, None, bdim, sdims, None, None)
        cshard = {"k": cspec, "v": cspec}
        token = _sds((B,), torch.int32)
        pos = _sds((), torch.int32)
        # out_shardings pinned: without this the returned updated cache
        # may be replicated — an all-gather of the entire KV cache per
        # decoded token (the reference measured 4.3 s of collectives on
        # phi3 long_500k)
        out_sh = (_ns(mesh, bdim, "model" if cfg.vocab %
                      _mesh_size(mesh, "model") == 0 else None), cshard)
        return LoweringCell(
            spec.arch_id, shape_name, fn,
            (pshape, cache, token, pos),
            (pshard, cshard, _ns(mesh, bdim), _ns(mesh)),
            {"model_flops": 2 * cfg.active_param_count() * B
             + 2 * 2 * cfg.n_layers * B * S * cfg.n_kv * cfg.hd},
            out_shardings=out_sh)
    raise ValueError(sh["kind"])


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gnn_cell(spec: ArchSpec, shape_name: str, mesh) -> LoweringCell:
    sh = spec.shapes[shape_name]
    dp = shd.batch_axes(mesh)
    dp_all = dp + ("model",)
    dpn = _mesh_size(mesh, dp_all)
    shd.set_hint_rules({}, mesh)
    cfg = dataclasses.replace(spec.config, d_feat=sh["d_feat"],
                              n_classes=sh["n_classes"],
                              task="graph" if sh["kind"] == "molecule"
                              else "node")
    pshape = _meta_tree(lambda: gnn_lib.init_params(torch.Generator(), cfg,
                                                    "cpu"))
    pshard = shd.tree_param_shardings(pshape, mesh, shd.gnn_param_spec)
    opt_cfg = adamw.AdamWConfig(weight_decay=0.0)
    oshape, oshard = _opt_specs(pshape, pshard, opt_cfg, mesh)

    if sh["kind"] == "full":
        N = _pad_to(sh["n_nodes"], dpn)
        E = _pad_to(sh["n_edges"], dpn)
        fn = train_steps.make_gnn_train_step(cfg, "full", opt_cfg)
        batch = {"x": _sds((N, sh["d_feat"]), torch.float32),
                 "edge_src": _sds((E,), torch.int32),
                 "edge_dst": _sds((E,), torch.int32),
                 "labels": _sds((N,), torch.int32),
                 "train_mask": _sds((N,), torch.bool)}
        bshard = {"x": _ns(mesh, dp, None),
                  "edge_src": _ns(mesh, dp_all),
                  "edge_dst": _ns(mesh, dp_all),
                  "labels": _ns(mesh, dp), "train_mask": _ns(mesh, dp)}
        flops = 0
        for i in range(cfg.n_layers):
            din = sh["d_feat"] if i == 0 else cfg.d_hidden
            flops += 2 * N * din * cfg.d_hidden * 2 + 2 * E * din
        return LoweringCell(spec.arch_id, shape_name, fn,
                            (pshape, oshape, batch, GENERATOR),
                            (pshard, oshard, bshard, _ns(mesh)),
                            {"model_flops": 3 * flops})

    if sh["kind"] == "minibatch":
        N = _pad_to(sh["n_nodes"], dpn)
        E = _pad_to(sh["n_edges"], dpn)
        Bn = sh["batch_nodes"]
        f1, f2 = sh["fanout"]
        fn = train_steps.make_gnn_train_step(cfg, "minibatch", opt_cfg,
                                             fanout=sh["fanout"])
        batch = {"feats": _sds((N, sh["d_feat"]), torch.float32),
                 "indptr": _sds((N + 1,), torch.int32),
                 "indices": _sds((E,), torch.int32),
                 "seeds": _sds((Bn,), torch.int32),
                 "labels": _sds((Bn,), torch.int32)}
        bshard = {"feats": _ns(mesh, dp, None), "indptr": _ns(mesh),
                  "indices": _ns(mesh, dp_all),
                  "seeds": _ns(mesh, dp), "labels": _ns(mesh, dp)}
        n_sub = Bn * (1 + f1 + f1 * f2)
        flops = 2 * n_sub * sh["d_feat"] * cfg.d_hidden * 2 * 3
        return LoweringCell(spec.arch_id, shape_name, fn,
                            (pshape, oshape, batch, GENERATOR),
                            (pshard, oshard, bshard, _ns(mesh)),
                            {"model_flops": 3 * flops})

    if sh["kind"] == "molecule":
        G = sh["batch"]
        fn = train_steps.make_gnn_train_step(cfg, "molecule", opt_cfg)
        batch = {"x": _sds((G, sh["n_nodes"], sh["d_feat"]), torch.float32),
                 "edge_src": _sds((G, sh["n_edges"]), torch.int32),
                 "edge_dst": _sds((G, sh["n_edges"]), torch.int32),
                 "node_mask": _sds((G, sh["n_nodes"]), torch.float32),
                 "targets": _sds((G,), torch.float32)}
        bshard = {k: _ns(mesh, dp) if v.ndim == 1
                  else _ns(mesh, dp, *([None] * (v.ndim - 1)))
                  for k, v in batch.items()}
        flops = 2 * G * sh["n_nodes"] * sh["d_feat"] * cfg.d_hidden * 2 * 2
        return LoweringCell(spec.arch_id, shape_name, fn,
                            (pshape, oshape, batch, GENERATOR),
                            (pshard, oshard, bshard, _ns(mesh)),
                            {"model_flops": 3 * flops})
    raise ValueError(sh["kind"])


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_batch_specs(cfg, arch: str, B: int, mesh):
    dp = shd.batch_axes(mesh)
    L = cfg.seq_len
    bspec = _ns(mesh, dp) if B % _mesh_size(mesh, dp) == 0 else _ns(mesh)
    if arch == "din":
        specs = {"hist_items": _sds((B, L), torch.int32),
                 "hist_cates": _sds((B, L), torch.int32),
                 "hist_mask": _sds((B, L), torch.float32),
                 "target_item": _sds((B,), torch.int32),
                 "target_cate": _sds((B,), torch.int32),
                 "labels": _sds((B,), torch.int32)}
    elif arch == "sasrec":
        specs = {"hist": _sds((B, L), torch.int32),
                 "pos": _sds((B, L), torch.int32),
                 "neg": _sds((B, L), torch.int32),
                 "hist_mask": _sds((B, L), torch.float32),
                 "target_item": _sds((B,), torch.int32)}
    elif arch == "bert4rec":
        M = 8
        specs = {"hist": _sds((B, L), torch.int32),
                 "hist_mask": _sds((B, L), torch.float32),
                 "mask_pos": _sds((B, M), torch.int32),
                 "cands": _sds((B, M, 1 + cfg.n_neg), torch.int32),
                 "mask_valid": _sds((B, M), torch.float32),
                 "target_item": _sds((B,), torch.int32)}
    else:  # mind
        specs = {"hist": _sds((B, L), torch.int32),
                 "hist_mask": _sds((B, L), torch.float32),
                 "cands": _sds((B, 1 + cfg.n_neg), torch.int32),
                 "target_item": _sds((B,), torch.int32)}
    shards = {k: bspec if v.ndim == 1
              else (_ns(mesh, dp, *([None] * (v.ndim - 1)))
                    if B % _mesh_size(mesh, dp) == 0
                    else _ns(mesh))
              for k, v in specs.items()}
    return specs, shards


def _recsys_cell(spec: ArchSpec, shape_name: str, mesh) -> LoweringCell:
    cfg = spec.config
    sh = spec.shapes[shape_name]
    dp = shd.batch_axes(mesh)
    shd.set_hint_rules({}, mesh)
    pshape = _meta_tree(lambda: recsys_lib.INIT[cfg.arch](torch.Generator(),
                                                          cfg, "cpu"))
    pshard = shd.tree_param_shardings(pshape, mesh, shd.recsys_param_spec)
    # rough dense-compute model flops (embedding gathers excluded)
    d = cfg.embed_dim

    if sh["kind"] == "train":
        B = sh["batch"]
        opt_cfg = adamw.AdamWConfig(weight_decay=0.0)
        oshape, oshard = _opt_specs(pshape, pshard, opt_cfg, mesh)
        fn = train_steps.make_recsys_train_step(cfg, opt_cfg)
        batch, bshard = _recsys_batch_specs(cfg, cfg.arch, B, mesh)
        flops = _recsys_flops(cfg, B)
        return LoweringCell(spec.arch_id, shape_name, fn,
                            (pshape, oshape, batch, GENERATOR),
                            (pshard, oshard, bshard, _ns(mesh)),
                            {"model_flops": 3 * flops})

    if sh["kind"] == "score":
        B = sh["batch"]
        fn = serve_steps.make_recsys_score_step(cfg)
        batch, bshard = _recsys_batch_specs(cfg, cfg.arch, B, mesh)
        return LoweringCell(spec.arch_id, shape_name, fn,
                            (pshape, batch), (pshard, bshard),
                            {"model_flops": _recsys_flops(cfg, B)})

    if sh["kind"] == "retrieval":
        C = sh["n_candidates"]
        fn = serve_steps.make_recsys_retrieval_step(cfg, sh["top_k"])
        L = cfg.seq_len
        dp_all = dp + ("model",)
        cspec = _ns(mesh, dp_all) if C % _mesh_size(mesh, dp_all) == 0 \
            else _ns(mesh)
        batch = {"hist": _sds((L,), torch.int32),
                 "hist_items": _sds((L,), torch.int32),
                 "hist_cates": _sds((L,), torch.int32),
                 "hist_mask": _sds((L,), torch.float32),
                 "cand_items": _sds((C,), torch.int32),
                 "cand_cates": _sds((C,), torch.int32)}
        bshard = {"hist": _ns(mesh), "hist_items": _ns(mesh),
                  "hist_cates": _ns(mesh), "hist_mask": _ns(mesh),
                  "cand_items": cspec, "cand_cates": cspec}
        if cfg.arch == "din":
            flops = 2 * C * (cfg.seq_len * 8 * d * 80 + 3 * 2 * d * 200)
        else:
            flops = 2 * C * d
        return LoweringCell(spec.arch_id, shape_name, fn,
                            (pshape, batch), (pshard, bshard),
                            {"model_flops": flops})
    raise ValueError(sh["kind"])


def _recsys_flops(cfg, B: int) -> int:
    d, L = cfg.embed_dim, cfg.seq_len
    if cfg.arch == "din":
        att = L * (8 * d * 80 + 80 * 40 + 40)
        mlp = 6 * d * 200 + 200 * 80 + 80
        return 2 * B * (att + mlp)
    if cfg.arch in ("sasrec", "bert4rec"):
        dff = d if cfg.arch == "sasrec" else 4 * d
        per_block = 4 * d * d * L + 2 * L * L * d + 2 * L * d * dff
        return 2 * B * cfg.n_blocks * per_block
    # mind: routing iterations + sampled softmax
    return 2 * B * (L * d * d + cfg.capsule_iters * L * cfg.n_interests * d
                    + (1 + cfg.n_neg) * cfg.n_interests * d)


# ---------------------------------------------------------------------------
# paper-index cells (bonus)
# ---------------------------------------------------------------------------

def _compact_rows(r_batch, mask):
    """The reference's ``vmap(compact)``: each row's matched values moved
    to its front over a SENTINEL tail, and the row's count (a device
    tensor; no host read, no data-dependent shape)."""
    from repro_torch.core.intersect import SENTINEL
    Q, M = r_batch.shape
    idx = torch.cumsum(mask.to(torch.int32), dim=1) - 1
    pos = torch.where(mask, idx, M).long()        # out of range → dropped
    out = torch.full((Q, M + 1), int(SENTINEL), dtype=r_batch.dtype,
                     device=r_batch.device)
    out = out.scatter(1, pos, r_batch)[:, :M]
    return out, mask.to(torch.int32).sum(1)


def _index_cell(spec: ArchSpec, shape_name: str, mesh) -> LoweringCell:
    from repro_torch.core import bitpack as bp
    from repro_torch.core import deltas
    from repro_torch.core import intersect as its
    sh = spec.shapes[shape_name]
    dp = shd.batch_axes(mesh)
    shd.set_hint_rules({}, mesh)
    if sh["kind"] == "svs":
        Q, M, N = sh["n_queries"], sh["m"], sh["n"]

        def fn(r_batch, f_batch):
            mask = its.intersect_gallop(r_batch, f_batch)
            return _compact_rows(r_batch, mask)

        ins = (_sds((Q, M), torch.int32), _sds((Q, N), torch.int32))
        shards = (_ns(mesh, dp + ("model",), None),
                  _ns(mesh, dp + ("model",), None))
        return LoweringCell(spec.arch_id, shape_name, fn, ins, shards,
                            {"model_flops": Q * M * int(np.log2(N))})
    if sh["kind"] == "decode_lists":
        K = sh["n_blocks"]

        def fn(flat_words, widths, offsets, seeds):
            return deltas.prefix_sum(
                bp.unpack_deltas(flat_words, widths, offsets, 32), seeds,
                "d1")

        ins = (_sds((K * 32, 128), torch.int32), _sds((K,), torch.int32),
               _sds((K,), torch.int32), _sds((K,), torch.int32))
        shards = (_ns(mesh, dp + ("model",), None), _ns(mesh, dp),
                  _ns(mesh, dp), _ns(mesh, dp))
        return LoweringCell(spec.arch_id, shape_name, fn, ins, shards,
                            {"model_flops": K * 4096 * 8})
    raise ValueError(sh["kind"])


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

_BUILDERS = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "index": _index_cell}


def build_cell(spec: ArchSpec, shape_name: str, mesh) -> LoweringCell:
    if shape_name not in spec.shapes:
        raise KeyError(f"{spec.arch_id} has no shape {shape_name!r}")
    return _BUILDERS[spec.family](spec, shape_name, mesh)


def is_generator(spec: Any) -> bool:
    return isinstance(spec, str) and spec == GENERATOR
