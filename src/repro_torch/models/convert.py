"""Carry an LM's or a recsys model's weights into the port.

``params_from_numpy(tree, cfg, device)`` turns the reference's parameter
pytree, as plain numpy arrays, into the port's ``transformer.LM`` on
``device``.  The reference stacks every layer weight on a leading
``n_layers`` axis; the port holds one module per layer, so the arrays are
unstacked here:

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (V, d)],
     "layers": {"ln1": (L, d), "ln2": (L, d),
                "attn": {"wq", "wk", "wv", "wo"}: (L, ...),
                "mlp": {"w_in", "w_gate", "w_out"}: (L, ...)}}

or, for an MoE config, ``"moe": {"router": (L, d, E), "w_in", "w_gate":
(L, E, d, F), "w_out": (L, E, F, d)}`` in place of ``"mlp"``.

``recsys_params_from_numpy(tree, cfg, device)`` does the same for a recsys
model: the reference's tree of dicts and lists (``recsys.INIT``'s) becomes
the port's tree of float32 tensors, checked leaf for leaf against the
layout in ``recsys.SPECS``.  ``gnn_params_from_numpy(tree, cfg, device)``
does it for a GNN (``{"layers": [{"w_self", "w_neigh", "b"}, ...],
"head"}``).

``opt_state_from_numpy(state, params, device)`` carries the reference's
AdamW state (``{"mu": tree, "nu": tree, "step": scalar}``, each moment
tree shaped as the reference's params) across to the port's
(``optim.adamw``: the moments as lists in the order of
``tree.leaves(params)``), for an LM, a recsys model or a GNN: each moment
tree is converted as that family's params are, and its leaves taken.

Both read numpy only, so the port never imports the reference; whoever holds
a reference model writes its arrays into the dict (``np.asarray`` of each
leaf).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels import ops
from repro_torch.models import gnn, recsys, transformer


def _tensor(a, shape, device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, if it has ``shape``; else
    ValueError.  An ml_dtypes bf16 array is widened to float32 (exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"shape {a.shape} for a weight of shape "
                         f"{tuple(shape)}")
    # a writable C-contiguous array (a JAX array's numpy view is read-only,
    # which torch.from_numpy warns about)
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(device)


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: transformer.LMConfig,
                      device=None) -> transformer.LM:
    """The port's LM on ``device`` (None = the CUDA card) holding the
    weights of ``tree``, laid out as the module docstring says."""
    device = ops.resolve_device(device)
    lm = transformer.LM(cfg, device)

    def put(p, a):
        p.copy_(_tensor(a, p.shape, "cpu"))

    put(lm.embed, tree["embed"])
    put(lm.final_norm, tree["final_norm"])
    if lm.lm_head is not None:
        put(lm.lm_head, tree["lm_head"])
    ly = tree["layers"]
    ffn = ({f"moe.{k}": a for k, a in ly["moe"].items()} if cfg.is_moe
           else ly["mlp"])
    stacked = {"ln1": ly["ln1"], "ln2": ly["ln2"], **ly["attn"], **ffn}
    for i, layer in enumerate(lm.layers):
        for name, a in stacked.items():
            put(layer.get_parameter(name), np.asarray(a)[i])
    return lm


def recsys_params_from_numpy(tree, cfg: recsys.RecsysConfig, device=None):
    """The port's recsys params of ``cfg`` on ``device`` (None = the CUDA
    card) holding the arrays of ``tree``; ValueError where the tree's
    structure or a leaf's shape is not the layout of ``recsys.SPECS``."""
    device = ops.resolve_device(device)

    def walk(spec, node, path):
        if recsys.is_leaf(spec):
            return _tensor(node, spec[1], device).float()
        if isinstance(spec, dict):
            if not isinstance(node, dict) or sorted(node) != sorted(spec):
                raise ValueError(f"{cfg.arch} params at {path or '/'}: keys "
                                 f"{sorted(node)}, want {sorted(spec)}")
            return {k: walk(v, node[k], f"{path}/{k}")
                    for k, v in spec.items()}
        if not isinstance(node, (list, tuple)) or len(node) != len(spec):
            raise ValueError(f"{cfg.arch} params at {path}: want a list of "
                             f"{len(spec)}")
        return [walk(v, n, f"{path}/{i}")
                for i, (v, n) in enumerate(zip(spec, node))]
    return walk(recsys.SPECS[cfg.arch](cfg), tree, "")


def gnn_params_from_numpy(tree, cfg: gnn.GNNConfig, device=None):
    """The port's GNN params of ``cfg`` on ``device`` (None = the CUDA card)
    holding the arrays of ``tree``; ValueError on another structure or a
    leaf of another shape."""
    device = ops.resolve_device(device)
    if not isinstance(tree, dict) or sorted(tree) != ["head", "layers"] \
            or len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"GNN params: want head and {cfg.n_layers} layers")
    layers = []
    d_in = cfg.d_feat
    for lp in tree["layers"]:
        if sorted(lp) != ["b", "w_neigh", "w_self"]:
            raise ValueError(f"GNN layer keys {sorted(lp)}")
        layers.append({
            "w_self": _tensor(lp["w_self"], (d_in, cfg.d_hidden), device),
            "w_neigh": _tensor(lp["w_neigh"], (d_in, cfg.d_hidden), device),
            "b": _tensor(lp["b"], (cfg.d_hidden,), device)})
        d_in = cfg.d_hidden
    return {"layers": layers,
            "head": _tensor(tree["head"], (d_in, cfg.n_classes), device)}


def _np_leaves(node) -> list:
    """A reference tree's arrays in ``jax.tree.leaves`` order."""
    if isinstance(node, dict):
        return [a for k in sorted(node) for a in _np_leaves(node[k])]
    if isinstance(node, (list, tuple)):
        return [a for v in node for a in _np_leaves(v)]
    return [node]


def _lm_leaf(tree, name: str):
    """The reference array (one layer's slice of a stacked one) behind the
    port LM's parameter ``name``."""
    parts = name.split(".")
    if parts[0] != "layers":
        return tree[parts[0]]
    i, rest = int(parts[1]), parts[2:]
    ly = tree["layers"]
    if rest[0] == "moe":
        return np.asarray(ly["moe"][rest[1]])[i]
    if rest[0] in ("ln1", "ln2"):
        return np.asarray(ly[rest[0]])[i]
    group = "attn" if rest[0] in ("wq", "wk", "wv", "wo") else "mlp"
    return np.asarray(ly[group][rest[0]])[i]


def opt_state_from_numpy(state, params, device=None):
    """The port's AdamW state (``optim.adamw``) for ``params`` (a
    ``transformer.LM``, a recsys or a GNN tree) from the reference's
    ``{"mu", "nu", "step"}``; each moment keeps its dtype (float32, or bf16
    from an ml_dtypes array).  ValueError where a moment's shape is not
    its parameter's."""
    device = ops.resolve_device(device)
    named = tree_lib.items(params)
    if isinstance(params, transformer.LM):
        def arrays(m):
            return [_lm_leaf(m, path[1:]) for path, _ in named]
    else:
        arrays = _np_leaves

    def moments(m):
        arrs = arrays(m)
        if len(arrs) != len(named):
            raise ValueError(f"{len(arrs)} moments for {len(named)} params")
        out = []
        for a, (path, p) in zip(arrs, named):
            a = np.asarray(a)
            dt = torch.bfloat16 if a.dtype.name == "bfloat16" \
                else torch.float32
            out.append(_tensor(a, p.shape, device).to(dt))
        return out

    return {"mu": moments(state["mu"]), "nu": moments(state["nu"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=device)}
