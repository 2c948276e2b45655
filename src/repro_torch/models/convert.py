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
layout in ``recsys.SPECS``.

Both read numpy only, so the port never imports the reference; whoever holds
a reference model writes its arrays into the dict (``np.asarray`` of each
leaf).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import recsys, transformer


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
