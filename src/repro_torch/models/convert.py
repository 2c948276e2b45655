"""Carry a dense LM's weights into the port.

``params_from_numpy(tree, cfg, device)`` turns the reference's parameter
pytree, as plain numpy arrays, into the port's ``transformer.LM`` on
``device``.  The reference stacks every layer weight on a leading
``n_layers`` axis; the port holds one module per layer, so the arrays are
unstacked here:

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (V, d)],
     "layers": {"ln1": (L, d), "ln2": (L, d),
                "attn": {"wq", "wk", "wv", "wo"}: (L, ...),
                "mlp": {"w_in", "w_gate", "w_out"}: (L, ...)}}

It reads numpy only, so the port never imports the reference; whoever holds
a reference model writes its arrays into the dict (``np.asarray`` of each
leaf).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models import transformer


@torch.no_grad()
def params_from_numpy(tree: dict, cfg: transformer.LMConfig,
                      device=None) -> transformer.LM:
    """The port's LM on ``device`` (None = the CUDA card) holding the
    weights of ``tree``, laid out as the module docstring says."""
    device = ops.resolve_device(device)
    lm = transformer.LM(cfg, device)

    def put(p, a):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(f"shape {a.shape} for a weight of shape "
                             f"{tuple(p.shape)}")
        # a writable C-contiguous array (a JAX array's numpy view is
        # read-only, which torch.from_numpy warns about)
        p.copy_(torch.from_numpy(np.require(a, requirements=["C", "W"])))

    put(lm.embed, tree["embed"])
    put(lm.final_norm, tree["final_norm"])
    if lm.lm_head is not None:
        put(lm.lm_head, tree["lm_head"])
    ly = tree["layers"]
    stacked = {"ln1": ly["ln1"], "ln2": ly["ln2"], **ly["attn"], **ly["mlp"]}
    for i, layer in enumerate(lm.layers):
        for name, a in stacked.items():
            put(getattr(layer, name), np.asarray(a)[i])
    return lm
