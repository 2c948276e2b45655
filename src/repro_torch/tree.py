"""Parameter trees: the pytree helpers the reference gets from JAX.

A tree is a tensor, ``None`` (no leaf), a dict (leaves in sorted-key
order, as ``jax.tree.leaves`` orders them), a list or tuple, or an
``nn.Module`` (its parameters in registration order, as the port's
``transformer.LM`` holds an LM's weights).  The optimizer, the train
steps and the checkpoint manager walk trees through these functions.
"""

from __future__ import annotations

import torch
from torch import nn


def leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in flattening order."""
    return [t for _, t in items(tree)]


def items(tree, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for each leaf, the path written as
    ``jax.tree_util.keystr`` writes one (``['params']['layers'][0]['b']``;
    a module's parameter as ``.name``)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, nn.Module):
        return [(f"{path}.{name}", p) for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in items(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in items(v, f"{path}[{i}]")]
    raise TypeError(f"not a tree node at {path or '/'}: {type(tree)}")


def unflatten(template, values: list[torch.Tensor]):
    """A tree shaped as ``template`` holding ``values`` (in flattening
    order), each moved to its template leaf's device and dtype.  Dicts,
    lists and tuples are new; an ``nn.Module`` takes its values into its
    parameters in place and is returned itself."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return next(it).to(device=node.device, dtype=node.dtype)
        if isinstance(node, nn.Module):
            with torch.no_grad():
                for p in node.parameters():
                    p.copy_(next(it))
            return node
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return type(node)(build(v) for v in node)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out

