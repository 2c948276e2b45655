"""Parameter trees: the pytree helpers the reference gets from JAX.

A tree is a tensor, ``None`` (no leaf), a dict (leaves in sorted-key
order, as ``jax.tree.leaves`` orders them), a list or tuple, or an
``nn.Module`` (its parameters in registration order, as the port's
``transformer.LM`` holds an LM's weights).  The optimizer, the train
steps, the checkpoint manager and the sharding rules walk trees through
these functions.  A tree that matches a template holds one node for each
of the template's leaves, in its structure; for an ``nn.Module`` that is
a dict keyed by parameter name.
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


def paths(tree) -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for each leaf in flattening order, the path's keys
    joined by '/' (``layers/0/moe/w_in``, ``blocks/1/wq``), as the
    reference's sharding rules read them."""
    names = matching(tree, map_leaves(lambda path, t: path, tree))
    return list(zip(names, leaves(tree)))


def map_leaves(fn, tree):
    """A tree matching ``tree`` holding ``fn(path, tensor)`` at each leaf
    (paths as ``paths`` writes them)."""
    def build(node, prefix):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return fn(prefix, node)
        if isinstance(node, nn.Module):
            return {name: fn(f"{prefix}/{name}".strip("/").replace(".", "/"),
                             p) for name, p in node.named_parameters()}
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}/{k}".strip("/"))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}/{i}".strip("/"))
                              for i, v in enumerate(node))
        raise TypeError(f"not a tree node at {prefix or '/'}: {type(node)}")
    return build(tree, "")


def matching(template, other) -> list:
    """The nodes of ``other``, a tree matching ``template``, at the
    template's leaves, in flattening order."""
    if template is None:
        return []
    if isinstance(template, torch.Tensor):
        return [other]
    if isinstance(template, nn.Module):
        return [other[name] for name, _ in template.named_parameters()]
    if isinstance(template, dict):
        return [x for k in sorted(template)
                for x in matching(template[k], other[k])]
    if isinstance(template, (list, tuple)):
        if len(template) != len(other):
            raise ValueError("the trees do not match")
        return [x for t, o in zip(template, other) for x in matching(t, o)]
    raise TypeError(f"not a tree node: {type(template)}")


def unflatten(template, values: list[torch.Tensor], *, replace=False):
    """A tree shaped as ``template`` holding ``values`` (in flattening
    order), each moved to its template leaf's device and dtype.  Dicts,
    lists and tuples are new; an ``nn.Module`` takes its values into its
    parameters in place and is returned itself.  With ``replace`` the
    values go in as they are (DTensors laid out on a mesh, say): each
    leaf is its value, and a module's parameters are replaced by
    parameters holding them."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            v = next(it)
            return v if replace else v.to(device=node.device,
                                           dtype=node.dtype)
        if isinstance(node, nn.Module):
            with torch.no_grad():
                for name, p in list(node.named_parameters()):
                    v = next(it)
                    if not replace:
                        p.copy_(v)
                        continue
                    owner, _, attr = name.rpartition(".")
                    setattr(node.get_submodule(owner), attr,
                            nn.Parameter(v, requires_grad=p.requires_grad))
            return node
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return type(node)(build(v) for v in node)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out

