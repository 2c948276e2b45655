"""Sharding rules: parameter specs per model family, their placements on a
torch ``DeviceMesh``, and activation hints.

Port of ``src/repro/distributed/sharding.py``.  Mesh axes are ('pod',
'data', 'model') multi-pod or ('data', 'model') single-pod.  The batch
shards over ``batch_axes`` = ('pod', 'data') (whichever exist), tensor
and expert parallelism run over 'model', and the ``fsdp`` preset also
shards large weight dims over 'data'.

- A *spec* is a tuple with one entry per dim: ``None``, an axis name, or
  a tuple of axis names, written as ``tuple(PartitionSpec(...))`` writes
  it (an entry of one name is that name, an empty entry ``None``).
- A *mesh*, for the rules, is a ``DeviceMesh`` with ``mesh_dim_names`` or
  a bare description: a mapping of axis name to size in mesh order
  (``{"data": 16, "model": 16}``).  The rules read only names and sizes,
  so a 256-chip mesh is described with no process group.
- ``Sharding(mesh, spec)`` is the port's ``NamedSharding``; its
  ``placements`` are DTensor's: ``Shard(d)`` on each mesh dim whose axis
  names dim d, ``Replicate()`` elsewhere.  A dim sharded over a tuple of
  axes is split in mesh order, the first axis major, as JAX splits it.
- The layer axis: the reference stacks each LM layer weight on a leading
  ``n_layers`` axis; the port holds one module a layer
  (``models/convert.py``).  ``lm_param_spec`` of a port leaf is the
  reference's spec of the stacked leaf with its first entry dropped.  The
  one rule that reads the rank does so: a layer's expert stack (E, d, F)
  is 3-D here, 4-D there, with its expert axis first.

DTensors are used only where a caller made one: this module imports
``torch.distributed.tensor`` inside the functions that build them.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any

import torch

from repro_torch import tree as tree_lib

# ---------------------------------------------------------------------------
# meshes, specs and placements
# ---------------------------------------------------------------------------


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh`` or a bare
    description."""
    if hasattr(mesh, "mesh_dim_names"):
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh has no mesh_dim_names")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def _spec(entries) -> tuple:
    """``entries`` written as ``tuple(PartitionSpec(*entries))`` writes
    them: a 1-tuple becomes its name, an empty tuple ``None``."""
    out = []
    for e in entries:
        if isinstance(e, tuple) and len(e) <= 1:
            e = e[0] if e else None
        out.append(e)
    return tuple(out)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is sharded over {entry}, not in the "
                             f"mesh's order {tuple(names)}: DTensor splits "
                             f"a dim over mesh dims in mesh order")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"axis {names[i]!r} shards two dims of "
                                 f"{spec}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The port's ``NamedSharding``: a mesh and a spec."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (none exists before
    ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def mesh_group(mesh):
    """The process group of every rank of ``mesh``: its own group if it
    has one dim, else the world, which a mesh of more dims must span (as
    ``launch.mesh``'s meshes do)."""
    import torch.distributed as dist
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}")
    return dist.group.WORLD


def block(t: torch.Tensor, mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of the global ``t`` under ``spec`` (a view; each
    sharded dim must divide by its axes' size), the block that
    ``distribute_tensor`` places here."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    coord = mesh.get_coordinate()
    for d, entry in enumerate(spec):
        idx, n = 0, 1
        for a in _axes(entry):
            idx = idx * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
        if n > 1:
            if t.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"divide over {entry} ({n})")
            size = t.shape[d] // n
            t = t.narrow(d, idx * size, size)
    return t


def distribute(t: torch.Tensor, sharding: Sharding):
    """``t`` (the whole value, on every rank) as a DTensor laid out by
    ``sharding`` on its mesh's device: each rank keeps its block, with no
    communication and no copy where the block is contiguous and already
    on that device (an expert stack's block is a view)."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    local = block(t.detach(), mesh, sharding.spec)
    local = local.to(mesh.device_type).contiguous()
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False)


def distribute_tree(params, shardings):
    """``params`` laid out as DTensors by ``shardings`` (a tree matching
    it, as ``tree_param_shardings`` makes).  Dicts and lists are new; an
    ``nn.Module``'s parameters are replaced in place."""
    values = [distribute(t, s) for t, s in
              zip(tree_lib.leaves(params),
                  tree_lib.matching(params, shardings))]
    return tree_lib.unflatten(params, values, replace=True)


# ---------------------------------------------------------------------------
# mesh-aware hint plumbing
# ---------------------------------------------------------------------------

_HINT_RULES: dict[str, tuple] = {}
_HINT_MESH: list = [None]


def set_hint_rules(rules: dict[str, tuple], mesh=None) -> None:
    """Register activation-sharding hints (name → spec) and the mesh they
    bind to.  With no mesh (tests, one-card runs) hints are the
    identity."""
    _HINT_RULES.clear()
    _HINT_RULES.update(rules)
    _HINT_MESH[0] = mesh


def shard_hint(x, name: str):
    """``x`` redistributed to the rule's placements, for a DTensor under a
    bound mesh with a rule registered for ``name``; otherwise ``x`` itself.
    The value never changes."""
    spec = _HINT_RULES.get(name)
    mesh = _HINT_MESH[0]
    if spec is None or mesh is None or not is_dtensor(x):
        return x
    if x.ndim < len(spec):
        return x
    return x.redistribute(mesh, placements(mesh, _spec(spec)))


def current_mesh():
    """Mesh bound by set_hint_rules (None outside launcher contexts)."""
    return _HINT_MESH[0]


def batch_axes(mesh) -> tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _divisible(dim: int, mesh, axis) -> bool:
    sizes = axis_sizes(mesh)
    size = math.prod(sizes[a] for a in _axes(axis))
    return dim % size == 0 and dim >= size


def lm_param_spec(path: str, shape: tuple[int, ...], mesh,
                  preset: str = "tp") -> tuple:
    """Name-based Megatron-style rules for one layer's LM params.

    path: '/'-joined key path of a port leaf, e.g. 'layers/3/wq' or
    'layers/3/moe/w_in'; shape: that leaf's shape (one layer's).
    """
    dp = batch_axes(mesh)
    specs: list[Any] = [None] * len(shape)

    def put(idx: int, axis) -> bool:
        if specs[idx] is None and _divisible(shape[idx], mesh, axis):
            specs[idx] = axis
            return True
        return False

    name = path.split("/")[-1]
    if "moe" in path and len(shape) == 3:
        # a layer's expert stack (E, D, F) / (E, F, D): the reference's
        # (L, E, D, F) rule with L dropped, experts → EP
        put(0, "model")
        if preset == "fsdp":
            put(1, "data")
    elif name in ("embed", "lm_head"):
        # (V, D): vocab over model (col-parallel logits)
        put(0, "model")
        if preset == "fsdp":
            put(1, dp if len(dp) == 1 else "data")
    elif name in ("wq", "wk", "wv", "w_in", "w_gate"):
        put(len(shape) - 1, "model")       # output-feature parallel
        if preset == "fsdp":
            put(len(shape) - 2, "data")
    elif name in ("wo", "w_out"):
        put(len(shape) - 2, "model")       # input-feature parallel
        if preset == "fsdp":
            put(len(shape) - 1, "data")
    # router (small), norms, scalars: replicated
    return _spec(specs)


def recsys_param_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    name = path.split("/")[-1]
    if "table" in name or name == "embed":
        # (V, d): column-shard d over 'model' if divisible, else rows
        if _divisible(shape[-1], mesh, "model"):
            return (None, "model")
        if _divisible(shape[0], mesh, "model"):
            return ("model", None)
    return (None,) * len(shape)


def gnn_param_spec(path: str, shape: tuple[int, ...], mesh) -> tuple:
    if len(shape) == 2 and _divisible(shape[-1], mesh, "model"):
        return (None, "model")
    return (None,) * len(shape)


def tree_param_shardings(params, mesh, rule) -> Any:
    """Map ``rule(path, shape, mesh)`` over a params tree to a tree of
    ``Sharding``s matching it (an ``nn.Module`` maps to a dict by
    parameter name)."""
    return tree_lib.map_leaves(
        lambda path, t: Sharding(mesh, rule(path, tuple(t.shape), mesh)),
        params)


def data_sharding(mesh, *spec_tail) -> Sharding:
    """Batch-dim sharding over ('pod','data')."""
    return Sharding(mesh, _spec((batch_axes(mesh), *spec_tail)))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())
