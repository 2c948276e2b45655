"""Dry-run on the production meshes: trace every (architecture × input
shape) as one rank of a 256- or 512-rank process group and count its
per-device work, collectives and memory.

Port of ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 512 forced host devices and reads XLA's cost and memory
analysis; torch has no compiled program to read, so the port runs the
step itself, eagerly, as rank 0 of a fake process group:

- ``run_cell`` starts ``init_process_group("fake", ...)`` of 256 (pod) or
  512 (multipod) ranks and ``make_production_mesh(device_type="cpu")`` over
  it.  The cell's parameters, optimizer state and batch are DTensors whose
  local blocks are ``FakeTensorMode`` tensors: shapes and dtypes, no
  memory and no arithmetic.  The step runs under
  ``implicit_replication()`` (plain tensors made inside the step, the RoPE
  tables say, join DTensor ops as replicated) with the cell's hint rules
  bound to the mesh; ``out_shardings`` lay out the outputs at the end.
- This is the one entry point of the port that runs nothing on the card,
  as the reference's runs on forced host devices: it never creates a CUDA
  context.  Its fake tensors lie on the CPU, so every kernel wrapper takes
  its plain version (``_build.kernel_path``) and no ctypes launch ever
  sees a fake pointer.  Its numbers are counts, not timings.
- ``Counter`` sees rank 0's local ops (DTensor's own dispatch returns them
  to it; the ops DTensor runs on global shapes only to propagate shapes
  are not counted), which is every rank's program:
  - ``flops``: ``torch.utils.flop_counter``'s formulas (matmuls,
    convolutions, attention) on the local operands, plus one per output
    element of every pointwise op.  A ``FlopCounterMode`` around the
    DTensor step would count the global product instead.
  Ops on real tensors are DTensor's bookkeeping (the mesh's coordinates,
  say), not the step's, whose every tensor is fake, and are not counted.
  - ``bytes_accessed``: input plus output bytes of every local op that
    writes a new result (views and bare allocations write none).  Eager
    PyTorch runs each op on its own, so this is the unfused traffic.
  - ``materialized_bytes``: twice the output bytes of those ops (a write
    and a later read).  The reference charges only the results that stay
    in HBM after XLA's TPU fusion (a whitelist of ops); in eager PyTorch
    every op's result lands in HBM, as no compiler fuses it away.
  - ``collective_bytes``: the reference's schema, result bytes of each
    all-gather / all-reduce / reduce-scatter / all-to-all /
    collective-permute, ``total`` and ``counts``; both DTensor's
    redistributions and the direct c10d calls of ``moe_ffn_sharded`` (its
    ``all_to_all_single`` and ``all_reduce`` calls).  A Shard→Shard
    redistribution is counted as the all-to-all it asks for: on a CPU
    mesh DTensor falls back to an all-gather and a chunk, which an NCCL
    mesh of cards does not run, so the dry-run calls the all-to-all op.
  - ``memory``: ``argument_bytes`` (the local bytes of every input),
    ``output_bytes`` (of every output), ``temp_bytes`` (the peak of live
    local storages above the arguments) and ``code_bytes``, null: there
    is no compiled executable whose code size could be read.
- Ops that DTensor cannot shard get a replicate-only strategy here
  (``register_sharding``; the model code is untouched), so the counted
  program gathers their operands, and the count shows that gather:
  ``aten.bincount``, ``aten.searchsorted.Tensor``,
  ``aten.segment_reduce``, ``aten.repeat_interleave.Tensor``.
  ``aten.masked_fill_.Scalar`` gets DTensor's shardings plus a zero fill
  of a partial sum, which DTensor refuses in place.  Any other op DTensor
  finds no sharding for (none registered, or none for its operands'
  placements, as older DTensors have for a dim split over two mesh
  axes) runs the same way, on its operands gathered whole with its
  results replicated, and the record lists it under ``replicated_ops``
  (none of the 42 cells needs one on torch 2.13).
- Fake tensors hold no values, so the sizes of data-dependent results are
  taken from their arguments: ``bincount``'s is its ``minlength`` (every
  caller passes ids below it), ``repeat_interleave(repeats)``'s is one
  item a repeat (``segment.group``: one run a destination, exact while no
  destination has over ``SEGMENT_CHUNK`` terms).  A scalar integer input
  (the decode position) is the int 0, a position rank 0's block holds.

LM probes: torch runs the layer loop, so a full-depth trace counts every
layer, and ``scan_body_costs`` is null.  ``--skip-full`` traces the L=1
and L=2 probes only and extrapolates, v(L) = v1 + (L−1)·(v2−v1), as the
reference does (there, to make up for XLA counting a scan body once).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b \\
      --shape train_4k --mesh pod --out results/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list

One (arch, shape, mesh) per process: the fake process group is the
process's world.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import tree as tree_lib
from repro_torch.distributed import sharding as shd

_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")

# ops that DTensor has no sharding strategy for, given replicate-only ones
REPLICATED_OPS = ("aten.bincount.default", "aten.searchsorted.Tensor",
                  "aten.segment_reduce.default",
                  "aten.repeat_interleave.Tensor")


def _collective_kinds() -> dict:
    c10d, fn = torch.ops.c10d, torch.ops._c10d_functional
    return {
        fn.all_gather_into_tensor: "all-gather",
        fn.all_gather_into_tensor_coalesced: "all-gather",
        fn.all_reduce: "all-reduce",
        fn.all_reduce_coalesced: "all-reduce",
        fn.reduce_scatter_tensor: "reduce-scatter",
        fn.reduce_scatter_tensor_coalesced: "reduce-scatter",
        fn.all_to_all_single: "all-to-all",
        torch.ops._dtensor.shard_dim_alltoall: "all-to-all",
        torch.ops._c10d_functional_autograd.all_to_all_single: "all-to-all",
        c10d.allgather_: "all-gather",
        c10d._allgather_base_: "all-gather",
        c10d.allreduce_: "all-reduce",
        c10d._reduce_scatter_base_: "reduce-scatter",
        c10d.reduce_scatter_: "reduce-scatter",
        c10d.alltoall_base_: "all-to-all",
        c10d.alltoall_: "all-to-all",
    }


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


_NO_WRITE = {
    torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default, torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten._unsafe_view.default,         # a view whose schema says not
    torch.ops._c10d_functional.wait_tensor.default,
}

# pointwise ops that move data and compute nothing
_COPIES = {
    torch.ops.aten.clone.default, torch.ops.aten._to_copy.default,
    torch.ops.aten.copy_.default, torch.ops.aten.copy.default,
    torch.ops.aten.fill_.Scalar, torch.ops.aten.fill_.Tensor,
    torch.ops.aten.zero_.default, torch.ops.aten.lift_fresh_copy.default,
}


def _writes_result(func) -> bool:
    """Whether ``func`` writes a new result: not a view (a return that
    aliases an input without writing it) and not a bare allocation."""
    if func in _NO_WRITE or not func._schema.returns:
        return False
    return all(r.alias_info is None or r.alias_info.is_write
               for r in func._schema.returns)


class Counter(TorchDispatchMode):
    """Counts the local ops that run under it: rank 0's program.  A DTensor
    op goes to DTensor (``_dtensor_op``), whose local ops and collectives
    then come here."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self._kinds = _collective_kinds()
        self.flops = 0
        self.bytes_accessed = 0
        self.out_bytes = 0
        self.coll = {k: 0 for k in _KINDS}
        self.counts = {k: 0 for k in _KINDS}
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        self.replicated: set[str] = set()     # ops run by the fallback
        self._in_dtensor = 0
        # > 0 while DTensor's propagator runs an op on global shapes to
        # learn its output's shape: those runs are not the rank's work
        self.propagating = 0

    def track(self, ts) -> None:
        """Count the storages of ``ts`` as live until they are freed."""
        for t in ts:
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            weakref.finalize(st, self._free, n)
        self.peak = max(self.peak, self.live)

    def _free(self, n: int) -> None:
        self.live -= n

    def _data_dependent(self, func, args, kwargs):
        """A fake result for an op whose result size depends on values."""
        aten = torch.ops.aten
        if func is aten.bincount.default:
            x = args[0]
            weights = kwargs.get("weights", args[1] if len(args) > 1
                                 else None)
            minlength = kwargs.get("minlength", args[2] if len(args) > 2
                                   else 0)
            if not minlength:
                raise ValueError("bincount without minlength: its size "
                                 "depends on the values")
            dt = torch.int64 if weights is None else weights.dtype
            return torch.empty(minlength, dtype=dt, device=x.device)
        if func is aten.repeat_interleave.Tensor:
            repeats = args[0]
            size = kwargs.get("output_size")
            if size is None:
                size = repeats.numel()
            return torch.empty(size, dtype=repeats.dtype,
                               device=repeats.device)
        return None

    def _dtensor_op(self, func, args, kwargs):
        """A DTensor op, run by DTensor with this mode pushed again (its
        local ops and collectives come back here).  Where DTensor has no
        sharding for it (none at all, or none for its operands'
        placements), ``_replicated`` runs it and its name is recorded."""
        self._in_dtensor += 1
        try:
            with self:
                try:
                    return func(*args, **kwargs)
                except (RuntimeError, NotImplementedError) as e:
                    if "propagation" not in str(e) and \
                            "sharding strategy" not in str(e):
                        raise
                self.replicated.add(str(func))
                return self._replicated(func, args, kwargs)
        finally:
            self._in_dtensor -= 1

    @torch.no_grad()            # below autograd: the op's value alone
    def _replicated(self, func, args, kwargs):
        """``func`` on its operands gathered whole, its results replicated,
        as a replicate-only strategy would have it (an in-place op writes
        back in its target's layout)."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_flatten, tree_map_only
        mesh = next(t for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, DTensor)).device_mesh
        whole = [Replicate()] * mesh.ndim
        local = tree_map_only(
            DTensor,
            lambda t: t.detach().redistribute(mesh, whole).to_local(),
            (args, kwargs))
        out = tree_map_only(
            torch.Tensor,
            lambda t: DTensor.from_local(t, mesh, whole, run_check=False),
            func(*local[0], **local[1]))
        if func._schema.is_mutable and isinstance(args[0], DTensor):
            target = args[0]
            target._local_tensor.copy_(out.redistribute(
                mesh, target.placements)._local_tensor)
            return target
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented       # DTensor runs it, locals here
            return self._dtensor_op(func, args, kwargs)
        out = self._data_dependent(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if self.propagating or not isinstance(func, torch._ops.OpOverload):
            return out
        outs = _tensors(out)
        if not any(isinstance(t, FakeTensor)
                   for t in outs + _tensors((args, kwargs))):
            return out          # DTensor's own bookkeeping on real tensors
        kind = self._kinds.get(func._overloadpacket)
        if kind is not None:
            b = _nbytes(_tensors(args[0]) if func._overloadpacket in (
                torch.ops.c10d.allreduce_, torch.ops.c10d.alltoall_base_,
                torch.ops.c10d.allgather_, torch.ops.c10d.alltoall_,
                torch.ops.c10d._allgather_base_,
                torch.ops.c10d._reduce_scatter_base_,
                torch.ops.c10d.reduce_scatter_) else outs)
            self.coll[kind] += b
            self.counts[kind] += 1
            self.out_bytes += b
            self.bytes_accessed += b + _nbytes(_tensors(args))
        elif (func.namespace == "c10d"
              or func.namespace.startswith("_c10d_functional")) and \
                func is not torch.ops._c10d_functional.wait_tensor.default:
            raise NotImplementedError(f"uncounted collective {func}")
        elif outs and _writes_result(func):
            f = self._flop_registry.get(func._overloadpacket)
            if f is not None:
                self.flops += f(*args, **kwargs, out_val=out)
            elif torch.Tag.pointwise in func.tags and func not in _COPIES:
                self.flops += sum(t.numel() for t in outs)
            ob = _nbytes(outs)
            self.out_bytes += ob
            self.bytes_accessed += ob + _nbytes(_tensors((args, kwargs)))
        self.track(outs)
        return out

    def costs(self) -> dict:
        coll = dict(self.coll)
        coll["total"] = sum(self.coll.values())
        coll["counts"] = dict(self.counts)
        return {"flops": float(self.flops),
                "bytes_accessed": float(self.bytes_accessed),
                "materialized_bytes": int(2 * self.out_bytes),
                "collective_bytes": coll}


# ---------------------------------------------------------------------------
# what the dry-run changes in DTensor while it runs
# ---------------------------------------------------------------------------

def _register_strategies() -> None:
    """Replicate-only sharding strategies for ``REPLICATED_OPS``, and
    ``masked_fill_`` by zero on a partial sum (DTensor refuses to fill a
    Partial tensor in place, though zero is the sum's identity)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor.experimental import register_sharding

    def replicated(*args, **kwargs):
        ins = [Replicate() if isinstance(a, DTensorSpec) else None
               for a in (*args, *kwargs.values())]
        return [([Replicate()], ins)]

    for op in _replicated_ops():
        register_sharding(op)(replicated)

    @register_sharding(torch.ops.aten.masked_fill_.Scalar)
    def masked_fill(x, mask, value):
        nd, lead = x.ndim, x.ndim - mask.ndim
        out = [([Replicate()], [Replicate(), Replicate(), None])]
        for d in range(nd):
            m = d - lead
            mp = Shard(m) if m >= 0 and mask.shape[m] == x.shape[d] \
                else Replicate()
            out.append(([Shard(d)], [Shard(d), mp, None]))
        if value == 0:
            out.append(([Partial()], [Partial(), Replicate(), None]))
        return out

    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.masked_fill_.Scalar
    prop.op_single_dim_strategy_funcs.pop(op, None)
    prop.op_to_schema_info[op] = RuntimeSchemaInfo(2)    # value in the key


def _replicated_ops() -> list:
    out = []
    for name in REPLICATED_OPS:
        ns, op, overload = name.split(".")
        out.append(getattr(getattr(getattr(torch.ops, ns), op), overload))
    return out


@contextlib.contextmanager
def _dtensor_patches(counter: Counter):
    """For the span of the trace, and undone after it: the strategies of
    ``_register_strategies``; Shard→Shard redistributions call the
    all-to-all op (not the CPU group's all-gather fallback); the
    propagator's shape runs are flagged; and ``view`` lays out anew an
    input whose unevenly split dim it cannot keep sharded, as ``reshape``
    does (DTensor's ``view`` refuses; XLA reshards the same way)."""
    from torch.distributed.tensor import DTensor, placement_types
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo
    from torch.distributed.tensor._ops import _view_ops
    from torch.distributed.tensor._decompositions import \
        DecompShardingStrategy
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    def flagged(fn):
        def run(*args, **kwargs):
            counter.propagating += 1
            try:
                return fn(*args, **kwargs)
            finally:
                counter.propagating -= 1
        return run

    # the propagator's runs on global shapes: output metadata, and the
    # strategies it derives by running an op's decomposition
    shape_runs = ((ShardingPropagator, "_propagate_tensor_meta_non_cached"),
                  (DecompShardingStrategy, "propagate_strategy"))
    unflagged = [getattr(cls, name) for cls, name in shape_runs]

    prop = DTensor._op_dispatcher.sharding_propagator
    views = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
    ops = (*views, *_replicated_ops(), torch.ops.aten.masked_fill_.Scalar)
    tables = (prop.op_strategy_funcs, prop.op_single_dim_strategy_funcs,
              prop.op_to_schema_info)
    saved = [{op: table[op] for op in ops if op in table} for table in tables]
    a2a = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = shard_dim_alltoall
    for (cls, name), fn in zip(shape_runs, unflagged):
        setattr(cls, name, flagged(fn))
    for op in views:
        _view_ops.register_op_strategy_map(
            op, torch.Tensor.view, schema_info=RuntimeSchemaInfo(1))
    _register_strategies()
    prop.propagate_op_sharding.cache_clear()
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = a2a
        for (cls, name), fn in zip(shape_runs, unflagged):
            setattr(cls, name, fn)
        for table, old in zip(tables, saved):
            for op in ops:
                table.pop(op, None)
            table.update(old)
        prop.propagate_op_sharding.cache_clear()


# ---------------------------------------------------------------------------
# one trace
# ---------------------------------------------------------------------------

def _materialize(spec, shard):
    """The run-time value of one input slot: a Generator for the
    reference's key slot, the int 0 for a scalar integer (the decode
    position), else DTensors of fake blocks laid out by ``shard``."""
    from repro_torch.launch.cells import is_generator
    if is_generator(spec):
        return torch.Generator()
    if isinstance(spec, torch.Tensor) and spec.ndim == 0 and \
            not spec.dtype.is_floating_point:
        return 0
    values = [shd.distribute(torch.empty(t.shape, dtype=t.dtype), s)
              for t, s in zip(tree_lib.leaves(spec),
                              tree_lib.matching(spec, shard))]
    return tree_lib.unflatten(spec, values, replace=True)


def _lay_out(out, shardings):
    """``out`` with each DTensor leaf laid out by its ``Sharding``."""
    if shardings is None:
        return out
    if isinstance(out, (tuple, list)):
        return type(out)(_lay_out(o, s) for o, s in zip(out, shardings))
    if isinstance(out, dict):
        return {k: _lay_out(v, shardings[k]) for k, v in out.items()}
    if shd.is_dtensor(out):
        return out.redistribute(shardings.mesh, shardings.placements)
    return out


def _local(ts) -> list[torch.Tensor]:
    return [t.to_local() if shd.is_dtensor(t) else t for t in ts]


def trace_cell(cell) -> dict:
    """Run ``cell``'s step once as rank 0 of the bound process group;
    returns its costs and memory (see the module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    counter = Counter()
    with FakeTensorMode():
        args = [_materialize(s, sh) for s, sh in
                zip(cell.in_specs, cell.in_shardings)]
        arg_locals = _local(t for a in args
                            if not isinstance(a, (torch.Generator, int))
                            for t in tree_lib.leaves(a))
        counter.track(arg_locals)
        base = counter.live
        counter.peak = base
        with _dtensor_patches(counter), implicit_replication(), counter:
            out = _lay_out(cell.fn(*args), cell.out_shardings)
        out_locals = _local(_tensors(out))
    return {**counter.costs(), "replicated_ops": sorted(counter.replicated),
            "memory": {"argument_bytes": _nbytes(arg_locals),
                       "output_bytes": _nbytes(out_locals),
                       "temp_bytes": counter.peak - base,
                       "code_bytes": None}}


def _extrapolate(v1: dict, v2: dict, L: int) -> dict:
    def lin(a, b):
        return a + (L - 1) * (b - a)
    coll = {}
    for k in v1["collective_bytes"]:
        if k == "counts":
            coll[k] = {kk: int(lin(v1["collective_bytes"][k][kk],
                                   v2["collective_bytes"][k][kk]))
                       for kk in v1["collective_bytes"][k]}
        else:
            coll[k] = int(lin(v1["collective_bytes"][k],
                              v2["collective_bytes"][k]))
    return {"flops": lin(v1["flops"], v2["flops"]),
            "bytes_accessed": lin(v1["bytes_accessed"], v2["bytes_accessed"]),
            "materialized_bytes": int(lin(v1["materialized_bytes"],
                                          v2["materialized_bytes"])),
            "collective_bytes": coll}


def init_fake_world(n_ranks: int) -> None:
    """A fake process group of ``n_ranks`` ranks, this process rank 0 (no
    communication ever happens)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != n_ranks:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is bound; "
                               f"the dry-run needs {n_ranks}")
    else:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n_ranks)


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str | None,
             verbose: bool = True, skip_full: bool = False,
             spec=None, mesh=None) -> dict:
    """One cell on the production mesh of ``mesh_kind`` ("pod": 16×16,
    "multipod": 2×16×16).  ``spec`` and ``mesh`` replace the registered
    arch and the production mesh (reduced cells on a small fake mesh)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_mesh

    if mesh is None:
        multi = mesh_kind == "multipod"
        init_fake_world(512 if multi else 256)
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    spec = spec or get_config(arch)
    n_chips = mesh.size()

    timings = {}
    mem = None
    cell = build_cell(spec, shape, mesh)
    if not skip_full:
        t0 = time.monotonic()
        costs = trace_cell(cell)
        timings["full_trace_s"] = round(time.monotonic() - t0, 2)
        mem = costs.pop("memory")
        replicated = costs["replicated_ops"]
    elif spec.family == "lm":
        probes = {}
        for L in (1, 2):
            pcfg = dataclasses.replace(spec.config, n_layers=L,
                                       unroll_scan=True)
            pspec = dataclasses.replace(spec, config=pcfg)
            t0 = time.monotonic()
            probes[L] = trace_cell(build_cell(pspec, shape, mesh))
            timings[f"probe{L}_trace_s"] = round(time.monotonic() - t0, 2)
        costs = _extrapolate(probes[1], probes[2], spec.config.n_layers)
        replicated = sorted({*probes[1]["replicated_ops"],
                             *probes[2]["replicated_ops"]})
    else:
        costs = trace_cell(cell)
        replicated = costs["replicated_ops"]
    if spec.family == "lm":
        costs["scan_body_costs"] = None

    result = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "n_devices": n_chips,
        **{k: costs[k] for k in ("flops", "bytes_accessed",
                                 "materialized_bytes", "collective_bytes")},
        "memory": mem,
        "model_flops": cell.static_meta.get("model_flops", 0),
        "timings": timings,
        "replicated_ops": replicated,
        "ok": True,
    }
    if verbose:
        print(f"[dryrun] {arch} × {shape} × {mesh_kind}: OK  {timings}")
        if mem is not None:
            print(f"  memory (per-device, counted): "
                  f"args={mem['argument_bytes']:,} "
                  f"temp={mem['temp_bytes']:,} "
                  f"out={mem['output_bytes']:,}")
        print(f"  costs (per-device, counted): flops={result['flops']:.3e} "
              f"bytes={result['bytes_accessed']:.3e}")
        print(f"  collective_bytes: {result['collective_bytes']['total']:,}")
        if replicated:
            print(f"  run replicated (no sharding for their operands): "
                  f"{', '.join(replicated)}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}__{shape}__{mesh_kind}.json")
        with open(fn, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str)
    ap.add_argument("--shape", type=str)
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--skip-full", action="store_true",
                    help="probes only (costs, no memory analysis)")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args()

    if args.list:
        from repro_torch.configs.base import all_arch_ids, get_config
        for a in all_arch_ids():
            print(a, "→", ", ".join(get_config(a).shapes))
        return

    try:
        run_cell(args.arch, args.shape, args.mesh, args.out,
                 skip_full=args.skip_full)
    except Exception:
        traceback.print_exc()
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fn = os.path.join(
                args.out, f"{args.arch}__{args.shape}__{args.mesh}.json")
            with open(fn, "w") as fh:
                json.dump({"arch": args.arch, "shape": args.shape,
                           "mesh": args.mesh, "ok": False,
                           "error": traceback.format_exc()}, fh, indent=1)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
