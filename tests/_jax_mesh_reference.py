"""The reference side of tests/test_torch_multidevice.py, on 8 host devices.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_jax_mesh_reference.py OUT_DIR

For each case of ``_multidevice_cases.MOE_CASES``: the reference's
``moe_ffn_sharded`` under jit on ``make_local_mesh`` (x placed
P('data', 'model', None), the expert stacks P('model', None, None), as
tests/test_multidevice.py places them), its output and aux, and the
gradients of sum(out · w) + aux with respect to x, the router and the
expert stacks; for the first case also ``moe_ffn_local``'s output and aux.
For each tree of ``PLACED``: every leaf's spec and, for each device of the
2×4 mesh by its mesh coordinate, the block ``devices_indices_map`` gives
it.  Writes ``OUT_DIR/ref.npz`` and ``OUT_DIR/ref_placed.json``.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import _multidevice_cases as cases
from repro.configs.base import get_config
from repro.distributed import sharding as shd
from repro.launch.mesh import make_local_mesh
from repro.models import gnn, moe, recsys, transformer


def run_moe(name: str, case: dict, out: dict) -> None:
    mesh = make_local_mesh(*case["mesh"])
    inp = {k: jnp.asarray(v) for k, v in cases.moe_inputs(case).items()}
    params = {k: inp[k] for k in ("router", "w_in", "w_gate", "w_out")}
    kw = dict(top_k=case["k"], capacity_factor=case["cf"], act="swiglu")
    shd.set_hint_rules({}, mesh)
    xs = jax.device_put(inp["x"], NamedSharding(mesh, P("data", "model",
                                                        None)))
    ps = jax.device_put(params, jax.tree.map(
        lambda l: NamedSharding(mesh, P(*(("model",) + (None,) * (l.ndim - 1)
                                          if l.ndim == 3
                                          else (None,) * l.ndim))), params))

    def loss(p, x):
        o, a = moe.moe_ffn_sharded(p, x, mesh=mesh, **kw)
        return jnp.sum(o * inp["w"]) + a, (o, a)

    (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(ps, xs)
    out[f"moe|{name}|out"] = np.asarray(o)
    out[f"moe|{name}|aux"] = np.asarray(a)
    out[f"moe|{name}|x"] = np.asarray(gx)
    for k, g in gp.items():
        out[f"moe|{name}|{k}"] = np.asarray(g)
    if name == "2x4-cf8":
        lo, la = moe.moe_ffn_local(params, inp["x"], **kw)
        out[f"local|{name}|out"] = np.asarray(lo)
        out[f"local|{name}|aux"] = np.asarray(la)
    shd.set_hint_rules({}, None)


def tree_shapes(arch: str, rule: str):
    spec = get_config(arch)
    cfg = spec.smoke_config()
    init = {"lm": transformer.init_params, "gnn": gnn.init_params,
            "recsys": recsys.INIT.get(arch)}[rule]
    return jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))


def run_placed(out: dict) -> None:
    mesh = make_local_mesh(2, 4)
    coord = {d.id: [int(i) for i in np.argwhere(mesh.devices == d)[0]]
             for d in mesh.devices.flat}
    rules = {"lm": shd.lm_param_spec, "recsys": shd.recsys_param_spec,
             "gnn": shd.gnn_param_spec}
    for name, arch, rule, preset in cases.PLACED:
        leaves = {}
        flat, _ = jax.tree_util.tree_flatten_with_path(
            tree_shapes(arch, rule))
        for keypath, leaf in flat:
            path = "/".join(shd._key_name(k) for k in keypath)
            args = (path, leaf.shape, mesh) + ((preset,) if preset else ())
            spec = rules[rule](*args)
            blocks = NamedSharding(mesh, spec).devices_indices_map(
                leaf.shape)
            leaves[path] = {
                "shape": list(leaf.shape),
                "spec": [list(e) if isinstance(e, tuple) else e
                         for e in tuple(spec)],
                "blocks": {",".join(map(str, coord[d.id])): [
                    [s.start or 0, leaf.shape[i] if s.stop is None
                     else s.stop] for i, s in enumerate(idx)]
                    for d, idx in blocks.items()}}
        out[name] = leaves


def main() -> None:
    out_dir = sys.argv[1]
    if jax.device_count() != 8:
        raise SystemExit(f"needs 8 host devices, has {jax.device_count()}")
    arrays = {}
    for name, case in cases.MOE_CASES.items():
        run_moe(name, case, arrays)
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)
    placed = {}
    run_placed(placed)
    with open(os.path.join(out_dir, "ref_placed.json"), "w") as fh:
        json.dump(placed, fh)


if __name__ == "__main__":
    main()
