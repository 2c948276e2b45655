"""One gloo rank of tests/test_torch_multidevice.py's port side.

    python tests/_torch_mesh_worker.py RANK WORLD INIT_METHOD OUT_DIR

Every rank runs the same program on CPU meshes over the group's 8 ranks:
the expert-parallel MoE cases of ``_multidevice_cases`` (output, aux,
gradients, dropped slots), ``moe_ffn``'s dispatch, the placed trees'
blocks, and the elastic checkpoint.  Each rank writes
``OUT_DIR/rank<r>.npz``; rank 0 also writes ``OUT_DIR/summary.json``.
"""

from __future__ import annotations

import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

import _multidevice_cases as cases
from repro_torch import tree as tree_lib
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe, recsys, transformer

RULES = {"lm": sharding.lm_param_spec, "recsys": sharding.recsys_param_spec,
         "gnn": sharding.gnn_param_spec}


def full(t) -> np.ndarray:
    return t.full_tensor().detach().numpy() if sharding.is_dtensor(t) \
        else t.detach().numpy()


def run_moe(name: str, case: dict, meshes: dict, arrays: dict,
            summary: dict) -> None:
    mesh = meshes[case["mesh"]]
    inp = cases.moe_inputs(case)
    params = moe.MoE(case["d"], case["ff"], case["E"], device="cpu")
    with torch.no_grad():
        for k in ("router", "w_in", "w_gate", "w_out"):
            getattr(params, k).copy_(torch.from_numpy(inp[k]))
    e_spec = ("model", None, None)
    specs = {"router": sharding.Sharding(mesh, ()),
             **{k: sharding.Sharding(mesh, e_spec)
                for k in ("w_in", "w_gate", "w_out")}}
    sharding.distribute_tree(params, specs)
    for p in params.parameters():
        p.requires_grad_(True)
    x_sh = sharding.Sharding(mesh, ("data", "model", None))
    x = sharding.distribute(torch.from_numpy(inp["x"]), x_sh)
    x.requires_grad_(True)
    w = sharding.distribute(torch.from_numpy(inp["w"]), x_sh)
    stats = {}
    out, aux = moe.moe_ffn_sharded(params, x, top_k=case["k"],
                                   capacity_factor=case["cf"], act="swiglu",
                                   mesh=mesh, stats=stats)
    ((out * w).sum() + aux).backward()
    got = {"out": full(out), "aux": full(aux), "x": full(x.grad),
           **{k: full(getattr(params, k).grad)
              for k in ("router", "w_in", "w_gate", "w_out")}}
    counts = torch.stack([stats["send_dropped"], stats["expert_dropped"],
                          torch.tensor(stats["kept"].numel())])
    dist.all_reduce(counts)
    # a second run gives the same output, bit for bit
    again, _ = moe.moe_ffn_sharded(params, x, top_k=case["k"],
                                   capacity_factor=case["cf"], act="swiglu",
                                   mesh=mesh)
    summary["moe"][name] = {
        "send_dropped": int(counts[0]), "expert_dropped": int(counts[1]),
        "slots": int(counts[2]),
        "repeat_equal": bool(torch.equal(out.to_local(), again.to_local())),
        "out_type": type(out).__name__, "aux_type": type(aux).__name__,
        "out_placements": [str(p) for p in out.placements]}
    for k, v in got.items():
        arrays[f"moe|{name}|{k}"] = v


def run_dispatch(meshes: dict, summary: dict) -> None:
    """moe_ffn: sharded on a bound 2×4 mesh, local with no mesh or where
    S % model != 0; the dispatched output against moe_ffn_sharded's."""
    case = cases.MOE_CASES["2x4-cf8"]
    inp = cases.moe_inputs(case)
    params = moe.MoE(case["d"], case["ff"], case["E"], device="cpu")
    with torch.no_grad():
        for k in ("router", "w_in", "w_gate", "w_out"):
            getattr(params, k).copy_(torch.from_numpy(inp[k]))
    x = torch.from_numpy(inp["x"])
    calls = []
    inner_s, inner_l = moe.moe_ffn_sharded, moe.moe_ffn_local

    def sharded(*a, **kw):
        calls.append("sharded")
        return inner_s(*a, **kw)

    def local(*a, **kw):
        calls.append("local")
        return inner_l(*a, **kw)
    moe.moe_ffn_sharded, moe.moe_ffn_local = sharded, local
    kw = dict(top_k=case["k"], capacity_factor=case["cf"], act="swiglu")
    try:
        out = {}
        sharding.set_hint_rules({}, meshes[(2, 4)])
        out["bound"] = moe.moe_ffn(params, x, **kw)
        out["s_not_divisible"] = moe.moe_ffn(params, x[:, :6], **kw)
        sharding.set_hint_rules({}, None)
        out["no_mesh"] = moe.moe_ffn(params, x, **kw)
    finally:
        moe.moe_ffn_sharded, moe.moe_ffn_local = inner_s, inner_l
        sharding.set_hint_rules({}, None)
    summary["dispatch"] = {
        "calls": calls,
        "bound_is_plain": not sharding.is_dtensor(out["bound"][0]),
        "bound_max_err_vs_local": float(
            (out["bound"][0] - out["no_mesh"][0]).abs().max()),
        "bound_aux_err_vs_local": float(
            (out["bound"][1] - out["no_mesh"][1]).abs()),
    }


def run_hint(meshes: dict, summary: dict) -> None:
    """shard_hint under a bound 2×4 mesh: a replicated DTensor moves to
    the rule's placements, its value unchanged; a DTensor of fewer dims
    than the rule is returned as it is."""
    mesh = meshes[(2, 4)]
    whole = torch.from_numpy(cases.fill((4, 8, 16)))
    x = sharding.distribute(whole, sharding.replicated(mesh))
    flat = sharding.distribute(whole[0], sharding.replicated(mesh))
    spec = ("data", "model", None)
    sharding.set_hint_rules({"act": spec}, mesh)
    try:
        y = sharding.shard_hint(x, "act")
        summary["hint"] = {
            "placements": [str(p) for p in y.placements],
            "local_equal": bool(torch.equal(
                y.to_local(), sharding.block(whole, mesh, spec))),
            "full_equal": bool(torch.equal(y.full_tensor(), whole)),
            "fewer_dims_same": sharding.shard_hint(flat, "act") is flat,
            "no_rule_same": sharding.shard_hint(x, "other") is x}
    finally:
        sharding.set_hint_rules({}, None)


def placed_tree(arch: str, rule: str):
    spec = get_config(arch)
    if rule == "lm":
        return transformer.LM(spec.smoke_config(), "cpu")
    if rule == "recsys":
        return recsys.map_spec(lambda s: torch.empty(s[1]),
                               recsys.SPECS[arch](spec.smoke_config()))
    from repro_torch.models import gnn
    return gnn.init_params(torch.Generator().manual_seed(0),
                           spec.smoke_config(), "cpu")


def run_placement(meshes: dict, arrays: dict, summary: dict) -> None:
    mesh = meshes[(2, 4)]
    summary["coordinate"] = list(mesh.get_coordinate())
    summary["placed"] = {}
    for name, arch, rule, preset in cases.PLACED:
        params = placed_tree(arch, rule)
        with torch.no_grad():
            for _, t in tree_lib.paths(params):
                t.copy_(torch.from_numpy(cases.fill(tuple(t.shape))))
        fn = RULES[rule]
        if preset is not None:
            fn = (lambda f, pr: lambda p, s, m: f(p, s, m, pr))(fn, preset)
        shardings = sharding.tree_param_shardings(params, mesh, fn)
        whole = {p: t.clone() for p, t in tree_lib.paths(params)}
        placed = sharding.distribute_tree(params, shardings)
        for path, t in tree_lib.paths(placed):
            arrays[f"placed|{name}|{path}"] = t.to_local().detach().numpy()
        summary["placed"][name] = {"torch_equal": _as_torch_places(
            placed, shardings, whole)}
    # a dim over two axes, split data-major as JAX splits it
    t = torch.from_numpy(cases.fill((16, 4)))
    sh = sharding.Sharding(mesh, (("data", "model"), None))
    arrays["two_axes"] = sharding.distribute(t, sh).to_local().numpy()
    summary["two_axes_torch_equal"] = _as_torch_places(
        {"t": sharding.distribute(t, sh)}, {"t": sh}, {"t": t})


def _as_torch_places(placed, shardings, whole) -> bool:
    """Whether each placed leaf's block is the one ``distribute_tensor``
    gives this rank under the same placements."""
    from torch.distributed.tensor import distribute_tensor
    return all(
        torch.equal(t.to_local(), distribute_tensor(
            whole[path], sh.mesh, sh.placements,
            src_data_rank=None).to_local())
        for (path, t), sh in zip(tree_lib.paths(placed),
                                 tree_lib.matching(placed, shardings)))


def run_checkpoint(meshes: dict, ckpt_dir: str, summary: dict) -> None:
    """tests/test_multidevice.py::test_elastic_checkpoint_reshard, and an
    LM module placed by the tp rules, saved on 2×4, restored onto 1×8."""
    want = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    spec = ("data", "model")
    m24 = meshes[(2, 4)]
    w = sharding.distribute(want, sharding.Sharding(m24, spec))
    CheckpointManager(os.path.join(ckpt_dir, "w")).save(5, {"w": w})
    rec = summary["checkpoint"] = {}
    for shape in ((4, 2), (1, 8)):
        mesh = meshes[shape]
        tree, step = CheckpointManager(os.path.join(ckpt_dir, "w")).restore(
            {"w": torch.zeros(64, 8)},
            shardings={"w": sharding.Sharding(mesh, spec)})
        got = tree["w"]
        rec["x".join(map(str, shape))] = {
            "step": step, "dtensor": sharding.is_dtensor(got),
            "mesh_shape": list(got.device_mesh.shape),
            "placements": [str(p) for p in got.placements],
            "local_equal": bool(torch.equal(
                got.to_local(), sharding.block(want, mesh, spec))),
            "full_equal": bool(torch.equal(got.full_tensor(), want))}

    # a module: saved from DTensor parameters, restored into a fresh one
    src = placed_tree("granite-moe-1b-a400m", "lm")
    with torch.no_grad():
        for i, p in enumerate(src.parameters()):
            p.copy_(torch.from_numpy(cases.fill(tuple(p.shape))) + i)
    whole = [p.detach().clone() for p in src.parameters()]
    rule = sharding.lm_param_spec
    sharding.distribute_tree(src, sharding.tree_param_shardings(src, m24,
                                                                rule))
    CheckpointManager(os.path.join(ckpt_dir, "lm")).save(3, src)
    m18 = meshes[(1, 8)]
    template = placed_tree("granite-moe-1b-a400m", "lm")
    got, step = CheckpointManager(os.path.join(ckpt_dir, "lm")).restore(
        template, shardings=sharding.tree_param_shardings(template, m18,
                                                          rule))
    rec["module"] = {
        "step": step, "same_object": got is template,
        "all_dtensor": all(sharding.is_dtensor(p) for p in got.parameters()),
        "on_1x8": all(list(p.device_mesh.shape) == [1, 8]
                      for p in got.parameters()),
        "equal": all(torch.equal(p.full_tensor(), w)
                     for p, w in zip(got.parameters(), whole))}


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, out_dir = sys.argv[3], sys.argv[4]
    torch.manual_seed(0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        meshes = {s: make_local_mesh(*s, device_type="cpu")
                  for s in ((2, 4), (4, 2), (1, 8))}
        arrays, summary = {}, {"moe": {}}
        for name, case in cases.MOE_CASES.items():
            run_moe(name, case, meshes, arrays, summary)
        run_dispatch(meshes, summary)
        run_hint(meshes, summary)
        run_placement(meshes, arrays, summary)
        run_checkpoint(meshes, os.path.join(out_dir, "ckpt"), summary)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
        if rank == 0:
            with open(os.path.join(out_dir, "summary.json"), "w") as fh:
                json.dump(summary, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
