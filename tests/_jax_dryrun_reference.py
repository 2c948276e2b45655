"""The reference side of tests/test_torch_dryrun.py, on 512 host devices.

    python tests/_jax_dryrun_reference.py RECORDS.json OUT.json

Sets ``--xla_force_host_platform_device_count=512`` before jax starts
(importing ``repro.launch.dryrun`` does), then:

- builds every cell of every registered arch with the reference's
  ``build_cell`` on both production meshes and writes, for each, every
  input leaf's '/'-joined path, shape, dtype and spec (``tuple`` of its
  ``PartitionSpec``), the out-shardings' specs and ``static_meta``;
- on the dry-run records in RECORDS.json (a list), with the reference
  roofline's three constants set to the values RECORDS.json's
  ``constants`` gives (the module is not edited): ``roofline_terms`` of
  each, ``format_table`` of all, and ``dryrun._extrapolate`` of each
  (v1, v2, L) of ``extrapolate``.
"""

from __future__ import annotations

import json
import sys

from repro.launch import dryrun  # noqa: I001  (sets XLA_FLAGS first)
import jax

from repro.configs.base import all_arch_ids, get_config
from repro.distributed import sharding as shd
from repro.launch import roofline
from repro.launch.cells import build_cell
from repro.launch.mesh import make_production_mesh


def _spec(ns) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in tuple(ns.spec)]


def _leaves(tree, shard_tree) -> list[dict]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    shards = jax.tree_util.tree_leaves(shard_tree)
    assert len(flat) == len(shards)
    return [{"path": "/".join(shd._key_name(k) for k in kp),
             "shape": list(leaf.shape), "dtype": str(leaf.dtype),
             "spec": _spec(ns)} for (kp, leaf), ns in zip(flat, shards)]


def cells() -> dict:
    out = {}
    for kind, multi in (("pod", False), ("multipod", True)):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in all_arch_ids():
            spec = get_config(arch)
            for shape in spec.shapes:
                c = build_cell(spec, shape, mesh)
                out[f"{arch}|{shape}|{kind}"] = {
                    "args": [_leaves(t, s) for t, s in
                             zip(c.in_specs, c.in_shardings)],
                    "out": (None if c.out_shardings is None else
                            [_spec(ns) for ns in
                             jax.tree_util.tree_leaves(c.out_shardings)]),
                    "meta": {k: int(v) for k, v in c.static_meta.items()},
                }
    return out


def analysis(records: dict) -> dict:
    const = records["constants"]
    roofline.PEAK_FLOPS = const["PEAK_FLOPS"]
    roofline.HBM_BW = const["HBM_BW"]
    roofline.ICI_BW = const["LINK_BW"]
    return {"terms": [roofline.roofline_terms(r) if r.get("ok") else None
                      for r in records["results"]],
            "table": roofline.format_table(records["results"]),
            "extrapolate": [dryrun._extrapolate(v1, v2, L)
                            for v1, v2, L in records["extrapolate"]]}


if __name__ == "__main__":
    with open(sys.argv[1]) as fh:
        records = json.load(fh)
    with open(sys.argv[2], "w") as fh:
        json.dump({"cells": cells(), **analysis(records)}, fh)
