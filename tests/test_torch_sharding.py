"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, with no process group: every registered arch's parameter
tree at its registered widths, on (data, model) meshes 2×4, 4×2, 1×8 and
16×16 and on (pod, data, model) 2×16×16.

The reference rules read only ``mesh.shape`` and ``mesh.axis_names``, so
they get a plain namespace; the port's get the bare description, a dict
of axis sizes.  The reference's trees are shapes from ``jax.eval_shape``;
the port's LMs and recsys tables are made on the meta device.  An LM leaf
of the port is one layer's: its spec must be the reference's spec of the
stacked leaf with the layer entry dropped.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _multidevice_cases as cases
from repro.configs.base import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tfm
from repro_torch import tree as tree_lib
from repro_torch.configs.base import all_arch_ids, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import gnn, recsys, transformer

pytestmark = pytest.mark.torch_port

MESHES = {"2x4": {"data": 2, "model": 4}, "4x2": {"data": 4, "model": 2},
          "1x8": {"data": 1, "model": 8}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = [a for a in all_arch_ids() if get_config(a).family != "index"]


def _ref_mesh(sizes: dict):
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str) -> dict:
    """{'/'-joined path: shape} of the reference's params at the
    registered widths (no arrays are made)."""
    spec = ref_get_config(arch)
    init = {"lm": ref_tfm.init_params, "gnn": ref_gnn.init_params,
            "recsys": ref_recsys.INIT.get(arch)}[spec.family]
    tree = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), spec.config))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(ref_shd._key_name(k) for k in kp): tuple(l.shape)
            for kp, l in flat}


def _port_tree(arch: str):
    spec = get_config(arch)
    if spec.family == "lm":
        return transformer.LM(spec.config, "meta")
    if spec.family == "recsys":
        return recsys.map_spec(lambda s: torch.empty(s[1], device="meta"),
                               recsys.SPECS[arch](spec.config))
    return gnn.init_params(torch.Generator().manual_seed(0), spec.config,
                           "cpu")


def _cases():
    for arch in ARCHS:
        lm = get_config(arch).family == "lm"
        presets = ("tp", "fsdp") if lm else (None,)
        for mesh in MESHES:
            for preset in presets:
                yield pytest.param(arch, mesh, preset,
                                   id=f"{arch}-{mesh}-{preset or 'rule'}")


@pytest.mark.parametrize("arch,mesh,preset", list(_cases()))
def test_leaf_specs_equal_the_reference_rules(arch, mesh, preset):
    family = get_config(arch).family
    sizes = MESHES[mesh]
    rm = _ref_mesh(sizes)
    port_rule = {"lm": sharding.lm_param_spec,
                 "recsys": sharding.recsys_param_spec,
                 "gnn": sharding.gnn_param_spec}[family]
    ref_rule = {"lm": ref_shd.lm_param_spec,
                "recsys": ref_shd.recsys_param_spec,
                "gnn": ref_shd.gnn_param_spec}[family]
    if preset is not None:
        port_rule = functools.partial(_with_preset, port_rule, preset)
        ref_rule = functools.partial(_with_preset, ref_rule, preset)
    ref_shapes = _ref_shapes(arch)
    params = _port_tree(arch)
    shardings = sharding.tree_param_shardings(params, sizes, port_rule)
    seen, sharded = set(), 0
    for (path, t), sh in zip(tree_lib.paths(params),
                             tree_lib.matching(params, shardings)):
        ref_path, stacked = cases.ref_path(path, family)
        shape = ref_shapes[ref_path]
        want = tuple(ref_rule(ref_path, shape, rm))
        if stacked:
            assert want[0] is None, (ref_path, want)
            want, shape = want[1:], shape[1:]
        assert tuple(t.shape) == shape, path
        assert isinstance(sh, sharding.Sharding) and sh.mesh is sizes
        assert sh.spec == want, (path, sh.spec, want)
        seen.add(ref_path)
        sharded += any(e is not None for e in want)
    assert seen == set(ref_shapes)
    assert sharded > 0


def _with_preset(rule, preset, path, shape, mesh):
    return rule(path, shape, mesh, preset)


def test_expert_stack_rule_reads_the_layer_axis():
    """A layer's expert stack is 3-D in the port: its expert axis (dim 0)
    goes over 'model', as the stacked 4-D leaf's dim 1 does; a literal
    transcription of the 4-D rule would shard d_ff instead."""
    sizes = MESHES["2x4"]
    for name in ("w_in", "w_gate", "w_out"):
        shape = (8, 32, 64) if name != "w_out" else (8, 64, 32)
        assert sharding.lm_param_spec(f"layers/0/moe/{name}", shape,
                                      sizes, "tp") == ("model", None, None)
        assert sharding.lm_param_spec(f"layers/0/moe/{name}", shape,
                                      sizes, "fsdp") == \
            ("model", "data", None)
    assert sharding.lm_param_spec("layers/0/moe/router", (32, 8),
                                  sizes) == (None, None)


@pytest.mark.parametrize("entries", [
    (("data",), None), ((), "model"), (("pod", "data"), "model"),
    ("data", ("model",)), ()])
def test_specs_are_written_as_partition_spec_writes_them(entries):
    assert sharding._spec(entries) == tuple(P(*entries))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_axes_and_data_sharding_match_the_reference(mesh):
    sizes, rm = MESHES[mesh], _ref_mesh(MESHES[mesh])
    dp = ref_shd.batch_axes(rm)
    assert sharding.batch_axes(sizes) == dp
    assert sharding.data_sharding(sizes).spec == tuple(P(dp))
    assert sharding.data_sharding(sizes, None, "model").spec == \
        tuple(P(dp, None, "model"))
    assert sharding.replicated(sizes).spec == tuple(P())


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    sizes = MESHES["2x4"]
    assert sharding.placements(sizes, ("data", "model")) == (Shard(0),
                                                             Shard(1))
    assert sharding.placements(sizes, ("model", None, None)) == \
        (Replicate(), Shard(0))
    assert sharding.placements(sizes, (("data", "model"), None)) == \
        (Shard(0), Shard(0))
    assert sharding.placements(sizes, ()) == (Replicate(), Replicate())
    pod = MESHES["2x16x16"]
    assert sharding.placements(pod, (("pod", "data"), "model", None)) == \
        (Shard(0), Shard(0), Shard(1))
    assert sharding.Sharding(sizes, ("model", None)).placements == \
        (Replicate(), Shard(0))


@pytest.mark.parametrize("spec", [(("model", "data"), None),
                                  ("data", "data")])
def test_placements_refuse_what_dtensor_cannot_hold(spec):
    with pytest.raises(ValueError):
        sharding.placements(MESHES["2x4"], spec)


def test_shard_hint_is_the_identity_without_a_dtensor_or_a_mesh():
    x = torch.arange(24.0).reshape(2, 3, 4)
    try:
        sharding.set_hint_rules({"act": ("data", None, "model")})
        assert sharding.current_mesh() is None
        assert sharding.shard_hint(x, "act") is x
        sharding.set_hint_rules({"act": ("data", None, "model")},
                                MESHES["2x4"])
        assert sharding.current_mesh() == MESHES["2x4"]
        assert sharding.shard_hint(x, "act") is x        # a plain tensor
        assert sharding.shard_hint(x, "other") is x
    finally:
        sharding.set_hint_rules({}, None)


def test_moe_ffn_takes_the_local_path_without_a_mesh():
    from repro_torch.models import moe
    rng = np.random.default_rng(0)
    p = moe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4,
                            device="cpu")
    x = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    got = moe.moe_ffn(p, x, top_k=2)
    want = moe.moe_ffn_local(p, x, top_k=2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_tree_paths_are_the_rules_paths():
    cfg = get_config("granite-moe-1b-a400m").smoke_config()
    paths = [p for p, _ in tree_lib.paths(transformer.LM(cfg, "meta"))]
    assert paths[:2] == ["embed", "final_norm"]
    assert "layers/1/moe/w_in" in paths and "layers/0/wq" in paths
    assert [p for p, _ in tree_lib.paths({"b": [torch.zeros(1)],
                                          "a": torch.zeros(1)})] == \
        ["a", "b/0"]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_needs_its_ranks(multi_pod):
    """Without a process group of 256 (512) ranks the production mesh
    raises, naming what it needs; importing the module touched nothing."""
    with pytest.raises(RuntimeError, match="512" if multi_pod else "256"):
        mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                      device_type="cpu")


def test_local_mesh_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_local_mesh(2, 4)
