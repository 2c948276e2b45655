"""The port's dry-run (``repro_torch.launch.{cells,dryrun,roofline}``)
against the reference's, with no card.

- Cell parity: ``tests/_jax_dryrun_reference.py`` builds every cell of
  every arch with the reference's ``build_cell`` on 512 host devices, on
  both production meshes; the port's ``build_cell`` on the bare mesh
  description must give the same non-parameter input shapes, specs and
  out-shardings and the same ``static_meta``, exactly, its dtypes under
  ``DTYPES``, and parameter (and AdamW moment) specs equal to the
  reference's with the layer entry dropped.  The reference's PRNG key is
  the port's ``GENERATOR`` slot, replicated as the key is.
- The counters on known answers, the L=1 / L=2 probes against the full
  count, one reduced run of each family and kind, all on a fake 2×4
  process group (8 ranks, this process rank 0), torn down at the end of
  the module.
- Roofline and the CLI: the port's functions against the reference's on
  the same records (the reference module's three constants set to the
  port's for the comparison; no file of it changes), ``--list``, and the
  reference's own test cell through the port's CLI.
- One card: with hint rules bound to a mesh and plain tensors, a reduced
  prefill, decode step and train step equal the unbound ones bit for bit;
  the head loss's sharding-aware pieces equal the indexed read and
  ``torch.logsumexp`` they replace, forward and backward.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import all_arch_ids, get_config
from repro_torch.distributed import sharding
from repro_torch.launch import cells, dryrun, roofline
from repro_torch.models import transformer

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": {"data": 16, "model": 16},
          "multipod": {"pod": 2, "data": 16, "model": 16}}
# reference dtype → port dtype (the port holds uint32 as int32 bit patterns)
DTYPES = {"int32": torch.int32, "uint32": torch.int32,
          "float32": torch.float32, "bfloat16": torch.bfloat16,
          "bool": torch.bool}
# the reference's stacked LM leaf of each port layer leaf's name
_LM_LAYER = {"wq": "attn/wq", "wk": "attn/wk", "wv": "attn/wv",
             "wo": "attn/wo", "w_in": "mlp/w_in", "w_gate": "mlp/w_gate",
             "w_out": "mlp/w_out"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(autouse=True)
def _unbind_hints():
    yield
    sharding.set_hint_rules({}, None)


@pytest.fixture(scope="module")
def mesh():
    """A fake 8-rank world and its 2×4 (data, model) CPU mesh."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    if dist.is_initialized():
        pytest.fail("a process group is already bound")
    dryrun.init_fake_world(8)
    yield make_local_mesh(2, 4, device_type="cpu")
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# reduced cells on the 2×4 fake mesh
# ---------------------------------------------------------------------------

LM_SHAPES = {"train": {"kind": "train", "seq_len": 64, "global_batch": 8},
             "prefill": {"kind": "prefill", "seq_len": 64,
                         "global_batch": 8},
             "decode": {"kind": "decode", "seq_len": 64, "global_batch": 8}}
GNN_SHAPES = {
    "full": {"kind": "full", "n_nodes": 200, "n_edges": 800, "d_feat": 16,
             "n_classes": 7},
    "minibatch": {"kind": "minibatch", "n_nodes": 300, "n_edges": 1200,
                  "batch_nodes": 16, "fanout": (4, 3), "d_feat": 16,
                  "n_classes": 8},
    "molecule": {"kind": "molecule", "n_nodes": 10, "n_edges": 20,
                 "batch": 16, "d_feat": 8, "n_classes": 1}}
RECSYS_SHAPES = {"train": {"kind": "train", "batch": 64},
                 "score": {"kind": "score", "batch": 32},
                 "retrieval": {"kind": "retrieval", "batch": 1,
                               "n_candidates": 512, "top_k": 10}}
INDEX_SHAPES = {"svs": {"kind": "svs", "n_queries": 16, "m": 64, "n": 1024},
                "decode_lists": {"kind": "decode_lists", "n_blocks": 16}}
REDUCED = [(a, s) for a in ("internlm2-1.8b", "granite-moe-1b-a400m")
           for s in LM_SHAPES] + \
    [("graphsage-reddit", s) for s in GNN_SHAPES] + \
    [(a, s) for a in ("din", "sasrec", "bert4rec", "mind")
     for s in RECSYS_SHAPES] + [("paper-index", s) for s in INDEX_SHAPES]


def _reduced_spec(arch: str, **cfg):
    spec = get_config(arch)
    shapes = {"lm": LM_SHAPES, "gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES,
              "index": INDEX_SHAPES}[spec.family]
    return dataclasses.replace(
        spec, config=dataclasses.replace(spec.smoke_config(), **cfg)
        if cfg else spec.smoke_config(), shapes=shapes)


def _run(mesh, arch, shape, **kw):
    cfg = kw.pop("cfg", {})
    return dryrun.run_cell(arch, shape, "2x4", None, verbose=False,
                           spec=_reduced_spec(arch, **cfg), mesh=mesh, **kw)


@pytest.fixture(scope="module")
def reduced_runs(mesh):
    return {(a, s): _run(mesh, a, s) for a, s in REDUCED}


@pytest.mark.parametrize("arch,shape", REDUCED,
                         ids=[f"{a}-{s}" for a, s in REDUCED])
def test_reduced_cell_runs(reduced_runs, arch, shape):
    r = reduced_runs[(arch, shape)]
    assert r["ok"] and r["n_devices"] == 8
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["materialized_bytes"] > 0
    coll = r["collective_bytes"]
    assert coll["total"] == sum(coll[k] for k in dryrun._KINDS)
    mem = r["memory"]
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0
    assert mem["temp_bytes"] >= 0 and mem["code_bytes"] is None
    if get_config(arch).family == "lm":
        assert r["collective_bytes"]["counts"]["all-gather"] > 0


def test_sharded_moe_counts_its_all_to_alls(reduced_runs):
    """granite's prefill routes through ``moe_ffn_sharded``: two token
    all-to-alls and one of expert ids a layer, counted as all-to-alls."""
    counts = reduced_runs[("granite-moe-1b-a400m", "prefill")][
        "collective_bytes"]["counts"]
    dense = reduced_runs[("internlm2-1.8b", "prefill")][
        "collective_bytes"]["counts"]
    assert counts["all-to-all"] - dense["all-to-all"] >= 3 * 2
    assert counts["all-reduce"] >= 2 * 2


def test_decode_collectives_stay_below_one_ranks_cache(mesh):
    """The decode step writes each rank's own cache block and the
    out-shardings keep the cache where it is: at 4096 positions its
    collectives move less than one rank's block of the cache."""
    spec = dataclasses.replace(
        _reduced_spec("internlm2-1.8b", n_kv=4),
        shapes={"decode": {"kind": "decode", "seq_len": 4096,
                           "global_batch": 8}})
    r = dryrun.run_cell("internlm2-1.8b", "decode", "2x4", None,
                        verbose=False, spec=spec, mesh=mesh)
    # k and v: 2 layers, 8/2 sequences, 4096/4 positions, 4 heads of 16
    cache_local = 2 * 2 * 4 * (4096 // 4) * 4 * 16 * 2
    assert r["memory"]["argument_bytes"] > cache_local
    assert 0 < r["collective_bytes"]["total"] < cache_local


def test_an_op_without_a_sharding_runs_replicated(mesh, monkeypatch):
    """With no strategy registered for the segment sums' ops, the trace
    still runs: each such op runs on its operands gathered whole, and its
    name is recorded."""
    monkeypatch.setattr(dryrun, "REPLICATED_OPS", ("aten.bincount.default",))
    r = _run(mesh, "graphsage-reddit", "full")
    assert r["ok"]
    assert {"aten.repeat_interleave.Tensor",
            "aten.segment_reduce.default"} <= set(r["replicated_ops"])


# ---------------------------------------------------------------------------
# the counters on known answers
# ---------------------------------------------------------------------------

def _trace(fn, specs, shardings):
    cell = cells.LoweringCell("t", "t", fn, specs, shardings, {})
    return dryrun.trace_cell(cell)


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_column_then_row_parallel_mlp(mesh):
    """x (8, 16) over 'data', W1 (16, 32) column-parallel, W2 (32, 16)
    row-parallel over 'model': each rank does 1/8 of every FLOP, and the
    partial sums meet in one all-reduce of its (4, 16) float32 block."""
    S = sharding.Sharding

    def mlp(x, w1, w2):
        y = torch.relu(x @ w1) @ w2
        return y.redistribute(mesh, sharding.placements(mesh, ("data",)))

    got = _trace(mlp, (_meta(8, 16), _meta(16, 32), _meta(32, 16)),
                 (S(mesh, ("data",)), S(mesh, (None, "model")),
                  S(mesh, ("model", None))))
    global_flops = 2 * (2 * 8 * 16 * 32) + 8 * 32          # two mms, relu
    assert got["flops"] == global_flops / 8
    coll = got["collective_bytes"]
    assert coll["counts"] == {"all-gather": 0, "all-reduce": 1,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    assert coll["all-reduce"] == coll["total"] == 4 * 16 * 4


def test_shard_to_shard_is_one_all_to_all(mesh):
    """(8, 16) from rows to columns over 'model' is one all-to-all of the
    rank's (8, 4) float32 block: the CPU group's all-gather fallback is
    not what is counted."""
    def move(x):
        return x.redistribute(mesh, sharding.placements(mesh,
                                                         (None, "model")))

    got = _trace(move, (_meta(8, 16),),
                 (sharding.Sharding(mesh, ("model", None)),))
    coll = got["collective_bytes"]
    assert coll["counts"]["all-to-all"] == 1
    assert coll["all-to-all"] == coll["total"] == 8 * 4 * 4
    assert got["memory"]["output_bytes"] == 8 * 4 * 4


def test_replicated_op_counts_its_full_flops_on_every_rank(mesh):
    got = _trace(lambda a, b: a @ b, (_meta(8, 16), _meta(16, 32)),
                 (sharding.replicated(mesh), sharding.replicated(mesh)))
    assert got["flops"] == 2 * 8 * 16 * 32
    assert got["collective_bytes"]["total"] == 0
    assert got["bytes_accessed"] == (8 * 16 + 16 * 32 + 8 * 32) * 4
    assert got["materialized_bytes"] == 2 * 8 * 32 * 4
    assert got["memory"]["argument_bytes"] == (8 * 16 + 16 * 32) * 4


def test_shape_propagation_is_not_counted(mesh):
    """The first sharded op of a kind makes DTensor run it once on global
    shapes; a second trace, with the propagation cached, counts the same."""
    def f(x, w):
        return torch.tanh(x @ w)

    args = ((_meta(24, 16), _meta(16, 40)),
            (sharding.Sharding(mesh, ("data",)),
             sharding.Sharding(mesh, (None, "model"))))
    first, second = _trace(f, *args), _trace(f, *args)
    assert first == second
    assert first["flops"] == 2 * 12 * 16 * 10 + 12 * 10


# ---------------------------------------------------------------------------
# the L=1 / L=2 probes against the full count
# ---------------------------------------------------------------------------

PROBES = [("internlm2-1.8b", "train"), ("granite-moe-1b-a400m", "train"),
          ("granite-moe-1b-a400m", "decode")]


@pytest.mark.parametrize("arch,shape", PROBES,
                         ids=[f"{a}-{s}" for a, s in PROBES])
def test_probes_extrapolate_to_the_full_count(mesh, arch, shape):
    full = _run(mesh, arch, shape, cfg={"n_layers": 4})
    probes = _run(mesh, arch, shape, cfg={"n_layers": 4}, skip_full=True)
    for k in ("flops", "bytes_accessed", "materialized_bytes",
              "collective_bytes"):
        assert probes[k] == full[k], k
    assert probes["memory"] is None and full["memory"] is not None
    assert set(probes["timings"]) == {"probe1_trace_s", "probe2_trace_s"}
    assert set(full["timings"]) == {"full_trace_s"}


# ---------------------------------------------------------------------------
# cell parity with the reference
# ---------------------------------------------------------------------------

def _records(reduced_runs) -> dict:
    results = [reduced_runs[k] for k in REDUCED[:4]] + [
        {"arch": "x", "shape": "y", "mesh": "pod", "ok": False,
         "error": "boom"},
        {"arch": "z", "shape": "w", "mesh": "pod", "ok": True,
         "n_devices": 256, "flops": 0.0, "bytes_accessed": 0.0,
         "materialized_bytes": 0, "model_flops": 0,
         "collective_bytes": {"total": 0}}]
    extrapolate = [(reduced_runs[REDUCED[i]], reduced_runs[REDUCED[i + 3]],
                    L) for i, L in ((0, 24), (1, 61), (3, 28))]
    return {"constants": {"PEAK_FLOPS": roofline.PEAK_FLOPS,
                          "HBM_BW": roofline.HBM_BW,
                          "LINK_BW": roofline.LINK_BW},
            "results": results, "extrapolate": extrapolate}


@pytest.fixture(scope="module")
def reference(reduced_runs, tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun_ref")
    records = _records(reduced_runs)
    with open(d / "records.json", "w") as fh:
        json.dump(records, fh)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests",
                                      "_jax_dryrun_reference.py"),
         str(d / "records.json"), str(d / "ref.json")],
        env=_env(), capture_output=True, text=True, timeout=240, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    with open(d / "ref.json") as fh:
        return records, json.load(fh)


def _ref_param_path(arch: str, path: str) -> str:
    """The reference's leaf path of a port parameter path (an LM layer
    leaf's is its stacked leaf's)."""
    if get_config(arch).family != "lm" or not path.startswith("layers/"):
        return path
    name = "/".join(path.split("/")[2:])
    return "layers/" + _LM_LAYER.get(name, name)


def _spec_json(s) -> list:
    return json.loads(json.dumps(list(s.spec)))


def _port_leaves(spec_tree, shard_tree) -> list[dict]:
    if cells.is_generator(spec_tree):
        return [{"path": "", "generator": True,
                 "spec": _spec_json(shard_tree)}]
    return [{"path": p, "shape": list(t.shape), "dtype": t.dtype,
             "spec": _spec_json(s)}
            for (p, t), s in zip(tree_lib.paths(spec_tree),
                                 tree_lib.matching(spec_tree, shard_tree))]


def _check_param(arch, ref_by_path, port_leaf, ref_path):
    ref = ref_by_path[ref_path]
    param = ref_path.split("/", 1)[1] if ref_path.startswith(
        ("mu/", "nu/")) else ref_path
    layer = get_config(arch).family == "lm" and param.startswith("layers/")
    drop = 1 if layer else 0
    assert port_leaf["shape"] == ref["shape"][drop:], ref_path
    assert port_leaf["dtype"] == DTYPES[ref["dtype"]], ref_path
    assert port_leaf["spec"] == ref["spec"][drop:], ref_path


def _check_plain(port, ref):
    """Non-parameter inputs: the same leaves, shapes, dtypes and specs."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p["path"] == r["path"]
        if p.get("generator"):
            assert r["shape"] == [2] and r["dtype"] == "uint32"
        else:
            assert p["shape"] == r["shape"], p["path"]
            assert p["dtype"] == DTYPES[r["dtype"]], p["path"]
        assert p["spec"] == r["spec"], p["path"]


CELLS = [(a, s, m) for m in MESHES for a in all_arch_ids()
         for s in get_config(a).shapes]


@pytest.mark.parametrize("arch,shape,mesh_kind", CELLS,
                         ids=[f"{a}|{s}|{m}" for a, s, m in CELLS])
def test_cell_matches_the_reference(reference, arch, shape, mesh_kind):
    ref = reference[1]["cells"][f"{arch}|{shape}|{mesh_kind}"]
    spec = get_config(arch)
    c = cells.build_cell(spec, shape, MESHES[mesh_kind])
    assert c.static_meta == ref["meta"]
    port = [_port_leaves(t, s) for t, s in zip(c.in_specs, c.in_shardings)]
    assert len(port) == len(ref["args"])
    has_params = spec.family != "index"
    has_opt = has_params and isinstance(c.in_specs[1], dict) and \
        "mu" in c.in_specs[1]
    if has_params:
        ref_params = {leaf["path"]: leaf for leaf in ref["args"][0]}
        assert len({_ref_param_path(arch, p["path"]) for p in port[0]}) == \
            len(ref_params)
        for leaf in port[0]:
            _check_param(arch, ref_params, leaf,
                         _ref_param_path(arch, leaf["path"]))
    if has_opt:
        ref_opt = {leaf["path"]: leaf for leaf in ref["args"][1]}
        names = [p["path"] for p in port[0]]
        for leaf in port[1]:
            head, _, rest = leaf["path"].partition("/")
            if head == "step":
                assert leaf["shape"] == ref_opt["step"]["shape"]
                assert leaf["dtype"] == DTYPES[ref_opt["step"]["dtype"]]
                assert leaf["spec"] == ref_opt["step"]["spec"]
                continue
            path = _ref_param_path(arch, names[int(rest)])
            _check_param(arch, ref_opt, leaf, f"{head}/{path}")
    first = 2 if has_opt else (1 if has_params else 0)
    for p, r in zip(port[first:], ref["args"][first:]):
        _check_plain(p, r)
    if ref["out"] is None:
        assert c.out_shardings is None
    else:
        got = [_spec_json(s) for s in
               (c.out_shardings[0], *c.out_shardings[1].values())]
        assert got == ref["out"]


# ---------------------------------------------------------------------------
# roofline and the CLI
# ---------------------------------------------------------------------------

def test_roofline_constants_are_the_h100_data_sheet():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9


def test_roofline_and_extrapolate_equal_the_reference(reference):
    records, ref = reference
    for r, want in zip(records["results"], ref["terms"]):
        if want is not None:
            assert roofline.roofline_terms(r) == want
    assert roofline.format_table(records["results"]) == ref["table"]
    for (v1, v2, L), want in zip(records["extrapolate"],
                                 ref["extrapolate"]):
        assert json.loads(json.dumps(dryrun._extrapolate(v1, v2, L))) == \
            want


def test_list_prints_what_the_reference_prints():
    got, want = (subprocess.run(
        [sys.executable, "-m", pkg, "--list"], env=_env(),
        capture_output=True, text=True, timeout=120, cwd=REPO)
        for pkg in ("repro_torch.launch.dryrun", "repro.launch.dryrun"))
    assert got.returncode == 0 and want.returncode == 0, want.stderr[-2000:]
    assert got.stdout == want.stdout


def test_the_reference_test_cell_through_the_cli(tmp_path):
    """The reference's own dry-run test cell (``tests/test_multidevice.py::
    test_dryrun_cell_compiles``), full width on the 512-rank mesh."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internlm2-1.8b", "--shape", "decode_32k", "--mesh", "multipod",
         "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "OK" in out.stdout
    with open(tmp_path / "internlm2-1.8b__decode_32k__multipod.json") as fh:
        rec = json.load(fh)
    assert rec["ok"] and rec["n_devices"] == 512
    assert rec["memory"]["code_bytes"] is None
    assert set(rec["collective_bytes"]) == {*dryrun._KINDS, "total",
                                            "counts"}
    assert rec["model_flops"] == cells.build_cell(
        get_config("internlm2-1.8b"), "decode_32k",
        MESHES["multipod"]).static_meta["model_flops"]


# ---------------------------------------------------------------------------
# one card: the hints and the head loss change no number
# ---------------------------------------------------------------------------

def _lm(seed=0):
    cfg = dataclasses.replace(get_config("internlm2-1.8b").smoke_config(),
                              compute_dtype="float32")
    return cfg, transformer.init_params(torch.Generator().manual_seed(seed),
                                        cfg, "cpu")


def _steps(cfg, params):
    from repro_torch.optim import adamw
    from repro_torch.train import steps as train_steps
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g)
    logits, cache = transformer.prefill(params, tokens, cfg)
    full = transformer.init_kv_cache(cfg, 2, 40, device="cpu")
    for n in ("k", "v"):
        full[n][:, :, :32] = cache[n]
    dec, full = transformer.decode_step(params, full, tokens[:, -1], 32, cfg)
    opt_cfg = adamw.AdamWConfig()
    p2 = copy.deepcopy(params)
    step = train_steps.make_lm_train_step(cfg, opt_cfg)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    p2, _, m = step(p2, adamw.init(p2, opt_cfg), batch)
    return [logits, cache["k"], cache["v"], dec, full["k"], full["v"],
            m["loss"], *tree_lib.leaves(p2)]


def test_bound_hints_change_nothing_on_plain_tensors(mesh):
    cfg, params = _lm()
    unbound = _steps(cfg, params)
    cells._set_lm_hints(mesh)
    bound = _steps(cfg, params)
    assert len(bound) == len(unbound)
    for a, b in zip(unbound, bound):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_loss_equals_an_indexed_read_and_torch_logsumexp(dtype):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 24, 32, generator=g).to(dtype)
    head = torch.randn(300, 32, generator=g)
    labels = torch.randint(-1, 300, (2, 24), generator=g)

    def before(x, head, labels):
        logits = x @ head.to(x.dtype).T
        lse = torch.logsumexp(logits.float(), dim=-1)
        B, S = labels.shape
        picked = logits[torch.arange(B)[:, None], torch.arange(S)[None, :],
                        torch.clamp_min(labels.long(), 0)]
        nll = lse - picked.float()
        mask = (labels >= 0).float()
        return torch.sum(nll * mask) / torch.clamp_min(mask.sum(), 1.0)

    outs = []
    for fn in (before, transformer._head_loss):
        xx = x.clone().requires_grad_()
        hh = head.clone().requires_grad_()
        loss = fn(xx, hh, labels)
        loss.backward()
        outs.append((loss, xx.grad, hh.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_write_at_on_a_plain_tensor_is_an_indexed_write():
    t = torch.zeros(3, 4, 5, 2)
    v = torch.arange(8.0).reshape(4, 2)
    want = t.clone()
    want[1, :, 3] = v
    sharding.write_at(t, (1, slice(None), 3), v)
    assert torch.equal(t, want)


def test_the_dryrun_leaves_dtensor_as_it_found_it(mesh):
    """The strategies and patches of a trace are undone after it."""
    from torch.distributed.tensor import DTensor, placement_types
    prop = DTensor._op_dispatcher.sharding_propagator
    before = (dict(prop.op_strategy_funcs),
              dict(prop.op_single_dim_strategy_funcs),
              placement_types.shard_dim_alltoall)
    _run(mesh, "paper-index", "svs")
    after = (dict(prop.op_strategy_funcs),
             dict(prop.op_single_dim_strategy_funcs),
             placement_types.shard_dim_alltoall)
    assert after == before
