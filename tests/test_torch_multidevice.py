"""The port's multi-rank layer against the reference's, on the CPU: the
expert-parallel MoE, the placement of parameter trees on a mesh, the
dispatcher and the elastic checkpoint.

One module fixture runs both sides at once and the tests read what they
wrote:
- the reference on 8 host devices in a subprocess
  (``tests/_jax_mesh_reference.py``, as tests/test_multidevice.py runs
  its checks), writing ``.npz`` / ``.json`` files;
- the port in 8 gloo processes (``tests/_torch_mesh_worker.py``) over
  2×4, 4×2 and 1×8 ``DeviceMesh``es, rendezvousing through a ``file://``
  store under the test's temporary directory, each process with its own
  process-group timeout and the whole launch with a deadline that fails
  the tests rather than hangs the suite.
The inputs are drawn from seeds on both sides (``_multidevice_cases``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _multidevice_cases as cases

pytestmark = pytest.mark.torch_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
WORLD = 8
DEADLINE = 120                  # seconds for both sides, started together
TOL = 1e-4                      # tests/test_multidevice.py's


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(REPO, "src"), TESTS])
    env.update(extra)
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Run the reference and the port side by side; returns (ref arrays,
    ref placements, port arrays by rank, port summary)."""
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    procs = {"reference": subprocess.Popen(
        [sys.executable, os.path.join(TESTS, "_jax_mesh_reference.py"),
         str(ref_dir)],
        env=_env(XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)}
    init = f"file://{port_dir / 'store'}"
    for r in range(WORLD):
        procs[f"rank {r}"] = subprocess.Popen(
            [sys.executable, os.path.join(TESTS, "_torch_mesh_worker.py"),
             str(r), str(WORLD), init, str(port_dir)],
            env=_env(OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    logs, failed = {}, []
    try:
        for name, p in procs.items():
            try:
                logs[name], _ = p.communicate(timeout=DEADLINE)
            except subprocess.TimeoutExpired:
                failed.append(f"{name}: no end within {DEADLINE} s")
                break
            if p.returncode != 0:
                failed.append(f"{name} exited {p.returncode}:\n"
                              f"{logs[name][-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        pytest.fail("\n".join(failed))
    ref = dict(np.load(ref_dir / "ref.npz"))
    with open(ref_dir / "ref_placed.json") as fh:
        ref_placed = json.load(fh)
    port = [dict(np.load(port_dir / f"rank{r}.npz")) for r in range(WORLD)]
    with open(port_dir / "summary.json") as fh:
        summary = json.load(fh)
    return ref, ref_placed, port, summary


# ---------------------------------------------------------------------------
# moe_ffn_sharded against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(cases.MOE_CASES))
def test_sharded_moe_output_matches_reference(runs, case):
    ref, _, port, _ = runs
    got, want = port[0][f"moe|{case}|out"], ref[f"moe|{case}|out"]
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err < TOL, err


@pytest.mark.parametrize("case", list(cases.MOE_CASES))
def test_sharded_moe_aux_matches_reference(runs, case):
    ref, _, port, _ = runs
    for r in range(WORLD):                    # one value on every rank
        assert abs(float(port[r][f"moe|{case}|aux"])
                   - float(ref[f"moe|{case}|aux"])) < TOL


@pytest.mark.parametrize("leaf", cases.GRAD_LEAVES)
@pytest.mark.parametrize("case", list(cases.MOE_CASES))
def test_sharded_moe_gradient_matches_reference(runs, case, leaf):
    """Gradients of sum(out · w) + aux through both all-to-alls, normwise
    per leaf (each rank holds the whole gradient after full_tensor)."""
    ref, _, port, _ = runs
    want = ref[f"moe|{case}|{leaf}"]
    assert np.linalg.norm(want) > 0
    for r in (0, WORLD - 1):
        got = port[r][f"moe|{case}|{leaf}"]
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < TOL, (r, err)


def test_no_drop_case_matches_reference_local(runs):
    """tests/test_multidevice.py::test_sharded_moe_matches_local's check,
    port side: at cf 8.0 nothing drops and the sharded output is the
    reference's local one."""
    ref, _, port, summary = runs
    rec = summary["moe"]["2x4-cf8"]
    assert rec["send_dropped"] == rec["expert_dropped"] == 0
    err = float(np.abs(port[0]["moe|2x4-cf8|out"]
                       - ref["local|2x4-cf8|out"]).max())
    assert err < TOL, err
    assert abs(float(port[0]["moe|2x4-cf8|aux"])
               - float(ref["local|2x4-cf8|aux"])) < TOL


@pytest.mark.parametrize("case", cases.DROPPING)
def test_dropping_cases_drop_a_tenth_of_slots(runs, case):
    """The cases that test the drop rule drop at least 10 % of slots, on
    the send side and at an expert's capacity."""
    rec = runs[3]["moe"][case]
    assert rec["slots"] == (cases.MOE_CASES[case]["B"]
                            * cases.MOE_CASES[case]["S"]
                            * cases.MOE_CASES[case]["k"])
    assert rec["send_dropped"] > 0 and rec["expert_dropped"] > 0
    assert rec["send_dropped"] + rec["expert_dropped"] >= 0.1 * rec["slots"]


@pytest.mark.parametrize("case", list(cases.MOE_CASES))
def test_sharded_moe_layout_and_repeat(runs, case):
    rec = runs[3]["moe"][case]
    assert rec["out_type"] == rec["aux_type"] == "DTensor"
    assert rec["out_placements"] == ["S(0)", "S(1)"]   # P('data', 'model')
    assert rec["repeat_equal"]


def test_moe_ffn_dispatch(runs):
    """moe_ffn: the sharded path on a bound 2×4 mesh (whole tensors in and
    out), the local one where S % model != 0 and with no mesh bound."""
    d = runs[3]["dispatch"]
    assert d["calls"] == ["sharded", "local", "local"]
    assert d["bound_is_plain"]
    assert d["bound_max_err_vs_local"] < TOL       # cf 8.0: nothing drops
    assert d["bound_aux_err_vs_local"] < TOL


def test_shard_hint_redistributes_a_dtensor_under_a_bound_mesh(runs):
    h = runs[3]["hint"]
    assert h["placements"] == ["S(0)", "S(1)"]
    assert h["local_equal"] and h["full_equal"]
    assert h["fewer_dims_same"] and h["no_rule_same"]


# ---------------------------------------------------------------------------
# placement on the gloo 2×4 mesh against the reference's device blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree,rule", [(p[0], p[2]) for p in cases.PLACED])
def test_placed_blocks_match_reference(runs, tree, rule):
    """Each rank's ``to_local()`` of each leaf is the block that
    ``NamedSharding.devices_indices_map`` gives the device at the same
    mesh coordinate (an LM leaf: the stacked leaf's block, its layer
    axis dropped)."""
    _, ref_placed, port, summary = runs
    assert summary["placed"][tree]["torch_equal"]
    ref_leaves = ref_placed[tree]
    prefix = f"placed|{tree}|"
    paths = sorted(k[len(prefix):] for k in port[0] if k.startswith(prefix))
    assert paths
    seen = set()
    for path in paths:
        ref_name, stacked = cases.ref_path(path, rule)
        leaf = ref_leaves[ref_name]
        seen.add(ref_name)
        shape = tuple(leaf["shape"][1:] if stacked else leaf["shape"])
        whole = cases.fill(shape)
        for r in range(WORLD):
            coord = f"{r // 4},{r % 4}"
            bounds = leaf["blocks"][coord]
            if stacked:
                assert bounds[0] == [0, leaf["shape"][0]]
                bounds = bounds[1:]
            want = whole[tuple(slice(a, b) for a, b in bounds)]
            got = port[r][prefix + path]
            assert got.shape == want.shape, (path, r)
            assert np.array_equal(got, want), (path, r)
    assert seen == set(ref_leaves)
    assert any(len(set(map(str, leaf["blocks"].values()))) > 1
               for leaf in ref_leaves.values()), "nothing was sharded"


def test_dim_over_two_axes_splits_data_major(runs):
    """A dim sharded over ('data', 'model') is split in mesh order, the
    first axis major, as JAX splits it: rank (i, j) holds chunk 4i + j."""
    _, _, port, summary = runs
    assert summary["two_axes_torch_equal"]
    whole = cases.fill((16, 4))
    for r in range(WORLD):
        assert np.array_equal(port[r]["two_axes"], whole[2 * r:2 * r + 2])


# ---------------------------------------------------------------------------
# the elastic checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["4x2", "1x8"])
def test_elastic_checkpoint_reshard(runs, target):
    """tests/test_multidevice.py::test_elastic_checkpoint_reshard: saved
    from a 2×4 mesh, restored onto 4×2 and 1×8 as DTensors equal to
    arange(64·8).reshape(64, 8)."""
    rec = runs[3]["checkpoint"][target]
    assert rec["step"] == 5
    assert rec["dtensor"]
    assert rec["mesh_shape"] == [int(s) for s in target.split("x")]
    assert rec["placements"] == ["S(0)", "S(1)"]
    assert rec["local_equal"] and rec["full_equal"]


def test_module_checkpoint_restores_onto_another_mesh(runs):
    """An LM module placed by the tp rules on 2×4, saved, restored into a
    fresh module on 1×8: DTensor parameters equal to the saved ones."""
    rec = runs[3]["checkpoint"]["module"]
    assert rec["step"] == 3 and rec["same_object"]
    assert rec["all_dtensor"] and rec["on_1x8"] and rec["equal"]
