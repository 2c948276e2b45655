"""The port's recsys serving path (configs, ``data/recsys_data``,
``models/recsys`` SCORE / RETRIEVAL, the serve steps, the params
converter, ``serve --arch <recsys id>``) against the reference on the CPU.

Params come from the reference's ``INIT`` (jitted, once per arch) and are
carried across with ``convert.recsys_params_from_numpy``; batches come from
the port's batch makers, which must give the reference's bytes for a seed.

Tolerances: scores and top-k values in float32 within 1e-4 (rtol and
atol): both packages gather the same rows and run the same float32
products and reductions, summed in another order (DIN's MLPs over
144-wide inputs, two attention blocks, MIND's three routing iterations).
Top-k indices are compared outside tie groups: Zipf candidates repeat
item ids, and a repeated id scores the same, so within a run of values
closer than the tolerance the two packages may order the indices
differently; such a run's index set must still be equal where it lies
wholly inside the top k, and the run that reaches rank k is compared up
to it only by value.
"""

import dataclasses
import io
import re
from contextlib import redirect_stdout
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.data import recsys_data as RD
from repro.launch import serve as ref_serve
from repro.models import recsys as RR
from repro.serve import steps as RS
from repro_torch.configs import base as tbase
from repro_torch.data import recsys_data as TD
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import recsys as TR
from repro_torch.serve import steps as TS

pytestmark = pytest.mark.torch_port

ARCHS = ["din", "sasrec", "bert4rec", "mind"]
TOL = 1e-4
N_CAND = 4096
TOP_K = 100
BATCH_MAKERS = {"din": "din_batch", "sasrec": "seq_batch",
                "bert4rec": "bert4rec_batch", "mind": "mind_batch"}


def _cfgs(arch: str):
    return (ref_get_config(arch).smoke_config(),
            tbase.get_config(arch).smoke_config())


_RUNS = {}


def _run(arch: str):
    """The reference's params for the smoke config of ``arch`` (jitted
    INIT, seed 0), their numpy tree and the port's params converted from
    it, made once per module."""
    if arch not in _RUNS:
        rcfg, tcfg = _cfgs(arch)
        params = jax.jit(RR.INIT[arch], static_argnums=1)(
            jax.random.PRNGKey(0), rcfg)
        tree = jax.tree_util.tree_map(np.asarray, params)
        _RUNS[arch] = SimpleNamespace(
            rcfg=rcfg, tcfg=tcfg, params=params, tree=tree,
            port=convert.recsys_params_from_numpy(tree, tcfg, device="cpu"))
    return _RUNS[arch]


def _batches(arch: str, seed: int, n: int, retrieval: bool = False):
    """(reference batch, port batch) from the port's batch maker, as jnp
    and torch tensors of the same numpy arrays."""
    cfg = _cfgs(arch)[1]
    rng = np.random.default_rng(seed)
    b = (TD.retrieval_batch(rng, cfg, n) if retrieval
         else getattr(TD, BATCH_MAKERS[arch])(rng, cfg, n))
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# --------------------------------------------------------------------------
# configs, data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_reference(arch):
    ref, port = ref_get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert (port.arch_id, port.family, port.source, port.shapes) == \
        (ref.arch_id, ref.family, ref.source, ref.shapes)
    assert dataclasses.asdict(port.smoke_config()) == \
        dataclasses.asdict(ref.smoke_config())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_layout_matches_reference_at_full_size(arch):
    """SPECS gives the reference INIT's tree, shapes (padded tables
    included) and float32 at the registered widths; nothing is
    allocated."""
    cfg = ref_get_config(arch).config
    want = jax.eval_shape(lambda k: RR.INIT[arch](k, cfg),
                          jax.random.PRNGKey(0))
    got = TR.SPECS[arch](tbase.get_config(arch).config)
    w_leaves, w_tree = jax.tree_util.tree_flatten(want)
    g_leaves, g_tree = jax.tree_util.tree_flatten(got, is_leaf=TR.is_leaf)
    assert w_tree == g_tree
    assert [tuple(l.shape) for l in w_leaves] == [l[1] for l in g_leaves]
    assert all(l.dtype == jnp.float32 for l in w_leaves)


@pytest.mark.parametrize("maker", sorted(set(BATCH_MAKERS.values()))
                         + ["retrieval_batch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batches_are_the_reference_bytes(arch, maker):
    rcfg, tcfg = _cfgs(arch)
    arg = 1000 if maker == "retrieval_batch" else 33
    want = getattr(RD, maker)(np.random.default_rng(7), rcfg, arg)
    got = getattr(TD, maker)(np.random.default_rng(7), tcfg, arg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape and got[k].tobytes() == want[k].tobytes(), k


def test_compress_histories_matches_reference():
    """Lists below one block go to varint, longer ones to bp-d1: the same
    kinds, payload bytes and bits/int."""
    rng = np.random.default_rng(3)
    hists = [rng.integers(0, 1 << 20, n) for n in (1, 50, 1023, 1024, 5000,
                                                   20000)]
    hists.append(np.arange(3000) * 7)
    want, want_bits = RD.compress_histories(hists)
    got, got_bits = TD.compress_histories(hists)
    assert got_bits == want_bits
    assert [k for k, _ in got] == [k for k, _ in want]
    for (kind, g), (_, w) in zip(got, want):
        assert g.n == w.n
        if kind == "varint":
            assert g.data.tobytes() == w.data.tobytes()
            continue
        for f in ("flat_words", "widths", "offsets", "maxes"):
            a = getattr(g, f).numpy()
            b = np.asarray(getattr(w, f))
            assert a.tobytes() == b.astype(a.dtype).tobytes(), f


# --------------------------------------------------------------------------
# models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["mean", "sum", "max"])
def test_embedding_bag_matches_reference(mode):
    rng = np.random.default_rng(11)
    table = rng.standard_normal((300, 8), dtype=np.float32)
    ids = rng.integers(0, 300, (5, 12)).astype(np.int32)
    mask = (rng.random((5, 12)) < 0.7).astype(np.float32)
    mask[:, 0] = 1
    want = RR.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                            jnp.asarray(mask), mode)
    got = TR.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(mask), mode)
    _close(got, want)


@pytest.mark.parametrize("batch", [1, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_score_matches_reference(arch, batch):
    run = _run(arch)
    rb, tb = _batches(arch, seed=batch, n=batch)
    want = jax.jit(RS.make_recsys_score_step(run.rcfg))(run.params, rb)
    got = TS.make_recsys_score_step(run.tcfg)(run.port, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == (batch,)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_scores_match_reference(arch):
    run = _run(arch)
    rb, tb = _batches(arch, seed=5, n=N_CAND, retrieval=True)
    want = jax.jit(RR.RETRIEVAL[arch], static_argnums=2)(run.params, rb,
                                                         run.rcfg)
    with torch.no_grad():
        got = TR.RETRIEVAL[arch](run.port, tb, run.tcfg)
    assert tuple(got.shape) == (N_CAND,)
    _close(got, want)


def assert_top_k(values, indices, want_values, want_indices, tol=TOL):
    """Values within ``tol``; indices equal outside tie groups (runs of
    reference values closer than 2·tol), a group's index set equal where
    the group ends before rank k.  Returns the count of ranks whose index
    was compared one to one."""
    values, want_values = np.asarray(values), np.asarray(want_values)
    indices, want_indices = np.asarray(indices), np.asarray(want_indices)
    np.testing.assert_allclose(values, want_values, rtol=tol, atol=tol)
    k = len(want_values)
    starts = np.flatnonzero(np.r_[True, np.abs(np.diff(want_values))
                                  > 2 * tol])
    ends = np.r_[starts[1:], k]
    single = 0
    for lo, hi in zip(starts, ends):
        if hi == k and hi - lo > 1:
            continue            # the group that reaches rank k
        assert sorted(indices[lo:hi]) == sorted(want_indices[lo:hi]), \
            (lo, hi)
        single += hi - lo == 1
    return single


@pytest.mark.parametrize("arch", ARCHS)
def test_retrieval_top_100_matches_reference(arch):
    run = _run(arch)
    rb, tb = _batches(arch, seed=6, n=N_CAND, retrieval=True)
    rv, ri = jax.jit(RS.make_recsys_retrieval_step(run.rcfg, TOP_K))(
        run.params, rb)
    tv, ti = TS.make_recsys_retrieval_step(run.tcfg, TOP_K)(run.port, tb)
    assert tuple(tv.shape) == tuple(ti.shape) == (TOP_K,)
    assert bool((tv[:-1] >= tv[1:]).all())
    # Zipf draws repeat ids, so ties are there to be handled
    assert len(np.unique(tb["cand_items"].numpy())) < N_CAND
    assert assert_top_k(tv.numpy(), ti.numpy(), rv, ri) > 0


def test_top_k_check_catches_a_wrong_index():
    v = np.array([5.0, 4.0, 4.0, 3.0, 2.0, 2.0], np.float32)
    i = np.array([9, 1, 2, 7, 3, 4])
    assert assert_top_k(v, i, v, i) == 2
    assert_top_k(v, [9, 2, 1, 7, 4, 3], v, i)       # ties reordered
    with pytest.raises(AssertionError):
        assert_top_k(v, [9, 1, 2, 8, 3, 4], v, i)
    with pytest.raises(AssertionError):
        assert_top_k(v, [9, 1, 5, 7, 3, 4], v, i)


def test_converter_refuses_wrong_shapes_and_layouts():
    run = _run("sasrec")
    bad = dict(run.tree, pos_embed=run.tree["pos_embed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        convert.recsys_params_from_numpy(bad, run.tcfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        convert.recsys_params_from_numpy(
            {k: v for k, v in run.tree.items() if k != "blocks"}, run.tcfg,
            device="cpu")
    with pytest.raises(ValueError, match="list"):
        convert.recsys_params_from_numpy(
            dict(run.tree, blocks=run.tree["blocks"][:1]), run.tcfg,
            device="cpu")
    with pytest.raises(ValueError, match="shape"):
        convert.recsys_params_from_numpy(run.tree, _run("bert4rec").tcfg,
                                         device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_layout_and_scales(arch):
    cfg = tbase.get_config(arch).smoke_config()
    params = TR.INIT[arch](torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    table = params["item_table"]
    assert table.shape[0] % 4096 == 0 and table.dtype == torch.float32
    assert float(table.std()) == pytest.approx(1 / np.sqrt(cfg.embed_dim),
                                               rel=0.05)
    flat = jax.tree_util.tree_leaves(TR.SPECS[arch](cfg), is_leaf=TR.is_leaf)
    got = jax.tree_util.tree_leaves(params)
    assert [tuple(t.shape) for t in got] == [l[1] for l in flat]
    assert all(not t.any() for t, l in zip(got, flat) if l[0] == "zeros")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TR.INIT[arch](torch.Generator().manual_seed(0), cfg)


# --------------------------------------------------------------------------
# serve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_recsys_prints_the_reference_line(arch):
    line = re.compile(rf"^\[serve\] {arch}: scored batch=4 in \d+\.\d\d ms; "
                      rf"mean score -?\d+\.\d{{4}}$")
    buf = io.StringIO()
    with redirect_stdout(buf):
        ref_serve.serve_recsys(SimpleNamespace(batch=0),
                               ref_get_config(arch))
        rep = tserve.main(["--arch", arch, "--device", "cpu"])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 2 and all(line.match(l) for l in lines), lines
    assert tuple(rep["scores"].shape) == (4,)
    assert bool(torch.isfinite(rep["scores"]).all())
