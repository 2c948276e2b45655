"""The port's GNN (graphsage-reddit) against the reference on the CPU:
config, deterministic segment sums, the sampler given the reference's
draws, the three forwards and losses, and one train step of each variant
from weights and optimizer state carried across.

Weights come from the reference's ``init_params`` (``gnn_params_from_numpy``);
graphs and batches from a numpy seed (``graph_data``, byte-equal in both
packages, tests/test_torch_graph_data.py).

Tolerances: float32 throughout, 1e-4 relative and absolute (``F32_TOL``,
as tests/test_torch_models.py): the reference sums messages by XLA's
scatter-add and the port by a segmented reduction in another order, and
the products run in each library's own order.  Sampled neighbour ids are
integers and must be equal.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as ref_get_config
from repro.data import graph_data as RD
from repro.models import gnn as RG
from repro.optim import adamw as RA
from repro.train import steps as RS
from repro_torch import tree as ttree
from repro_torch.configs import base as tbase
from repro_torch.data import graph_data as TD
from repro_torch.models import convert
from repro_torch.models import gnn as TG
from repro_torch.models import segment as TSeg
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TS

pytestmark = pytest.mark.torch_port

F32_TOL = 1e-4
FANOUT = (5, 3)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfg(task="node"):
    cfg = ref_get_config("graphsage-reddit").smoke_config()
    return dataclasses.replace(cfg, task=task)


def _tcfg(task="node"):
    return dataclasses.replace(tbase.get_config("graphsage-reddit")
                               .smoke_config(), task=task)


def _params(cfg, tcfg, seed=0):
    ref = RG.init_params(jax.random.PRNGKey(seed), cfg)
    tree = jax.tree.map(np.asarray, ref)
    return ref, convert.gnn_params_from_numpy(tree, tcfg, device="cpu")


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _full_batch(seed=0):
    g = RD.synthetic_graph(1000, 6, seed=seed, d_feat=16, n_classes=8)
    return {k: g[k] for k in ("x", "edge_src", "edge_dst", "labels",
                              "train_mask")}


def _molecule_batch(seed=0):
    return RD.molecule_batch(np.random.default_rng(seed), 8, 30, 64, 16)


def _minibatch(key, seed=0):
    """A minibatch with the reference's two hops drawn from ``key`` as its
    ``minibatch_forward`` draws them."""
    g = RD.synthetic_graph(2000, 8, seed=seed, d_feat=16, n_classes=8)
    seeds = np.arange(64, dtype=np.int32) * 7 % 2000
    k1, k2 = jax.random.split(key)
    ip, ix = jnp.asarray(g["indptr"]), jnp.asarray(g["indices"])
    l1 = RG.sample_neighbors(k1, ip, ix, jnp.asarray(seeds), FANOUT[0])
    l2 = RG.sample_neighbors(k2, ip, ix, l1.reshape(-1), FANOUT[1])
    return {"feats": g["x"], "indptr": g["indptr"], "indices": g["indices"],
            "seeds": seeds, "labels": g["labels"][seeds]}, \
        (np.asarray(l1), np.asarray(l2).reshape(64, *FANOUT))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_registered_config_matches_reference():
    ref, port = ref_get_config("graphsage-reddit"), \
        tbase.get_config("graphsage-reddit")
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert (port.arch_id, port.family, port.source, port.shapes) == \
        (ref.arch_id, ref.family, ref.source, ref.shapes)
    assert dataclasses.asdict(port.smoke_config()) == \
        dataclasses.asdict(ref.smoke_config())
    assert tbase.NOT_YET_PORTED == {}


def test_init_params_shapes_and_scales():
    tcfg = _tcfg()
    p = TG.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    ref = RG.init_params(jax.random.PRNGKey(0), _cfg())
    assert [tuple(t.shape) for t in jax.tree.leaves(ref)] == \
        [tuple(t.shape) for t in ttree.leaves(p)]
    assert float(p["layers"][0]["w_self"].std()) == pytest.approx(
        1 / np.sqrt(tcfg.d_feat), rel=0.15)
    assert not p["layers"][1]["b"].any()


# ---------------------------------------------------------------------------
# segment sums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,e,chunk", [(50, 400, 512), (50, 4000, 7),
                                       (300, 0, 512), (7, 900, 3)])
def test_gather_segment_sum_matches_scatter_add(n, e, chunk, monkeypatch):
    """Forward and backward equal to index_add over the edges (the
    reference's segment_sum), in one level and across runs of ``chunk``
    edges, with hubs, empty nodes and no edges at all; repeats bit-equal;
    ``take``'s backward equal to index_add of the row gradients."""
    monkeypatch.setattr(TSeg, "SEGMENT_CHUNK", chunk)
    rng = np.random.default_rng(n + e)
    src = torch.from_numpy(rng.integers(0, n, e))
    dst = torch.from_numpy(np.minimum(rng.zipf(1.5, e) - 1, n - 1))
    h = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
    up = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32))
    plan = TG.segment_plan(src, dst, n)
    h1 = h.clone().requires_grad_(True)
    out = TG.gather_segment_sum(h1, plan)
    (g,) = torch.autograd.grad((out * up).sum(), h1)
    h2 = h.clone().requires_grad_(True)
    want = torch.zeros(n, 5).index_add(0, dst, h2[src])
    (gw,) = torch.autograd.grad((want * up).sum(), h2)
    _close(out, want, 1e-5)
    _close(g, gw, 1e-5)
    assert torch.equal(plan.in_degree, torch.bincount(dst, minlength=n))
    again = TG.gather_segment_sum(h, TG.segment_plan(src, dst, n))
    assert torch.equal(again, out.detach())
    # take: rows of h by src; its backward sums each row's gradients
    h3 = h.clone().requires_grad_(True)
    up_rows = torch.from_numpy(rng.normal(size=(e, 5)).astype(np.float32))
    rows = TSeg.take(h3, src)
    assert torch.equal(rows.detach(), h[src])
    (gt,) = torch.autograd.grad((rows * up_rows).sum(), h3)
    _close(gt, torch.zeros(n, 5).index_add(0, src, up_rows), 1e-5)


# ---------------------------------------------------------------------------
# sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_neighbors_from_draws_match_reference_sampler(seed):
    """Given the r that ``jax.random.randint`` draws for a key, the port's
    deterministic half gives the reference's samples, self-loops of
    isolated nodes included."""
    g = RD.synthetic_graph(500, 3, seed=seed)
    indptr = g["indptr"].copy()
    nodes = np.arange(0, 500, 3, dtype=np.int32)
    key = jax.random.PRNGKey(seed)
    want = RG.sample_neighbors(key, jnp.asarray(indptr),
                               jnp.asarray(g["indices"]),
                               jnp.asarray(nodes), 7)
    r = jax.random.randint(key, (len(nodes), 7), 0, 1 << 30)
    got = TG.neighbors_from_draws(torch.from_numpy(indptr),
                                  torch.from_numpy(g["indices"]),
                                  torch.from_numpy(nodes),
                                  torch.from_numpy(np.array(r)))
    assert np.array_equal(_np(got), np.asarray(want))
    # node 1 has no neighbour (a self-loop); the offsets wrap by degree
    got = TG.neighbors_from_draws(
        torch.tensor([0, 2, 2, 3]), torch.tensor([1, 2, 0]),
        torch.tensor([0, 1, 2]), torch.tensor([[0, 1], [5, 6], [3, 4]]))
    assert got.tolist() == [[1, 2], [1, 1], [0, 0]]


def test_sampler_draws_in_range_and_from_the_generator():
    g = TD.synthetic_graph(300, 4)
    ip, ix = torch.from_numpy(g["indptr"]), torch.from_numpy(g["indices"])
    seeds = torch.arange(32)
    a = TG.sample_hops(torch.Generator().manual_seed(5), ip, ix, seeds, (4, 2))
    b = TG.sample_hops(torch.Generator().manual_seed(5), ip, ix, seeds, (4, 2))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    l1, l2 = a
    assert l1.shape == (32, 4) and l2.shape == (32, 4, 2)
    for node, nbrs in zip(seeds.tolist(), l1.tolist()):
        row = set(g["indices"][g["indptr"][node]:g["indptr"][node + 1]])
        assert set(nbrs) <= (row or {node})


# ---------------------------------------------------------------------------
# forwards and losses
# ---------------------------------------------------------------------------

def test_full_graph_forward_and_loss_match_reference():
    cfg, tcfg = _cfg(), _tcfg()
    ref, port = _params(cfg, tcfg)
    b = _full_batch()
    want = RG.full_graph_forward(ref, jnp.asarray(b["x"]),
                                 jnp.asarray(b["edge_src"]),
                                 jnp.asarray(b["edge_dst"]), cfg)
    tb = _t(b)
    got = TG.full_graph_forward(port, tb["x"], tb["edge_src"],
                                tb["edge_dst"], tcfg)
    _close(got, want)
    rl, _ = RG.node_loss(ref, {k: jnp.asarray(v) for k, v in b.items()}, cfg)
    tl, _ = TG.node_loss(port, tb, tcfg)
    _close(tl, rl)


def test_minibatch_forward_and_loss_match_reference():
    cfg, tcfg = _cfg(), _tcfg()
    ref, port = _params(cfg, tcfg)
    key = jax.random.PRNGKey(11)
    b, (l1, l2) = _minibatch(key)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = RG.minibatch_forward(ref, jb["feats"], jb["indptr"],
                                jb["indices"], jb["seeds"], key, cfg, FANOUT)
    tb = _t({**b, "l1": l1, "l2": l2})
    got = TG.minibatch_forward(port, tb["feats"], tb["seeds"], tb["l1"],
                               tb["l2"], tcfg)
    _close(got, want)
    rl, _ = RG.minibatch_loss(ref, jb, key, cfg, FANOUT)
    tl, _ = TG.minibatch_loss(port, tb, None, tcfg, FANOUT)
    _close(tl, rl)


def test_molecule_forward_and_loss_match_reference():
    cfg, tcfg = _cfg("graph"), _tcfg("graph")
    ref, port = _params(cfg, tcfg)
    b = _molecule_batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    want = RG.molecule_forward(ref, jb["x"], jb["edge_src"], jb["edge_dst"],
                               jb["node_mask"], cfg)
    tb = _t(b)
    got = TG.molecule_forward(port, tb["x"], tb["edge_src"], tb["edge_dst"],
                              tb["node_mask"], tcfg)
    _close(got, want)
    _close(TG.molecule_loss(port, tb, tcfg)[0],
           RG.molecule_loss(ref, jb, cfg)[0])


# ---------------------------------------------------------------------------
# one train step of each variant, from carried weights and optimizer state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["full", "minibatch", "molecule"])
def test_gnn_train_step_matches_reference(variant):
    """The reference takes one step from its init; its params and AdamW
    state are carried across; both take a second step on another batch:
    loss, grad norm, params and moments agree, the step count is equal."""
    task = "graph" if variant == "molecule" else "node"
    cfg, tcfg = _cfg(task), _tcfg(task)
    ref, _ = _params(cfg, tcfg)
    opt = RA.AdamWConfig(lr=1e-2, weight_decay=0.0)
    kw = dict(total_steps=50, warmup=1)
    rstep = jax.jit(RS.make_gnn_train_step(cfg, variant, opt,
                                           fanout=FANOUT, **kw))
    tstep = TS.make_gnn_train_step(tcfg, variant, TA.AdamWConfig(
        lr=1e-2, weight_decay=0.0), fanout=FANOUT, **kw)
    keys = [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]
    if variant == "full":
        batches = [_full_batch(0), _full_batch(1)]
        hops = [None, None]
    elif variant == "molecule":
        batches = [_molecule_batch(0), _molecule_batch(1)]
        hops = [None, None]
    else:
        pairs = [_minibatch(k, s) for k, s in zip(keys, (0, 1))]
        batches, hops = [p[0] for p in pairs], [p[1] for p in pairs]
    p1, o1, _ = rstep(ref, RA.init(ref, opt),
                      {k: jnp.asarray(v) for k, v in batches[0].items()},
                      keys[0])
    tp = convert.gnn_params_from_numpy(jax.tree.map(np.asarray, p1), tcfg,
                                       device="cpu")
    to = convert.opt_state_from_numpy(jax.tree.map(np.asarray, o1), tp,
                                      device="cpu")
    p2, o2, m2 = rstep(p1, o1, {k: jnp.asarray(v)
                                for k, v in batches[1].items()}, keys[1])
    tb = _t(batches[1] if hops[1] is None else
            {**batches[1], "l1": hops[1][0], "l2": hops[1][1]})
    tp, to, tm = tstep(tp, to, tb, None)
    _close(tm["loss"], m2["loss"])
    _close(tm["grad_norm"], m2["grad_norm"])
    for got, want in zip(ttree.leaves(tp), jax.tree.leaves(p2)):
        _close(got, want)
    want_moments = jax.tree.leaves(o2["mu"]) + jax.tree.leaves(o2["nu"])
    for got, want in zip(to["mu"] + to["nu"], want_moments):
        _close(got, want)
    assert int(to["step"]) == int(o2["step"]) == 2
