"""The port's training stack against the reference on the CPU: AdamW and
its schedule, one train step of the LM (remat none / dots / full, accum
2, an MoE config) and of each recsys arch from weights and optimizer
state carried across, remat changing no number, the fault-tolerant
trainer and checkpoint manager (the cases of tests/test_trainer_ft.py),
gradient compression, and the launcher.

Tolerances: float32, 1e-4 relative and absolute (``F32_TOL``, as
tests/test_torch_models.py) on losses, gradient norms, parameters and
moments after a step: each library sums products in its own order.  The
LM steps are compared in float32 compute (the smoke configs with
``compute_dtype="float32"``); one bf16 step (the registered compute dtype)
is held to the loss within ``BF16_LOSS_TOL``: bf16 keeps 8 significant
bits, and each package rounds its elementwise chains at other points.
Within the port, remat, resume and repeats are held to exact equality.
"""

import dataclasses
import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs.base import get_config as ref_get_config
from repro.data import lm_data as RLD
from repro.data import recsys_data as RRD
from repro.distributed import grad_compress as RGC
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro.optim import adamw as RA
from repro.train import steps as RS
from repro_torch import tree as ttree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import base as tbase
from repro_torch.data.lm_data import TokenStream
from repro_torch.distributed import grad_compress as gc
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.train import steps as TS
from repro_torch.train.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.torch_port

F32_TOL = 1e-4
BF16_LOSS_TOL = 2e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype=np.float32) if \
        np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clip,moment", [(1.0, "float32"), (100.0, "float32"),
                                         (1.0, "bfloat16")])
def test_adamw_update_matches_reference(clip, moment):
    """Two updates from a carried state: clipping on (‖g‖ > clip) and off,
    decay only on leaves of two or more dims, float32 and bf16 moments."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(6, 5)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32),
              "blocks": [{"k": rng.normal(size=(3, 4)).astype(np.float32)}]}
    cfg_r = RA.AdamWConfig(lr=1e-2, clip_norm=clip, moment_dtype=moment)
    cfg_t = adamw.AdamWConfig(lr=1e-2, clip_norm=clip, moment_dtype=moment)
    rp = jax.tree.map(jnp.asarray, params)
    ro = RA.init(rp, cfg_r)
    tp = jax.tree.map(torch.from_numpy, params)
    to = adamw.init(tp, cfg_t)
    for i, scale in enumerate((3.0, 0.5)):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * scale)
                         .astype(np.float32), params)
        rp, ro, rm = RA.update(jax.tree.map(jnp.asarray, g), ro, rp, cfg_r,
                               lr_scale=0.5)
        tp, to, tm = adamw.update(ttree.leaves(jax.tree.map(
            torch.from_numpy, g)), to, tp, cfg_t, lr_scale=0.5)
        _close(tm["grad_norm"], rm["grad_norm"])
        for a, b in zip(ttree.leaves(tp), jax.tree.leaves(rp)):
            _close(a, b)
        for a, b in zip(to["mu"] + to["nu"],
                        jax.tree.leaves(ro["mu"]) + jax.tree.leaves(ro["nu"])):
            assert str(a.dtype).endswith(moment)
            _close(a, b, 1e-2 if moment == "bfloat16" else F32_TOL)
        assert int(to["step"]) == int(ro["step"]) == i + 1


def test_cosine_schedule_matches_reference():
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 20000):
        want = RA.cosine_schedule(jnp.int32(step), 2.0, 100, 10000)
        got = adamw.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                    2.0, 100, 10000)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# one train step: LM and recsys, carried weights and optimizer state
# ---------------------------------------------------------------------------

def _lm_cfgs(arch, **kw):
    cfg = dataclasses.replace(ref_get_config(arch).smoke_config(), **kw)
    tcfg = dataclasses.replace(tbase.get_config(arch).smoke_config(), **kw)
    return cfg, tcfg


def _lm_batch(vocab, seed, accum=1):
    s = RLD.TokenStream(vocab, seed=seed)
    bs = [s.batch(2, 32) for _ in range(accum)]
    if accum == 1:
        return bs[0]
    return {k: np.stack([b[k] for b in bs]) for k in bs[0]}


def _carried_step(rstep, tstep, ref_params, ref_opt, to_port, batches):
    """The reference's first step, its state carried across, then one
    more step in each package.  Returns (port result, reference result)."""
    p1, o1, _ = rstep(ref_params, ref_opt, _j(batches[0]),
                      jax.random.PRNGKey(0))
    tp = to_port(jax.tree.map(np.asarray, p1))
    to = convert.opt_state_from_numpy(jax.tree.map(np.asarray, o1), tp,
                                      device="cpu")
    want = rstep(p1, o1, _j(batches[1]), jax.random.PRNGKey(1))
    got = tstep(tp, to, _t(batches[1]), None)
    return got, want


def _check_step(got, want, tol=F32_TOL, leaves_of=None):
    (tp, to, tm), (rp, ro, rm) = got, want
    _close(tm["loss"], rm["loss"], tol)
    _close(tm["grad_norm"], rm["grad_norm"], tol)
    ref_leaves = leaves_of(rp) if leaves_of else jax.tree.leaves(rp)
    for a, b in zip(ttree.leaves(tp), ref_leaves):
        _close(a, b, tol)
    mu = leaves_of(ro["mu"]) if leaves_of else jax.tree.leaves(ro["mu"])
    for a, b in zip(to["mu"], mu):
        _close(a, b, tol)
    assert int(to["step"]) == int(ro["step"]) == 2


def _lm_leaves(lm_tcfg):
    """A reference LM tree's arrays in the order of the port LM's
    parameters (layer by layer)."""
    def leaves(tree):
        lm = convert.params_from_numpy(jax.tree.map(np.asarray, tree),
                                       lm_tcfg, device="cpu")
        return ttree.leaves(lm)
    return leaves


@pytest.mark.parametrize("arch,remat,accum", [
    ("internlm2-1.8b", "none", 1), ("internlm2-1.8b", "dots", 1),
    ("internlm2-1.8b", "full", 1), ("internlm2-1.8b", "none", 2),
    ("gemma-7b", "dots", 1), ("granite-moe-1b-a400m", "dots", 1)])
def test_lm_train_step_matches_reference(arch, remat, accum):
    cfg, tcfg = _lm_cfgs(arch, compute_dtype="float32", remat=remat)
    opt_r, opt_t = RA.AdamWConfig(lr=3e-3), adamw.AdamWConfig(lr=3e-3)
    kw = dict(total_steps=50, warmup=1)
    rstep = jax.jit(RS.make_lm_train_step(cfg, opt_r, accum=accum, **kw))
    tstep = TS.make_lm_train_step(tcfg, opt_t, accum=accum, **kw)
    ref = RT.init_params(jax.random.PRNGKey(0), cfg)
    got, want = _carried_step(
        rstep, tstep, ref, RA.init(ref, opt_r),
        lambda tree: convert.params_from_numpy(tree, tcfg, device="cpu"),
        [_lm_batch(cfg.vocab, s, accum) for s in (0, 1)])
    _check_step(got, want, leaves_of=_lm_leaves(tcfg))
    if accum == 1:
        assert "nll" in got[2] and "aux" in got[2]
        _close(got[2]["aux"], want[2]["aux"])
        assert (float(got[2]["aux"]) > 0) == tcfg.is_moe


def test_lm_train_step_bf16_loss_matches_reference():
    cfg, tcfg = _lm_cfgs("internlm2-1.8b", remat="dots")
    assert tcfg.compute_dtype == "bfloat16"
    ref = RT.init_params(jax.random.PRNGKey(0), cfg)
    b = _lm_batch(cfg.vocab, 0)
    want, _ = RT.lm_loss(ref, _j(b), cfg)
    lm = convert.params_from_numpy(jax.tree.map(np.asarray, ref), tcfg,
                                   device="cpu")
    got, _ = TT.lm_loss(lm, _t(b), tcfg)
    assert abs(float(got) - float(want)) <= BF16_LOSS_TOL


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "granite-moe-1b-a400m"])
def test_remat_changes_no_number(arch):
    """Loss and every gradient bit-equal under remat none, dots and full."""
    _, tcfg = _lm_cfgs(arch)
    lm = TT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    b = _t(_lm_batch(tcfg.vocab, 0))
    out = []
    for remat in ("none", "dots", "full"):
        c = dataclasses.replace(tcfg, remat=remat)
        leaves = ttree.leaves(lm)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = TT.lm_loss(lm, b, c)
        out.append([loss.detach()] + list(torch.autograd.grad(loss, leaves)))
    for other in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], other))


@pytest.mark.parametrize("arch", ["din", "sasrec", "bert4rec", "mind"])
def test_recsys_train_step_matches_reference(arch):
    cfg = ref_get_config(arch).smoke_config()
    tcfg = tbase.get_config(arch).smoke_config()
    opt_r = RA.AdamWConfig(lr=1e-3, weight_decay=0.0)
    opt_t = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    kw = dict(total_steps=50, warmup=1)
    rstep = jax.jit(RS.make_recsys_train_step(cfg, opt_r, **kw))
    tstep = TS.make_recsys_train_step(tcfg, opt_t, **kw)
    ref = RR.INIT[arch](jax.random.PRNGKey(0), cfg)
    mk = {"din": RRD.din_batch, "sasrec": RRD.seq_batch,
          "bert4rec": RRD.bert4rec_batch, "mind": RRD.mind_batch}[arch]
    rng = np.random.default_rng(3)
    got, want = _carried_step(
        rstep, tstep, ref, RA.init(ref, opt_r),
        lambda tree: convert.recsys_params_from_numpy(tree, tcfg, "cpu"),
        [mk(rng, cfg, 16) for _ in range(2)])
    _check_step(got, want)
    if arch == "din":
        _close(got[2]["logit_mean"], want[2]["logit_mean"])


def test_opt_state_from_numpy_refuses_wrong_shapes():
    cfg = tbase.get_config("mind").smoke_config()
    p = TR.INIT["mind"](torch.Generator().manual_seed(0), cfg, device="cpu")
    state = {"mu": {k: v.numpy() for k, v in p.items()},
             "nu": {k: v.numpy() for k, v in p.items()}, "step": 3}
    o = convert.opt_state_from_numpy(state, p, device="cpu")
    assert int(o["step"]) == 3 and len(o["mu"]) == len(ttree.leaves(p))
    state["nu"] = dict(state["nu"], w_caps=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        convert.opt_state_from_numpy(state, p, device="cpu")


# ---------------------------------------------------------------------------
# the fault-tolerant trainer (tests/test_trainer_ft.py's cases)
# ---------------------------------------------------------------------------

CFG = TT.LMConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv=2,
                  d_ff=64, vocab=64, remat="none")
OPT = adamw.AdamWConfig(lr=3e-3)


def _data_iter(seed=0):
    stream = TokenStream(CFG.vocab, seed=seed)
    while True:
        yield _t(stream.batch(4, 16))


def _fresh():
    p = TT.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    return p, adamw.init(p, OPT)


def _state(tr):
    return [t.detach().clone() for t in
            ttree.leaves({"p": tr.params, "o": tr.opt_state})]


def test_loss_decreases_and_resume_is_bitwise(tmp_path):
    step = TS.make_lm_train_step(CFG, OPT, total_steps=40, warmup=4)
    p, o = _fresh()
    tr = Trainer(step, p, o, _data_iter(), TrainerConfig(
        total_steps=40, ckpt_every=20, ckpt_dir=str(tmp_path / "a")))
    res = tr.run()
    assert res["history"][-1] < res["history"][0]
    final_a = _state(tr)

    p, o = _fresh()
    tr1 = Trainer(step, p, o, _data_iter(), TrainerConfig(
        total_steps=20, ckpt_every=20, ckpt_dir=str(tmp_path / "b")))
    tr1.run()
    tr1.mgr.wait()
    it = _data_iter()
    for _ in range(20):      # advance data to the checkpoint boundary
        next(it)
    p, o = _fresh()
    tr2 = Trainer(step, p, o, it, TrainerConfig(
        total_steps=40, ckpt_every=20, ckpt_dir=str(tmp_path / "b")))
    start = tr2.try_restore()
    assert start == 20
    tr2.run(start_step=start)
    final_b = _state(tr2)
    assert len(final_a) == len(final_b)
    assert all(torch.equal(a, b) for a, b in zip(final_a, final_b)), \
        "resume must be bitwise identical"


def test_generator_state_resumes_with_the_step(tmp_path):
    """A sampling step's generator is checkpointed: after a restore it
    draws what the uninterrupted run's draws next."""
    def step(params, opt, batch, generator):
        params["w"].add_(torch.rand(3, generator=generator))
        return params, opt, {"loss": params["w"].sum()}

    def run(total, ckpt_dir, start_from=None):
        tr = Trainer(step, {"w": torch.zeros(3)}, {}, iter(lambda: {}, 1),
                     TrainerConfig(total_steps=total, ckpt_every=5,
                                   ckpt_dir=ckpt_dir),
                     generator=torch.Generator().manual_seed(4))
        start = tr.try_restore() if start_from else 0
        tr.run(start)
        return tr.params["w"]

    whole = run(10, str(tmp_path / "a"))
    run(5, str(tmp_path / "b"))
    assert torch.equal(run(10, str(tmp_path / "b"), start_from=True), whole)


def test_corrupt_checkpoint_skipped(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    tree = {"w": torch.arange(8, dtype=torch.float32)}
    mgr.save(10, tree)
    mgr.save(20, {"w": tree["w"] * 2})
    bad = os.path.join(str(tmp_path), "ckpt_00000020", "arr_00000.npy")
    with open(bad, "wb") as fh:
        fh.write(b"corrupt")
    restored, step = mgr.restore(tree)
    assert step == 10
    assert np.array_equal(restored["w"].numpy(), np.arange(8))


def test_checkpoint_layout_is_the_reference_s(tmp_path):
    """The same tree saved by both managers: the same directories, files,
    arrays and manifest; each manager restores the other's."""
    tree = {"b": np.arange(3, dtype=np.int32),
            "a": [np.ones((2, 2), np.float32), np.float32(2.5)]}
    RefManager(str(tmp_path / "r")).save(7, jax.tree.map(jnp.asarray, tree))
    CheckpointManager(str(tmp_path / "t")).save(
        7, jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree))
    for d in ("r", "t"):
        assert sorted(os.listdir(tmp_path / d)) == ["ckpt_00000007"]
    r, t = tmp_path / "r" / "ckpt_00000007", tmp_path / "t" / "ckpt_00000007"
    assert sorted(os.listdir(r)) == sorted(os.listdir(t))
    for name in os.listdir(r):
        if name.endswith(".npy"):
            a, b = np.load(r / name), np.load(t / name)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert json.loads((r / "manifest.json").read_text()) == \
        json.loads((t / "manifest.json").read_text())
    template = jax.tree.map(lambda a: torch.zeros(np.shape(a)), tree)
    got, step = CheckpointManager(str(tmp_path / "r")).restore(template)
    assert step == 7 and torch.equal(got["a"][0], torch.ones(2, 2))
    back, _ = RefManager(str(tmp_path / "t")).restore(tree)
    assert np.array_equal(back["b"], tree["b"])


def test_atomic_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"w": torch.zeros(128), "h": torch.ones(4, dtype=torch.bfloat16)}
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree)
    mgr.wait()
    names = sorted(os.listdir(str(tmp_path)))
    assert all(n.startswith("ckpt_") for n in names)
    assert len(mgr.all_steps()) == 2          # retention
    got, _ = mgr.restore({"w": torch.ones(128),
                          "h": torch.zeros(4, dtype=torch.bfloat16)})
    assert torch.equal(got["h"], tree["h"]) and not got["w"].any()


def test_straggler_stall_fallback(tmp_path):
    """A stalling data pipeline must not block training (reuse last batch)."""
    def slow_iter():
        yield {"tokens": torch.zeros((4, 16), dtype=torch.int32),
               "labels": torch.zeros((4, 16), dtype=torch.int32)}
        time.sleep(60)        # producer wedges
        yield None

    step = TS.make_lm_train_step(CFG, OPT)
    p, o = _fresh()
    tr = Trainer(step, p, o, slow_iter(), TrainerConfig(
        total_steps=3, ckpt_every=100, ckpt_dir=str(tmp_path),
        stall_timeout_s=0.5))
    res = tr.run()
    assert res["step"] == 3
    assert res["stalls"] >= 1


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_grad_compress_wire_lossless(rng):
    g = rng.normal(size=20000).astype(np.float32)
    g[[5, 9]] = 10.0                           # a tie: the lower index first
    res = np.zeros_like(g)
    idx, vals, new_res = gc.sparsify(torch.from_numpy(g),
                                     torch.from_numpy(res), 512)
    r_idx, r_vals, r_res = RGC.sparsify(jnp.asarray(g), jnp.asarray(res), 512)
    assert np.array_equal(idx.numpy(), np.asarray(r_idx))
    assert np.array_equal(vals.numpy(), np.asarray(r_vals))
    assert np.array_equal(new_res.numpy(), np.asarray(r_res))
    packed, vals16 = gc.encode_wire(idx, vals)
    r_packed, r_vals16 = RGC.encode_wire(np.asarray(r_idx), np.asarray(r_vals))
    idx2, vals2 = gc.decode_wire(packed, vals16)
    assert np.array_equal(idx2.numpy(), idx.numpy())     # indices lossless
    assert np.array_equal(vals2.numpy(), np.asarray(r_vals16, np.float32))
    assert np.allclose(vals2.numpy(), vals.numpy(), rtol=8e-3, atol=1e-4)
    assert gc.wire_bits_per_coord(packed) == \
        RGC.wire_bits_per_coord(r_packed)
    assert gc.compress_ratio(g.size, 512, packed) == \
        RGC.compress_ratio(g.size, 512, r_packed) > 10
    dense = gc.apply_sparse(torch.from_numpy(g), idx, vals)
    assert np.allclose(dense.numpy() + new_res.numpy(), g, atol=1e-6)


def test_grad_compress_preserves_convergence():
    """Toy quadratic: top-k + error feedback still converges."""
    w_true = torch.linspace(-1, 1, 64)
    w = torch.zeros(64)
    res = torch.zeros(64)
    for _ in range(300):
        g = w - w_true
        idx, vals, res = gc.sparsify(0.2 * g, res, 8)
        w = w - gc.apply_sparse(g, idx, vals)
    assert float(torch.max(torch.abs(w - w_true))) < 0.05


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["graphsage-reddit", "internlm2-1.8b",
                                  "din"])
def test_launcher_trains_and_resumes_on_the_cpu(arch, tmp_path, capsys):
    flags = ["--arch", arch, "--device", "cpu", "--steps", "20",
             "--ckpt-every", "10", "--ckpt-dir", str(tmp_path)]
    res = tlaunch.main(flags)
    assert f"[train] {arch}: " in capsys.readouterr().out
    assert res["step"] == 20 and len(res["history"]) == 2
    assert np.isfinite(res["history"]).all()
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000010", "ckpt_00000020"]
    again = tlaunch.main(flags + ["--steps", "30"])
    assert again["step"] == 30 and len(again["history"]) == 1


def test_launcher_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--arch", "din", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])
