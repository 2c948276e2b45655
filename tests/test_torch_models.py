"""The port's LM serving path, dense and MoE (configs, layers, prefill,
decode_step, greedy_generate, serve --arch), against the reference on the
CPU.

Weights come from the reference's ``init_params`` and are carried across
with ``params_from_numpy``; tokens and layer inputs come from a numpy seed.
Each (arch, S, dtype) reference run is computed once per module, with the
reference's prefill and decode_step under ``jax.jit`` (each compiles once
per shape; unjitted, every call compiles its scan again) in the loop of its
``greedy_generate``, which one test holds against that function itself.

Tolerances:
- float32: 1e-4 (rtol and atol) on logits and caches, the sums taken in
  another order by XLA and by torch; greedy tokens equal.
- bf16: bf16 keeps 8 significant bits, so one rounding moves a value by up
  to 2**-8 of itself.  XLA rounds every elementwise op of GELU/SiLU and
  RoPE to bf16 where torch rounds once, and each framework sums the
  products in its own order before rounding, so values differ by an ulp
  or two, and the differences pass through two layers.  Logits must agree
  within 0.03 of the largest reference logit (about four ulps of it), the
  caches and each layers function within 2**-5 relative plus 2**-5
  absolute (four ulps).  Tokens
  are compared only where the reference's top-two margin exceeds the
  logits' tolerance (and every earlier token of the row agreed).
- bf16 prefill of the MoE archs: the router ranks float32 logits of
  layer inputs that differ between the packages by an ulp or two, so a
  token whose k-th and (k+1)-th logits are closer than that gap is routed
  to other experts by each (and may push another token of a full expert
  past capacity); from that layer on its rows differ by O(1), a fault of
  neither.  Both packages' layer inputs are recorded, and each is routed
  by the port's ``moe`` functions (equal to the reference's on equal
  inputs, tests/test_torch_moe.py).  A token routed apart must first be
  so at a near tie (its reference logit margin at most twice the largest
  logit difference the two inputs give) or, with equal experts, by
  capacity at a layer where a near tie moved another token.  Such tokens
  (at most 5 % of them) are left out of the cache comparison, and of the
  logits where one is a row's last; the rest are held to the tolerances
  above.
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
from repro.launch import serve as ref_serve
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import transformer as RT
from repro.serve import steps as RS
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import steps as TS

pytestmark = pytest.mark.torch_port

LM_ARCHS = ["gemma-7b", "phi3-medium-14b", "internlm2-1.8b",
            "granite-moe-1b-a400m", "kimi-k2-1t-a32b"]
RECSYS_ARCHS = ["din", "sasrec", "bert4rec", "mind"]
NOT_PORTED = ["graphsage-reddit"]
N_NEW = 4
F32_TOL = 1e-4
BF16_LOGIT_TOL = 0.03
BF16_TOL = 2.0 ** -5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _configs(arch: str, dtype: str):
    ref = dataclasses.replace(ref_get_config(arch).smoke_config(),
                              compute_dtype=dtype)
    port = dataclasses.replace(tbase.get_config(arch).smoke_config(),
                               compute_dtype=dtype)
    return ref, port


REF_PREFILL = jax.jit(RT.prefill, static_argnums=2)
REF_DECODE = jax.jit(RT.decode_step, static_argnums=4)


def _ref_generate_with_logits(params, cfg, prompt, max_new, cache_len):
    """The loop of the reference's greedy_generate (serve/steps.py) with
    every step's logits and the cache after the first decode step kept."""
    B, S = prompt.shape
    logits, pre = REF_PREFILL(params, prompt, cfg)
    cache = RT.init_kv_cache(cfg, B, cache_len)
    cache = {k: cache[k].at[:, :, :S].set(pre[k]) for k in ("k", "v")}
    start = cache
    out, steps = [jnp.argmax(logits, -1).astype(jnp.int32)], [logits]
    for i in range(max_new - 1):
        logits, cache = REF_DECODE(params, cache, out[-1], jnp.int32(S + i),
                                   cfg)
        first = cache if i == 0 else first
        out.append(jnp.argmax(logits, -1).astype(jnp.int32))
        steps.append(logits)
    return SimpleNamespace(
        logits=np.asarray(steps[0]), pre={k: _np(pre[k]) for k in pre},
        kv={k: np.array(start[k].astype(jnp.float32)) for k in start},
        next=np.array(out[0]), dlogits=np.asarray(steps[1]),
        dcache={k: _np(first[k]) for k in first},
        gen=np.stack([np.asarray(t) for t in out], 1),
        gen_logits=np.stack([np.asarray(l) for l in steps], 1))


@pytest.fixture(scope="module")
def lm_runs():
    """(arch, S, dtype) → the reference's prefill (logits, cache), its
    first decode step (from the prefill's cache: logits, updated cache) and
    its greedy generation (tokens, every step's logits), with the numpy
    weights and tokens they ran on."""
    cache = {}

    def get(arch, S, dtype):
        key = (arch, S, dtype)
        if key not in cache:
            rcfg, tcfg = _configs(arch, dtype)
            params = RT.init_params(jax.random.PRNGKey(0), rcfg)
            tokens = np.random.default_rng(S).integers(
                0, rcfg.vocab, (2, S)).astype(np.int32)
            run = _ref_generate_with_logits(params, rcfg, jnp.asarray(tokens),
                                            N_NEW, S + N_NEW)
            run.__dict__.update(
                rcfg=rcfg, tcfg=tcfg, tokens=tokens, params=params,
                tree=jax.tree_util.tree_map(np.asarray, params))
            cache[key] = run
        return cache[key]
    return get


def _port_params(run):
    return convert.params_from_numpy(run.tree, run.tcfg, device="cpu")


def _assert_logits(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=F32_TOL, atol=F32_TOL)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=0,
                                   atol=BF16_LOGIT_TOL * np.abs(want).max())


def _assert_cache(got, want, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=tol)


CASES = [(a, S, d) for a in LM_ARCHS for S in (32, 512)
         for d in ("float32", "bfloat16")]


def _moe_inputs(fn, module, *args) -> list:
    """Run ``fn(*args)`` with ``module.moe_ffn`` wrapped to record each MoE
    layer's input, in layer order, as float32 numpy arrays."""
    got, inner = [], module.moe_ffn

    def record(p, h, **kw):
        if module is RM:
            jax.debug.callback(lambda a: got.append(np.asarray(
                a, np.float32)), h, ordered=True)
        else:
            got.append(_np(h))
        return inner(p, h, **kw)
    module.moe_ffn = record
    try:
        jax.block_until_ready(fn(*args)) if module is RM else fn(*args)
    finally:
        module.moe_ffn = inner
    return got


def _routing(router, h, cfg):
    """(expert ids (N, k) in ascending order, whether each of those slots
    is kept (N, k), router logits (N, E)) of one MoE layer on its input
    ``h``; the order of a token's k experts changes only the order of its
    sum, so it is not compared."""
    hf = torch.from_numpy(h.reshape(-1, cfg.d_model)).to(
        TT._dtype(cfg.compute_dtype))
    _, ids, _ = TM._route(router, hf, cfg.top_k, cfg.n_experts)
    order = torch.argsort(ids.reshape(-1), stable=True)
    pos, _ = TM._group_positions(ids.reshape(-1)[order], cfg.n_experts)
    pos_flat = torch.empty_like(pos)
    pos_flat[order] = pos
    C = TM.capacity(hf.shape[0], cfg.top_k, cfg.n_experts,
                    cfg.capacity_factor)
    ids, perm = ids.sort(1)
    kept = (pos_flat < C).reshape(ids.shape).gather(1, perm)
    return ids, kept, hf.float() @ router


def _routed_apart(run, lm, port_h) -> np.ndarray:
    """(B, S) mask of the tokens the two packages route apart at some
    layer, each checked to start at a near tie (see the module
    docstring)."""
    # a function of its own, so jit traces it afresh with the recorder
    ref_h = _moe_inputs(jax.jit(lambda p, t: RT.prefill(p, t, run.rcfg)),
                        RM, run.params, jnp.asarray(run.tokens))
    assert len(ref_h) == len(port_h) == run.tcfg.n_layers
    apart = np.zeros(run.tokens.size, bool)
    for layer, rh, ph in zip(lm.layers, ref_h, port_h):
        (ri, rk, rl), (pi, pk, pl) = (_routing(layer.moe.router, h, run.tcfg)
                                      for h in (rh, ph))
        flip = (ri != pi).any(1).numpy() & ~apart
        top = torch.sort(rl, -1, descending=True).values
        margin = (top[:, run.tcfg.top_k - 1] - top[:, run.tcfg.top_k]).numpy()
        gap = (rl - pl).abs().amax(-1).numpy()
        assert (margin[flip] <= 2 * gap[flip]).all(), "a flip at no near tie"
        moved = (rk != pk).any(1).numpy() & ~apart & ~flip
        assert not moved.any() or flip.any(), "capacity moved without a flip"
        apart |= flip | moved
    assert apart.mean() <= 0.05, f"{apart.sum()} tokens routed apart"
    return apart.reshape(run.tokens.shape)


@pytest.mark.parametrize("arch,S,dtype", CASES)
def test_prefill_matches_reference(lm_runs, arch, S, dtype):
    """Last-token logits and the whole K/V cache; S = 512 is above the
    reduced full_attn_max_seq (256), so attention_chunked runs.  In bf16 an
    MoE arch's tokens routed apart at a near tie are left out."""
    run = lm_runs(arch, S, dtype)
    lm = _port_params(run)
    port_h = _moe_inputs(TT.prefill, TM, lm, torch.from_numpy(run.tokens),
                         run.tcfg) if run.tcfg.is_moe else []
    logits, cache = TT.prefill(lm, torch.from_numpy(run.tokens), run.tcfg)
    assert logits.dtype == torch.float32
    assert cache["k"].dtype == TT._dtype(dtype)
    same = np.ones(run.tokens.shape, bool)
    if dtype == "bfloat16" and run.tcfg.is_moe:
        same = ~_routed_apart(run, lm, port_h)
    rows = same[:, -1]
    _assert_logits(logits[rows], run.logits[rows], dtype)
    for k in ("k", "v"):
        assert tuple(cache[k].shape) == run.pre[k].shape
        _assert_cache(cache[k][:, same], run.pre[k][:, same], dtype)


@pytest.mark.parametrize("arch,S,dtype", CASES)
def test_decode_step_matches_reference(lm_runs, arch, S, dtype):
    """One step from the reference's own prefill cache: logits, and the
    cache with the new K/V written at pos."""
    run = lm_runs(arch, S, dtype)
    cdt = TT._dtype(dtype)
    cache = {k: torch.from_numpy(run.kv[k]).to(cdt) for k in ("k", "v")}
    logits, cache = TT.decode_step(_port_params(run), cache,
                                   torch.from_numpy(run.next), S, run.tcfg)
    _assert_logits(logits, run.dlogits, dtype)
    for k in ("k", "v"):
        _assert_cache(cache[k], run.dcache[k], dtype)


def test_reference_loop_is_its_greedy_generate(lm_runs):
    """The fixture's loop (jitted steps) gives the tokens of the
    reference's greedy_generate itself."""
    run = lm_runs("internlm2-1.8b", 32, "float32")
    want = RS.greedy_generate(run.params, run.rcfg, jnp.asarray(run.tokens),
                              N_NEW, 32 + N_NEW)
    assert np.array_equal(run.gen, np.asarray(want))


@pytest.mark.parametrize("arch,S,dtype", CASES)
def test_greedy_generate_matches_reference(lm_runs, arch, S, dtype):
    run = lm_runs(arch, S, dtype)
    got = TS.greedy_generate(_port_params(run), run.tcfg,
                             torch.from_numpy(run.tokens), N_NEW,
                             S + N_NEW).numpy()
    assert got.dtype == np.int32 and got.shape == run.gen.shape
    if dtype == "float32":
        assert np.array_equal(got, run.gen)
        return
    top2 = np.sort(run.gen_logits, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    tol = BF16_LOGIT_TOL * np.abs(run.gen_logits).max()
    compared = 0
    for b in range(got.shape[0]):
        for i in range(N_NEW):
            if margin[b, i] <= tol:
                break
            assert got[b, i] == run.gen[b, i], (b, i)
            compared += 1
    assert compared > 0


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _rand(rng, shape, dtype="float32"):
    a = rng.standard_normal(shape, dtype=np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(TT._dtype(dtype))


def _layer_case(name, dtype, rng):
    """(reference output, port output) of one layers function on shared
    numpy inputs."""
    B, S, H, Hkv, D = 2, 48, 4, 2, 16
    if name == "rms_norm":
        (rx, tx), (rw, tw) = _rand(rng, (B, S, 64), dtype), _rand(rng, (64,))
        return RL.rms_norm(rx, rw), TL.rms_norm(tx, tw)
    if name.startswith("rope"):
        theta = 1e6 if name == "rope_1e6" else 1e4
        pos = rng.integers(0, 5000, (B, S)).astype(np.int32)
        rc, rs = RL.rope_angles(jnp.asarray(pos), D, theta)
        tc, ts = TL.rope_angles(torch.from_numpy(pos), D, theta)
        rx, tx = _rand(rng, (B, S, H, D), dtype)
        return (jnp.stack([rc, rs]), RL.apply_rope(rx, rc, rs)), \
            (torch.stack([tc, ts]), TL.apply_rope(tx, tc, ts))
    (rq, tq), (rk, tk), (rv, tv) = (_rand(rng, s, dtype) for s in (
        (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    if name == "attention_full":
        return RL.attention_full(rq, rk, rv), TL.attention_full(tq, tk, tv)
    if name == "attention_full_offset_bf16_scores":
        return (RL.attention_full(rq, rk, rv, q_offset=5,
                                  scores_dtype=jnp.bfloat16),
                TL.attention_full(tq, tk, tv, q_offset=5,
                                  scores_dtype=torch.bfloat16))
    if name == "attention_chunked":
        return (RL.attention_chunked(rq, rk, rv, chunk=16),
                TL.attention_chunked(tq, tk, tv, chunk=16))
    if name == "attention_decode":
        return (RL.attention_decode(rq[:, :1], rk, rv, 30),
                TL.attention_decode(tq[:, :1], tk, tv, 30))
    act = name.split("_")[1]
    (rx, tx) = _rand(rng, (B, S, 64), dtype)
    ws = [_rand(rng, s) for s in ((64, 128), (64, 128), (128, 64))]
    return (RL.glu_mlp(rx, *(w[0] / 8 for w in ws), act),
            TL.glu_mlp(tx, *(w[1] / 8 for w in ws), act))


LAYER_FUNCS = ["rms_norm", "rope_1e4", "rope_1e6", "attention_full",
               "attention_full_offset_bf16_scores", "attention_chunked",
               "attention_decode", "glu_geglu", "glu_swiglu"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", LAYER_FUNCS)
def test_layers_match_reference(name, dtype):
    """Each layers function on the same inputs: float32 within 1e-5, bf16
    within four ulps (2**-5 relative, plus 2**-5 absolute)."""
    ref, got = _layer_case(name, dtype, np.random.default_rng(
        LAYER_FUNCS.index(name)))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    for r, g in zip(ref, got):
        assert str(g.dtype).split(".")[-1] == str(r.dtype)
        np.testing.assert_allclose(_np(g), np.asarray(r, np.float32),
                                   rtol=tol, atol=tol)


# --------------------------------------------------------------------------
# configs, registry, serve
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_config_matches_reference(arch):
    """Field for field, with the same source, shapes and parameter counts;
    nothing is allocated."""
    ref, port = ref_get_config(arch), tbase.get_config(arch)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert (port.arch_id, port.family, port.source, port.shapes) == \
        (ref.arch_id, ref.family, ref.source, ref.shapes)
    assert port.config.param_count() == ref.config.param_count()
    assert port.config.active_param_count() == \
        ref.config.active_param_count()
    assert port.config.hd == ref.config.hd
    assert dataclasses.asdict(port.smoke_config()) == \
        dataclasses.asdict(ref.smoke_config())


def test_registry_lists_the_ported_archs():
    assert tbase.all_arch_ids() == sorted(LM_ARCHS + RECSYS_ARCHS
                                          + ["paper-index"])
    with pytest.raises(KeyError):
        tbase.get_config("no-such-arch")


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_archs_raise(arch):
    ref_get_config(arch)                 # the reference has it
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tbase.get_config(arch)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tserve.main(["--arch", arch, "--device", "cpu"])


def test_params_from_numpy_refuses_wrong_shapes(lm_runs):
    run = lm_runs("internlm2-1.8b", 32, "float32")
    tree = dict(run.tree, embed=run.tree["embed"][:, :8])
    with pytest.raises(ValueError):
        convert.params_from_numpy(tree, run.tcfg, device="cpu")


def test_init_params_scales_and_device():
    """The reference's scales (std 1/sqrt(d_model) for the projections, 1
    for the embedding), zero norms, and the card as default device."""
    cfg = tbase.get_config("phi3-medium-14b").smoke_config()
    lm = TT.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert float(lm.embed.std()) == pytest.approx(1.0, rel=0.05)
    assert float(lm.layers[0].wq.std()) == pytest.approx(
        1 / np.sqrt(cfg.d_model), rel=0.1)
    assert float(lm.lm_head.std()) == pytest.approx(1 / np.sqrt(cfg.d_model),
                                                    rel=0.05)
    assert not lm.layers[1].ln2.any() and not lm.final_norm.any()
    assert lm.embed.dtype == torch.float32 and lm.embed.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TT.init_params(torch.Generator().manual_seed(0), cfg)


LINE = re.compile(r"^\[serve\] internlm2-1\.8b: batch=4 generated 4 tokens in "
                  r"\d+\.\d\ds \(\d+\.\d tok/s\); sample: \[\d+(, \d+){3}\]$")


def test_serve_lm_prints_the_reference_line():
    buf = io.StringIO()
    with redirect_stdout(buf):
        ref_serve.serve_lm(SimpleNamespace(batch=0, tokens=4),
                           ref_get_config("internlm2-1.8b"))
        rep = tserve.main(["--arch", "internlm2-1.8b", "--device", "cpu",
                           "--tokens", "4"])
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 2 and all(LINE.match(l) for l in lines), lines
    assert tuple(rep["tokens"].shape) == (4, 4)
