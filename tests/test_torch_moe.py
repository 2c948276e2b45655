"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``moe_ffn_local`` and ``_route`` on the CPU.

Weights are numpy draws at the scales, shapes and dtypes of the reference's
``init_moe_params``, and tokens come from a numpy seed; both packages get
the same values.  Cases: E=8/top-2,
E=32/top-8 and E=384/top-8 at d=32, F=16 (with 64 tokens E=384 runs at
C=1 and C=2, kimi's regime), capacity factors 0.5, 1.25 and E/top_k (no
slot dropped), swiglu and geglu, float32 and bf16; and a batch of identical
tokens, where only a stable sort by expert keeps the reference's first C
tokens of each expert.

Tolerances:
- float32: outputs within 1e-5 (rtol and atol; the expert GEMMs and the
  combine sum in another order), expert ids equal, top-k weights and
  probabilities within 1e-6, the aux term within 1e-6.
- bf16: outputs within 2**-5 relative plus 2**-5 absolute (four bf16
  ulps, as tests/test_torch_models.py), since XLA rounds each elementwise
  op of the GLU to bf16 and the combine adds in bf16 one slot at a time
  where torch accumulates the k slots in float32; expert ids equal (the
  router runs in float32 on the same bf16 inputs).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.models import moe as RM
from repro_torch.models import moe as TM

pytestmark = pytest.mark.torch_port

D, F = 32, 16
B, S = 4, 16                      # 64 tokens
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


_PARAMS = {}


def _params(E: int, dtype: str, seed: int = 0):
    """The reference's params and the port's ``MoE`` holding the same
    values, made once per module for each (E, dtype, seed): numpy normal
    draws in the tree, shapes and dtypes of the reference's
    ``init_moe_params`` (read by ``jax.eval_shape``), at its scales."""
    key = (E, dtype, seed)
    if key not in _PARAMS:
        jdt, tdt = DTYPES[dtype]
        layout = jax.eval_shape(
            lambda k: RM.init_moe_params(k, D, F, E, dtype=jdt),
            jax.random.PRNGKey(0))
        scale = {"router": D, "w_in": D, "w_gate": D, "w_out": F}
        rng = np.random.default_rng(seed)
        ref, port = {}, TM.MoE(D, F, E, tdt, device="cpu")
        for name, sd in layout.items():
            a = rng.standard_normal(sd.shape, dtype=np.float32) \
                / np.float32(np.sqrt(scale[name]))
            ref[name] = jnp.asarray(a, sd.dtype)
            with torch.no_grad():
                getattr(port, name).copy_(torch.from_numpy(
                    np.array(_np(ref[name]))))
        _PARAMS[key] = ref, port
    return _PARAMS[key]


def _x(dtype: str, seed: int = 1, identical: bool = False):
    a = np.random.default_rng(seed).standard_normal((B, S, D),
                                                    dtype=np.float32)
    if identical:
        a[:] = a[0, 0]
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


EXPERTS = [(8, 2), (32, 8), (384, 8)]
FACTORS = ["0.5", "1.25", "no-drop"]


def _factor(name: str, E: int, top_k: int) -> float:
    return E / top_k if name == "no-drop" else float(name)


# jitted: one compile per case instead of one per op and shape
REF_MOE = jax.jit(RM.moe_ffn_local,
                  static_argnames=("top_k", "capacity_factor", "act"))
ACTS = ["swiglu", "geglu"]
_REF_OUT = {}


def _ref_out(E: int, top_k: int, dtype: str):
    """The reference's (out, aux) for every (factor, act) on ``_params(E,
    dtype)`` and ``_x(dtype)``, from one jitted program (one compile for the
    six cases)."""
    if (E, dtype) not in _REF_OUT:
        def every_case(p, x):
            return {(f, a): RM.moe_ffn_local(
                p, x, top_k=top_k, capacity_factor=_factor(f, E, top_k),
                act=a) for f in FACTORS for a in ACTS}
        _REF_OUT[E, dtype] = jax.jit(every_case)(_params(E, dtype)[0],
                                                 _x(dtype)[0])
    return _REF_OUT[E, dtype]


def _assert_out(got, want, dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("E,top_k", EXPERTS)
def test_moe_ffn_local_matches_reference(E, top_k, factor, act, dtype):
    port_p = _params(E, dtype)[1]
    tx = _x(dtype)[1]
    cf = _factor(factor, E, top_k)
    want, want_aux = _ref_out(E, top_k, dtype)[factor, act]
    got, aux = TM.moe_ffn_local(port_p, tx, top_k=top_k,
                                capacity_factor=cf, act=act)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (B, S, D)
    _assert_out(got, want, dtype)
    assert float(aux) == pytest.approx(float(want_aux), abs=1e-6)
    # the dispatcher is the local path on one device
    again, _ = TM.moe_ffn(port_p, tx, top_k=top_k, capacity_factor=cf,
                          act=act)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,top_k", EXPERTS)
def test_route_matches_reference(E, top_k, dtype):
    ref_p, port_p = _params(E, dtype)
    rx, tx = _x(dtype, seed=2)
    rw, ri, rp = RM._route(ref_p["router"], rx.reshape(-1, D), top_k, E)
    tw, ti, tp = TM._route(port_p.router, tx.reshape(-1, D), top_k, E)
    assert np.array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(_np(tw), _np(rw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tp), _np(rp), rtol=1e-6, atol=1e-6)
    rd, rdp = RM._aux_loss(ri, rp, E)
    td, tdp = TM._aux_loss(ti, tp, E)
    np.testing.assert_allclose(_np(td), _np(rd), atol=1e-6)
    np.testing.assert_allclose(_np(tdp), _np(rdp), atol=1e-6)


def test_top_k_keeps_the_lower_id_among_ties():
    """Equal probabilities: the lower expert id first, as lax.top_k."""
    router = np.zeros((D, 8), np.float32)
    router[:, 5] = 1.0
    x = np.ones((3, D), np.float32)
    rw, ri, _ = RM._route(jnp.asarray(router), jnp.asarray(x), 3, 8)
    tw, ti, _ = TM._route(torch.from_numpy(router), torch.from_numpy(x), 3, 8)
    assert ti.tolist() == np.asarray(ri).tolist() == [[5, 0, 1]] * 3
    np.testing.assert_allclose(tw.numpy(), np.asarray(rw), atol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,top_k", [(8, 2), (32, 8)])
def test_identical_tokens_keep_the_first_c(E, top_k, dtype):
    """Every token routes alike, so each chosen expert gets all 64 and
    keeps the first C: the rows past C get nothing, as in the reference."""
    ref_p, port_p = _params(E, dtype, seed=3)
    rx, tx = _x(dtype, seed=4, identical=True)
    want, _ = REF_MOE(ref_p, rx, top_k=top_k, capacity_factor=1.25)
    got, _ = TM.moe_ffn_local(port_p, tx, top_k=top_k, capacity_factor=1.25)
    _assert_out(got, want, dtype)
    C = TM.capacity(B * S, top_k, E, 1.25)
    rows = _np(got).reshape(B * S, D)
    assert 0 < C < B * S
    assert np.abs(rows[:C]).min(axis=1).max() > 0 and not rows[C:].any()


@pytest.mark.parametrize("N,top_k,E,cf", [(64, 8, 384, 1.25),
                                          (64, 8, 384, 0.5), (4, 8, 384, 1.25),
                                          (4096, 8, 384, 1.25),
                                          (4096, 8, 32, 4.0), (7, 2, 8, 0.3)])
def test_capacity_is_the_reference_expression(N, top_k, E, cf):
    assert TM.capacity(N, top_k, E, cf) == max(
        int(np.ceil(N * top_k / E * cf)), 1)


def test_group_positions_match_reference():
    ids = np.sort(np.random.default_rng(5).integers(0, 9, 200)).astype(
        np.int32)
    rp, rg = RM._group_positions(jnp.asarray(ids), 9)
    tp, tg = TM._group_positions(torch.from_numpy(ids).long(), 9)
    assert np.array_equal(tp.numpy(), np.asarray(rp))
    assert np.array_equal(tg.numpy(), np.asarray(rg))


def test_init_moe_params_shapes_scales_dtypes():
    g = torch.Generator().manual_seed(0)
    m = TM.init_moe_params(g, 64, 128, 16, dtype=torch.bfloat16,
                           device="cpu")
    assert m.router.dtype == torch.float32
    assert m.w_in.dtype == m.w_gate.dtype == m.w_out.dtype == torch.bfloat16
    assert tuple(m.w_in.shape) == tuple(m.w_gate.shape) == (16, 64, 128)
    assert tuple(m.w_out.shape) == (16, 128, 64)
    assert float(m.router.std()) == pytest.approx(1 / 8, rel=0.1)
    assert float(m.w_in.float().std()) == pytest.approx(1 / 8, rel=0.05)
    assert float(m.w_out.float().std()) == pytest.approx(
        1 / np.sqrt(128), rel=0.05)
    # one expert at a time: no two experts drew the same values
    assert not torch.equal(m.w_in[0], m.w_in[1])
