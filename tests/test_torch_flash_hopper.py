"""K8's Hopper routes (kernels/flash_attention.py: ``tc``, ``split``,
``simt``), on the CPU: the route table, and torch emulations of what the
``tc`` and ``split`` kernels compute, held against the plain version and the
reference Pallas kernel in interpret mode.

- ``tc_walk`` is the tensor-core route's tile walk (csrc/flash_attention_tc.cuh)
  at the kernel's tile sizes: scores in the log2 domain with exp2, the
  finite -1e30 mask, and optionally the skipping of fully masked tiles and
  p rounded to bf16 before P·V (with l summing the rounded p).
- ``split_combine`` is the split-KV route (csrc/flash_decode.cuh): float32
  partial (m, l, acc) per contiguous chunk of keys, then the combine.

Inputs come from a numpy seed; each reference result is computed once per
module.  The kernels themselves are held against the plain version on the
card in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch_port

NEG_INF = -1e30
LOG2E = np.float32(1.4426950408889634)


def _inputs(seed: int, shape, dtype=torch.float32):
    B, Sq, Sk, H, Hkv, D = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _heads(q, k, v):
    """(B, H, S, D) float32 views, KV heads repeated for GQA."""
    n_rep = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).float(),
            k.transpose(1, 2).repeat_interleave(n_rep, 1).float(),
            v.transpose(1, 2).repeat_interleave(n_rep, 1).float())


def _scale(D: int) -> float:
    return float(np.float32(1.0 / np.sqrt(D)))


def tc_walk(q, k, v, *, causal, kv_len, skip, round_p, rescale=True):
    """The tc route's arithmetic, tile by tile at the kernel's tile sizes
    (``TC_TILES``), in float32 → (B, Sq, H, D) float32 (before the output's
    rounding).  ``rescale=False`` is a wrong kernel that leaves l and acc
    unscaled when m grows."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    warps, BK = tfa.TC_TILES[D]
    BQ = 16 * warps
    qt, kt, vt = _heads(q, k, v)
    scale_log2 = float(np.float32(_scale(D)) * LOG2E)
    n_visible = Sk if kv_len is None else min(kv_len, Sk)
    out = torch.empty((B, H, Sq, D))
    for q0 in range(0, Sq, BQ):
        q1 = min(q0 + BQ, Sq)
        end = Sk
        if skip:
            end = min(n_visible, q1) if causal else n_visible
        m = torch.full((B, H, q1 - q0), NEG_INF)
        l = torch.zeros((B, H, q1 - q0))
        acc = torch.zeros((B, H, q1 - q0, D))
        q_pos = torch.arange(q0, q1)[:, None]
        for k0 in range(0, end, BK):
            k1 = min(k0 + BK, Sk)     # keys past Sk: -inf, weight exactly 0
            s = (qt[:, :, q0:q1] @ kt[:, :, k0:k1].transpose(-1, -2)) \
                * scale_log2
            k_pos = torch.arange(k0, k1)[None, :]
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool)
            if causal:
                mask &= q_pos >= k_pos
            if kv_len is not None:
                mask &= k_pos < kv_len
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new) if rescale else torch.ones_like(m)
            p = torch.exp2(s - m_new[..., None])
            if round_p:
                p = p.to(torch.bfloat16).float()
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vt[:, :, k0:k1]
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2)


def split_combine(q, k, v, *, kv_len, chunk, rescale=True, drop=None):
    """The split route's arithmetic in float32: contiguous chunks of
    ``chunk`` keys over all of [0, Sk) (chunks wholly past kv_len carry
    m = -1e30, l = 0, acc = 0), then the combine → (B, Sq, H, D).  Two
    wrong kernels: ``rescale=False`` combines without e^(m_i - M), ``drop``
    leaves out chunk ``drop``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qt, kt, vt = _heads(q, k, v)
    n_visible = Sk if kv_len is None else min(kv_len, Sk)
    parts = []
    for k0 in range(0, Sk, chunk):
        k1 = min(k0 + chunk, n_visible)
        if k1 <= k0:
            parts.append((torch.full((B, H, Sq), NEG_INF),
                          torch.zeros((B, H, Sq)),
                          torch.zeros((B, H, Sq, D))))
            continue
        s = (qt @ kt[:, :, k0:k1].transpose(-1, -2)) * _scale(D)
        m = s.amax(-1)
        p = torch.exp(s - m[..., None])
        parts.append((m, p.sum(-1), p @ vt[:, :, k0:k1]))
    M = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, D))
    for i, (m, li, ai) in enumerate(parts):
        w = torch.exp(m - M) if rescale else torch.ones_like(m)
        if i == drop:
            continue
        l = l + li * w
        acc = acc + ai * w[..., None]
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).transpose(1, 2)


# --------------------------------------------------------------------------
# the route table
# --------------------------------------------------------------------------

def _unaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte line."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


# B, Sq, Sk, H, Hkv, D, dtype, causal, kv_len, route
ROUTE_CASES = [
    (1, 256, 256, 4, 2, 64, torch.float32, True, None, "simt"),
    (1, 256, 256, 4, 2, 80, torch.bfloat16, True, None, "simt"),
    (1, 32, 32, 4, 2, 16, torch.bfloat16, True, None, "simt"),
    (1, 64, 128, 2, 1, 64, torch.bfloat16, False, 0, "simt"),
    (4, 1, 1056, 16, 16, 256, torch.bfloat16, False, 1055, "split"),
    (2, 1, 512, 4, 2, 128, torch.bfloat16, False, 1, "split"),
    (2, 2, 512, 8, 2, 64, torch.bfloat16, False, None, "split"),
    (4, 1, 1024, 40, 10, 128, torch.bfloat16, False, 700, "split"),
    (1, 16, 512, 2, 2, 128, torch.bfloat16, False, None, "tc"),
    (1, 4, 512, 8, 2, 128, torch.bfloat16, False, None, "tc"),
    (1, 1, 512, 2, 2, 128, torch.bfloat16, True, None, "tc"),
    (4, 1024, 1024, 16, 16, 256, torch.bfloat16, True, None, "tc"),
    (4, 1024, 1024, 40, 10, 128, torch.bfloat16, True, None, "tc"),
    (2, 256, 512, 4, 1, 64, torch.bfloat16, False, 450, "tc"),
    (1, 256, 256, 4, 4, 64, torch.bfloat16, True, 200, "tc"),
]


@pytest.mark.parametrize("case", ROUTE_CASES)
def test_route_table(case):
    B, Sq, Sk, H, Hkv, D, dtype, causal, kv_len, route = case
    q = torch.empty((B, Sq, H, D), dtype=dtype)
    k = torch.empty((B, Sk, Hkv, D), dtype=dtype)
    assert tfa._route(q, k, k, causal, kv_len) == route


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_route_unaligned_view_takes_simt(which):
    shapes = {"q": (1, 64, 2, 64), "k": (1, 64, 2, 64), "v": (1, 64, 2, 64)}
    t = {n: torch.zeros(s, dtype=torch.bfloat16) for n, s in shapes.items()}
    assert tfa._route(t["q"], t["k"], t["v"], True, None) == "tc"
    t[which] = _unaligned(shapes[which], torch.bfloat16)
    assert t[which].is_contiguous() and t[which].data_ptr() % 16 != 0
    assert tfa._route(t["q"], t["k"], t["v"], True, None) == "simt"


@pytest.mark.parametrize("B,Hkv,n_visible", [
    (4, 16, 1055), (4, 16, 8192), (2, 2, 1), (1, 1, 63), (1, 1, 64),
    (1, 1, 65), (4, 10, 1000), (64, 32, 4097), (1, 1, 100000)])
def test_split_plan_covers_the_visible_keys(B, Hkv, n_visible):
    n_split, chunk = tfa._split_plan(B, Hkv, n_visible, 132)
    assert n_split >= 1 and chunk >= 1
    # every chunk holds a visible key, and the chunks cover them all
    assert (n_split - 1) * chunk < n_visible <= n_split * chunk
    if n_visible >= tfa.SPLIT_MIN_CHUNK:
        assert chunk >= tfa.SPLIT_MIN_CHUNK
    assert n_split <= -(-tfa.SPLIT_CTAS_PER_SM * 132 // (B * Hkv))


def test_cpu_calls_count_no_route():
    q, k, v = _inputs(1, (1, 64, 64, 2, 2, 64), torch.bfloat16)
    before = ops.flash_routes()
    ops.flash_attention(q, k, v)
    assert ops.flash_routes() == before


# --------------------------------------------------------------------------
# the tc route: skipping masked tiles, and p rounded to bf16
# --------------------------------------------------------------------------

# B, Sq, Sk, H, Hkv, D, causal, kv_len: causal or kv_len >= 1, ragged
# tiles, Sq != Sk both ways, GQA
SKIP_CASES = [
    (2, 256, 256, 4, 2, 64, True, None),
    (1, 200, 200, 2, 1, 128, True, None),
    (2, 96, 160, 4, 2, 64, True, 150),
    (1, 320, 192, 2, 2, 64, True, None),
    (1, 130, 384, 2, 2, 64, True, None),
    (2, 256, 512, 4, 1, 64, False, 450),
    (1, 128, 256, 2, 2, 256, True, 100),
    (2, 64, 300, 2, 1, 64, False, 1),
]


@pytest.mark.parametrize("case", SKIP_CASES)
def test_tc_skipping_masked_tiles_is_bit_exact(case):
    """Wherever every row has a visible key, the walk that skips the fully
    masked tiles equals, bit for bit, the walk that visits them all."""
    causal, kv_len = case[6:]
    q, k, v = _inputs(10, case[:6])
    kw = dict(causal=causal, kv_len=kv_len, round_p=False)
    a = tc_walk(q, k, v, skip=True, **kw)
    b = tc_walk(q, k, v, skip=False, **kw)
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a, tfa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     bq=case[1], bk=case[2]),
        rtol=1e-5, atol=2e-5)


def test_tc_skipping_differs_at_kv_len_zero():
    """kv_len = 0: no row has a visible key; the reference averages V over
    every (masked) key, which only a walk over every tile reproduces — the
    route table sends these calls to simt."""
    q, k, v = _inputs(11, (1, 64, 128, 2, 1, 64))
    kw = dict(causal=False, kv_len=0, round_p=False)
    full = tc_walk(q, k, v, skip=False, **kw)
    mean_v = v.mean(1, keepdim=True).repeat_interleave(2, 2).expand_as(full)
    torch.testing.assert_close(full, mean_v, rtol=1e-5, atol=2e-5)
    assert not torch.equal(tc_walk(q, k, v, skip=True, **kw), full)
    assert tfa._route(q.bfloat16(), k.bfloat16(), v.bfloat16(), False,
                      0) == "simt"


# B, Sq, Sk, H, Hkv, D, causal, kv_len, bq, bk: tests/test_torch_flash.py's
# bf16 case, then D = 256 (causal, and kv_len ending mid-tile) and 128
BF16_CASES = [
    (1, 256, 256, 4, 2, 64, True, None, 128, 128),
    (1, 128, 256, 2, 1, 256, True, None, 128, 256),
    (1, 128, 192, 2, 2, 256, True, 100, 128, 64),
    (2, 64, 128, 4, 2, 128, False, 70, 64, 128),
]


@pytest.fixture(scope="module")
def bf16_reference():
    """Each BF16_CASES case's bf16 inputs and the reference kernel's
    bf16 output (interpret mode)."""
    out = {}
    for i, case in enumerate(BF16_CASES):
        causal, kv_len, bq, bk = case[6:]
        q, k, v = _inputs(20 + i, case[:6], torch.bfloat16)
        ref = ref_flash(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                          for t in (q, k, v)),
                        causal=causal, kv_len=kv_len, bq=bq, bk=bk,
                        interpret=True)
        out[case] = (q, k, v, np.asarray(ref, np.float32))
    return out


@pytest.mark.parametrize("case", BF16_CASES)
def test_tc_rounded_p_matches_reference(bf16_reference, case):
    """p rounded to bf16 before P·V (the one rounding the reference lacks),
    masked tiles skipped, output rounded to bf16: within the reference's
    bf16 tolerance of 0.05."""
    q, k, v, ref = bf16_reference[case]
    causal, kv_len = case[6:8]
    got = tc_walk(q, k, v, causal=causal, kv_len=kv_len, skip=True,
                  round_p=True).to(torch.bfloat16).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0.05, atol=0.05)


# --------------------------------------------------------------------------
# the split route: partials over chunks, then the combine
# --------------------------------------------------------------------------

# B, Sq, Sk, H, Hkv, D, kv_len, chunk: decode rows against caches cut in
# chunks, with chunks wholly past kv_len (kv_len 1 and 300 of 512)
SPLIT_CASES = [
    (2, 1, 512, 4, 2, 128, 300, 64),
    (2, 1, 512, 4, 2, 128, 1, 64),
    (2, 1, 512, 4, 2, 128, None, 100),
    (1, 2, 384, 8, 2, 64, 257, 32),
    (2, 1, 264, 2, 2, 256, 263, 37),
]


@pytest.fixture(scope="module")
def split_reference():
    out = {}
    for i, case in enumerate(SPLIT_CASES):
        B, Sq, Sk, H, Hkv, D, kv_len, _ = case
        q, k, v = _inputs(40 + i, (B, Sq, Sk, H, Hkv, D))
        ref = ref_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                        jnp.asarray(v.numpy()), causal=False, kv_len=kv_len,
                        bq=Sq, bk=Sk, interpret=True)
        out[case] = (q, k, v, np.asarray(ref))
    return out


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_combine_matches_plain_and_reference(split_reference, case):
    q, k, v, ref = split_reference[case]
    kv_len, chunk = case[6:]
    got = split_combine(q, k, v, kv_len=kv_len, chunk=chunk)
    plain = tfa.flash_attention_plain(q, k, v, causal=False, kv_len=kv_len,
                                      bq=q.shape[1], bk=k.shape[1])
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_plan_chunks_equal_the_emulation(case):
    """The wrapper's own chunking (over the visible keys only) gives the
    same result as any other chunking, to the order of the sums."""
    B, Sq, Sk, H, Hkv, D, kv_len, chunk = case
    q, k, v = _inputs(60, (B, Sq, Sk, H, Hkv, D))
    n_visible = Sk if kv_len is None else min(kv_len, Sk)
    _, plan_chunk = tfa._split_plan(B, Hkv, n_visible, 132)
    torch.testing.assert_close(
        split_combine(q, k, v, kv_len=kv_len, chunk=plan_chunk),
        split_combine(q, k, v, kv_len=kv_len, chunk=chunk),
        rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the card's bound (flash_attention.bf16_allowance): met by the emulations,
# missed by wrong kernels
# --------------------------------------------------------------------------

# B, Sq, Sk, H, Hkv, D, causal, kv_len: tests/test_torch_cuda.py's
# FLASH_ROUTE_CASES of the tc route, cut in batch and heads
TC_BOUND_CASES = [
    (1, 200, 200, 2, 1, 128, True, None),
    (1, 96, 160, 2, 1, 128, True, None),
    (1, 320, 192, 2, 2, 256, True, None),
    (1, 130, 384, 2, 2, 256, True, None),
    (1, 192, 256, 2, 1, 64, True, 100),
    (1, 1024, 1024, 1, 1, 256, True, None),
]
# B, Sq, Sk, H, Hkv, D, kv_len: the split route's card cases
SPLIT_BOUND_CASES = [
    (2, 1, 8192, 4, 4, 256, 1),
    (2, 1, 8192, 4, 4, 256, 4097),
    (2, 1, 8192, 4, 4, 256, 8192),
    (2, 1, 2048, 8, 2, 128, 2000),
    (4, 1, 1056, 16, 16, 256, 1055),
]


def _exceeds(got, want, v, rounded_p):
    """How many elements of ``got`` (bf16) lie beyond the allowance."""
    allow = tfa.bf16_allowance(want, v, rounded_p=rounded_p)
    return int(((got.float() - want.float()).abs() > allow).sum())


@pytest.mark.parametrize("case", TC_BOUND_CASES)
def test_tc_emulation_within_the_card_bound(case):
    """The tc walk (p rounded to bf16, output rounded to bf16) against the
    plain version: inside ``bf16_allowance(rounded_p=True)``; a halved
    output and a walk that forgets to rescale are not."""
    causal, kv_len = case[6:]
    q, k, v = _inputs(70, case[:6], torch.bfloat16)
    want = tfa.flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     bq=case[1], bk=case[2])
    kw = dict(causal=causal, kv_len=kv_len, skip=True, round_p=True)
    got = tc_walk(q, k, v, **kw).to(torch.bfloat16)
    assert _exceeds(got, want, v, True) == 0
    assert _exceeds((got.float() * 0.5).bfloat16(), want, v, True) > 0
    assert _exceeds(tc_walk(q, k, v, rescale=False, **kw).bfloat16(), want,
                    v, True) > 0


@pytest.mark.parametrize("case", SPLIT_BOUND_CASES)
def test_split_emulation_within_the_card_bound(case):
    """The split-and-combine, rounded to bf16, against the plain version:
    inside ``bf16_allowance(rounded_p=False)``; a halved output, a combine
    without e^(m_i - M) and one that loses a chunk are not."""
    B, Sq, Sk, H, Hkv, D, kv_len = case
    q, k, v = _inputs(71, case[:6], torch.bfloat16)
    want = tfa.flash_attention_plain(q, k, v, causal=False, kv_len=kv_len,
                                     bq=Sq, bk=Sk)
    n_visible = min(kv_len, Sk)
    _, chunk = tfa._split_plan(B, Hkv, n_visible, 132)
    run = lambda **kw: split_combine(q, k, v, kv_len=kv_len, chunk=chunk,
                                     **kw).to(torch.bfloat16)
    got = run()
    assert _exceeds(got, want, v, False) == 0
    assert _exceeds((got.float() * 0.5).bfloat16(), want, v, False) > 0
    if n_visible > chunk:       # more than one chunk holds a visible key
        assert _exceeds(run(rescale=False), want, v, False) > 0
        assert _exceeds(run(drop=0), want, v, False) > 0
