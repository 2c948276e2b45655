"""K8 (flash attention forward), by its plain version on the CPU, against the
reference Pallas kernel in interpret mode.  Inputs come from a numpy seed
and go to both packages as numpy; each reference result is computed once
per module.  The tolerances are the reference's own
(tests/test_flash_attention.py): rtol 1e-5 / atol 2e-5 against the kernel,
1e-4 against the chunked library path, 0.05 in bf16.  The CUDA kernel is
held against this plain version on the card in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as ref_flash
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import layers as TL

pytestmark = pytest.mark.torch_port

# tests/test_flash_attention.py's CASES, then kv_len = 0 (every key masked:
# the mean of V), Sq != Sk causal, and decode (Sq = 1) with kv_len
CASES = [
    # B, Sq, Sk, H, Hkv, D, causal, kv_len, bq, bk
    (2, 256, 256, 4, 2, 64, True, None, 128, 128),
    (1, 512, 512, 8, 8, 128, True, None, 256, 256),
    (2, 256, 512, 4, 1, 64, False, 450, 128, 128),
    (1, 128, 1024, 2, 2, 256, False, None, 128, 512),
    (1, 256, 256, 4, 4, 64, True, 200, 64, 64),
    (1, 64, 128, 2, 1, 64, False, 0, 64, 64),
    (1, 128, 256, 4, 2, 64, True, None, 128, 256),
    (2, 1, 512, 4, 2, 128, False, 300, 512, 512),
]


def _inputs(seed: int, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32).astype(dtype)
            for s in shapes]


def _qkv_shapes(B, Sq, Sk, H, Hkv, D):
    return (B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D)


@pytest.fixture(scope="module")
def reference_results():
    """Each case's numpy inputs and the reference kernel's output."""
    out = {}
    for i, case in enumerate(CASES):
        B, Sq, Sk, H, Hkv, D, causal, kv_len, bq, bk = case
        q, k, v = _inputs(100 + i, _qkv_shapes(B, Sq, Sk, H, Hkv, D))
        ref = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, kv_len=kv_len, bq=bq, bk=bk,
                        interpret=True)
        out[case] = (q, k, v, np.asarray(ref))
    return out


@pytest.mark.parametrize("case", CASES)
def test_flash_plain_matches_reference_kernel(reference_results, case):
    q, k, v, ref = reference_results[case]
    causal, kv_len, bq, bk = case[6:]
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              kv_len=kv_len, bq=bq, bk=bk)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)


def test_flash_fully_masked_rows_average_v(reference_results):
    """kv_len = 0: every score is the finite -1e30, so each row is the mean
    of V over all keys, as in the reference — not NaN."""
    case = CASES[5]
    q, k, v, ref = reference_results[case]
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=False, kv_len=0,
                              bq=64, bk=64).numpy()
    mean_v = v.mean(axis=1, keepdims=True)                  # (B, 1, Hkv, D)
    want = np.repeat(mean_v, 2, axis=2).repeat(q.shape[1], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(ref, want, rtol=1e-5, atol=2e-5)


def test_flash_matches_chunked_library_path():
    """The plain K8 ≡ the port's online-softmax path used by prefill."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        1, _qkv_shapes(2, 512, 512, 4, 2, 64)))
    a = ops.flash_attention(q, k, v, causal=True, bq=128, bk=128)
    b = TL.attention_chunked(q, k, v, chunk=128)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_flash_bf16_io():
    q, k, v = _inputs(2, _qkv_shapes(1, 256, 256, 4, 2, 64))
    ref = ref_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    causal=True, bq=128, bk=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, bq=128, bk=128)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("Sq,Sk,bq,bk", [(256, 256, 96, 128),
                                         (256, 200, 128, 128)])
def test_flash_refuses_unpadded_sequences_as_the_reference(Sq, Sk, bq, bk):
    q, k, v = _inputs(3, _qkv_shapes(1, Sq, Sk, 2, 2, 64))
    with pytest.raises(AssertionError, match="block multiples"):
        ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=bq,
                  bk=bk, interpret=True)
    with pytest.raises(AssertionError, match="block multiples"):
        ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), bq=bq, bk=bk)


def test_flash_cpu_path_launches_nothing():
    """CPU tensors take the plain version: no kernel launch is counted."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        4, _qkv_shapes(1, 64, 64, 2, 2, 32)))
    before = ops.launches()["flash_attention"]
    out = ops.flash_attention(q, k, v)
    assert ops.launches()["flash_attention"] == before
    np.testing.assert_allclose(
        out.numpy(), tfa.flash_attention_plain(q, k, v, causal=True,
                                               kv_len=None, bq=512,
                                               bk=512).numpy())
