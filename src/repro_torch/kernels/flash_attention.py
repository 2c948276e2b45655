"""K8: flash attention forward (GQA, causal and ``kv_len`` masks), and its
plain version.

Port of ``src/repro/kernels/flash_attention.py``: ``flash_attention_plain``
is the tile recurrence of the reference's ``_flash_kernel`` in torch (the
online-softmax state m, l, acc carried across KV tiles of ``bk`` keys);
``flash_attention`` replaces the Pallas kernel with the CUDA kernel in
``csrc/flash_attention.cu``.  Both keep the reference's semantics:

- q (B, Sq, H, D), k/v (B, Sk, Hkv, D), H % Hkv == 0; query head h reads
  KV head h // (H / Hkv);
- scores (q·k) · 1/sqrt(D) in float32; masked scores are the finite -1e30
  and m starts at -1e30, so a row with no visible key averages V (every
  masked key adds exp(0) = 1) instead of giving NaN;
- the causal mask is q_pos >= k_pos, both counted from 0 with no offset,
  even when Sq != Sk; the ``kv_len`` mask is k_pos < kv_len;
- float32 arithmetic throughout, the final divide acc / max(l, 1e-30), the
  output in q's dtype (float32 or bfloat16).

``bq`` and ``bk`` only tile the work: they change the result through the
order of float sums alone.  Both are kept, with the reference's check
``Sq % min(bq, Sq) == 0 and Sk % min(bk, Sk) == 0``, so that the port
accepts and refuses the same calls.  The plain version tiles the keys by
``bk`` as the reference does (its rows are independent, so all query rows
run at once); the CUDA kernel picks its own tiles.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

DEFAULT_BQ = 512
DEFAULT_BK = 512
NEG_INF = -1e30
MAX_HEAD_DIM = 256                # the CUDA kernel's widest head
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_tiles(q, k, bq: int, bk: int) -> tuple[int, int]:
    """The reference's asserts (raised as AssertionError under -O too);
    returns the effective (bq, bk)."""
    Sq, H = q.shape[1], q.shape[2]
    Sk, Hkv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise AssertionError(f"H={H} is not a multiple of Hkv={Hkv}")
    bq, bk = min(bq, Sq), min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise AssertionError("pad sequences to block multiples")
    return bq, bk


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          kv_len: int | None = None, bq: int = DEFAULT_BQ,
                          bk: int = DEFAULT_BK) -> torch.Tensor:
    """Plain version of K8: ``_flash_kernel``'s recurrence over KV tiles of
    ``bk`` keys, in torch.  Returns (B, Sq, H, D) in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _, bk = _check_tiles(q, k, bq, bk)
    n_rep = H // Hkv
    scale = float(np.float32(1.0 / np.sqrt(D)))
    qt = q.transpose(1, 2).float()                          # (B, H, Sq, D)
    kt = k.transpose(1, 2).repeat_interleave(n_rep, 1).float()
    vt = v.transpose(1, 2).repeat_interleave(n_rep, 1).float()
    dev = q.device
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    for j in range(Sk // bk):
        kb = kt[:, :, j * bk:(j + 1) * bk]
        vb = vt[:, :, j * bk:(j + 1) * bk]
        s = (qt @ kb.transpose(-1, -2)) * scale
        k_pos = j * bk + torch.arange(bk, device=dev)[None, :]
        mask = torch.ones((Sq, bk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos >= k_pos)
        if kv_len is not None:
            mask = mask & (k_pos < kv_len)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p @ vb
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2).contiguous()


def flash_attention(q, k, v, *, causal: bool = True, kv_len: int | None = None,
                    bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK) -> torch.Tensor:
    """K8's wrapper, the reference's signature: q (B, Sq, H, D), k/v
    (B, Sk, Hkv, D), float32 or bfloat16 → (B, Sq, H, D) in q's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which needs q, k and v contiguous, of one dtype, and D ≤ 256."""
    if not _build.kernel_path(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, kv_len=kv_len,
                                     bq=bq, bk=bk)
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t, name, q.dtype, 4)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, D) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B={B}, Sk, Hkv, D={D}), got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D} outside 1..{MAX_HEAD_DIM}")
    _check_tiles(q, k, bq, bk)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _build.function("repro_flash_attention")
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, Sk, H, Hkv,
                 D, int(causal), -1 if kv_len is None else max(int(kv_len), 0),
                 _DTYPE_CODES[q.dtype], out.data_ptr(), _build.stream_of(q))
    _build.check(err, "flash_attention")
    _build.count("flash_attention")
    return out
