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
run at once); the CUDA kernels pick their own tiles.

On the card a call takes one of three routes, chosen by ``_route`` from
dtype, shapes, masks and alignment alone (deterministic; no route falls
back to another or to the plain version):

=========  ===============================================  =====================
route      takes                                            kernel (``csrc/``)
=========  ===============================================  =====================
``simt``   float32, or D not in {64, 128, 256}, or          ``flash_attention.cu``
           ``kv_len`` <= 0, or Sk = 0, or q, k or v not     (CUDA cores, float32,
           16-byte aligned                                  every tile visited)
``split``  bf16, D in {64, 128, 256}, ``causal=False``,     ``flash_decode.cuh``
           ``kv_len`` != 0, Sq x H / Hkv <= 8 (the rows     (split-KV partials,
           of one KV head's group)                          then the combine)
``tc``     every other bf16 call with D in {64, 128, 256}   ``flash_attention_tc.cuh``
                                                            (mma.sync bf16, masked
                                                            tiles skipped)
=========  ===============================================  =====================

The ``tc`` route rounds p to bf16 before P·V (the reference multiplies p in
float32); ``split`` and ``simt`` keep p in float32.  ``bf16_allowance``
states, elementwise, how far a bf16 output may lie from the plain version's
on each side of that line (always within the reference's bf16 tolerance of
0.05).  ``LAUNCHES["flash_attention"]`` counts one per call (the split
route's two launches included); ``ROUTES`` counts the calls by route.  The
wrapper takes the lean launch path (``_build.kernel_device`` /
``_build.launch``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

DEFAULT_BQ = 512
DEFAULT_BK = 512
NEG_INF = -1e30
MAX_HEAD_DIM = 256                # the SIMT kernel's widest head
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TC_WIDTHS = (64, 128, 256)        # head widths of the tc and split routes
SPLIT_MAX_ROWS = 8                # query rows a split CTA holds (Sq H / Hkv)
# the tc kernel's CTA by D, fixed at compile time (flash_tc::Tile in
# csrc/flash_attention_tc.cuh): warps (16 query rows each), keys a KV tile
TC_TILES = {64: (4, 64), 128: (4, 32), 256: (8, 64)}
SPLIT_MIN_CHUNK = 64              # keys a split CTA streams, at least
SPLIT_CTAS_PER_SM = 4             # split CTAs the grid aims for, per SM
ROUTES = {"tc": 0, "split": 0, "simt": 0}


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


def bf16_allowance(want: torch.Tensor, v: torch.Tensor, *,
                   rounded_p: bool) -> torch.Tensor:
    """The largest |out - want| each element of a bf16 route's output may
    show against ``want``, the plain version's output on the same inputs
    (``v`` the values): ``atol + 2**-6 |want|``, capped at 0.05.

    2**-6 |want| covers the two outputs' bf16 rounding, one step of at most
    2**-7 |x| on either side of a binade edge.  Where both sides keep p in
    float32 (split, simt) they differ only by the order of float32 sums
    before that rounding: atol 1e-4.  Where one side rounds p to bf16 before
    P·V (tc, ``rounded_p``), each weight moves by up to 2**-9 of itself and
    the output by up to 2**-8 max|V| if every error fell one way; they fall
    both ways, and atol is 2**-9 max|V|."""
    atol = 2.0 ** -9 * float(v.abs().max()) if rounded_p else 1e-4
    return torch.clamp_max(atol + 2.0 ** -6 * want.float().abs(), 0.05)


def _route(q, k, v, causal: bool, kv_len) -> str:
    """The route a call on the card takes: "tc", "split" or "simt" (see the
    module docstring).  Pure: dtype, shapes, masks and alignment only."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if (q.dtype != torch.bfloat16 or D not in TC_WIDTHS or Sk == 0
            or (kv_len is not None and kv_len <= 0)
            or any(t.data_ptr() % 16 for t in (q, k, v))):
        return "simt"
    if not causal and Sq * (H // Hkv) <= SPLIT_MAX_ROWS:
        return "split"
    return "tc"


def _split_plan(B: int, Hkv: int, n_visible: int,
                n_sm: int) -> tuple[int, int]:
    """(n_split, chunk) for the split route: contiguous chunks of ``chunk``
    keys over [0, n_visible), every chunk non-empty, B·Hkv·n_split about
    ``SPLIT_CTAS_PER_SM`` CTAs an SM, chunks of at least
    ``SPLIT_MIN_CHUNK`` keys where there are that many."""
    want = -(-SPLIT_CTAS_PER_SM * n_sm // (B * Hkv))
    n_split = max(1, min(want, n_visible // SPLIT_MIN_CHUNK))
    chunk = -(-n_visible // n_split)
    return -(-n_visible // chunk), chunk


def _launch(q, k, v, index: int, *, route: str, causal: bool,
            kv_len) -> torch.Tensor:
    """Launch the kernel of ``route`` on checked operands on CUDA device
    ``index`` and count it.  ``flash_attention`` calls it with ``_route``'s
    choice; the card tests and chip_smoke.py also call it with route="simt"
    to hold a route against the SIMT kernel at the same shape."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    kvl = -1 if kv_len is None else max(int(kv_len), 0)
    qkv = (q.data_ptr(), k.data_ptr(), v.data_ptr(), B, Sq, Sk, H, Hkv, D)
    if route == "simt":
        _build.launch("flash_attention", "repro_flash_attention", index, *qkv,
                      int(causal), kvl, _DTYPE_CODES[q.dtype], out.data_ptr())
    elif route == "tc":
        _build.launch("flash_attention", "repro_flash_attention_tc", index,
                      *qkv, int(causal), kvl, out.data_ptr())
    elif route == "split":
        n_visible = Sk if kv_len is None else min(kvl, Sk)
        n_split, chunk = _split_plan(B, Hkv, n_visible, _build.sm_count(index))
        # scratch: acc (B, Hkv, n_split, rows, D), then (m, l) a row
        n_rows = B * Hkv * n_split * Sq * (H // Hkv)
        part = torch.empty(n_rows * (D + 2), dtype=torch.float32,
                           device=q.device)
        _build.launch("flash_attention", "repro_flash_decode", index, *qkv,
                      n_visible, n_split, chunk, part.data_ptr(),
                      part.data_ptr() + 4 * n_rows * D, out.data_ptr())
    else:
        raise ValueError(f"unknown route {route!r}")
    ROUTES[route] += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True, kv_len: int | None = None,
                    bq: int = DEFAULT_BQ, bk: int = DEFAULT_BK) -> torch.Tensor:
    """K8's wrapper, the reference's signature: q (B, Sq, H, D), k/v
    (B, Sk, Hkv, D), float32 or bfloat16 → (B, Sq, H, D) in q's dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    ``_route``'s route, which needs q, k and v contiguous, of one dtype,
    and D ≤ 256."""
    index = _build.kernel_device(q, k, v)
    if index < 0:
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
    return _launch(q, k, v, index, route=_route(q, k, v, causal, kv_len),
                   causal=causal, kv_len=kv_len)
