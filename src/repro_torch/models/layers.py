"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full / chunked /
decode), GLU MLPs.

Port of ``src/repro/models/layers.py``: plain torch functions with the
reference's dtype flow.  Norms compute in float32 and cast back; the score
products take bf16 operands with float32 accumulation (written here as a
float32 product of the widened operands: bf16 × bf16 products are exact in
float32); softmax runs in float32 and the probabilities are cast to the
query's dtype before the value product.  ``attention_chunked``'s
``lax.scan`` is a Python loop over KV chunks.  ``attention_decode`` keeps
the reference's two ``shard_hint`` calls: the identity on one card (no
DTensor), they lay out the dry-run's decode (``launch/dryrun.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _scale(D: int) -> float:
    """1/sqrt(D) as float32, as JAX rounds the reference's numpy scalar."""
    return float(np.float32(1.0 / np.sqrt(D)))


def rms_norm(x, w, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + w.float())
    return out.to(x.dtype)


def rope_angles(positions, head_dim: int, theta: float = 10000.0):
    """positions: (...,) integer tensor → cos, sin of shape
    (..., head_dim//2), float32; the frequencies are numpy float32 as in the
    reference."""
    half = head_dim // 2
    freqs = theta ** (-np.arange(0, half, dtype=np.float32) / half)
    ang = positions[..., None].float() * torch.from_numpy(
        np.asarray(freqs, np.float32)).to(positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D//2) → rotated x."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]      # broadcast over heads
    s = sin[..., None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention_full(q, k, v, causal: bool = True, q_offset: int = 0,
                   scores_dtype=torch.float32):
    """q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D).  Materializes the (Sq, Sk)
    scores; long contexts use attention_chunked.  ``scores_dtype`` is the
    score product's output type (bf16 rounds the scores before the scale,
    as the reference's ``preferred_element_type`` does)."""
    B, Sq, H, D = q.shape
    n_rep = H // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits.to(scores_dtype).float() * _scale(D)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(qpos >= kpos, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention_chunked(q, k, v, chunk: int = 1024, causal: bool = True):
    """Online-softmax attention (the flash recurrence, a loop over KV
    chunks).  Never materializes more than (B, H, Sq, chunk) scores."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    n_rep = H // k.shape[2]
    scale = _scale(D)
    if Sk % chunk:
        raise AssertionError("pad KV to chunk multiple")
    qf = q.float()
    qpos = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for idx in range(Sk // chunk):
        kb = _repeat_kv(k[:, idx * chunk:(idx + 1) * chunk], n_rep)
        vb = _repeat_kv(v[:, idx * chunk:(idx + 1) * chunk], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if causal:
            kpos = idx * chunk + torch.arange(chunk, device=q.device)[None, :]
            s = torch.where(qpos >= kpos, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(q.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)   # (B, Sq, H, D)


def attention_decode(q, k_cache, v_cache, length):
    """Single-token decode: q (B, 1, H, D) vs cache (B, S, Hkv, D);
    positions ≥ length are masked.  O(S·D) per head."""
    from repro_torch.distributed.sharding import shard_hint
    B, _, H, D = q.shape
    n_rep = H // k_cache.shape[2]
    q = shard_hint(q, "decode_q")
    k = _repeat_kv(k_cache, n_rep)
    v = _repeat_kv(v_cache, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * _scale(D)
    logits = shard_hint(logits, "decode_logits")
    mask = torch.arange(k.shape[1], device=q.device)[None, None, None, :] \
        < length
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def glu_mlp(x, w_in, w_gate, w_out, act: str):
    """GeGLU (gemma; ``jax.nn.gelu``'s default tanh approximation) /
    SwiGLU (llama-family) feed-forward."""
    h = x @ w_in.to(x.dtype)
    g = x @ w_gate.to(x.dtype)
    g = F.gelu(g, approximate="tanh") if act == "geglu" else F.silu(g)
    return (h * g) @ w_out.to(x.dtype)
