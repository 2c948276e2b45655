"""Config-driven decoder-only transformer (dense or MoE) with GQA, RoPE,
GeGLU/SwiGLU, RMSNorm, and its serving entry points: prefill and decode
with a KV cache.  Covers gemma-7b, phi3-medium-14b, internlm2-1.8b,
granite-moe-1b-a400m and kimi-k2-1t-a32b through ``LMConfig``.

Port of ``src/repro/models/transformer.py``.  The reference keeps every
layer weight stacked on a leading ``n_layers`` axis and scans over it; the
port holds one ``DecoderLayer`` module per layer and loops.  Weights are
kept in ``param_dtype`` and cast to ``compute_dtype`` at each use, as the
reference casts them per call; logits are a float32-accumulated product.
A layer of an MoE config (``n_experts > 0``) holds ``moe.MoE`` (a float32
router and the stacked expert weights) in place of the dense MLP and runs
``moe.moe_ffn`` after attention, in prefill and in decode alike.
``decode_step`` writes the new K/V into the cache in place at ``pos``
(the reference's ``dynamic_update_slice``) and returns the same cache.
The training entry points (``forward``, ``lm_hidden``, ``lm_loss``) come
with a later slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    act: str = "swiglu"               # 'swiglu' | 'geglu'
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    embed_scale: bool = False         # gemma multiplies embeddings by sqrt(d)
    # MoE
    n_experts: int = 0                # 0 → dense FFN
    top_k: int = 0
    capacity_factor: float = 1.25
    # numerics / memory
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "dots"               # 'none' | 'dots' | 'full' (training)
    attn_chunk: int = 1024            # KV chunk for online-softmax attention
    unroll_scan: bool = False         # the reference's dry-run cost probes
    attn_scores_dtype: str = "float32"  # training's attention (not serving)
    full_attn_max_seq: int = 8192     # above this, use chunked attention
    sharding_preset: str = "tp"       # 'tp' | 'fsdp'

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        hd = self.hd
        attn = self.d_model * hd * (self.n_heads + 2 * self.n_kv) \
            + self.n_heads * hd * self.d_model
        if self.is_moe:
            ffn = self.n_experts * 3 * self.d_model * self.d_ff \
                + self.d_model * self.n_experts
        else:
            ffn = 3 * self.d_model * self.d_ff
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + 2 * self.d_model) + embed

    def active_param_count(self) -> int:
        """Activated params (MoE: top_k experts only) for 6·N·D accounting."""
        if not self.is_moe:
            return self.param_count()
        hd = self.hd
        attn = self.d_model * hd * (self.n_heads + 2 * self.n_kv) \
            + self.n_heads * hd * self.d_model
        ffn = self.top_k * 3 * self.d_model * self.d_ff \
            + self.d_model * self.n_experts
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * (attn + ffn + 2 * self.d_model) + embed


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _empty(*shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One layer's weights, in the reference's (in, out) layout: attention,
    then a dense GLU MLP or, for an MoE config, ``moe`` (``moe.MoE``)."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        e = lambda *s: _empty(*s, dtype=_dtype(cfg.param_dtype), device=device)
        d, hd = cfg.d_model, cfg.hd
        self.ln1, self.ln2 = e(d), e(d)
        self.wq = e(d, cfg.n_heads * hd)
        self.wk = e(d, cfg.n_kv * hd)
        self.wv = e(d, cfg.n_kv * hd)
        self.wo = e(cfg.n_heads * hd, d)
        if cfg.is_moe:
            self.moe = moe.MoE(d, cfg.d_ff, cfg.n_experts,
                               _dtype(cfg.param_dtype), device)
        else:
            self.w_in = e(d, cfg.d_ff)
            self.w_gate = e(d, cfg.d_ff)
            self.w_out = e(cfg.d_ff, d)


class LM(nn.Module):
    """An LM's weights (uninitialised; see ``init_params`` and
    ``convert.params_from_numpy``) on ``device``."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        e = lambda *s: _empty(*s, dtype=_dtype(cfg.param_dtype), device=device)
        self.embed = e(cfg.vocab, cfg.d_model)
        self.final_norm = e(cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.lm_head = None if cfg.tie_embeddings else e(cfg.vocab,
                                                         cfg.d_model)

    @property
    def head(self) -> torch.Tensor:
        return self.embed if self.lm_head is None else self.lm_head


@torch.no_grad()
def init_params(generator: torch.Generator, cfg: LMConfig, device=None) -> LM:
    """Random weights with the reference's scales (normal draws from
    ``generator``, made on the generator's device; norms zero).  The model
    lands on ``device``: the CUDA card unless the caller passes "cpu".
    Expert stacks are drawn one expert at a time, and the router, as the
    reference's, is drawn in ``param_dtype`` and kept in float32."""
    device = ops.resolve_device(device)
    lm = LM(cfg, device)
    s = 1.0 / np.sqrt(cfg.d_model)
    ffn = (("moe.router", s), ("moe.w_in", s), ("moe.w_gate", s),
           ("moe.w_out", 1.0 / np.sqrt(cfg.d_ff))) if cfg.is_moe else (
        ("w_in", s), ("w_gate", s), ("w_out", 1.0 / np.sqrt(cfg.d_ff)))
    pdt = _dtype(cfg.param_dtype)

    # the reference's draw order: attention, FFN, embedding, head
    for name, scale in (("wq", s), ("wk", s), ("wv", s),
                        ("wo", 1.0 / np.sqrt(cfg.n_heads * cfg.hd)), *ffn):
        for layer in lm.layers:
            moe.fill_normal(layer.get_parameter(name), generator, scale,
                            pdt if name == "moe.router" else None)
    moe.fill_normal(lm.embed, generator, 1.0)
    if lm.lm_head is not None:
        moe.fill_normal(lm.lm_head, generator, s)
    for layer in lm.layers:
        layer.ln1.zero_()
        layer.ln2.zero_()
    lm.final_norm.zero_()
    return lm


# ---------------------------------------------------------------------------
# the pieces of one layer
# ---------------------------------------------------------------------------

def embed_tokens(params: LM, tokens, cfg: LMConfig):
    """tokens (B, S) → (B, S, d_model) in the compute dtype.  gemma's
    ``embed_scale`` multiplies in float32 and rounds once, as JAX promotes
    the reference's bf16 × numpy-scalar product."""
    cdt = _dtype(cfg.compute_dtype)
    x = params.embed[tokens.long()].to(cdt)
    if cfg.embed_scale:
        x = (x.float() * float(np.float32(np.sqrt(cfg.d_model)))).to(cdt)
    return x


def rope_tables(positions, batch: int, cfg: LMConfig):
    """cos, sin for (S,) positions, broadcast to (batch, S, hd//2)."""
    cos, sin = L.rope_angles(positions, cfg.hd, cfg.rope_theta)
    return (cos[None].expand(batch, *cos.shape),
            sin[None].expand(batch, *sin.shape))


def layer_qkv(lp: DecoderLayer, x, cos, sin, cfg: LMConfig):
    """The attention operands of one layer: RMSNorm, the q/k/v projections
    and RoPE → q (B, S, H, hd), k/v (B, S, Hkv, hd) in x's dtype."""
    cdt = x.dtype
    B, S, _ = x.shape
    h = L.rms_norm(x, lp.ln1.float())
    q = (h @ lp.wq.to(cdt)).reshape(B, S, cfg.n_heads, cfg.hd)
    k = (h @ lp.wk.to(cdt)).reshape(B, S, cfg.n_kv, cfg.hd)
    v = (h @ lp.wv.to(cdt)).reshape(B, S, cfg.n_kv, cfg.hd)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def layer_out(lp: DecoderLayer, x, attn, cfg: LMConfig):
    """The rest of one layer: output projection, residual, RMSNorm, the GLU
    MLP or the MoE layer, residual."""
    B, S = x.shape[:2]
    x = x + attn.reshape(B, S, cfg.n_heads * cfg.hd) @ lp.wo.to(x.dtype)
    h = L.rms_norm(x, lp.ln2.float())
    if cfg.is_moe:
        out, _ = moe.moe_ffn(lp.moe, h, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + out
    return x + L.glu_mlp(h, lp.w_in, lp.w_gate, lp.w_out, cfg.act)


def _logits(params: LM, x, cfg: LMConfig):
    """Final norm and the tied or separate head on (B, d) → (B, V) float32,
    a float32-accumulated product of compute-dtype operands."""
    x = L.rms_norm(x, params.final_norm.float())
    head = params.head.to(_dtype(cfg.compute_dtype))
    return x.float() @ head.float().T


# ---------------------------------------------------------------------------
# serving: prefill + decode with KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, device=None):
    device = ops.resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    cdt = _dtype(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cdt, device=device),
            "v": torch.zeros(shape, dtype=cdt, device=device)}


@torch.no_grad()
def prefill(params: LM, tokens, cfg: LMConfig):
    """Full-sequence forward that also returns the KV cache.

    tokens: (B, S).  Returns (last-token logits (B, V), cache with k/v of
    shape (L, B, S, Hkv, hd))."""
    x = embed_tokens(params, tokens, cfg)
    B, S, _ = x.shape
    cos, sin = rope_tables(torch.arange(S, device=x.device), B, cfg)
    ks, vs = [], []
    for lp in params.layers:
        q, k, v = layer_qkv(lp, x, cos, sin, cfg)
        if S > cfg.full_attn_max_seq:
            attn = L.attention_chunked(q, k, v, chunk=cfg.attn_chunk)
        else:
            attn = L.attention_full(q, k, v)
        x = layer_out(lp, x, attn, cfg)
        ks.append(k)
        vs.append(v)
    return _logits(params, x[:, -1], cfg), {"k": torch.stack(ks),
                                            "v": torch.stack(vs)}


@torch.no_grad()
def decode_step(params: LM, cache, token, pos, cfg: LMConfig):
    """One decode step.  token: (B,) integers; pos: the current length (an
    int).  cache k/v: (L, B, S_max, Hkv, hd), written in place at ``pos``.
    Returns (logits (B, V), the cache)."""
    B = token.shape[0]
    x = embed_tokens(params, token[:, None], cfg)
    cos, sin = rope_tables(torch.tensor([pos], device=x.device), B, cfg)
    for i, lp in enumerate(params.layers):
        q, k, v = layer_qkv(lp, x, cos, sin, cfg)
        cache["k"][i, :, pos] = k[:, 0]
        cache["v"][i, :, pos] = v[:, 0]
        attn = L.attention_decode(q, cache["k"][i], cache["v"][i], pos + 1)
        x = layer_out(lp, x, attn, cfg)
    return _logits(params, x[:, 0], cfg), cache
