"""Attention of the port's LM stack: GQA/MHA with RoPE, prefill through B11
and single-token decode against a KV cache.

Counterpart of the JAX package's ``models/attention.py``.  Prefill
(``apply_attention``) runs the causal self-attention in B11
(``ops.flash_attention``), the hand-written counterpart of the Pallas
kernel that implements this contract on the reference's hardware; the
reference's own prefill materialises the scores at S <= 4096
(``full_attention``), which computes the same function.  Decode
(``decode_attention``) attends to the cache with ``full_attention`` in
torch ops, as the reference does: it has no Pallas kernel there.  In
training (autograd recording) prefill's attention takes B11's autograd
form, whose backward is B12 (``kernels/autograd.py``).

Shapes:  x (B, S, d_model); q (B, S, Hq, hd); k/v (B, S, Hkv, hd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import autograd as grad_ops
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (apply_rope, dense_init, linear,
                                       plain_route, rms_norm_vec,
                                       torch_dtype)

NEG_INF = -1e30


def init_attention(gen, cfg: ModelConfig, device: torch.device, lead=()):
    dt = torch_dtype(cfg)
    p = {"wq": dense_init(gen, cfg.d_model, cfg.q_dim, dt, device, lead),
         "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device, lead),
         "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device, lead),
         "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dt, device, lead)}
    if cfg.attn.qk_norm:
        p["q_norm"] = torch.ones((*lead, cfg.head_dim), dtype=dt,
                                 device=device)
        p["k_norm"] = torch.ones((*lead, cfg.head_dim), dtype=dt,
                                 device=device)
    return p


def attention_logical(cfg: ModelConfig):
    lg = {"wq": ("embed", "qkv"), "wk": ("embed", "qkv"),
          "wv": ("embed", "qkv"), "wo": ("qkv", "embed")}
    if cfg.attn.qk_norm:
        lg["q_norm"] = ("head_dim",)
        lg["k_norm"] = ("head_dim",)
    return lg


def _project_qkv(params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, path: Optional[str] = None):
    B, S, _ = x.shape
    q = linear(x, params["wq"], path).reshape(B, S, cfg.n_heads,
                                              cfg.head_dim)
    k = linear(x, params["wk"], path).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
    v = linear(x, params["wv"], path).reshape(B, S, cfg.n_kv_heads,
                                              cfg.head_dim)
    if "q_norm" in params:
        q = rms_norm_vec(q, params["q_norm"])
        k = rms_norm_vec(k, params["k_norm"])
    q = apply_rope(q, positions, cfg.attn.rope_theta)
    k = apply_rope(k, positions, cfg.attn.rope_theta)
    return q, k, v


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """Materialised-scores attention, in torch ops: fp32 scores, masked to
    -1e30, an fp32 softmax, probabilities cast to v's dtype for P·V.  GQA
    groups the query heads over the KV heads without copying them."""
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / math.sqrt(hd))
    cap = cfg.attn.logits_softcap
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask[None, None, None], scores,
                             torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, hd)


def apply_attention(params, x: torch.Tensor, cfg: ModelConfig,
                    positions: Optional[torch.Tensor] = None,
                    causal: Optional[bool] = None,
                    path: Optional[str] = None):
    """Full-sequence attention (prefill) through B11.  Returns
    (out (B, S, d_model), (k, v)), k and v as (B, S, Hkv, hd) for the
    cache."""
    B, S, _ = x.shape
    if cfg.attn.logits_softcap is not None:
        raise NotImplementedError(
            "logit softcapping: B11 has no softcap; ROADMAP A17")
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    causal = cfg.attn.causal if causal is None else causal
    q, k, v = _project_qkv(params, x, cfg, positions, path)
    G = cfg.n_heads // cfg.n_kv_heads
    kh = k if G == 1 else k.repeat_interleave(G, dim=2)
    vh = v if G == 1 else v.repeat_interleave(G, dim=2)
    # (B, S, H, hd) memory seen as (B, H, S, hd): no transposed copy
    qt, kt, vt = (t.permute(0, 2, 1, 3) for t in (q, kh, vh))
    if plain_route(path):
        out = ref.attention(qt, kt, vt, causal=causal)
    elif grad_ops.records(qt, kt, vt):
        out = grad_ops.flash_attention(qt, kt, vt, causal)
    else:
        out = ops.flash_attention(qt, kt, vt, causal=causal)
    out = out.permute(0, 2, 1, 3).reshape(B, S, cfg.q_dim)
    return linear(out, params["wo"], path), (k, v)


def decode_attention(params, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig, *, length: int,
                     path: Optional[str] = None):
    """One-token decode with every row at one position (the reference's
    ``aligned=True``): write this token's k and v into the cache at
    ``pos[0]`` and attend to it.

    x: (B, 1, d_model); cache_k/v: (B, S_max, Hkv, hd); pos: (B,) int.
    ``length``: positions already written (a host int, equal to pos), so
    the scores cover the ``length + 1`` written positions.  The reference
    scores the whole cache and masks the unwritten rest to -1e30, whose
    probabilities are exact zeros, so this is the same result.

    Unlike the reference, which returns new cache arrays, this writes
    ``cache_k`` and ``cache_v`` IN PLACE and returns them.
    Returns (out (B, 1, d_model), cache_k, cache_v).
    """
    B = x.shape[0]
    q, k, v = _project_qkv(params, x, cfg, pos[:, None], path)
    at = pos[:1].to(torch.long)
    cache_k.index_copy_(1, at, k.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    skv = length + 1
    out = full_attention(q, cache_k[:, :skv], cache_v[:, :skv], cfg,
                         causal=False)
    out = out.reshape(B, 1, cfg.q_dim)
    return linear(out, params["wo"], path), cache_k, cache_v
