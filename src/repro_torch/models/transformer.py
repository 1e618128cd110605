"""Decoder LM stack of the port, dense family.

Counterpart of the JAX package's ``models/transformer.py`` for dense
archs (stablelm-3b): the same parameter tree, with each layer's weights
stacked on a leading axis under ``params["layers"]["sub0"]``, and the
same three entry points:

  forward(params, tokens, cfg)               scoring (full sequence)
  prefill(params, tokens, cfg, max_seq=)     full sequence + decode cache
  decode_step(params, cache, tokens, cfg)    one token against the cache

The reference scans its layers; here a Python loop walks them, each
layer's weights a view of the stacked tensors.  Every dense projection
and the unembedding go through B10 and prefill's attention through B11.
MoE, SSM, hybrid, enc-dec and VLM configs raise ``NotImplementedError``:
their modules wait for ROADMAP A17.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense decoder, the family the port
    serves."""
    other = [name for name, on in (
        ("MoE", cfg.moe is not None or cfg.family == "moe"),
        ("SSM", cfg.ssm is not None or cfg.family == "ssm"),
        ("hybrid", bool(cfg.hybrid_block) or cfg.family == "hybrid"),
        ("enc-dec", cfg.encoder is not None or cfg.family == "audio"),
        ("VLM", cfg.vision is not None or cfg.family == "vlm")) if on]
    if other or cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.arch_id}: the port's LM stack serves the dense family; "
            f"{'/'.join(other) or cfg.family} layers wait for ROADMAP A17")


def layer_plan(cfg: ModelConfig):
    """(mixer kinds, ffn kinds, unit size, number of units), as in the
    reference: for a dense decoder one attention layer per unit."""
    check_supported(cfg)
    return ["attn"], ["mlp" if cfg.d_ff else "none"], 1, cfg.n_layers


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None) -> Dict[str, Any]:
    """Seeded random weights (N(0, 1/in) projections, N(0, 0.02²)
    embedding, unit norms) on ``device``, drawn from ``generator`` (a
    ``torch.Generator`` on that device; seed 0 when none).  On the
    ``"meta"`` device nothing is allocated: the tree of shapes and dtypes
    at full width."""
    mixers, ffns, _, n_units = layer_plan(cfg)
    dev = resolve_device(device)
    if dev.type == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    lead = (n_units,)
    sub: Dict[str, Any] = {"norm_mixer": L.init_norm(cfg, dev, lead),
                           "attn": attn.init_attention(generator, cfg, dev,
                                                       lead)}
    if ffns[0] != "none":
        sub["norm_ffn"] = L.init_norm(cfg, dev, lead)
        sub["mlp"] = L.init_mlp(generator, cfg, dev, lead)
    return {"embed": L.init_embed(generator, cfg, dev),
            "final_norm": L.init_norm(cfg, dev),
            "layers": {"sub0": sub}}


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's leaf shapes, from ``init_params`` on the meta
    device (nothing allocated)."""
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)
    return shapes(init_params(cfg, device="meta"))


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _sublayer(p, x: torch.Tensor, cfg: ModelConfig, positions, path):
    h = L.apply_norm(p["norm_mixer"], x, cfg)
    out, kv = attn.apply_attention(p["attn"], h, cfg, positions=positions,
                                   path=path)
    x = x + out
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm_ffn"], x, cfg),
                            cfg, path)
    return x, kv


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            path: Optional[str] = None):
    """tokens (B, S) -> (logits (B, S, vocab), aux loss): the aux loss is
    the reference's MoE balance term, a zero for a dense model."""
    _, _, _, n_units = layer_plan(cfg)
    x = L.apply_embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i in range(n_units):
        x, _ = _sublayer(_layer(params["layers"]["sub0"], i), x, cfg,
                         positions, path)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x, cfg, path)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def layer_states(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                 path: Optional[str] = None):
    """tokens (B, S) -> the residual stream (B, S, d_model) after each
    layer, a list of ``n_layers`` tensors: the prefill's forward pass seen
    layer by layer, so that two routes can be held against each other at
    every layer rather than only at the logits."""
    _, _, _, n_units = layer_plan(cfg)
    x = L.apply_embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    states = []
    for i in range(n_units):
        x, _ = _sublayer(_layer(params["layers"]["sub0"], i), x, cfg,
                         positions, path)
        states.append(x)
    return states


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


class DecodeCache(NamedTuple):
    kv_k: torch.Tensor     # (n_layers, B, S_max, Hkv, hd)
    kv_v: torch.Tensor
    pos: torch.Tensor      # (B,) int32: the next position to write
    length: int            # the same position, on the host


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None, *,
               device: DeviceLike = None) -> DecodeCache:
    _, _, _, n_units = layer_plan(cfg)
    dev = resolve_device(device)
    shape = (n_units, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or L.torch_dtype(cfg)
    return DecodeCache(kv_k=torch.zeros(shape, dtype=dt, device=dev),
                       kv_v=torch.zeros(shape, dtype=dt, device=dev),
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=dev),
                       length=0)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_seq: Optional[int] = None, path: Optional[str] = None):
    """tokens (B, S) -> (last-position logits (B, vocab), DecodeCache with
    the prompt's k and v in positions [0, S) of ``max_seq``)."""
    _, _, _, n_units = layer_plan(cfg)
    x = L.apply_embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    max_seq = max_seq or S
    if S > max_seq:
        raise ValueError(f"prompt of {S} tokens exceeds max_seq={max_seq}")
    positions = torch.arange(S, device=x.device).expand(B, S)
    cache = init_cache(cfg, B, max_seq, device=x.device)
    for i in range(n_units):
        x, (k, v) = _sublayer(_layer(params["layers"]["sub0"], i), x, cfg,
                              positions, path)
        cache.kv_k[i, :, :S] = k
        cache.kv_v[i, :, :S] = v
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x[:, -1], cfg, path)
    return logits, cache._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=x.device),
        length=S)


def decode_step(params, cache: DecodeCache, tokens: torch.Tensor,
                cfg: ModelConfig, *, path: Optional[str] = None):
    """tokens (B, 1) -> (logits (B, vocab), cache advanced by one), every
    row at one position (the reference's ``aligned=True``).

    The cache's k and v tensors are written in place (see
    ``attention.decode_attention``): the returned cache holds the same
    tensors, and the one passed in is spent."""
    _, _, _, n_units = layer_plan(cfg)
    if cache.length >= cache.kv_k.shape[2]:
        raise ValueError(f"the cache is full: {cache.length} of "
                         f"{cache.kv_k.shape[2]} positions written")
    x = L.apply_embed(params["embed"], tokens, cfg)
    for i in range(n_units):
        p = _layer(params["layers"]["sub0"], i)
        h = L.apply_norm(p["norm_mixer"], x, cfg)
        out, _, _ = attn.decode_attention(
            p["attn"], h, cache.kv_k[i], cache.kv_v[i], cache.pos, cfg,
            length=cache.length, path=path)
        x = x + out
        if "mlp" in p:
            x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm_ffn"], x,
                                                       cfg), cfg, path)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x[:, 0], cfg, path)
    return logits, cache._replace(pos=cache.pos + 1, length=cache.length + 1)
