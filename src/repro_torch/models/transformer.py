"""Decoder LM stack of the port: the dense and MoE families.

Counterpart of the JAX package's ``models/transformer.py`` for dense
archs (stablelm-3b) and MoE archs (qwen3-moe-30b-a3b, phi3.5-moe): the
same parameter tree, with each layer's weights stacked on a leading axis
under ``params["layers"]["sub0"]``, and the same three entry points:

  forward(params, tokens, cfg)               scoring (full sequence)
  prefill(params, tokens, cfg, max_seq=)     full sequence + decode cache
  decode_step(params, cache, tokens, cfg)    one token against the cache

The reference scans its layers; here a Python loop walks them, each
layer's weights a view of the stacked tensors.  ``forward`` is also the
training path's (``training/trainer.py``): with autograd recording, B10
and B11 take their autograd forms (B10 and B12 in the backward pass),
and ``remat`` chooses what the backward pass recomputes.  Every dense
projection and the unembedding go through B10, prefill's attention
through B11 and an MoE layer's router through B5 (``models/moe.py``; the
expert GEMMs are batched ``torch.matmul``, as the reference's are plain
einsums).  An MoE layer runs on the B·S tokens of a prefill and the B tokens of a
decode step, as the reference's does.  SSM, hybrid, enc-dec and VLM
configs raise ``NotImplementedError``: their modules wait for ROADMAP
A17.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import autograd as grad_ops
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod


def check_supported(cfg: ModelConfig) -> None:
    """Raise unless ``cfg`` is a dense or MoE decoder, the families the
    port serves."""
    other = [name for name, on in (
        ("SSM", cfg.ssm is not None or cfg.family == "ssm"),
        ("hybrid", bool(cfg.hybrid_block) or cfg.family == "hybrid"),
        ("enc-dec", cfg.encoder is not None or cfg.family == "audio"),
        ("VLM", cfg.vision is not None or cfg.family == "vlm")) if on]
    if other or cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.arch_id}: the port's LM stack serves the dense and MoE "
            f"families; {'/'.join(other) or cfg.family} layers wait for "
            "ROADMAP A17")


def layer_plan(cfg: ModelConfig):
    """(mixer kinds, ffn kinds, unit size, number of units), as in the
    reference: one attention layer per unit, its FFN an MoE where
    ``cfg.moe.every == 1`` and else the dense MLP."""
    check_supported(cfg)
    if cfg.moe:
        ffn = "moe" if cfg.moe.every == 1 else "mlp"
    else:
        ffn = "mlp" if cfg.d_ff else "none"
    return ["attn"], [ffn], 1, cfg.n_layers


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
    if ffns[0] == "moe":
        sub["moe"] = moe_mod.init_moe(generator, cfg, dev, lead)
    elif ffns[0] == "mlp":
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


def layer_params(params, i: int, dtype: Optional[torch.dtype] = None):
    """Layer ``i``'s weights: views of the stacked tensors (no copies), or
    with ``dtype`` one layer's copy cast to it."""
    def take(tree):
        if isinstance(tree, dict):
            return {k: take(v) for k, v in tree.items()}
        return tree[i] if dtype is None else tree[i].to(dtype)
    return take(params["layers"]["sub0"])


def mixer(p, x: torch.Tensor, cfg: ModelConfig, positions,
          path: Optional[str] = None):
    """The attention half of a layer (weights ``p``) on the residual stream
    x (B, S, d): (x + attention(norm(x)), the layer's (k, v))."""
    h = L.apply_norm(p["norm_mixer"], x, cfg)
    out, kv = attn.apply_attention(p["attn"], h, cfg, positions=positions,
                                   path=path)
    return x + out, kv


def ffn(p, x: torch.Tensor, cfg: ModelConfig, path: Optional[str] = None):
    """The FFN half of a layer on x (B, S, d): (x + MLP(norm(x)), None), or
    for an MoE layer (x + MoE(norm(x)) over the B·S tokens, its aux loss)."""
    if "moe" in p:
        h = L.apply_norm(p["norm_ffn"], x, cfg)
        y, aux = moe_mod.apply_moe(p["moe"], h.reshape(-1, h.shape[-1]), cfg,
                                   path)
        return x + y.reshape(x.shape), aux
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm_ffn"], x, cfg),
                            cfg, path)
    return x, None


def _sublayer(p, x: torch.Tensor, cfg: ModelConfig, positions, path):
    x, kv = mixer(p, x, cfg, positions, path)
    x, aux = ffn(p, x, cfg, path)
    return x, kv, aux


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


# ---------------------------------------------------------------------------
# Full-sequence forward
# ---------------------------------------------------------------------------


REMAT = ("none", "dots", "full")
# the products whose outputs remat "dots" keeps: B10's autograd form and
# the plain route's 2-D products (aten.mm), the counterparts of the
# reference's dots with no batch dimensions
SAVED_OPS = (grad_ops.MATMUL_OP, torch.ops.aten.mm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in SAVED_OPS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, policy: str):
    """The reference's ``_remat_wrap``: ``none`` keeps every activation;
    ``full`` recomputes the layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant); ``dots`` keeps the
    outputs of ``SAVED_OPS`` and recomputes the rest, attention (B11)
    included, as ``checkpoint_dots_with_no_batch_dims`` keeps the
    reference's projections and recomputes its batched attention
    einsums."""
    if policy not in REMAT:
        raise ValueError(f"unknown remat policy {policy!r}; one of {REMAT}")
    if policy == "none":
        return fn
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _dots_policy) if policy == "dots" \
        else noop_context_fn
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=context_fn)


def unstack_layers(params):
    """Every layer's weights as views of the stacked tensors: each stacked
    leaf ``unbind``-ed once, so its gradient is one ``stack`` of the
    layers' gradients (indexing it once a layer would add a full-size
    zero tensor into its gradient for every layer)."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return torch.unbind(tree)
    return split(params["layers"]["sub0"])


def _layer(p, x: torch.Tensor, positions, cfg: ModelConfig, path):
    x, _, aux = _sublayer(p, x, cfg, positions, path)
    return x, aux if aux is not None else \
        torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            path: Optional[str] = None, remat: str = "none"):
    """tokens (B, S) -> (logits (B, S, vocab), aux loss): the sum of the
    MoE layers' balance terms, as the reference's; a zero for a dense
    model.  ``remat`` (``REMAT``) chooses what the backward pass
    recomputes (``_remat_wrap``)."""
    layer_plan(cfg)
    body = _remat_wrap(functools.partial(_layer, cfg=cfg, path=path), remat)
    x = L.apply_embed(params["embed"], tokens, cfg)
    positions = _positions(x)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in unstack_layers(params):
        x, aux = body(p, x, positions)
        total = total + aux
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x, cfg, path)
    return logits, total


def layer_states(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                 path: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None):
    """tokens (B, S) -> the residual stream (B, S, d_model) after each
    layer, a list of ``n_layers`` tensors: the prefill's forward pass seen
    layer by layer, so that two routes can be held against each other at
    every layer rather than only at the logits.  With ``dtype`` the
    embedding table and each layer's weights are cast to it as they are
    used, one layer's copy at a time: an fp32 route over bf16 weights
    that never holds an fp32 copy of the whole tree."""
    _, _, _, n_units = layer_plan(cfg)
    tok = params["embed"]["tok"]
    x = L.apply_embed({"tok": tok if dtype is None else tok.to(dtype)},
                      tokens, cfg)
    positions = _positions(x)
    states = []
    for i in range(n_units):
        x, _, _ = _sublayer(layer_params(params, i, dtype), x, cfg,
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
    positions = _positions(x)
    cache = init_cache(cfg, B, max_seq, device=x.device)
    for i in range(n_units):
        x, (k, v), _ = _sublayer(layer_params(params, i), x, cfg, positions,
                                 path)
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
        p = layer_params(params, i)
        h = L.apply_norm(p["norm_mixer"], x, cfg)
        out, _, _ = attn.decode_attention(
            p["attn"], h, cache.kv_k[i], cache.kv_v[i], cache.pos, cfg,
            length=cache.length, path=path)
        x, _ = ffn(p, x + out, cfg, path)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x[:, 0], cfg, path)
    return logits, cache._replace(pos=cache.pos + 1, length=cache.length + 1)
