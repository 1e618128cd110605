"""Decoder LM stack of the port: dense, MoE, SSM, hybrid, enc-dec and VLM.

Counterpart of the JAX package's ``models/transformer.py`` for all of
its archs: dense (stablelm-3b, gemma-7b, deepseek-67b, nemotron-4-340b),
MoE (qwen3-moe-30b-a3b, phi3.5-moe), SSM (mamba2-780m), hybrid
(jamba-1.5-large-398b), the enc-dec whisper-large-v3 and the VLM
phi-3-vision-4.2b.  The same parameter tree: the layers run in scan
units of ``layer_plan``'s sublayers (one for every arch but a hybrid,
whose unit is ``hybrid_block`` sublayers: SSD mixers with one attention
at ``hybrid_attn_pos``, an MoE FFN at every ``moe.every``-th), and
sublayer j's weights are stacked over the units under
``params["layers"]["sub<j>"]`` (an enc-dec arch adds
``params["encoder"]`` and, per decoder layer, its cross-attention block
and norm under ``params["cross"]``).  Layer i is sublayer i % unit of
unit i // unit.  The same three entry points:

  forward(params, tokens, cfg)               scoring (full sequence)
  prefill(params, tokens, cfg, max_seq=)     full sequence + decode cache
  decode_step(params, cache, tokens, cfg)    one token against the cache

``forward`` and ``prefill`` take the stub frontends' inputs as the
reference's do: ``patch_embeds`` (B, P, d_model), prepended to the
tokens' embeddings (positions 0..P+S-1), and ``encoder_frames`` (B,
n_ctx, d_model), run through the encoder once (``models/whisper.py``);
each decoder layer then ends with norm, cross-attention into the memory
and a residual, after its MLP.  Prefill keeps each layer's memory keys
and values in the cache's ``cross_kv``; decode reads them and never
writes them.

Each takes ``plan=`` (a ``sharding.ParallelPlan``), which sends the MoE
layers through the two-phase expert-parallel ``apply_moe_two_phase``, as
the reference's ``_moe`` does; ``plan=None`` keeps the one-device layer.
``params_logical`` and ``cache_logical`` give the trees' logical axes for
``models/factory.py``'s specs.

The reference scans its layers; here a Python loop walks them, each
layer's weights a view of the stacked tensors.  ``forward`` is also the
training path's (``training/trainer.py``): with autograd recording, B10
and B11 take their autograd forms (B10 and B12 in the backward pass),
and ``remat`` chooses what the backward pass recomputes.  Every dense
projection and the unembedding go through B10, prefill's attention
through B11 and an MoE layer's router through B5 (``models/moe.py``; the
expert GEMMs are batched ``torch.matmul``, as the reference's are plain
einsums).  An SSD mixer's five in-projections and output projection go
through B10, its scan in torch ops (``models/ssm.py``); a tied arch's
unembedding through B10 on a copy of the table's transpose
(``layers.apply_unembed``).  An MoE layer runs on the B·S tokens of a
prefill and the B tokens of a decode step, as the reference's does.  The
cross-attention's scores run in torch ops
(``attention.apply_cross_attention``), its projections on B10; the
encoder's self-attention on B11.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, NamedTuple, Optional

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
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import whisper


def layer_plan(cfg: ModelConfig):
    """(mixer kinds, ffn kinds, unit size, number of units), the
    reference's: for a hybrid arch a unit of ``hybrid_block`` sublayers,
    SSD mixers but attention at ``hybrid_attn_pos``, an MoE FFN where
    ``i % moe.every == moe.every - 1``; otherwise one sublayer a unit, an
    SSD mixer for the SSM family and attention else, its FFN an MoE where
    ``moe.every == 1``, the dense MLP, or none where ``d_ff`` is 0."""
    if cfg.hybrid_block:
        unit = cfg.hybrid_block
        mixers = ["attn" if i == cfg.hybrid_attn_pos else "ssm"
                  for i in range(unit)]
        e = cfg.moe.every if cfg.moe else 0
        ffns = [("moe" if (cfg.moe and i % e == e - 1) else
                 ("mlp" if cfg.d_ff else "none")) for i in range(unit)]
        return mixers, ffns, unit, cfg.n_layers // unit
    mixers = ["ssm" if cfg.family == "ssm" else "attn"]
    if cfg.moe:
        ffns = ["moe" if cfg.moe.every == 1 else "mlp"]
    else:
        ffns = ["mlp" if cfg.d_ff else "none"]
    return mixers, ffns, 1, cfg.n_layers


def ssm_slots(cfg: ModelConfig) -> List[Optional[int]]:
    """For each sublayer of a unit, its index among the unit's SSD
    mixers (the decode cache's second SSM axis), None for attention."""
    mixers = layer_plan(cfg)[0]
    return [mixers[:j].count("ssm") if m == "ssm" else None
            for j, m in enumerate(mixers)]


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
    layers = {f"sub{j}": _sublayer_init(generator, cfg, mx, ff, dev, lead)
              for j, (mx, ff) in enumerate(zip(mixers, ffns))}
    params = {"embed": L.init_embed(generator, cfg, dev),
              "final_norm": L.init_norm(cfg, dev),
              "layers": layers}
    if cfg.encoder is not None:
        params["encoder"] = whisper.init_encoder(generator, cfg, dev)
        params["cross"] = {"attn": attn.init_attention(generator, cfg, dev,
                                                       lead, cross=True),
                           "norm": L.init_norm(cfg, dev, lead)}
    return params


def _sublayer_init(gen, cfg: ModelConfig, mixer: str, ffn: str,
                   dev: torch.device, lead) -> Dict[str, Any]:
    """One sublayer's weights stacked over ``lead``, as the reference's
    ``_sublayer_init``: ``norm_mixer``, ``attn`` or ``ssm``, and where
    it has an FFN ``norm_ffn`` and ``moe`` or ``mlp``."""
    sub: Dict[str, Any] = {"norm_mixer": L.init_norm(cfg, dev, lead)}
    if mixer == "attn":
        sub["attn"] = attn.init_attention(gen, cfg, dev, lead)
    else:
        sub["ssm"] = ssm_mod.init_ssm(gen, cfg, dev, lead)
    if ffn != "none":
        sub["norm_ffn"] = L.init_norm(cfg, dev, lead)
    if ffn == "moe":
        sub["moe"] = moe_mod.init_moe(gen, cfg, dev, lead)
    elif ffn == "mlp":
        sub["mlp"] = L.init_mlp(gen, cfg, dev, lead)
    return sub


def _sublayer_logical(cfg: ModelConfig, mixer: str, ffn: str):
    lg: Dict[str, Any] = {"norm_mixer": L.norm_logical(cfg)}
    if mixer == "attn":
        lg["attn"] = attn.attention_logical(cfg)
    else:
        lg["ssm"] = ssm_mod.ssm_logical(cfg)
    if ffn != "none":
        lg["norm_ffn"] = L.norm_logical(cfg)
    if ffn == "moe":
        lg["moe"] = moe_mod.moe_logical(cfg)
    elif ffn == "mlp":
        lg["mlp"] = L.mlp_logical(cfg)
    return lg


def params_logical(cfg: ModelConfig):
    """The parameter tree's logical axes (``sharding/partitioning.py``),
    each stacked leaf with the leading "layers" axis, as the
    reference's."""
    mixers, ffns, _, _ = layer_plan(cfg)

    def stacked(tree):
        return {k: stacked(v) if isinstance(v, dict) else ("layers",) + v
                for k, v in tree.items()}
    lg = {"embed": L.embed_logical(cfg),
          "final_norm": L.norm_logical(cfg),
          "layers": {f"sub{j}": stacked(_sublayer_logical(cfg, mx, ff))
                     for j, (mx, ff) in enumerate(zip(mixers, ffns))}}
    if cfg.encoder is not None:
        lg["encoder"] = whisper.encoder_logical(cfg)
        lg["cross"] = stacked({"attn": attn.attention_logical(cfg,
                                                              cross=True),
                               "norm": L.norm_logical(cfg)})
    return lg


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's leaf shapes, from ``init_params`` on the meta
    device (nothing allocated)."""
    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)
    return shapes(init_params(cfg, device="meta"))


def layer_params(params, i: int, dtype: Optional[torch.dtype] = None,
                 part: str = "layers"):
    """Layer ``i``'s weights (sublayer i % unit of unit i // unit): views
    of the stacked tensors (no copies), or with ``dtype`` one layer's
    copy cast to it; ``part="cross"`` takes unit ``i``'s cross-attention
    block and norm instead."""
    if part != "layers":
        return L.take_layer(params[part], i, dtype)
    subs = params["layers"]
    u, j = divmod(i, len(subs))
    return L.take_layer(subs[f"sub{j}"], u, dtype)


def mixer(p, x: torch.Tensor, cfg: ModelConfig, positions,
          path: Optional[str] = None):
    """The mixer half of a layer (weights ``p``) on the residual stream
    x (B, S, d): (x + mixer(norm(x)), the state it leaves for decode: an
    attention layer's (k, v), an SSD mixer's ``SSMCache``)."""
    h = L.apply_norm(p["norm_mixer"], x, cfg)
    if "ssm" in p:
        out, state = ssm_mod.apply_ssm(p["ssm"], h, cfg, path=path)
    else:
        out, state = attn.apply_attention(p["attn"], h, cfg,
                                          positions=positions, path=path)
    return x + out, state


def ffn(p, x: torch.Tensor, cfg: ModelConfig, path: Optional[str] = None,
        plan=None):
    """The FFN half of a layer on x (B, S, d): (x + MLP(norm(x)), None), or
    for an MoE layer (x + MoE(norm(x)) over the B·S tokens, its aux loss):
    the two-phase expert-parallel MoE where a ``ParallelPlan`` is given,
    as the reference's ``_moe`` takes it."""
    if "moe" in p:
        h = L.apply_norm(p["norm_ffn"], x, cfg)
        h2 = h.reshape(-1, h.shape[-1])
        y, aux = moe_mod.apply_moe(p["moe"], h2, cfg, path) if plan is None \
            else moe_mod.apply_moe_two_phase(p["moe"], h2, cfg, plan, path)
        return x + y.reshape(x.shape), aux
    if "mlp" in p:
        x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["norm_ffn"], x, cfg),
                            cfg, path)
    return x, None


def cross(cp, x: torch.Tensor, memory_kv, cfg: ModelConfig,
          path: Optional[str] = None) -> torch.Tensor:
    """An enc-dec decoder layer's last part (weights ``cp``: its
    cross-attention block and norm): x + cross-attention(norm(x)) into the
    memory's (k, v)."""
    h = L.apply_norm(cp["norm"], x, cfg)
    return x + attn.apply_cross_attention(cp["attn"], h, memory_kv, cfg,
                                          path)


def _sublayer(p, x: torch.Tensor, cfg: ModelConfig, positions, path,
              plan=None, cp=None, memory=None):
    """One decoder layer: (x out, its mixer's state (``mixer``), the MoE
    aux loss or None, the memory's (k, v) where ``cp`` (a unit's last
    layer of an enc-dec arch) is given, or None)."""
    x, state = mixer(p, x, cfg, positions, path)
    x, aux = ffn(p, x, cfg, path, plan)
    memory_kv = None
    if cp is not None:
        memory_kv = attn.encode_cross_kv(cp["attn"], memory, cfg, path)
        x = cross(cp, x, memory_kv, cfg, path)
    return x, state, aux, memory_kv


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S, _ = x.shape
    return torch.arange(S, device=x.device).expand(B, S)


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig, patch_embeds,
           dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The tokens' embeddings (B, S_tok, d), after the patch embeddings
    (B, P, d) cast to their dtype where a VLM's are given.  With ``dtype``
    only the rows the tokens take are cast to it, never the whole
    table."""
    if dtype is None:
        x = L.apply_embed(params["embed"], tokens, cfg)
    else:
        rows, inv = torch.unique(tokens, return_inverse=True)
        x = L.apply_embed({"tok": params["embed"]["tok"][rows].to(dtype)},
                          inv, cfg)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _frontend_check(cfg: ModelConfig, patch_embeds, encoder_frames):
    """The stub frontends' inputs a config takes: frames, and only frames,
    for an enc-dec arch; patches only for a VLM."""
    if (cfg.encoder is None) != (encoder_frames is None):
        raise ValueError(
            f"{cfg.arch_id}: encoder_frames (B, n_ctx, d_model) are "
            f"{'required' if cfg.encoder is not None else 'only for'} "
            "enc-dec archs")
    if cfg.vision is None and patch_embeds is not None:
        raise ValueError(f"{cfg.arch_id}: patch_embeds are only for VLM "
                         "archs")


def _memory(params, cfg: ModelConfig, encoder_frames, path):
    """The encoder memory of an enc-dec arch (None otherwise)."""
    if cfg.encoder is None:
        return None
    return whisper.apply_encoder(params["encoder"], encoder_frames, cfg,
                                 path=path)


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


def unstack_layers(params, part: str = "layers"):
    """Every layer's weights as views of the stacked tensors, in the order
    the layers run: each stacked leaf ``unbind``-ed once, so its gradient
    is one ``stack`` of the layers' gradients (indexing it once a layer
    would add a full-size zero tensor into its gradient for every layer).
    ``part="cross"``: the units' cross-attention blocks and norms."""
    def split(tree):
        if isinstance(tree, dict):
            parts = {k: split(v) for k, v in tree.items()}
            n = len(next(iter(parts.values())))
            return [{k: v[i] for k, v in parts.items()} for i in range(n)]
        return torch.unbind(tree)
    if part != "layers":
        return split(params[part])
    subs = [split(params["layers"][f"sub{j}"])
            for j in range(len(params["layers"]))]
    return [s[u] for u in range(len(subs[0])) for s in subs]


def _layer(p, x: torch.Tensor, positions, cp, memory, cfg: ModelConfig,
           path, plan=None):
    x, _, aux, _ = _sublayer(p, x, cfg, positions, path, plan, cp, memory)
    return x, aux if aux is not None else \
        torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            patch_embeds: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None,
            path: Optional[str] = None, remat: str = "none", plan=None):
    """tokens (B, S_tok) -> (logits (B, S, vocab), aux loss): the sum of
    the MoE layers' balance terms, as the reference's; a zero for a dense
    model.  A VLM's ``patch_embeds`` (B, P, d_model) come first (S = P +
    S_tok); an enc-dec arch's ``encoder_frames`` (B, n_ctx, d_model) go
    through the encoder, whose memory each decoder layer cross-attends
    into.  ``remat`` (``REMAT``) chooses what the backward pass
    recomputes (``_remat_wrap``); ``plan`` (a ``ParallelPlan``) sends
    the MoE layers through ``apply_moe_two_phase``."""
    _, _, unit, _ = layer_plan(cfg)
    _frontend_check(cfg, patch_embeds, encoder_frames)
    body = _remat_wrap(functools.partial(_layer, cfg=cfg, path=path,
                                         plan=plan), remat)
    x = _embed(params, tokens, cfg, patch_embeds)
    positions = _positions(x)
    memory = _memory(params, cfg, encoder_frames, path)
    crosses = unstack_layers(params, "cross") if memory is not None \
        else None
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(unstack_layers(params)):
        u, j = divmod(i, unit)
        cp = crosses[u] if crosses is not None and j == unit - 1 else None
        x, aux = body(p, x, positions, cp, memory)
        total = total + aux
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x, cfg, path)
    return logits, total


def layer_states(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                 patch_embeds: Optional[torch.Tensor] = None,
                 encoder_frames: Optional[torch.Tensor] = None,
                 path: Optional[str] = None,
                 dtype: Optional[torch.dtype] = None, plan=None):
    """tokens (B, S_tok) -> the residual stream after each layer: the
    prefill's forward pass seen layer by layer, so that two routes can be
    held against each other at every layer rather than only at the
    logits.  A list of one tensor (B, S, d_model) a layer (a hybrid's
    sublayers each count as one), after the
    encoder's ``encoder.n_layers`` (B, n_ctx, d_model) for an enc-dec
    arch.  With ``dtype`` the embedding rows the tokens take, the stub
    frontends' inputs and each layer's weights are cast to it as they are
    used, one layer's copy at a time: an fp32 route over bf16 weights
    that never holds an fp32 copy of the whole tree."""
    _, _, unit, n_units = layer_plan(cfg)
    _frontend_check(cfg, patch_embeds, encoder_frames)
    x = _embed(params, tokens, cfg, patch_embeds, dtype)
    positions = _positions(x)
    states: List[torch.Tensor] = []
    memory = None
    if cfg.encoder is not None:
        states, memory = whisper.encoder_states(
            params["encoder"], encoder_frames, cfg, path=path, dtype=dtype)
    for i in range(unit * n_units):
        u, j = divmod(i, unit)
        cp = None if memory is None or j != unit - 1 else \
            layer_params(params, u, dtype, part="cross")
        x, _, _, _ = _sublayer(layer_params(params, i, dtype), x, cfg,
                               positions, path, plan, cp, memory)
        states.append(x)
    return states


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


class CrossKV(NamedTuple):
    """An enc-dec arch's memory keys and values, each (n_layers, B, n_ctx,
    Hkv, hd): the reference's (k, v) pair, written by prefill and only
    read by decode."""
    k: Any
    v: Any


class DecodeCache(NamedTuple):
    kv_k: Optional[torch.Tensor]   # (n_units, B, S_max, Hkv, hd)
    kv_v: Optional[torch.Tensor]
    pos: torch.Tensor      # (B,) int32: the next position to write
    length: int            # the same position, on the host
    cross_kv: Optional[CrossKV] = None    # enc-dec archs only
    ssm: Optional[ssm_mod.SSMCache] = None  # (n_units, n_ssm, B, ...)


def cache_logical(cfg: ModelConfig, long_context: bool = False):
    """Logical specs for the decode cache.  The reference's k and v are
    (n_units, n_attn_per_unit, B, S_max, Hkv, hd) with ("blocks",
    "layers", ...); every layer plan has at most one attention sublayer a
    unit, so the port's (n_units, B, S_max, Hkv, hd) drop the "layers"
    axis (both axes map to no mesh axis).  Its SSM state keeps the
    reference's (n_units, n_ssm_per_unit, ...) and ("blocks", "layers",
    ...), since a hybrid unit holds several SSD mixers (jamba's seven).
    A field the layer plan has no use for is None, as in the reference:
    k and v without attention, ``ssm`` without an SSD mixer.
    ``length``, a host int, is replicated (``()``).  An enc-dec arch's
    ``cross_kv`` takes the reference's spec, which has no "layers" axis.
    For ``long_context`` (batch 1) the caller's rules shard the KV
    sequence over the data axes instead of the batch."""
    mixers = layer_plan(cfg)[0]
    kv = ("blocks", "batch", "kv_seq", "kv_heads", "kv_hd") \
        if "attn" in mixers else None
    ssm = ssm_mod.SSMCache(*(("blocks", "layers") + lg for lg in
                             ssm_mod.ssm_cache_logical(cfg))) \
        if "ssm" in mixers else None
    cross_kv = None
    if cfg.encoder is not None:
        c = ("blocks", "batch", "frames", "kv_heads", "kv_hd")
        cross_kv = CrossKV(c, c)
    return DecodeCache(kv_k=kv, kv_v=kv, pos=("batch",), length=(),
                       cross_kv=cross_kv, ssm=ssm)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype: Optional[torch.dtype] = None, *,
               device: DeviceLike = None) -> DecodeCache:
    mixers, _, _, n_units = layer_plan(cfg)
    dev = resolve_device(device)
    dt = dtype or L.torch_dtype(cfg)
    kv_k = kv_v = None
    if "attn" in mixers:
        shape = (n_units, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        kv_k = torch.zeros(shape, dtype=dt, device=dev)
        kv_v = torch.zeros(shape, dtype=dt, device=dev)
    ssm = None
    if "ssm" in mixers:
        ssm = ssm_mod.init_ssm_cache(cfg, batch, dt, device=dev,
                                     lead=(n_units, mixers.count("ssm")))
    cross_kv = None
    if cfg.encoder is not None:
        c = (n_units, batch, cfg.encoder.n_ctx, cfg.n_kv_heads, cfg.head_dim)
        cross_kv = CrossKV(torch.zeros(c, dtype=dt, device=dev),
                           torch.zeros(c, dtype=dt, device=dev))
    return DecodeCache(kv_k=kv_k, kv_v=kv_v,
                       pos=torch.zeros((batch,), dtype=torch.int32,
                                       device=dev),
                       length=0, cross_kv=cross_kv, ssm=ssm)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, *,
            max_seq: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            encoder_frames: Optional[torch.Tensor] = None,
            path: Optional[str] = None, plan=None):
    """tokens (B, S_tok) -> (last-position logits (B, vocab), DecodeCache
    with the prompt's k and v in positions [0, S) of ``max_seq``, S = P +
    S_tok where a VLM's ``patch_embeds`` (B, P, d_model) come first; an
    SSD mixer's conv windows and final state; for an enc-dec arch, with
    every layer's memory (k, v) from ``encoder_frames`` in
    ``cross_kv``).  A prompt longer than ``max_seq`` raises: the
    reference's prefill leaves such a cache at S positions, and its
    decode then writes every token at the last one (ROADMAP C)."""
    _, _, unit, n_units = layer_plan(cfg)
    slots = ssm_slots(cfg)
    _frontend_check(cfg, patch_embeds, encoder_frames)
    x = _embed(params, tokens, cfg, patch_embeds)
    B, S, _ = x.shape
    max_seq = max_seq or S
    if S > max_seq:
        raise ValueError(f"prompt of {S} positions exceeds max_seq="
                         f"{max_seq}")
    positions = _positions(x)
    cache = init_cache(cfg, B, max_seq, device=x.device)
    memory = _memory(params, cfg, encoder_frames, path)
    for i in range(unit * n_units):
        u, j = divmod(i, unit)
        cp = None if memory is None or j != unit - 1 else \
            layer_params(params, u, part="cross")
        x, state, _, memory_kv = _sublayer(layer_params(params, i), x, cfg,
                                           positions, path, plan, cp,
                                           memory)
        if slots[j] is None:
            cache.kv_k[u, :, :S] = state[0]
            cache.kv_v[u, :, :S] = state[1]
        else:
            for dst, src in zip(cache.ssm, state):
                dst[u, slots[j]] = src
        if memory_kv is not None:
            cache.cross_kv.k[u] = memory_kv[0]
            cache.cross_kv.v[u] = memory_kv[1]
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x[:, -1], cfg, path)
    return logits, cache._replace(
        pos=torch.full((B,), S, dtype=torch.int32, device=x.device),
        length=S)


def decode_step(params, cache: DecodeCache, tokens: torch.Tensor,
                cfg: ModelConfig, *, path: Optional[str] = None, plan=None):
    """tokens (B, 1) -> (logits (B, vocab), cache advanced by one), every
    row at one position (the reference's ``aligned=True``).

    The cache's tensors are written in place (see
    ``attention.decode_attention``; an SSD mixer's windows and state are
    copied into their slots): the returned cache holds the same tensors,
    and the one passed in is spent."""
    _, _, unit, n_units = layer_plan(cfg)
    slots = ssm_slots(cfg)
    if cache.kv_k is not None and cache.length >= cache.kv_k.shape[2]:
        raise ValueError(f"the cache is full: {cache.length} of "
                         f"{cache.kv_k.shape[2]} positions written")
    x = L.apply_embed(params["embed"], tokens, cfg)
    for i in range(unit * n_units):
        u, j = divmod(i, unit)
        p = layer_params(params, i)
        h = L.apply_norm(p["norm_mixer"], x, cfg)
        if slots[j] is None:
            out, _, _ = attn.decode_attention(
                p["attn"], h, cache.kv_k[u], cache.kv_v[u], cache.pos, cfg,
                length=cache.length, path=path)
        else:
            state = ssm_mod.SSMCache(*(t[u, slots[j]] for t in cache.ssm))
            out, state = ssm_mod.decode_ssm(p["ssm"], h, state, cfg, path)
            for dst, src in zip(cache.ssm, state):
                dst[u, slots[j]] = src
        x, _ = ffn(p, x + out, cfg, path, plan)
        if cache.cross_kv is not None and j == unit - 1:
            x = cross(layer_params(params, u, part="cross"), x,
                      (cache.cross_kv.k[u], cache.cross_kv.v[u]), cfg, path)
    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.apply_unembed(params["embed"], x[:, 0], cfg, path)
    return logits, cache._replace(pos=cache.pos + 1, length=cache.length + 1)
