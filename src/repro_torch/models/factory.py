"""Model factory of the port: config -> parameters, logical sharding specs
and input trees for every assigned shape.

Counterpart of the JAX package's ``models/factory.py`` for the dense,
MoE, enc-dec and VLM families (an enc-dec arch's ``encoder`` and
``cross`` params and its cache's ``cross_kv`` pair included).  Shapes
come from the ``meta`` device (nothing is allocated):
``transformer.param_shapes`` for the params, ``make_batch`` with
``abstract=True`` for a step's inputs, ``cache_shapes`` for the decode
cache; the specs resolve their logical axes against a
``MeshConfig`` (``sharding/partitioning.py``), leaf by leaf with the
reference's divisibility fix-up.  Real batches are drawn from a
``torch.Generator``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import MeshConfig, ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import torch_dtype
from repro_torch.sharding.partitioning import (leaf_shape, map_logical,
                                               to_pspec)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None) -> Dict[str, Any]:
    return transformer.init_params(cfg, generator, device=device)


def params_logical(cfg: ModelConfig):
    return transformer.params_logical(cfg)


def param_pspecs(cfg: ModelConfig, mesh_cfg: MeshConfig, params_shape=None,
                 rules=None):
    """Tree of PartitionSpec matching ``init_params``' structure.

    When ``params_shape`` (a tree of shapes or meta tensors, e.g.
    ``transformer.param_shapes(cfg)``) is given, divisibility is checked
    per leaf and non-divisible axes are dropped.  ``rules``: logical-rule
    overrides (e.g. no-TP for small archs)."""
    logical = params_logical(cfg)
    if params_shape is None:
        return map_logical(lambda lg: to_pspec(lg, mesh_cfg, rules=rules),
                           logical)
    return map_logical(
        lambda lg, sh: to_pspec(lg, mesh_cfg, shape=leaf_shape(sh),
                                rules=rules),
        logical, params_shape)


# ---------------------------------------------------------------------------
# Model inputs per shape (meta tensors for the dry run; real ones for runs)
# ---------------------------------------------------------------------------


def _token_split(cfg: ModelConfig, seq_len: int) -> int:
    """VLM archs spend part of the sequence budget on patch embeddings."""
    if cfg.vision is not None:
        return seq_len - cfg.vision.num_patches
    return seq_len


def batch_logical(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    lg: Dict[str, Any] = {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        lg["targets"] = ("batch", "seq")
    if cfg.vision is not None and shape.kind != "decode":
        lg["patch_embeds"] = ("batch", "patches", "embed")
    if cfg.encoder is not None and shape.kind != "decode":
        lg["encoder_frames"] = ("batch", "frames", "embed")
    return lg


def make_batch(cfg: ModelConfig, shape: ShapeConfig, *,
               abstract: bool = True,
               generator: Optional[torch.Generator] = None,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Inputs for one step.  ``abstract=True`` -> tensors on the ``meta``
    device (the dry run); otherwise token ids uniform in the vocabulary
    and N(0, 0.02²) embeddings drawn from ``generator`` on ``device``."""
    B = shape.global_batch
    S_tok = 1 if shape.is_decode else _token_split(cfg, shape.seq_len)
    dev = torch.device("meta") if abstract else resolve_device(device)
    if not abstract and generator is None:
        raise ValueError("make_batch(abstract=False) draws its inputs from "
                         "generator= (a torch.Generator on the device)")

    def mk(shp, dtype):
        if abstract:
            return torch.empty(shp, dtype=dtype, device=dev)
        if not dtype.is_floating_point:
            return torch.randint(0, cfg.vocab_size, shp, generator=generator,
                                 dtype=dtype, device=dev)
        return torch.randn(shp, generator=generator, dtype=torch.float32,
                           device=dev).mul_(0.02).to(dtype)

    out: Dict[str, torch.Tensor] = {"tokens": mk((B, S_tok), torch.int32)}
    if shape.kind == "train":
        out["targets"] = mk((B, S_tok), torch.int32)
    if cfg.vision is not None and shape.kind != "decode":
        out["patch_embeds"] = mk((B, cfg.vision.num_patches, cfg.d_model),
                                 torch_dtype(cfg))
    if cfg.encoder is not None and shape.kind != "decode":
        out["encoder_frames"] = mk((B, cfg.encoder.n_ctx, cfg.d_model),
                                   torch_dtype(cfg))
    return out


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig):
    lg = batch_logical(cfg, shape)
    batch_tree = make_batch(cfg, shape, abstract=True)
    return map_logical(
        lambda lgl, t: to_pspec(lgl, mesh_cfg, shape=leaf_shape(t)),
        lg, batch_tree)


def cache_shapes(cfg: ModelConfig, shape: ShapeConfig):
    """The decode cache of a decode-kind shape on the ``meta`` device."""
    return transformer.init_cache(cfg, shape.global_batch, shape.seq_len,
                                  device="meta")


# flash-decoding style cache layout: shard the KV sequence over the model
# axis so decode attention is a local partial softmax + tiny psum of stats
# (the paper's local->global combine) instead of a cache all-gather.
# Toggled by the dry run's --decode-seq-shard.
DECODE_SEQ_SHARD = False


def cache_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig):
    long_context = shape.global_batch < mesh_cfg.data  # batch can't shard
    lg = transformer.cache_logical(cfg, long_context=long_context)
    if DECODE_SEQ_SHARD:
        rules = {"kv_seq": (("dp", "model") if long_context else ("model",)),
                 "kv_hd": ()}
    else:
        rules = {"kv_seq": ("dp",)} if long_context else None
    cache = cache_shapes(cfg, shape)
    return map_logical(
        lambda lgl, t: to_pspec(lgl, mesh_cfg, shape=leaf_shape(t),
                                rules=rules),
        lg, cache)
