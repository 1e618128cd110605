"""Whisper-style encoder stack of the port (the conv frontend stubbed: the
caller passes precomputed frame embeddings (B, n_ctx, d_model)).

Counterpart of the JAX package's ``models/whisper.py``: the encoder's
layers stacked on a leading axis, as the decoder's are; each layer a
norm, bidirectional self-attention on B11 (``attention.apply_attention``
with ``causal=False``), a residual, a norm and the gelu MLP on B10; a
final norm.  The decoder lives in ``models/transformer.py`` and
cross-attends into the memory this returns.

It follows the reference, not OpenAI's Whisper: the frames get the
sinusoidal table added, and then each encoder layer's attention also
rotates its q and k by RoPE at positions 0..n_ctx-1, since the
reference's encoder attention projects through the same ``_project_qkv``
as its decoder's; the decoder has RoPE and no learned positions.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


def init_encoder(gen, cfg: ModelConfig, device: torch.device
                 ) -> Dict[str, Any]:
    lead = (cfg.encoder.n_layers,)
    return {"layers": {"norm_attn": L.init_norm(cfg, device, lead),
                       "attn": attn.init_attention(gen, cfg, device, lead),
                       "norm_mlp": L.init_norm(cfg, device, lead),
                       "mlp": L.init_mlp(gen, cfg, device, lead)},
            "final_norm": L.init_norm(cfg, device)}


def encoder_logical(cfg: ModelConfig):
    def stacked(tree):
        return {k: stacked(v) if isinstance(v, dict) else ("layers",) + v
                for k, v in tree.items()}
    return {"layers": stacked({"norm_attn": L.norm_logical(cfg),
                               "attn": attn.attention_logical(cfg),
                               "norm_mlp": L.norm_logical(cfg),
                               "mlp": L.mlp_logical(cfg)}),
            "final_norm": L.norm_logical(cfg)}


def embed_frames(frames: torch.Tensor) -> torch.Tensor:
    """The encoder's input: the frames plus the sinusoidal table, cast to
    the frames' dtype first."""
    _, S, D = frames.shape
    sinus = L.sinusoidal_positions(S, D, frames.device).to(frames.dtype)
    return frames + sinus[None]


def encoder_layer(p, x: torch.Tensor, cfg: ModelConfig,
                  path: Optional[str] = None) -> torch.Tensor:
    h = L.apply_norm(p["norm_attn"], x, cfg)
    out, _ = attn.apply_attention(p["attn"], h, cfg, causal=False,
                                  path=path)
    x = x + out
    h = L.apply_norm(p["norm_mlp"], x, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg, path)


def encoder_states(params, frames: torch.Tensor, cfg: ModelConfig, *,
                   path: Optional[str] = None,
                   dtype: Optional[torch.dtype] = None, keep: bool = True
                   ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """frames (B, n_ctx, d_model) -> (the residual stream after each
    encoder layer, empty unless ``keep``; the memory, the last one's final
    norm).  With ``dtype`` the frames and each layer's weights are cast to
    it as they are used, one layer's copy at a time."""
    x = embed_frames(frames if dtype is None else frames.to(dtype))
    states = []
    for i in range(cfg.encoder.n_layers):
        x = encoder_layer(L.take_layer(params["layers"], i, dtype), x, cfg,
                          path)
        if keep:
            states.append(x)
    return states, L.apply_norm(
        L.take_layer(params["final_norm"], None, dtype), x, cfg)


def apply_encoder(params, frames: torch.Tensor, cfg: ModelConfig, *,
                  path: Optional[str] = None) -> torch.Tensor:
    """frames (B, n_ctx, d_model) -> the encoder memory (B, n_ctx,
    d_model)."""
    return encoder_states(params, frames, cfg, path=path, keep=False)[1]
