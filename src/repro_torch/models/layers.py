"""Shared model layers of the port's LM stack: norms, rotary embeddings, MLP
variants, embeddings, and ``linear``, through which every dense projection
runs.

Counterpart of the JAX package's ``models/layers.py``, with the same
parameter trees (plain dicts of tensors) and the same arithmetic: norms
and rotary embeddings in fp32, cast back to the activations' dtype.
Weights keep the reference's (in, out) layout, so ``linear(x, w)`` is the
reference's ``x @ w``; it flattens x to rows and calls B10
(``ops.matmul``, or in training its autograd form), or with the plain
route its plain version, which autograd differentiates as it is.

The plain route: ``path="ref"``, or no path and ``REPRO_BACKEND=ref``,
sends B10, B11 and the MoE router's B5 to ``kernels/ref.py``;
``path=None`` or ``"fused"`` takes the kernels (on a card; the wrappers
run the plain versions for CPU tensors either way).  The LM ops have no
other arm, so any other ``REPRO_BACKEND`` leaves them on the kernels.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import autograd as grad_ops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dispatch import ENV_VAR

ROUTES = (None, "fused", "ref")


def plain_route(path: Optional[str] = None) -> bool:
    """Whether B10, B11 and B5 (the MoE router) take their plain versions
    (see the module docstring)."""
    if path not in ROUTES:
        raise ValueError(f"unknown LM path {path!r}; one of {ROUTES}")
    if path is None:
        return os.environ.get(ENV_VAR) == "ref"
    return path == "ref"


def linear(x: torch.Tensor, w: torch.Tensor,
           path: Optional[str] = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) -> (..., N) as one (rows, K) x (K, N) product
    through B10 (one launch).  Where autograd records (grad mode on and x
    or w requiring a gradient), B10's autograd form, whose backward is two
    more B10 launches (``kernels/autograd.py``); serving calls B10
    directly."""
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    if plain_route(path):
        mm = ref.matmul
    elif grad_ops.records(rows, w):
        mm = grad_ops.matmul
    else:
        mm = ops.matmul
    return mm(rows, w).reshape(*x.shape[:-1], w.shape[1])


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# the most fp32 elements ``normal_init`` draws at once (1 GiB)
DRAW_ELEMS = 1 << 28


def normal_init(gen: Optional[torch.Generator], shape, scale: float,
                dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, scale²) values of ``shape`` in ``dtype``, drawn in fp32 and
    cast, at most ``DRAW_ELEMS`` rows' worth at a time: a full-width table
    or a stack of layers never has a whole fp32 copy (a tensor of at most
    ``DRAW_ELEMS`` elements is one draw).  On the ``meta`` device nothing
    is drawn."""
    out = torch.empty(shape, dtype=dtype, device=device)
    if device.type == "meta" or out.numel() == 0:
        return out
    rows = out.view(-1, shape[-1])
    step = max(1, DRAW_ELEMS // shape[-1])
    for lo in range(0, rows.shape[0], step):
        part = rows[lo:lo + step]
        part.copy_(torch.randn(part.shape, generator=gen,
                               dtype=torch.float32, device=device)
                   .mul_(scale))
    return out


def dense_init(gen: Optional[torch.Generator], in_dim: int, out_dim: int,
               dtype: torch.dtype, device: torch.device, lead=(),
               scale: Optional[float] = None) -> torch.Tensor:
    """N(0, 1/in_dim) weights of shape lead + (in_dim, out_dim), drawn in
    fp32 and cast, as the reference's ``dense_init``
    (``normal_init``)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return normal_init(gen, (*lead, in_dim, out_dim), scale, dtype, device)


def take_layer(tree, i: Optional[int], dtype: Optional[torch.dtype] = None):
    """Layer ``i`` of a tree of leaves stacked on a leading layer axis:
    views (no copies), or with ``dtype`` one layer's copy cast to it;
    ``i=None`` takes each leaf whole."""
    if isinstance(tree, dict):
        return {k: take_layer(v, i, dtype) for k, v in tree.items()}
    t = tree if i is None else tree[i]
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, device: torch.device, lead=()):
    dt = torch_dtype(cfg)
    p = {"scale": torch.ones((*lead, cfg.d_model), dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, cfg.d_model), dtype=dt,
                                device=device)
    return p


def norm_logical(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    return {"scale": ("embed",)}


def apply_norm(params, x: torch.Tensor, cfg: ModelConfig,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].to(torch.float32) + \
            params["bias"].to(torch.float32)
    else:
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return y.to(x.dtype)


def rms_norm_vec(x: torch.Tensor, scale: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Headwise RMSNorm (qk-norm)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) *
            scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., seq, heads, head_dim); positions broadcastable to
    (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n_ctx: int, d_model: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper-style fixed sinusoidal table (n_ctx, d_model) in fp32: sines
    of the first d_model/2 frequencies, then cosines, as the reference's
    ``sinusoidal_positions``."""
    pos = torch.arange(n_ctx, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / max(d_model // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP variants (swiglu | geglu | squared_relu | gelu)
# ---------------------------------------------------------------------------


def mlp_is_gated(mlp_type: str) -> bool:
    return mlp_type in ("swiglu", "geglu")


def init_mlp(gen, cfg: ModelConfig, device: torch.device, lead=()):
    dt = torch_dtype(cfg)
    p = {"w_in": dense_init(gen, cfg.d_model, cfg.d_ff, dt, device, lead),
         "w_out": dense_init(gen, cfg.d_ff, cfg.d_model, dt, device, lead)}
    if mlp_is_gated(cfg.mlp_type):
        p["w_gate"] = dense_init(gen, cfg.d_model, cfg.d_ff, dt, device,
                                 lead)
    return p


def mlp_logical(cfg: ModelConfig):
    lg = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}
    if mlp_is_gated(cfg.mlp_type):
        lg["w_gate"] = ("embed", "mlp")
    return lg


def apply_mlp(params, x: torch.Tensor, cfg: ModelConfig,
              path: Optional[str] = None) -> torch.Tensor:
    h = linear(x, params["w_in"], path)
    if cfg.mlp_type == "swiglu":
        h = F.silu(linear(x, params["w_gate"], path)) * h
    elif cfg.mlp_type == "geglu":
        h = F.gelu(linear(x, params["w_gate"], path),
                   approximate="tanh") * h
    elif cfg.mlp_type == "squared_relu":
        h = torch.square(F.relu(h))
    elif cfg.mlp_type == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp_type {cfg.mlp_type}")
    return linear(h, params["w_out"], path)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(gen, cfg: ModelConfig, device: torch.device):
    dt = torch_dtype(cfg)
    p = {"tok": normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dt,
                            device)}
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                  device)
    return p


def embed_logical(cfg: ModelConfig):
    lg = {"tok": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        lg["unembed"] = ("embed", "vocab")
    return lg


def apply_embed(params, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    x = params["tok"][tokens]
    if cfg.arch_id.startswith("gemma"):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    return x


def apply_unembed(params, x: torch.Tensor, cfg: ModelConfig,
                  path: Optional[str] = None) -> torch.Tensor:
    """x (..., d_model) -> logits (..., vocab) through B10.  A tied arch
    (``cfg.tie_embeddings``) multiplies by the embedding table's
    transpose, the reference's ``x @ tok.T``: B10 takes its weight as
    (in, out), so a contiguous (d_model, vocab) copy of the (vocab,
    d_model) table is made for each call (its bytes once more a forward
    pass; a B10 form that reads the table in place is ROADMAP P14).  With
    autograd recording the copy stays on the graph, so the table's
    gradient sums its embedding and unembedding parts."""
    w = params["tok"].t().contiguous() if cfg.tie_embeddings \
        else params["unembed"]
    return linear(x, w, path)
