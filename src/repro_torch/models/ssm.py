"""Mamba2 / SSD (state-space duality) mixer of the port [arXiv:2405.21060].

Counterpart of the JAX package's ``models/ssm.py``, with the same
parameter tree, logical axes and decode state.  The sequence is split
into chunks of length Q: within a chunk the recurrence is a masked-decay
quadratic product, and one (H, P, N) state a chunk is carried across
chunks in a loop (the reference's ``lax.scan``).  Decode is the O(1)
recurrent update h' = exp(dt·A)·h + dt·B⊗x; y = C·h + D·x.

The five in-projections and ``w_out`` go through ``layers.linear``, so
they run on B10 as every dense projection of the port does (``path=``
as there).  The SSD's einsums, the causal conv, the softplus and the
segment sums are torch ops in fp32, as the reference computes them in
jnp with no Pallas kernel.

``apply_ssm`` returns the decode state the sequence leaves beside its
output: the final state and the conv windows, the last W-1
pre-activation conv inputs from the projections it has already made
(the reference's prefill projects them a second time,
``transformer._ssm_conv_tail``; a prompt shorter than W-1 is padded
with zeros on the left, the causal conv's own padding).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_ssm(gen, cfg: ModelConfig, device: torch.device, lead=()):
    """Seeded weights of one SSD mixer (``lead``: stacked layers), drawn
    from ``gen`` as ``layers.dense_init`` draws them; the conv taps N(0,
    0.1²); A_log, D and dt_bias in fp32 as the reference keeps them."""
    c = cfg.ssm
    dt = L.torch_dtype(cfg)
    d, d_in, H = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    GN = c.n_groups * c.d_state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wz": L.dense_init(gen, d, d_in, dt, device, lead),
        "wx": L.dense_init(gen, d, d_in, dt, device, lead),
        "wB": L.dense_init(gen, d, GN, dt, device, lead),
        "wC": L.dense_init(gen, d, GN, dt, device, lead),
        "wdt": L.dense_init(gen, d, H, dt, device, lead),
        "conv_x": L.normal_init(gen, (*lead, c.conv_width, d_in), 0.1, dt,
                                device),
        "conv_B": L.normal_init(gen, (*lead, c.conv_width, GN), 0.1, dt,
                                device),
        "conv_C": L.normal_init(gen, (*lead, c.conv_width, GN), 0.1, dt,
                                device),
        "A_log": torch.zeros((*lead, H), **f32),
        "D": torch.ones((*lead, H), **f32),
        "dt_bias": torch.full((*lead, H), -2.0, **f32),
        "norm_scale": torch.ones((*lead, d_in), dtype=dt, device=device),
        "w_out": L.dense_init(gen, d_in, d, dt, device, lead),
    }


def ssm_logical(cfg: ModelConfig):
    return {
        "wz": ("embed", "d_inner"),
        "wx": ("embed", "d_inner"),
        "wB": ("embed", "state"),
        "wC": ("embed", "state"),
        "wdt": ("embed", "ssm_heads"),
        "conv_x": ("conv", "d_inner"),
        "conv_B": ("conv", "state"),
        "conv_C": ("conv", "state"),
        "A_log": ("ssm_heads",),
        "D": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm_scale": ("d_inner",),
        "w_out": ("d_inner", "embed"),
    }


class SSMCache(NamedTuple):
    """Decode-time recurrent state of one layer (stacked in the decode
    cache with leading (n_units, n_ssm) axes)."""

    conv_x: torch.Tensor   # (B, W-1, d_inner)
    conv_B: torch.Tensor   # (B, W-1, G*N)
    conv_C: torch.Tensor   # (B, W-1, G*N)
    h: torch.Tensor        # (B, H, P, N) float32


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   dtype: Optional[torch.dtype] = None, *,
                   device: Optional[torch.device] = None,
                   lead=()) -> SSMCache:
    """Zeros: the conv windows in ``dtype`` (the config's by default),
    the state in fp32; ``lead`` axes first."""
    c = cfg.ssm
    dt = dtype or L.torch_dtype(cfg)
    GN = c.n_groups * c.d_state
    W = c.conv_width

    def z(*shape, dtype=dt):
        return torch.zeros((*lead, batch, *shape), dtype=dtype,
                           device=device)
    return SSMCache(conv_x=z(W - 1, cfg.d_inner), conv_B=z(W - 1, GN),
                    conv_C=z(W - 1, GN),
                    h=z(cfg.ssm_heads, c.head_dim, c.d_state,
                        dtype=torch.float32))


def ssm_cache_logical(cfg: ModelConfig):
    return SSMCache(
        conv_x=("batch", "conv", "d_inner"),
        conv_B=("batch", "conv", "state"),
        conv_C=("batch", "conv", "state"),
        h=("batch", "ssm_heads", "head_dim", "state"),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv. x: (B, S, C); w: (W, C)."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _conv_step(window: torch.Tensor, x_new: torch.Tensor, w: torch.Tensor):
    """One decode step of the causal conv. window: (B, W-1, C); x_new:
    (B, C).  Returns (y (B, C), the next window)."""
    full = torch.cat([window, x_new[:, None]], dim=1)        # (B, W, C)
    return (full * w).sum(1), full[:, 1:]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q). Returns (..., Q, Q) with out[i, j] = sum_{j < t <= i}
    a[t], -inf above the diagonal (the within-chunk decay matrix in log
    space)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    keep = torch.ones((Q, Q), dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~keep, -torch.inf)


def _project(params, u: torch.Tensor, cfg: ModelConfig,
             path: Optional[str] = None):
    """The five in-projections, each one B10 launch (kept separate, as
    the reference keeps them)."""
    return tuple(L.linear(u, params[k], path)
                 for k in ("wz", "wx", "wB", "wC", "wdt"))


def _tail(t: torch.Tensor, n: int) -> torch.Tensor:
    """The last ``n`` positions of t (B, S, C), zeros first where S < n."""
    t = t[:, -n:] if n else t[:, :0]
    return F.pad(t, (0, 0, n - t.shape[1], 0))


def _heads(t: torch.Tensor, hg: int, H: int, dim: int) -> torch.Tensor:
    """A group axis (``dim``) broadcast to the H heads, ``hg`` heads a
    group (the reference's ``jnp.repeat``; a view for one group)."""
    if t.shape[dim] == 1:
        shape = list(t.shape)
        shape[dim] = H
        return t.expand(shape)
    return t.repeat_interleave(hg, dim=dim)


def apply_ssm(params, u: torch.Tensor, cfg: ModelConfig,
              h0: Optional[torch.Tensor] = None,
              path: Optional[str] = None):
    """Full-sequence SSD. u: (B, S, d_model) -> (out (B, S, d_model), the
    decode state the sequence leaves: an ``SSMCache`` of the conv windows
    and the final state (B, H, P, N) fp32).  S is padded up to a multiple
    of the chunk; padded steps have dt = 0 (decay 1, no input), so the
    carried state stays exact."""
    c = cfg.ssm
    B_, S_orig, _ = u.shape
    H, P, N, G = cfg.ssm_heads, c.head_dim, c.d_state, c.n_groups
    hg = H // G
    Q = min(c.chunk, S_orig)

    z, x, Bp, Cp, dt_raw = _project(params, u, cfg, path)
    W = c.conv_width
    windows = [_tail(t, W - 1) for t in (x, Bp, Cp)]
    x = F.silu(_causal_conv(x, params["conv_x"]))
    Bp = F.silu(_causal_conv(Bp, params["conv_B"]))
    Cp = F.silu(_causal_conv(Cp, params["conv_C"]))

    pad = (-S_orig) % Q
    S = S_orig + pad
    if pad:
        x, Bp, Cp, dt_raw = (F.pad(t, (0, 0, 0, pad))
                             for t in (x, Bp, Cp, dt_raw))
    xh = x.reshape(B_, S, H, P).float()
    Bh = Bp.reshape(B_, S, G, N).float()
    Ch = Cp.reshape(B_, S, G, N).float()
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())   # (B,S,H)
    if pad:
        valid = (torch.arange(S, device=u.device) < S_orig).float()
        dt = dt * valid[None, :, None]
    A = -torch.exp(params["A_log"].float())                        # (H,)
    dA = dt * A

    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=u.device) \
        if h0 is None else h0.float()
    ys = []
    for lo in range(0, S, Q):
        xb, Bb, Cb = xh[:, lo:lo + Q], Bh[:, lo:lo + Q], Ch[:, lo:lo + Q]
        dtb = dt[:, lo:lo + Q]
        a = dA[:, lo:lo + Q].transpose(1, 2)                       # (B,H,Q)
        decay = torch.exp(_segsum(a))                              # (B,H,Q,Q)
        a_cum = torch.cumsum(a, dim=-1)
        # intra-chunk: y_diag[l] = sum_s C_l·B_s decay[l, s] dt_s x_s
        gbc = _heads(torch.einsum("blgn,bsgn->bgls", Cb, Bb), hg, H, 1)
        xw = xb * dtb[..., None]                                   # (B,Q,H,P)
        y_diag = torch.einsum("bhls,bshp->blhp", gbc * decay, xw)
        # the chunk's contribution to the state: decay from s to its end
        decay_states = torch.exp(a_cum[..., -1:] - a_cum)          # (B,H,Q)
        state_in = torch.einsum("bshn,bhs,bshp->bhpn",
                                _heads(Bb, hg, H, 2), decay_states, xw)
        # the carried state's contribution to every position
        y_off = torch.einsum("blhn,bhpn,bhl->blhp", _heads(Cb, hg, H, 2),
                             h, torch.exp(a_cum))
        h = h * torch.exp(a_cum[..., -1])[..., None, None] + state_in
        ys.append(y_diag + y_off)
    y = torch.cat(ys, dim=1)
    y = y + xh * params["D"].float()[:, None]
    y = y[:, :S_orig].reshape(B_, S_orig, cfg.d_inner).to(u.dtype)
    y = L.rms_norm_vec(y * F.silu(z), params["norm_scale"])
    return L.linear(y, params["w_out"], path), SSMCache(*windows, h)


def decode_ssm(params, u: torch.Tensor, cache: SSMCache, cfg: ModelConfig,
               path: Optional[str] = None):
    """One-token recurrent step. u: (B, 1, d_model) -> (out (B, 1,
    d_model), the next ``SSMCache``)."""
    c = cfg.ssm
    B_ = u.shape[0]
    H, P, N, G = cfg.ssm_heads, c.head_dim, c.d_state, c.n_groups
    hg = H // G
    z, x, Bp, Cp, dt_raw = _project(params, u[:, 0], cfg, path)
    x, conv_x = _conv_step(cache.conv_x, x, params["conv_x"])
    Bp, conv_B = _conv_step(cache.conv_B, Bp, params["conv_B"])
    Cp, conv_C = _conv_step(cache.conv_C, Cp, params["conv_C"])
    xh = F.silu(x).reshape(B_, H, P).float()
    Bh = _heads(F.silu(Bp).reshape(B_, G, N).float(), hg, H, 1)
    Ch = _heads(F.silu(Cp).reshape(B_, G, N).float(), hg, H, 1)
    dt = F.softplus(dt_raw.float() + params["dt_bias"].float())    # (B,H)
    dA = torch.exp(dt * -torch.exp(params["A_log"].float()))
    h = cache.h * dA[..., None, None] + \
        torch.einsum("bh,bhp,bhn->bhpn", dt, xh, Bh)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch)
    y = y + xh * params["D"].float()[:, None]
    y = y.reshape(B_, cfg.d_inner).to(u.dtype)
    y = L.rms_norm_vec(y * F.silu(z), params["norm_scale"])
    out = L.linear(y, params["w_out"], path)[:, None]
    return out, SSMCache(conv_x=conv_x, conv_B=conv_B, conv_C=conv_C, h=h)
