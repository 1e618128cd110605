"""AdamW with a warmup-cosine schedule and global-norm clipping.

Counterpart of the JAX package's ``training/optimizer.py``: the same
state (a step counter and fp32 moments shaped as the params), schedule and
arithmetic, the params updated in fp32 and cast back to their dtype.  Every
quantity stays a tensor on the params' device, so an update makes no host
sync.

Unlike the reference, which returns new arrays, ``adamw_update`` writes
the params and the moments IN PLACE and returns them: at stablelm-3b's
width a second copy of the params and moments would take 28 GB.  Leaves
past ``CHUNK`` elements are updated in slices of their leading axis of at
most ``CHUNK`` elements (one layer of a stacked leaf, a few thousand rows
of the embedding), so the fp32 temporaries of an update are a slice's,
not a whole leaf's, while the launches stay few.  ``opt_state_pspecs``
applies the ZeRO-1 rule of ``sharding/partitioning.py``: the moments
additionally sharded over the data axes (the paper's horizontal split
applied to optimizer memory).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import tree as T
from repro_torch.configs.base import MeshConfig, TrainConfig
from repro_torch.sharding.partitioning import (PartitionSpec, leaf_shape,
                                               map_logical, zero1_pspec)

CHUNK = 1 << 24       # elements past which a leaf is updated by slices


class AdamState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: Any             # tree like params (float32)
    nu: Any             # tree like params (float32)


def init_opt_state(params) -> AdamState:
    zeros = T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), params)
    device = T.leaves(params)[0].device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros, nu=T.map(torch.zeros_like, zeros))


def lr_schedule(step: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), fp32."""
    warm = torch.clamp(step.to(torch.float32) / max(cfg.warmup_steps, 1),
                       max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in T.leaves(tree)))


def _slices(t: torch.Tensor):
    """``t`` cut along its leading axis into slices of at most ``CHUNK``
    elements (at least one row each)."""
    if t.numel() <= CHUNK or t.ndim < 2:
        return [t]
    return list(t.split(max(1, CHUNK * t.shape[0] // t.numel())))


def adamw_update(params, grads, state: AdamState, cfg: TrainConfig):
    """One AdamW step with global-norm clipping, in place (see the module
    docstring).  Returns (params, state, stats), stats {"grad_norm",
    "lr"}."""
    step = state.step + 1
    gn = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    lr = lr_schedule(step, cfg)
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.to(torch.float32) * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        pf = p.to(torch.float32)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + \
            cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))

    for p, g, m, v in zip(T.leaves(params), T.leaves(grads),
                          T.leaves(state.mu), T.leaves(state.nu)):
        for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                  _slices(v)):
            upd(ps, gs, ms, vs)
    stats = {"grad_norm": gn, "lr": lr}
    return params, AdamState(step=step, mu=state.mu, nu=state.nu), stats


def opt_state_pspecs(param_pspecs, params_shape, mesh_cfg: MeshConfig,
                     zero1: bool = True) -> AdamState:
    """PartitionSpecs for AdamState: the step replicated, the moments as
    the params (``params_shape``: a tree of shapes or meta tensors), or
    with ``zero1`` each also sharded over the data axes
    (``zero1_pspec``)."""
    def mom_spec(ps, shp):
        return zero1_pspec(ps, leaf_shape(shp), mesh_cfg) if zero1 else ps

    mu = map_logical(mom_spec, param_pspecs, params_shape)
    return AdamState(step=PartitionSpec(), mu=mu,
                     nu=map_logical(lambda ps: ps, mu))
