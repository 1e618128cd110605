"""Mixture-of-Experts layer of the port: sort-based capacity dispatch.

Counterpart of the JAX package's ``models/moe.py`` on one device.  The
router's top-k runs on B5 (``ops.topk_smallest`` of the negated
probabilities: the k largest, ties to the smaller expert, ``lax.top_k``'s
order), the only kernel of the layer; ``path="ref"`` (or
``REPRO_BACKEND=ref``) takes B5's plain version.  Dispatch is the
reference's slot-space scheme: a stable rank of each assignment within its
expert, a static capacity C an expert, and (E, C, d) x (E, d, f) batched
expert GEMMs, which the reference computes outside any Pallas kernel and
the port as ``torch.matmul``.

The combine differs from the reference's scatter-add in form only: each
token sums its k weighted expert rows in ascending slot order (the order
of a sequential scatter), a dropped assignment adding a zero row, in the
activations' dtype.  No atomics, so the layer is bit-for-bit repeatable,
and the kernel route equals the plain route bit for bit, since B5 returns
exactly what its plain version does.

The expert-parallel ``apply_moe_two_phase`` waits for the LM stack's
sharding (ROADMAP A17).

Memory: ``init_moe`` draws the (E, d, f) expert slabs one layer at a time
in fp32 and casts each at once, so at qwen3-moe-30b-a3b's width (48 x 128
x 2048 x 768 a weight) the fp32 temporary is one layer's slab, 805 MB,
not the whole stack's 38.7 GB.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (dense_init, mlp_is_gated, plain_route,
                                       torch_dtype)

CAPACITY_FACTOR = 1.25
DROPLESS_THRESHOLD = 1024  # below this token count, run fully dropless


def _expert_slabs(gen, n_experts: int, in_dim: int, out_dim: int,
                  dtype: torch.dtype, device: torch.device, lead=()):
    """lead + (E, in, out) N(0, 1/in) weights, drawn one (E, in, out) slab
    at a time in fp32 and cast into place."""
    out = torch.empty((*lead, n_experts, in_dim, out_dim), dtype=dtype,
                      device=device)
    if device.type == "meta":
        return out
    for slab in out.view(-1, n_experts, in_dim, out_dim):
        slab.copy_(dense_init(gen, in_dim, out_dim, torch.float32, device,
                              (n_experts,)))
    return out


def init_moe(gen, cfg: ModelConfig, device: torch.device, lead=()):
    m = cfg.moe
    dt = torch_dtype(cfg)
    E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert
    params = {
        "router": dense_init(gen, d, E, torch.float32, device, lead,
                             scale=0.02),
        "w_in": _expert_slabs(gen, E, d, f, dt, device, lead),
        "w_out": _expert_slabs(gen, E, f, d, dt, device, lead),
    }
    if mlp_is_gated(cfg.mlp_type):
        params["w_gate"] = _expert_slabs(gen, E, d, f, dt, device, lead)
    return params


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Static per-expert capacity.

    Capacity-based dropping is not prefix-causal (a later token can displace
    an earlier token's slot), which would make prefill(S) disagree with
    forward(S+k) prefixes. Small token counts (decode steps, small-batch
    serving) therefore run DROPLESS (C = T*k covers the worst-case skew);
    large training/prefill batches use the standard capacity factor.
    """
    m = cfg.moe
    if tokens <= DROPLESS_THRESHOLD:
        return max(8, -(-tokens * m.top_k // 8) * 8)
    c = int(math.ceil(tokens * m.top_k / m.num_experts * CAPACITY_FACTOR))
    return max(8, -(-c // 8) * 8)  # round up to 8 for TPU lane alignment


def router_logits(params, x: torch.Tensor) -> torch.Tensor:
    """x (T, d) -> (T, E) fp32 logits: x against the router cast to x's
    dtype, products and sums in fp32 (exact products of bf16 operands), as
    the reference's einsum with an f32 accumulator."""
    return x.float() @ params["router"].to(x.dtype).float()


def route(params, x: torch.Tensor, cfg: ModelConfig,
          path: Optional[str] = None):
    """Router: x (T, d) -> (weights (T, k) fp32, expert ids (T, k) int32,
    aux loss): softmax, the top-k on B5 (its indices; the weights are
    gathered from the probabilities), renormalised weights and the
    Switch-style balance term E * sum(f_e * p_e)."""
    m = cfg.moe
    probs = torch.softmax(router_logits(params, x), dim=-1)        # (T, E)
    topk = ref.topk_smallest if plain_route(path) else ops.topk_smallest
    _, ids = topk(-probs, m.top_k)
    # the weights gathered from probs at B5's indices: the values B5
    # returns, bit for bit (it is exact), but on probs' autograd graph, so
    # the router gets its gradient through them on either route
    weights = probs.gather(-1, ids.long())
    weights = weights / weights.sum(-1, keepdim=True)
    T = x.shape[0]
    # the experts' counts as integers (no host sync, unlike bincount on a
    # card)
    e_flat = ids.reshape(-1).long()
    counts = torch.zeros((m.num_experts,), dtype=torch.long,
                         device=x.device).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    dispatch_frac = counts.float() / (T * m.top_k)
    aux = m.num_experts * torch.sum(dispatch_frac * probs.mean(0))
    return weights, ids, aux


def _ranks_static(e_flat: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Rank of each assignment within its expert, via one stable argsort:
    (A,) expert ids -> (A,) int32 ranks."""
    e = e_flat.long()
    A = e.shape[0]
    order = torch.argsort(e, stable=True)
    sorted_e = e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=e.device), right=False)
    rank_sorted = torch.arange(A, device=e.device) - starts[sorted_e]
    ranks = torch.empty((A,), dtype=torch.int32, device=e.device)
    ranks[order] = rank_sorted.to(torch.int32)
    return ranks


def slot_map(weights: torch.Tensor, ids: torch.Tensor, C: int,
             num_experts: int):
    """The dispatch of (T, k) assignments into num_experts * C expert
    slots: (slot (T, k) int64, the sentinel num_experts * C where an
    assignment is dropped; inv_tok (num_experts * C,) int32, each slot's
    token or T where empty; w_slot (num_experts * C,) fp32, each slot's
    routing weight or 0)."""
    T, k = ids.shape
    e_flat = ids.reshape(-1).long()
    ranks = _ranks_static(e_flat, num_experts).long()
    n_slots = num_experts * C
    slot = torch.where(ranks < C, e_flat * C + ranks,
                       torch.full_like(e_flat, n_slots))
    # kept slots are distinct; the dropped all land on the sentinel entry,
    # which is cut off
    inv_tok = torch.full((n_slots + 1,), T, dtype=torch.int32,
                         device=ids.device)
    inv_tok[slot] = torch.arange(T, dtype=torch.int32, device=ids.device
                                 ).repeat_interleave(k)
    w_slot = torch.zeros((n_slots + 1,), dtype=torch.float32,
                         device=ids.device)
    w_slot[slot] = weights.reshape(-1).float()
    return slot.reshape(T, k), inv_tok[:n_slots], w_slot[:n_slots]


def _expert_ffn(params, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Batched expert GEMMs. xe: (E, C, d) with matching weight slices."""
    h = torch.matmul(xe, params["w_in"])
    if cfg.mlp_type == "swiglu":
        h = F.silu(torch.matmul(xe, params["w_gate"])) * h
    elif cfg.mlp_type == "geglu":
        h = F.gelu(torch.matmul(xe, params["w_gate"]),
                   approximate="tanh") * h
    elif cfg.mlp_type == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.matmul(h, params["w_out"])


def _dispatch_compute_combine(params, x: torch.Tensor, cfg: ModelConfig,
                              C: int, path: Optional[str] = None):
    """Route + dispatch + expert FFN + weighted combine over every expert:
    x (T, d) -> (y (T, d) in x's dtype, aux)."""
    T, d = x.shape
    E = cfg.moe.num_experts
    weights, ids, aux = route(params, x, cfg, path)
    slot, inv_tok, w_slot = slot_map(weights, ids, C, E)
    x_pad = torch.cat([x, x.new_zeros((1, d))])                 # sentinel row
    buf = x_pad[inv_tok.long()]                                 # (E*C, d)
    ye = _expert_ffn(params, buf.view(E, C, d), cfg).reshape(-1, d)
    contrib = torch.cat([ye * w_slot[:, None].to(ye.dtype),
                         ye.new_zeros((1, d))])                 # sentinel row
    # each token's k rows in ascending slot order, summed in ye's dtype
    rows = contrib[torch.sort(slot, dim=1).values]              # (T, k, d)
    y = rows[:, 0]
    for j in range(1, rows.shape[1]):
        y = y + rows[:, j]
    return y.to(x.dtype), aux


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              path: Optional[str] = None):
    """x (T, d_model) -> (y (T, d_model), aux) over every expert."""
    return _dispatch_compute_combine(params, x, cfg,
                                     capacity(x.shape[0], cfg), path)
