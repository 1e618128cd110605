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

``apply_moe_two_phase`` is the reference's expert-parallel form over a
``sharding.ParallelPlan``: each (data, model) shard of the plan's mesh
routes its local tokens (B5 once a shard) and computes
``_dispatch_compute_combine`` over its own expert range (the reference's
``e_base``/``e_local``) into a partial output, OP1; the partials are
summed over the model shards in shard order, OP2
(``core/collectives.py``).  Within a shard the combine keeps the
ascending-slot order above, so the layer's kernel route still equals its
plain route bit for bit; against the one-device layer it differs by the
grouping of the bf16 additions (a token's k rows are summed a shard at a
time, then across shards), within 2(k − 1)·2^-8·Σ|w·ye| where both keep
the same assignments.

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
from repro_torch.core import collectives
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


def moe_logical(cfg: ModelConfig):
    lg = {"router": ("embed", "experts"),
          "w_in": ("experts", "embed", "mlp"),
          "w_out": ("experts", "mlp", "embed")}
    if mlp_is_gated(cfg.mlp_type):
        lg["w_gate"] = ("experts", "embed", "mlp")
    return lg


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
             num_experts: int, e_base: int = 0,
             e_local: Optional[int] = None):
    """The dispatch of (T, k) assignments into the ``e_local * C`` slots
    of the experts [e_base, e_base + e_local) (every expert by default),
    as the reference's ``_dispatch_compute_combine`` places them: an
    assignment is kept where its expert lies in the range and its rank
    among all the assignments to that expert is under C, in slot
    (e − e_base)·C + rank.  Returns (slot (T, k) int64, the sentinel
    e_local * C where an assignment is not kept; inv_tok (e_local * C,)
    int32, each slot's token or T where empty; w_slot (e_local * C,)
    fp32, each slot's routing weight or 0)."""
    if e_local is None:
        e_local = num_experts - e_base
    T, k = ids.shape
    e_flat = ids.reshape(-1).long()
    ranks = _ranks_static(e_flat, num_experts).long()
    n_slots = e_local * C
    keep = (e_flat >= e_base) & (e_flat < e_base + e_local) & (ranks < C)
    slot = torch.where(keep, (e_flat - e_base) * C + ranks,
                       torch.full_like(e_flat, n_slots))
    # kept slots are distinct; the others all land on the sentinel entry,
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


def expert_terms(params, x: torch.Tensor, cfg: ModelConfig, C: int,
                 path: Optional[str] = None, *, e_base: int = 0,
                 e_local: Optional[int] = None):
    """Route + dispatch + expert FFN over the experts [e_base, e_base +
    e_local) (every expert by default; ``params``' expert slabs hold that
    range, the router every expert): x (T, d) -> (slot (T, k), contrib
    (e_local * C + 1, d) each slot's expert row times its routing weight
    in the activations' dtype, the last row the zero sentinel, aux)."""
    T, d = x.shape
    E = cfg.moe.num_experts
    e_local = E - e_base if e_local is None else e_local
    weights, ids, aux = route(params, x, cfg, path)
    slot, inv_tok, w_slot = slot_map(weights, ids, C, E, e_base, e_local)
    x_pad = torch.cat([x, x.new_zeros((1, d))])                 # sentinel row
    buf = x_pad[inv_tok.long()]                                 # (E_loc*C, d)
    ye = _expert_ffn(params, buf.view(e_local, C, d), cfg).reshape(-1, d)
    contrib = torch.cat([ye * w_slot[:, None].to(ye.dtype),
                         ye.new_zeros((1, d))])                 # sentinel row
    return slot, contrib, aux


def combine(slot: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Each token's k rows of ``contrib`` in ascending slot order, summed
    in contrib's dtype: (T, d)."""
    rows = contrib[torch.sort(slot, dim=1).values]              # (T, k, d)
    y = rows[:, 0]
    for j in range(1, rows.shape[1]):
        y = y + rows[:, j]
    return y


def _dispatch_compute_combine(params, x: torch.Tensor, cfg: ModelConfig,
                              C: int, path: Optional[str] = None, *,
                              e_base: int = 0,
                              e_local: Optional[int] = None):
    """Route + dispatch + expert FFN + weighted combine over the expert
    range [e_base, e_base + e_local) (every expert by default): x (T, d)
    -> (y (T, d) in x's dtype, aux).  A pure function of the LOCAL tokens:
    the paper's OP1, each worker's partial result for its slice."""
    slot, contrib, aux = expert_terms(params, x, cfg, C, path,
                                      e_base=e_base, e_local=e_local)
    return combine(slot, contrib).to(x.dtype), aux


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              path: Optional[str] = None):
    """x (T, d_model) -> (y (T, d_model), aux) over every expert."""
    return _dispatch_compute_combine(params, x, cfg,
                                     capacity(x.shape[0], cfg), path)


def expert_shard(params, j: int, e_local: int, device: torch.device):
    """Model shard ``j``'s MoE params on ``device``: the router whole, each
    expert slab's experts [j·e_local, (j + 1)·e_local), views of the
    stacked slabs (no copy where ``device`` holds them)."""
    return {name: (w if name == "router" else
                   w[j * e_local:(j + 1) * e_local]).to(device)
            for name, w in params.items()}


def shard_grid(plan, T: int):
    """The two-phase layer's shards for T tokens: (data-shard count, T_loc,
    whether the tokens are split).  Tokens split over the data axes where
    T divides by their product; otherwise (a long-context decode, T = 1)
    every data shard holds all T tokens and computes the same partials,
    so the port computes one data shard's."""
    dp_total = plan.dp_total
    if T % dp_total == 0:
        return dp_total, T // dp_total, True
    return 1, T, False


def shard_device(plan, i: int, j: int) -> torch.device:
    """The device of data shard ``i`` (row-major over ``plan.dp_axes``)
    and model shard ``j``."""
    mesh = plan.mesh
    coords = {plan.model_axis: j}
    for a in reversed(plan.dp_axes):
        coords[a] = i % mesh.shape[a]
        i //= mesh.shape[a]
    return mesh.device_at(coords)


def apply_moe_two_phase(params, x: torch.Tensor, cfg: ModelConfig, plan,
                        path: Optional[str] = None):
    """The paper's two-phase scheme at production scale: x (T, d) -> (y
    (T, d), aux), experts split over ``plan.model_axis`` and tokens over
    ``plan.dp_axes``.

    OP1: every (data, model) shard routes its LOCAL tokens (B5 once a
    shard) and dispatches them to its LOCAL experts, e_local =
    num_experts / model shards of them, with the capacity C of its T_loc
    tokens, into a partial y (``_dispatch_compute_combine`` over its
    expert range, on its device).  OP2: one psum of the partials over the
    model shards, in shard order, in the activations' dtype
    (``core/collectives.py``); the data shards' rows are then gathered in
    order.  aux is the mean over the model shards, then over each data
    axis in ``plan.dp_axes`` order, as the reference's pmeans take it; on
    the token-replicated branch (``shard_grid``) it is the model mean."""
    m = cfg.moe
    model_n = plan.mesh.shape[plan.model_axis]
    if m.num_experts % model_n:
        raise ValueError(f"{m.num_experts} experts do not divide over "
                         f"{model_n} model shards")
    e_local = m.num_experts // model_n
    n_data, T_loc, split = shard_grid(plan, x.shape[0])
    C = capacity(T_loc, cfg)
    ys, auxes = [], []
    for i in range(n_data):
        x_loc = x[i * T_loc:(i + 1) * T_loc]
        parts, shard_aux = [], []
        for j in range(model_n):
            dev = shard_device(plan, i, j)
            with collectives.on(dev):
                y_part, aux = _dispatch_compute_combine(
                    expert_shard(params, j, e_local, dev), x_loc.to(dev),
                    cfg, C, path, e_base=j * e_local, e_local=e_local)
            parts.append(y_part)
            shard_aux.append(aux)
        home = shard_device(plan, i, 0)
        ys.append(collectives.psum(parts, home))             # OP2
        auxes.append(collectives.psum(shard_aux, home) / model_n)
    y = collectives.gather_rows(ys, x.device)
    aux = torch.stack([a.to(x.device) for a in auxes])
    if split:
        aux = aux.reshape([plan.mesh.shape[a] for a in plan.dp_axes])
        while aux.ndim:                  # one mean a data axis, in order
            aux = collectives.psum(list(aux), x.device) / aux.shape[0]
    else:
        aux = aux[0]
    return y, aux
