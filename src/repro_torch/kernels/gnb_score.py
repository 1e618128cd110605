"""Launcher of the CUDA kernel B3 (batched GNB joint log-likelihood) in
``csrc/gnb_score.cu``; B9 (``ops.gnb_scores``) launches it at B = 1.

Counterpart of the JAX package's ``kernels/gnb_score.py``.  Takes fp32,
contiguous CUDA tensors that ``kernels/ops.py`` has already checked,
allocates the output with ``torch.empty`` and launches one kernel on the
current stream without synchronising.

Two routes (``route``), counted in ``ROUTE_LAUNCHES``: ``resident``
where one group of at most ``CLASS_GROUP`` classes holds every class and
its (mu, var) pairs fit ``RESIDENT_MAX`` bytes of shared memory (staged
once a block), ``stream`` otherwise (chunks of ``chunk(C, d)`` features
of each class group, ``group_size(C)`` classes, staged in turn).
``plan`` picks the warps a query and the grid.

A grouped launch (a multi-tenant model group) takes G same-shape tenants
at once on either route: queries (G, B, d) against (mu, var) (G, C, d) and
log priors (G, C), the tenant on the grid's second axis, one launch for
the group.  It keeps the G = 1 launch's warps a query (``plan`` of B), so
each lane is bit-equal to the G = 1 launch on that tenant's operands; the
blocks a tenant shrink so that the group stays about ``BLOCKS_PER_SM`` an
SM.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gemm import sm_count

_STEM = "gnb_score"
WARPS = 16              # warps of a block
CLASS_GROUP = 16        # classes a lane sums at once
RESIDENT_MAX = 98304    # bytes of (mu, var) pairs staged a block
BLOCKS_PER_SM = 2       # persistent blocks an SM
ROUTES = ("resident", "stream")

# launches per route since the last ``ops.reset_launches``
ROUTE_LAUNCHES: Dict[str, int] = dict.fromkeys(ROUTES, 0)

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns = {}


def _fn():
    if "scores" not in _fns:
        for const, want in (("gnb_resident_max", RESIDENT_MAX),
                            ("gnb_class_group", CLASS_GROUP),
                            ("gnb_warps", WARPS)):
            got = _build.bind(_STEM, const, [])()
            if got != want:
                raise RuntimeError(f"{const}() = {got} in the built "
                                   f"library, the wrapper expects {want}")
        _fns["scores"] = _build.bind(_STEM, "gnb_scores_batch_f32",
                                     [_P] * 5 + [_I] * 7 + [_P])
    return _fns["scores"]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def group_size(C: int) -> int:
    """Classes a lane sums at once: C split into the fewest groups of at
    most ``CLASS_GROUP``, as evenly as they go (the kernel's template
    parameter)."""
    groups = -(-C // CLASS_GROUP)
    return -(-C // groups)


def chunk(C: int, d: int) -> int:
    """Features of a class group's (mu, var) pairs staged at once: all d
    where they fit ``RESIDENT_MAX`` bytes, else the most 32-feature
    stripes that do."""
    nc = group_size(C)
    if nc * d * 8 <= RESIDENT_MAX:
        return d
    return RESIDENT_MAX // (nc * 8) // 32 * 32


@functools.lru_cache(maxsize=256)
def route(C: int, d: int) -> str:
    return "resident" if C <= CLASS_GROUP and chunk(C, d) == d else "stream"


@functools.lru_cache(maxsize=256)   # a wrapper call's host time counts
def plan(B: int, C: int, d: int, sms: int) -> Tuple[int, int, int]:
    """(warps a query, features a chunk, blocks).  Each query takes the
    most warps, a power of two up to ``WARPS`` and at most one a
    32-feature stripe of a chunk, that keep the blocks to
    ``BLOCKS_PER_SM`` an SM; blocks are persistent, at most that many."""
    f = chunk(C, d)
    stripes = -(-f // 32)
    cap = BLOCKS_PER_SM * sms
    split = 1
    while split * 2 <= min(WARPS, stripes) and \
            -(-B * split * 2 // WARPS) <= cap:
        split *= 2
    return split, f, min(-(-B * split // WARPS), cap)


def launch_scores_batch(X: torch.Tensor, mu: torch.Tensor,
                        var: torch.Tensor, log_prior: torch.Tensor
                        ) -> torch.Tensor:
    """B3: X (B, d), mu/var (C, d), log_prior (C,) fp32 on the card ->
    (B, C) joint log-likelihood; or a group's X (G, B, d), mu/var
    (G, C, d), log_prior (G, C) -> (G, B, C), one launch."""
    fn = _fn()
    B, d = X.shape[-2:]
    C = mu.shape[-2]
    G = X.shape[0] if X.ndim == 3 else 1
    sms = sm_count(X.device)
    split, f, grid = plan(B, C, d, sms)
    if G > 1:
        grid = min(grid, max(1, -(-BLOCKS_PER_SM * sms // G)))
    way = route(C, d)
    out = torch.empty(X.shape[:-1] + (C,), dtype=torch.float32,
                      device=X.device)
    err = fn(X.data_ptr(), mu.data_ptr(), var.data_ptr(),
             log_prior.data_ptr(), out.data_ptr(), B, C, d, split, f, grid,
             G, _stream())
    _build.check(_STEM, err, f"gnb_scores_batch G={G} B={B} C={C} d={d} "
                 f"{way}")
    ROUTE_LAUNCHES[way] += 1
    return out
