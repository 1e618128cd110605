"""Public wrappers of the port's kernels.

Each wrapper checks device, dtype, shape and contiguity, then
  * for CUDA tensors launches its hand-written kernel (``csrc/``) and adds
    one to its count in ``LAUNCHES``; a failed build or launch raises,
    nothing falls back;
  * for CPU tensors runs the kernel's plain PyTorch version
    (``kernels/ref.py``).
bf16 inputs of the Non-Neural kernels (B1-B5, B9) are upcast to fp32
before the kernel, as the Pallas kernels upcast inside, so both dtypes
give the fp32 arithmetic.  The LM stack's B10 (``matmul``) and B11
(``flash_attention``) take bf16 as bf16: upcasting would copy every
weight to fp32 on every call.  They sum in fp32 and round once to the
inputs' dtype, and so does B12 (``flash_attention_bwd``), B11's backward
pass in training (``kernels/autograd.py``), which replaces no Pallas
kernel.

Counterpart of the JAX package's ``kernels/ops.py``.  The Hopper kernels
mask ragged edges themselves, so none of that module's padding to block
multiples (or the GNB padding correction) is needed.

B9 (``gnb_scores``, one query) is B3 launched at B = 1, as ROADMAP B9
plans; it keeps its own count.  B1, B2, B3 (B9's launches among them),
B4, B5, B6, B7, B8, B10 and B11 also count their launches per route
(``ROUTE_LAUNCHES`` in their modules; B7's ``ARGMIN_ROUTE_LAUNCHES``), so
a run can show which kernel design served it.

The int8 tier's B6 (``distance_topk_q8``) and B7 (``distance_argmin_q8``)
and IVF-PQ's B8 (``adc_topk``) take integer tensors and return exact
integers.  B8 up to its fused list length (``ann.FUSED_K_MAX``) sums and
selects in one launch.  B6 past B1's list length and B8 past its own
write an int32 matrix in chunks of queries and hand it to B5 in its
int32 key mode: a call then counts its matrix launches under its own
name and its selections under ``topk_smallest``.

B1, B2 and B3 also take a multi-tenant model group in one launch
(``distance_topk_group``, ``distance_argmin_group``,
``gnb_scores_batch_group``: G same-shape tenants on a leading axis, each
lane bit-equal to the one-tenant launch on its operands).  A grouped
launch counts once in ``LAUNCHES`` under the kernel's name and once in
``GROUP_LAUNCHES``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ann as _ann
from repro_torch.kernels import distance_argmin as _da
from repro_torch.kernels import distance_topk as _dt
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import gemm as _gemm
from repro_torch.kernels import gnb_score as _gs
from repro_torch.kernels import pairwise_sq_dist as _pd
from repro_torch.kernels import quantized as _q
from repro_torch.kernels import topk_select as _ts
from repro_torch.kernels import ref
from repro_torch.kernels.distance_topk import TOPK_K_MAX

# kernel launches per wrapper since the last reset: what a run reads to
# show that its main path went through the kernels
LAUNCHES: Dict[str, int] = {"distance_topk": 0, "distance_argmin": 0,
                            "gnb_scores_batch": 0, "pairwise_sq_dist": 0,
                            "topk_smallest": 0, "gnb_scores": 0,
                            "distance_topk_q8": 0, "distance_argmin_q8": 0,
                            "adc_topk": 0, "matmul": 0,
                            "flash_attention": 0, "flash_attention_bwd": 0}

# the grouped launches among them (B1, B2, B3 with a tenant axis)
GROUP_LAUNCHES: Dict[str, int] = {"distance_topk": 0, "distance_argmin": 0,
                                  "gnb_scores_batch": 0}

_FLOATS = (torch.float32, torch.bfloat16)
_INT8 = (torch.int8,)
_INT32 = (torch.int32,)


def reset_launches() -> None:
    """Set every count to 0: ``LAUNCHES``, ``GROUP_LAUNCHES`` and the
    per-route counts of B1,
    B2, B3 (with B9), B4, B5, B6, B7, B8, B10, B11 and B12
    (``ROUTE_LAUNCHES`` of ``kernels/distance_topk.py``,
    ``kernels/distance_argmin.py``, ``kernels/gnb_score.py``,
    ``kernels/pairwise_sq_dist.py``, ``kernels/topk_select.py``,
    ``kernels/quantized.py`` (B6; B7's are ``ARGMIN_ROUTE_LAUNCHES``
    there), ``kernels/ann.py``, ``kernels/gemm.py``,
    ``kernels/flash_attention.py`` and
    ``kernels/flash_attention_bwd.py``)."""
    for counts in (LAUNCHES, GROUP_LAUNCHES, _dt.ROUTE_LAUNCHES,
                   _da.ROUTE_LAUNCHES,
                   _gs.ROUTE_LAUNCHES, _pd.ROUTE_LAUNCHES,
                   _ts.ROUTE_LAUNCHES, _q.ROUTE_LAUNCHES,
                   _q.ARGMIN_ROUTE_LAUNCHES, _ann.ROUTE_LAUNCHES,
                   _gemm.ROUTE_LAUNCHES, _fa.ROUTE_LAUNCHES,
                   _fab.ROUTE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _check(op: str, rows: Tuple[str, ...] = (),
           types: Optional[Dict[str, Tuple[torch.dtype, ...]]] = None,
           inner: Tuple[str, ...] = (),
           **tensors: Tuple[torch.Tensor, int]) -> torch.device:
    """Each argument is (tensor, ndim); all on one device, contiguous, of
    the dtypes ``types`` names for it (float32/bf16 where it names none).
    The arguments named in ``rows`` need only contiguous rows (any row
    stride), those named in ``inner`` only a contiguous last axis.
    Returns the device."""
    device = None
    types = types or {}
    for name, (t, ndim) in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{op}: {name} must be a torch.Tensor")
        if t.ndim != ndim:
            raise ValueError(f"{op}: {name} must be {ndim}-D, got "
                             f"{tuple(t.shape)}")
        allowed = types.get(name, _FLOATS)
        if t.dtype not in allowed:
            raise TypeError(f"{op}: {name} has dtype {t.dtype}; one of "
                            f"{[str(a) for a in allowed]} expected")
        if name in inner:
            if t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f"{op}: {name} must have a contiguous last "
                                 f"axis, got strides {t.stride()}")
        elif name in rows:
            if (t.shape[1] > 1 and t.stride(1) != 1) or \
                    (t.shape[0] > 1 and t.stride(0) < t.shape[1]):
                raise ValueError(f"{op}: {name} must have contiguous rows, "
                                 f"got strides {t.stride()}")
        elif not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{op}: {name} is on {t.device}, the other "
                             f"inputs on {device}")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op}: unsupported device {device}")
    return device


def distance_topk(a: torch.Tensor, c: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (N, d) data rows, C (Q, d) queries -> the k nearest rows per
    query: (values (Q, k) f32, row indices (Q, k) int32), ascending,
    ties to the smallest row.  k is at most ``TOPK_K_MAX``."""
    dev = _check("distance_topk", a=(a, 2), c=(c, 2))
    N, d = a.shape
    if c.shape[1] != d:
        raise ValueError(f"distance_topk: a is {tuple(a.shape)}, c is "
                         f"{tuple(c.shape)}")
    if not 1 <= k <= min(N, TOPK_K_MAX):
        raise ValueError(f"distance_topk: k={k} outside [1, min(N={N}, "
                         f"{TOPK_K_MAX})]; larger k goes to the 'blocked' "
                         "arm (pairwise_sq_dist, then topk_smallest)")
    if dev.type == "cpu":
        return ref.distance_topk(a, c, k)
    out = _dt.launch_topk(a.float(), c.float(), k)
    LAUNCHES["distance_topk"] += 1
    return out


def distance_argmin(a: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (N, d), centroids C (K, d) -> (min sq-dist (N,) f32, nearest id
    (N,) int32), first index on ties."""
    dev = _check("distance_argmin", a=(a, 2), c=(c, 2))
    if c.shape[1] != a.shape[1] or a.shape[0] < 1 or c.shape[0] < 1:
        raise ValueError(f"distance_argmin: a is {tuple(a.shape)}, c is "
                         f"{tuple(c.shape)}")
    if dev.type == "cpu":
        return ref.distance_argmin(a, c)
    out = _da.launch(a.float(), c.float())
    LAUNCHES["distance_argmin"] += 1
    return out


def gnb_scores_batch(X: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
                     log_prior: torch.Tensor) -> torch.Tensor:
    """X (B, d) queries, mu/var (C, d), log_prior (C,) -> (B, C) joint
    log-likelihood."""
    dev = _check("gnb_scores_batch", X=(X, 2), mu=(mu, 2), var=(var, 2),
                 log_prior=(log_prior, 1))
    C, d = mu.shape
    if X.shape[1] != d or var.shape != mu.shape or log_prior.shape[0] != C \
            or X.shape[0] < 1:
        raise ValueError(f"gnb_scores_batch: X {tuple(X.shape)}, mu "
                         f"{tuple(mu.shape)}, var {tuple(var.shape)}, "
                         f"log_prior {tuple(log_prior.shape)}")
    if dev.type == "cpu":
        return ref.gnb_scores_batch(X, mu, var, log_prior)
    out = _gs.launch_scores_batch(X.float(), mu.float(), var.float(),
                                  log_prior.float())
    LAUNCHES["gnb_scores_batch"] += 1
    return out


def _groups(op: str, *tensors: torch.Tensor) -> int:
    """The common tenant count G of a group's operands (their leading
    axis), at least one."""
    G = tensors[0].shape[0]
    if G < 1 or any(t.shape[0] != G for t in tensors):
        raise ValueError(f"{op}: the operands' tenant axes "
                         f"{[tuple(t.shape) for t in tensors]} differ or "
                         "are empty")
    return G


def distance_topk_group(a: torch.Tensor, c: torch.Tensor, k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 over a model group: A (G, N, d) data rows, C (G, Q, d) queries ->
    each tenant's k nearest rows per query, (values (G, Q, k) f32, row
    indices (G, Q, k) int32), one launch.  k is at most ``TOPK_K_MAX``."""
    dev = _check("distance_topk_group", a=(a, 3), c=(c, 3))
    _groups("distance_topk_group", a, c)
    N, d = a.shape[1:]
    if c.shape[2] != d or c.shape[1] < 1:
        raise ValueError(f"distance_topk_group: a is {tuple(a.shape)}, c "
                         f"is {tuple(c.shape)}")
    if not 1 <= k <= min(N, TOPK_K_MAX):
        raise ValueError(f"distance_topk_group: k={k} outside [1, min(N={N},"
                         f" {TOPK_K_MAX})]")
    if dev.type == "cpu":
        return ref.distance_topk_group(a, c, k)
    out = _dt.launch_topk(a.float(), c.float(), k)
    LAUNCHES["distance_topk"] += 1
    GROUP_LAUNCHES["distance_topk"] += 1
    return out


def distance_argmin_group(a: torch.Tensor, c: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B2 over a model group: A (G, N, d), centroids C (G, K, d) -> (min
    sq-dist (G, N) f32, nearest id (G, N) int32), one launch."""
    dev = _check("distance_argmin_group", a=(a, 3), c=(c, 3))
    _groups("distance_argmin_group", a, c)
    if c.shape[2] != a.shape[2] or a.shape[1] < 1 or c.shape[1] < 1:
        raise ValueError(f"distance_argmin_group: a is {tuple(a.shape)}, c "
                         f"is {tuple(c.shape)}")
    if dev.type == "cpu":
        return ref.distance_argmin_group(a, c)
    out = _da.launch(a.float(), c.float())
    LAUNCHES["distance_argmin"] += 1
    GROUP_LAUNCHES["distance_argmin"] += 1
    return out


def gnb_scores_batch_group(X: torch.Tensor, mu: torch.Tensor,
                           var: torch.Tensor, log_prior: torch.Tensor
                           ) -> torch.Tensor:
    """B3 over a model group: X (G, B, d), mu/var (G, C, d), log_prior
    (G, C) -> (G, B, C) joint log-likelihood, one launch."""
    dev = _check("gnb_scores_batch_group", X=(X, 3), mu=(mu, 3),
                 var=(var, 3), log_prior=(log_prior, 2))
    _groups("gnb_scores_batch_group", X, mu, var, log_prior)
    C, d = mu.shape[1:]
    if X.shape[2] != d or var.shape != mu.shape or \
            log_prior.shape[1] != C or X.shape[1] < 1:
        raise ValueError(f"gnb_scores_batch_group: X {tuple(X.shape)}, mu "
                         f"{tuple(mu.shape)}, var {tuple(var.shape)}, "
                         f"log_prior {tuple(log_prior.shape)}")
    if dev.type == "cpu":
        return ref.gnb_scores_batch_group(X, mu, var, log_prior)
    out = _gs.launch_scores_batch(X.float(), mu.float(), var.float(),
                                  log_prior.float())
    LAUNCHES["gnb_scores_batch"] += 1
    GROUP_LAUNCHES["gnb_scores_batch"] += 1
    return out


def pairwise_sq_dist(a: torch.Tensor, c: torch.Tensor, *,
                     col_major: bool = False) -> torch.Tensor:
    """A (N, d), C (K, d) -> E (N, K) f32 squared distances as
    ``‖a‖² − 2a·c + ‖c‖²``.  ``col_major``: E is stored column-major, so
    its transpose ``E.T`` (K, N) is contiguous; the kNN arm hands that view
    to ``topk_smallest`` without a copy."""
    dev = _check("pairwise_sq_dist", a=(a, 2), c=(c, 2))
    if c.shape[1] != a.shape[1] or a.shape[0] < 1 or c.shape[0] < 1:
        raise ValueError(f"pairwise_sq_dist: a is {tuple(a.shape)}, c is "
                         f"{tuple(c.shape)}")
    if dev.type == "cpu":
        e = ref.pairwise_sq_dist(a, c)
        return e.T.contiguous().T if col_major else e
    out = _pd.launch(a.float(), c.float(), col_major)
    LAUNCHES["pairwise_sq_dist"] += 1
    return out


def topk_smallest(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (R, n) -> the k smallest of each row as (values (R, k), indices
    (R, k) int32): ascending, ties to the first index, NaN after every
    number, indices distinct.  Any 1 <= k <= n.  x needs contiguous rows
    only, so a transposed column-major matrix goes in as it is.  Float
    rows give f32 values; int32 rows take the int32 key mode and give
    int32 values."""
    dev = _check("topk_smallest", rows=("x",),
                 types={"x": _FLOATS + _INT32}, x=(x, 2))
    R, n = x.shape
    if R < 1 or not 1 <= k <= n:
        raise ValueError(f"topk_smallest: k={k} outside [1, n={n}] or no "
                         f"rows in {tuple(x.shape)}")
    if dev.type == "cpu":
        return ref.topk_smallest(x, k)
    out = _ts.launch(x if x.dtype == torch.int32 else x.float(), k)
    LAUNCHES["topk_smallest"] += 1
    return out


def gnb_scores(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
               log_prior: torch.Tensor) -> torch.Tensor:
    """One query x (d,), mu/var (C, d), log_prior (C,) -> (C,) joint
    log-likelihood: B3 at B = 1."""
    dev = _check("gnb_scores", x=(x, 1), mu=(mu, 2), var=(var, 2),
                 log_prior=(log_prior, 1))
    C, d = mu.shape
    if x.shape[0] != d or var.shape != mu.shape or log_prior.shape[0] != C:
        raise ValueError(f"gnb_scores: x {tuple(x.shape)}, mu "
                         f"{tuple(mu.shape)}, var {tuple(var.shape)}, "
                         f"log_prior {tuple(log_prior.shape)}")
    if dev.type == "cpu":
        return ref.gnb_scores(x, mu, var, log_prior)
    out = _gs.launch_scores_batch(x.float()[None], mu.float(), var.float(),
                                  log_prior.float())[0]
    LAUNCHES["gnb_scores"] += 1
    return out


def _matrix_topk(matrix, Q: int, n: int, k: int, name: str):
    """Rows of a per-chunk int32 (chunk, n) matrix -> B5's k smallest, the
    queries taken in chunks whose matrix stays under the blocked arm's
    byte budget (``dispatch.BLOCKED_BYTES``).  ``matrix(lo, hi)`` launches
    one chunk's kernel, counted under ``name``."""
    from repro_torch.kernels.dispatch import BLOCKED_BYTES
    step = max(1, BLOCKED_BYTES // (4 * n))
    parts = []
    for lo in range(0, Q, step):
        e = matrix(lo, min(Q, lo + step))
        LAUNCHES[name] += 1
        parts.append(topk_smallest(e, k))
        del e
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))


def distance_topk_q8(a: torch.Tensor, c: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 rows A (N, d), int8 queries C (Q, d) -> the k nearest rows per
    query: (exact lattice distances (Q, k) int32, rows (Q, k) int32),
    ascending, ties to the smallest row.  Any 1 <= k <= N; d <= 832."""
    dev = _check("distance_topk_q8", types={"a": _INT8, "c": _INT8},
                 a=(a, 2), c=(c, 2))
    N, d = a.shape
    if c.shape[1] != d or c.shape[0] < 1:
        raise ValueError(f"distance_topk_q8: a is {tuple(a.shape)}, c is "
                         f"{tuple(c.shape)}")
    _q.check_width(d, "distance_topk_q8")
    if not 1 <= k <= N:
        raise ValueError(f"distance_topk_q8: k={k} outside [1, N={N}]")
    if dev.type == "cpu":
        return ref.distance_topk_q8(a, c, k)
    if k <= TOPK_K_MAX:
        out = _q.launch_topk(a, c, k)
        LAUNCHES["distance_topk_q8"] += 1
        return out
    return _matrix_topk(lambda lo, hi: _q.launch_dist(a, c[lo:hi]),
                        c.shape[0], N, k, "distance_topk_q8")


def distance_argmin_q8(a: torch.Tensor, c: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 rows A (N, d), int8 centroids C (K, d) -> (exact lattice
    distance (N,) int32, nearest centroid (N,) int32), first index on
    ties; d <= 832."""
    dev = _check("distance_argmin_q8", types={"a": _INT8, "c": _INT8},
                 a=(a, 2), c=(c, 2))
    if c.shape[1] != a.shape[1] or a.shape[0] < 1 or c.shape[0] < 1:
        raise ValueError(f"distance_argmin_q8: a is {tuple(a.shape)}, c is "
                         f"{tuple(c.shape)}")
    _q.check_width(a.shape[1], "distance_argmin_q8")
    if dev.type == "cpu":
        return ref.distance_argmin_q8(a, c)
    out = _q.launch_argmin(a, c)
    LAUNCHES["distance_argmin_q8"] += 1
    return out


def adc_topk(qlut: torch.Tensor, codes: torch.Tensor,
             cand_ids: torch.Tensor, k: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query LUTs (Q, m*n_codes) int32, candidate PQ codes (Q, L, m)
    int8 (stored code - 128), candidate ids (Q, L) int32 (< 0 = invalid)
    -> (ADC distances (Q, k) int32, candidate positions (Q, k) int32 into
    the L axis), ascending, ties to the smallest position.  Any
    1 <= k <= L."""
    dev = _check("adc_topk", types={"qlut": _INT32, "codes": _INT8,
                                    "cand_ids": _INT32},
                 qlut=(qlut, 2), codes=(codes, 3), cand_ids=(cand_ids, 2))
    Q, L, m = codes.shape
    if Q < 1 or L < 1 or m < 1 or cand_ids.shape != (Q, L) or \
            qlut.shape[0] != Q or qlut.shape[1] % m or qlut.shape[1] < m:
        raise ValueError(f"adc_topk: qlut {tuple(qlut.shape)}, codes "
                         f"{tuple(codes.shape)}, cand_ids "
                         f"{tuple(cand_ids.shape)}")
    if not 1 <= k <= L:
        raise ValueError(f"adc_topk: k={k} outside [1, L={L}]")
    if dev.type == "cpu":
        return ref.adc_topk(qlut, codes, cand_ids, k)
    if _ann.route(k) == "fused":
        out = _ann.launch_topk(qlut, codes, cand_ids, k)
        LAUNCHES["adc_topk"] += 1
        return out
    return _matrix_topk(lambda lo, hi: _ann.launch_dist(
        qlut[lo:hi], codes[lo:hi], cand_ids[lo:hi]), Q, L, k, "adc_topk")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """B10: a (M, K) @ b (K, N) -> (M, N) in their dtype (fp32, or bf16
    kept as bf16), the products summed in fp32 and rounded once.  Any
    M, N, K >= 1; b is a weight in the (in, out) layout."""
    dev = _check("matmul", a=(a, 2), b=(b, 2))
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: a is {a.dtype}, b is {b.dtype}; one dtype "
                        "expected")
    M, K = a.shape
    if K != b.shape[0] or M < 1 or K < 1 or b.shape[1] < 1:
        raise ValueError(f"matmul: a is {tuple(a.shape)}, b is "
                         f"{tuple(b.shape)}")
    if dev.type == "cpu":
        return ref.matmul(a, b)
    out = _gemm.launch(a, b)
    LAUNCHES["matmul"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """B11: q, k, v (B, H, S, d) -> softmax(q k^T / sqrt(d)) v, (B, H, S,
    d) in q's dtype, causal or full.  Any S >= 1 and d <= 256; any
    (batch, head, position) strides with the d axis contiguous, so a
    permuted (B, S, H, d) tensor goes in without a copy.  GQA callers
    expand the KV heads first, as in the reference."""
    D_MAX = _fa.D_MAX
    dev = _check("flash_attention", inner=("q", "k", "v"), q=(q, 4),
                 k=(k, 4), v=(v, 4))
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}; one dtype expected")
    if k.shape != q.shape or v.shape != q.shape or min(q.shape) < 1 or \
            q.shape[-1] > D_MAX:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; one (B, H, "
                         f"S, d) shape with d <= {D_MAX} expected")
    if dev.type == "cpu":
        return ref.attention(q, k, v, causal=causal)
    out = _fa.launch(q, k, v, causal)
    LAUNCHES["flash_attention"] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True):
    """B12: the gradient of ``flash_attention`` at q, k, v (B, H, S, d),
    given its output o and the output's gradient dO -> (dq, dk, dv) in
    q's dtype, from the exact softmax in fp32 (D = rowsum(dO * o)).  Any
    S >= 1 and d <= 256, any (batch, head, position) strides with the d
    axis contiguous, as B11 takes them; on the tensor cores where
    ``flash_attention_bwd.route`` gives ``wgmma``."""
    D_MAX = _fab.D_MAX
    dev = _check("flash_attention_bwd", inner=("q", "k", "v", "o", "do"),
                 q=(q, 4), k=(k, 4), v=(v, 4), o=(o, 4), do=(do, 4))
    if len({t.dtype for t in (q, k, v, o, do)}) != 1:
        raise TypeError("flash_attention_bwd: q, k, v, o, dO of dtypes "
                        f"{[str(t.dtype) for t in (q, k, v, o, do)]}; one "
                        "dtype expected")
    if any(t.shape != q.shape for t in (k, v, o, do)) or \
            min(q.shape) < 1 or q.shape[-1] > D_MAX:
        raise ValueError("flash_attention_bwd: shapes "
                         f"{[tuple(t.shape) for t in (q, k, v, o, do)]}; one "
                         f"(B, H, S, d) shape with d <= {D_MAX} expected")
    if dev.type == "cpu":
        return ref.attention_bwd(q, k, v, o, do, causal=causal)
    out = _fab.launch(q, k, v, o, do, causal)
    LAUNCHES["flash_attention_bwd"] += 1
    return out
