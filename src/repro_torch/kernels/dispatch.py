"""Kernel dispatch: one registry for the Non-Neural hot-path ops.

The part of the JAX package's ``kernels/dispatch.py`` that the
single-device path of kNN, K-Means, GNB, GMM, RF and IVF-PQ ANN needs.
Each ``(algorithm, op)`` registers executable arms:

  ``fused``   — a hand-written CUDA kernel that fuses the op (kNN B1,
                K-Means B2, ANN's ADC B8),
  ``blocked`` — kernels that round-trip device memory: the two-pass
                distance matrix (B4) then top-k (B5) or min/argmin, and
                the feature-chunked GNB kernel (B3) for GNB and GMM,
  ``ref``     — the plain PyTorch version (``kernels/ref.py``), or the
                torch-op pipeline of an op that has no kernel (the GMM
                chunked E-step, the RF traversal),
  ``quant``   — the int8 lattice arm: per-feature symmetric scales from
                the op's model-side operand, exact integer distances (kNN
                B6, K-Means B7) or affine scores over int8 features (GNB,
                GMM) and int8 thresholds (RF).  Lossy by design, so no
                selector picks it: only ``path="quant"`` or
                ``REPRO_BACKEND=quant`` does.

Precedence in ``resolve``: explicit ``path=`` > ``REPRO_BACKEND`` (when the
op has that arm) > the op's shape selector.  With a card, kNN resolves to
``fused`` or ``blocked`` for every k and ANN to ``fused``, never to
``ref``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantized as qk

ENV_VAR = "REPRO_BACKEND"
# the reference's arm names, in its order
PATH_NAMES = ("fused", "blocked", "ref", "quant")

# algorithm -> its serve-time hot op in the registry
HOT_OPS = {"knn": "distance_topk", "kmeans": "distance_argmin",
           "gnb": "scores", "gmm": "responsibilities",
           "rf": "forest_votes", "ann": "adc_topk"}


def hot_shape_kw(algorithm: str, cost_shape: Dict[str, int],
                 bucket: int) -> Dict[str, int]:
    """An estimator's ``serve_cost_shape()`` plus a batch bucket -> the
    shape kwargs ``resolve`` expects for its hot op."""
    s = dict(cost_shape or {})
    if algorithm == "knn":
        return {"N": s.get("N", 0), "d": s.get("d", 0), "Q": bucket,
                "k": s.get("k", 1)}
    if algorithm == "kmeans":
        return {"N": bucket, "d": s.get("d", 0), "K": s.get("K", 1)}
    if algorithm == "gnb":
        return {"B": bucket, "d": s.get("d", 0), "C": s.get("C", 1)}
    if algorithm == "gmm":
        return {"B": bucket, "d": s.get("d", 0), "k": s.get("K", 1)}
    if algorithm == "ann":
        return {"Q": bucket, "L": s.get("L", 0), "m": s.get("m", 1),
                "n_codes": s.get("n_codes", 256), "k": s.get("k", 1)}
    if algorithm == "rf":
        return {}    # the forest-vote op resolves shape-free
    raise KeyError(f"no hot op for {algorithm!r}; known: {sorted(HOT_OPS)}")


# ---------------------------------------------------------------------------
# PrecisionPolicy — the paper's FP-backend axis (§3.4) as a compute dtype
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrecisionPolicy:
    """The dtype estimators cast float inputs and params to: fp32 (the
    paper's FPU-native arm) or bf16 (reduced precision); the fp kernels
    compute in fp32 either way.  ``int8`` is the quantized tier: inputs
    stay fp32 at the API and the estimators rewrite their fitted params
    onto the int8 lattice (``core/quantization.py``)."""

    name: str
    dtype: torch.dtype

    @property
    def quantized(self) -> bool:
        return self.name.split("@")[0] == "int8"

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """Cast float tensors to the policy dtype; integers pass through."""
        if x.is_floating_point():
            return x.to(self.dtype)
        return x


POLICIES: Dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy("fp32", torch.float32),
    "bf16": PrecisionPolicy("bf16", torch.bfloat16),
    # float inputs pass through: the lattice step happens in the quant arms
    # and the quantized estimators, not as a cast
    "int8": PrecisionPolicy("int8", torch.float32),
}
DEFAULT_POLICY = POLICIES["fp32"]


def get_policy(name: str) -> PrecisionPolicy:
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")
    return POLICIES[name]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class KernelPath(NamedTuple):
    algorithm: str
    op: str
    name: str
    fn: Callable


_PATHS: Dict[Tuple[str, str], Dict[str, Callable]] = {}
_SELECTORS: Dict[Tuple[str, str], Callable[..., str]] = {}


def register(algorithm: str, op: str, path: str):
    if path not in PATH_NAMES:
        raise ValueError(f"unknown path {path!r}; known: {PATH_NAMES}")

    def deco(fn):
        _PATHS.setdefault((algorithm, op), {})[path] = fn
        return fn

    return deco


def selector(algorithm: str, op: str):
    def deco(fn):
        _SELECTORS[(algorithm, op)] = fn
        return fn

    return deco


def registered() -> Dict[Tuple[str, str], Tuple[str, ...]]:
    """(algorithm, op) -> available path names."""
    return {k: tuple(n for n in PATH_NAMES if n in v)
            for k, v in sorted(_PATHS.items())}


def env_override() -> Optional[str]:
    v = os.environ.get(ENV_VAR, "").strip()
    if not v:
        return None
    if v not in PATH_NAMES:
        # a typo must not silently run the default arms
        raise ValueError(f"{ENV_VAR}={v!r} is not one of {PATH_NAMES}")
    return v


def requested(path: Optional[str]) -> Optional[str]:
    """The arm the caller asks for: explicit ``path=`` over
    ``REPRO_BACKEND``, or None.  ``resolve`` and the quantized estimators'
    hot paths, which call the int8 kernels directly, both read it."""
    return path if path is not None else env_override()


def resolve(algorithm: str, op: str, *, path: Optional[str] = None,
            policy: Optional[PrecisionPolicy] = None,
            **shape_kw) -> KernelPath:
    """Pick the executable arm for ``(algorithm, op)`` at these shapes:
    explicit ``path=`` > ``REPRO_BACKEND`` > the op's selector."""
    key = (algorithm, op)
    if key not in _PATHS:
        raise KeyError(f"no kernel registered for {key}; "
                       f"known: {sorted(_PATHS)}")
    paths = _PATHS[key]
    if path is not None and path not in paths:
        raise KeyError(f"{key} has no {path!r} path (has {sorted(paths)})")
    chosen = requested(path)
    if chosen not in paths:
        # REPRO_BACKEND names an arm this op lacks, or nothing is asked
        chosen = _SELECTORS[key](policy=policy or DEFAULT_POLICY, **shape_kw)
    return KernelPath(algorithm, op, chosen, paths[chosen])


# ---------------------------------------------------------------------------
# kNN — distance -> top-k (Fig. 6 OP1+OP2): fused B1, or blocked B4 + B5
# ---------------------------------------------------------------------------


@register("knn", "distance_topk", "fused")
def _knn_fused(a, c, k):
    return ops.distance_topk(a, c, k)


# the most bytes the blocked kNN arm's (N, Q) distance matrix may hold at
# once: the queries go through B4 and B5 in chunks that keep it under this
# (one chunk per 1024-query bucket up to N = 2^20)
BLOCKED_BYTES = 1 << 32


@register("knn", "distance_topk", "blocked")
def _knn_blocked(a, c, k):
    # the two-pass composition: the matrix through device memory, stored
    # column-major so that its transpose, the rows B5 reads, is contiguous
    # and never copied; each chunk's matrix is freed before the next
    step = max(1, BLOCKED_BYTES // (4 * a.shape[0]))
    parts = [ops.topk_smallest(ops.pairwise_sq_dist(a, cq, col_major=True).T,
                               k) for cq in torch.split(c, step)]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([v for v, _ in parts]),
            torch.cat([i for _, i in parts]))


@register("knn", "distance_topk", "ref")
def _knn_ref(a, c, k):
    return ref.distance_topk(a, c, k)


def _lattice(operand):
    """Per-feature scales from the model-side operand's abs-max."""
    return qk.feature_scales(torch.amax(torch.abs(operand.float()), dim=0))


@register("knn", "distance_topk", "quant")
def _knn_quant(a, c, k):
    # scales from the REFERENCE rows, never the query batch, so a single
    # query and a batch share one lattice; exact lattice distances (B6),
    # dequantized with the mean squared scale
    scale = _lattice(a)
    vals, idx = ops.distance_topk_q8(qk.quantize_rows(a, scale),
                                     qk.quantize_rows(c, scale), k)
    return vals.to(torch.float32) * torch.mean(scale * scale), idx


@selector("knn", "distance_topk")
def _knn_select(*, N, d, Q, k, policy=None):
    # B1 tiles Q and N itself, so any shape fits except a k longer than
    # the per-thread lists it keeps; B5 takes every k up to N
    return "fused" if k <= ops.TOPK_K_MAX else "blocked"


def distance_topk(a, c, k: int, *, policy: Optional[PrecisionPolicy] = None,
                  path: Optional[str] = None):
    """A (N, d) data, C (Q, d) queries -> (values (Q, k), indices (Q, k))."""
    if policy is not None:
        a, c = policy.cast(a), policy.cast(c)
    N, d = a.shape
    kp = resolve("knn", "distance_topk", path=path, policy=policy,
                 N=N, d=d, Q=c.shape[0], k=k)
    return kp.fn(a, c, k)


# ---------------------------------------------------------------------------
# K-Means — distance -> argmin (Fig. 7 OP1+OP2): fused B2, or blocked B4
# ---------------------------------------------------------------------------


@register("kmeans", "distance_argmin", "fused")
def _km_fused(a, c):
    return ops.distance_argmin(a, c)


@register("kmeans", "distance_argmin", "blocked")
def _km_blocked(a, c):
    # B4, then the row min and first-index argmin in torch, as the
    # reference takes them in jnp
    e = ops.pairwise_sq_dist(a, c)
    vals, ids = torch.min(e, dim=1)
    return vals, ids.to(torch.int32)


@register("kmeans", "distance_argmin", "ref")
def _km_ref(a, c):
    return ref.distance_argmin(a, c)


@register("kmeans", "distance_argmin", "quant")
def _km_quant(a, c):
    # scales from the centroids (B7)
    scale = _lattice(c)
    vals, idx = ops.distance_argmin_q8(qk.quantize_rows(a, scale),
                                       qk.quantize_rows(c, scale))
    return vals.to(torch.float32) * torch.mean(scale * scale), idx


@selector("kmeans", "distance_argmin")
def _km_select(*, N, d, K, policy=None):
    # B2 stages centroids in tiles, so every (K, d) fits
    return "fused"


def distance_argmin(a, c, *, policy: Optional[PrecisionPolicy] = None,
                    path: Optional[str] = None):
    """A (N, d), centroids (K, d) -> (min sq-dist (N,), nearest id (N,))."""
    if policy is not None:
        a, c = policy.cast(a), policy.cast(c)
    N, d = a.shape
    kp = resolve("kmeans", "distance_argmin", path=path, policy=policy,
                 N=N, d=d, K=c.shape[0])
    return kp.fn(a, c)


# ---------------------------------------------------------------------------
# GNB — joint log-likelihood (Fig. 5 OP1+OP2): B3
# ---------------------------------------------------------------------------


@register("gnb", "scores", "blocked")
def _gnb_blocked(X, mu, var, log_prior):
    return ops.gnb_scores_batch(X, mu, var, log_prior)


@register("gnb", "scores", "ref")
def _gnb_ref(X, mu, var, log_prior):
    return ref.gnb_scores_batch(X, mu, var, log_prior)


def _gauss_lattice(X, mu, var):
    """int8 features and affine score tables, scales from mu/var."""
    from repro_torch.core import quantization as cq
    scale = qk.feature_scales(cq.gauss_absmax(mu.float(), var.float()))
    quad, lin, const = cq.gauss_score_tables(mu, var, scale)
    return qk.quantize_rows(X, scale), quad, lin, const


@register("gnb", "scores", "quant")
def _gnb_quant(X, mu, var, log_prior):
    xq, quad, lin, const = _gauss_lattice(X, mu, var)
    return qk.affine_scores(xq, quad, lin, const + log_prior)


@selector("gnb", "scores")
def _gnb_select(*, B, d, C, policy=None):
    # the reference's threshold: the feature-chunked kernel pays once there
    # are several feature chunks; small d stays on the plain version
    return "blocked" if d >= 64 else "ref"


def gnb_scores(X, mu, var, log_prior, *,
               policy: Optional[PrecisionPolicy] = None,
               path: Optional[str] = None):
    """X (B, d) queries -> (B, C) joint log-likelihood."""
    if policy is not None:
        X, mu, var = policy.cast(X), policy.cast(mu), policy.cast(var)
    B, d = X.shape
    kp = resolve("gnb", "scores", path=path, policy=policy,
                 B=B, d=d, C=mu.shape[0])
    return kp.fn(X, mu, var, log_prior)


# ---------------------------------------------------------------------------
# GMM — E-step responsibilities (GNB OP1/OP2 + Fig. 6 row chunking)
# ---------------------------------------------------------------------------


@register("gmm", "responsibilities", "ref")
def _gmm_ref(mu, var, log_pi, X, *, n_cores=8):
    # the chunked E-step: its accumulation order is the reference schedule
    # that EM convergence parity rests on
    from repro_torch.core.gmm import gmm_e_step
    return gmm_e_step(X, mu, var, log_pi, n_cores)


@register("gmm", "responsibilities", "blocked")
def _gmm_blocked(mu, var, log_pi, X, *, n_cores=8):
    # GMM's joint log-density is GNB's per-class score with log_pi as the
    # prior: B3, then the per-row logsumexp.  The same contract as the ref
    # arm in another accumulation order.
    joint = ops.gnb_scores_batch(X, mu, var, log_pi)
    norm = torch.logsumexp(joint, dim=1, keepdim=True)
    return joint - norm, torch.mean(norm[:, 0])


@register("gmm", "responsibilities", "quant")
def _gmm_quant(mu, var, log_pi, X, *, n_cores=8):
    # the GNB tables with log_pi as the prior, normalised per row
    xq, quad, lin, const = _gauss_lattice(X, mu, var)
    joint = qk.affine_scores(xq, quad, lin, const + log_pi)
    norm = torch.logsumexp(joint, dim=1, keepdim=True)
    return joint - norm, torch.mean(norm[:, 0])


@selector("gmm", "responsibilities")
def _gmm_select(*, B=0, d=0, k=0, policy=None):
    # the GNB threshold; small d stays on the ref schedule
    return "blocked" if d >= 64 else "ref"


def gmm_responsibilities(mu, var, log_pi, X, *,
                         policy: Optional[PrecisionPolicy] = None,
                         path: Optional[str] = None, n_cores: int = 8):
    """X (B, d) -> (log-responsibilities (B, k), mean log-likelihood)."""
    if policy is not None:
        mu, var, X = policy.cast(mu), policy.cast(var), policy.cast(X)
    kp = resolve("gmm", "responsibilities", path=path, policy=policy,
                 B=X.shape[0], d=X.shape[1], k=mu.shape[0])
    return kp.fn(mu, var, log_pi, X, n_cores=n_cores)


# ---------------------------------------------------------------------------
# RF — batched forest vote (Fig. 8 Independent-Tasks)
# ---------------------------------------------------------------------------


@register("rf", "forest_votes", "ref")
def _rf_ref(forest, X, *, depth=None):
    # traversal is integer gather and branch work; the reference has no
    # Pallas kernel for it, and the port runs it in torch ops
    from repro_torch.core.random_forest import forest_classify_batch
    return forest_classify_batch(forest, X, depth=depth)


@register("rf", "forest_votes", "quant")
def _rf_quant(forest, X, *, depth=None):
    # thresholds and features on one lattice, scales from the thresholds
    # (the only feature statistics the fitted forest carries); the same
    # traversal compares int8 against int8
    from repro_torch.core import quantization as cq
    from repro_torch.core.random_forest import Forest, forest_classify_batch
    qf = cq.quantize_forest(forest, d=X.shape[1])
    int_forest = Forest(feature=qf.feature, threshold=qf.qthreshold,
                        left=qf.left, right=qf.right, n_class=qf.n_class)
    return forest_classify_batch(int_forest, qk.quantize_rows(X, qf.scale),
                                 depth=depth)


@selector("rf", "forest_votes")
def _rf_select(*, policy=None):
    return "ref"


def forest_votes(forest, X, *, policy: Optional[PrecisionPolicy] = None,
                 path: Optional[str] = None, depth: Optional[int] = None):
    """Forest params + X (B, d) -> (classes (B,) int32, votes (B, n_class)
    int32).  ``depth``: the forest's longest root-to-leaf path, if the
    caller has worked it out already."""
    if policy is not None:
        X = policy.cast(X)
    kp = resolve("rf", "forest_votes", path=path, policy=policy)
    return kp.fn(forest, X, depth=depth)


# ---------------------------------------------------------------------------
# ANN — IVF-PQ asymmetric-distance scoring (B8)
# ---------------------------------------------------------------------------


@register("ann", "adc_topk", "fused")
def _ann_fused(qlut, codes, cand_ids, k):
    return ops.adc_topk(qlut, codes, cand_ids, k)


@register("ann", "adc_topk", "ref")
def _ann_ref(qlut, codes, cand_ids, k):
    return ref.adc_topk(qlut, codes, cand_ids, k)


@selector("ann", "adc_topk")
def _ann_select(*, Q, L, m, n_codes, k, policy=None):
    # B8 stages the LUT in shared memory where it fits and reads it from
    # device memory where it does not, so every shape takes the kernel
    return "fused"


def adc_topk(qlut, codes, cand_ids, k: int, *,
             policy: Optional[PrecisionPolicy] = None,
             path: Optional[str] = None):
    """Per-query integer LUTs (Q, m*n_codes), candidate PQ codes (Q, L, m)
    int8 + ids (Q, L) -> (ADC distances (Q, k) int32, candidate positions
    (Q, k)).  Integer end to end: no policy cast."""
    Q, L, m = codes.shape
    kp = resolve("ann", "adc_topk", path=path, policy=policy, Q=Q, L=L, m=m,
                 n_codes=qlut.shape[1] // max(m, 1), k=k)
    return kp.fn(qlut, codes, cand_ids, k)
