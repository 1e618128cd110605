"""Kernel dispatch: one registry for the Non-Neural hot-path ops.

The part of the JAX package's ``kernels/dispatch.py`` that the fp32/bf16
single-device path of kNN, K-Means and GNB needs.  Each ``(algorithm,
op)`` registers executable arms:

  ``fused``   — a hand-written CUDA kernel that fuses the op (kNN, K-Means),
  ``blocked`` — the feature-chunked GNB kernel (the reference's arm name),
  ``ref``     — the plain PyTorch version (``kernels/ref.py``).

Precedence in ``resolve``: explicit ``path=`` > ``REPRO_BACKEND`` (when the
op has that arm) > the op's shape selector.  A selector returns ``ref``
for shapes its kernel cannot take, so ``resolve`` shows the choice.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops, ref

ENV_VAR = "REPRO_BACKEND"
# the reference's arm names that this package registers; the int8 tier's
# "quant" comes with that tier (ROADMAP A9), and until then REPRO_BACKEND
# rejects it rather than running the fp32 arms
PATH_NAMES = ("fused", "blocked", "ref")

# algorithm -> its serve-time hot op in the registry
HOT_OPS = {"knn": "distance_topk", "kmeans": "distance_argmin",
           "gnb": "scores"}


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
    raise KeyError(f"no hot op for {algorithm!r}; known: {sorted(HOT_OPS)}")


# ---------------------------------------------------------------------------
# PrecisionPolicy — the paper's FP-backend axis (§3.4) as a compute dtype
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrecisionPolicy:
    """The dtype estimators cast float inputs and params to: fp32 (the
    paper's FPU-native arm) or bf16 (reduced precision).  The kernels
    compute in fp32 either way."""

    name: str
    dtype: torch.dtype

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """Cast float tensors to the policy dtype; integers pass through."""
        if x.is_floating_point():
            return x.to(self.dtype)
        return x


POLICIES: Dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy("fp32", torch.float32),
    "bf16": PrecisionPolicy("bf16", torch.bfloat16),
}
DEFAULT_POLICY = POLICIES["fp32"]


def get_policy(name: str) -> PrecisionPolicy:
    if name.split("@")[0] == "int8":
        raise NotImplementedError(
            "the int8 tier is not ported yet (ROADMAP A9)")
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
    if path is not None:
        if path not in paths:
            raise KeyError(f"{key} has no {path!r} path "
                           f"(has {sorted(paths)})")
        chosen = path
    else:
        env = env_override()
        if env is not None and env in paths:
            chosen = env
        else:
            chosen = _SELECTORS[key](policy=policy or DEFAULT_POLICY,
                                     **shape_kw)
    return KernelPath(algorithm, op, chosen, paths[chosen])


# ---------------------------------------------------------------------------
# kNN — fused distance -> top-k (Fig. 6 OP1+OP2), kernel B1
# ---------------------------------------------------------------------------


@register("knn", "distance_topk", "fused")
def _knn_fused(a, c, k):
    return ops.distance_topk(a, c, k)


@register("knn", "distance_topk", "ref")
def _knn_ref(a, c, k):
    return ref.distance_topk(a, c, k)


@selector("knn", "distance_topk")
def _knn_select(*, N, d, Q, k, policy=None):
    # B1 tiles Q and N itself, so any shape fits except a k longer than
    # the per-thread lists it keeps
    return "fused" if k <= ops.TOPK_K_MAX else "ref"


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
# K-Means — fused distance -> argmin (Fig. 7 OP1+OP2), kernel B2
# ---------------------------------------------------------------------------


@register("kmeans", "distance_argmin", "fused")
def _km_fused(a, c):
    return ops.distance_argmin(a, c)


@register("kmeans", "distance_argmin", "ref")
def _km_ref(a, c):
    return ref.distance_argmin(a, c)


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
# GNB — batched joint log-likelihood (Fig. 5 OP1+OP2), kernel B3
# ---------------------------------------------------------------------------


@register("gnb", "scores", "blocked")
def _gnb_blocked(X, mu, var, log_prior):
    return ops.gnb_scores_batch(X, mu, var, log_prior)


@register("gnb", "scores", "ref")
def _gnb_ref(X, mu, var, log_prior):
    return ref.gnb_scores_batch(X, mu, var, log_prior)


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
