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
op has that arm) > a calibrated cost model's measured-fastest fp32 arm near
the batch bucket (never ``quant``, never under the int8 policy, and on a
card never ``ref``) > the op's shape selector.  With a card, calibrated or
not, kNN resolves to ``fused`` or ``blocked`` for every k and ANN to
``fused``, never to ``ref``: only ``path="ref"`` or ``REPRO_BACKEND=ref``
sends a call on the card to the plain version.

``PrecisionPolicy`` carries the paper's FP-backend axis (§3.4, Figs. 9–11)
as a compute dtype plus an analytic cost backend (the libgcc / rvfplib /
fpu / int8 / cortex-m4 cycles-per-op vectors of ``core.precision``), so a
caller can cost a call under each backend (``estimated_cycles``), and
``resolve_strategy`` costs a mesh's partition strategies under it.  The
process-wide ``CostModel`` (``set_cost_model``, or ``REPRO_CALIBRATION``
naming a calibration file, loaded once at first use) is analytic, and
then inert in ``resolve``, until a calibrated one is installed.

The mesh-aware registry (``register_sharded``, ``sharded``,
``resolve_strategy``) keys each hot op's sharded arms by partition
strategy; ``core/cluster.py`` holds them.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import precision
from repro_torch.kernels import ops, ref
from repro_torch.kernels import quantized as qk

ENV_VAR = "REPRO_BACKEND"
# the reference's arm names, in its order
PATH_NAMES = ("fused", "blocked", "ref", "quant")



# algorithm -> census key in core.precision.PAPER_CENSUSES ("ann" maps to
# the paper's kNN census: the probe+ADC structure has no paper analogue,
# and serve-side costing uses precision.serve_census("ann") instead)
_CENSUS_KEY = {"knn": "knn", "kmeans": "kmeans_iter", "gnb": "gnb",
               "gmm": "gmm_iter", "rf": "rf", "lr": "lr", "svm": "svm",
               "ann": "knn"}

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


def _bucket_hint(shape_kw: Dict[str, int]) -> Optional[int]:
    """Batch-size hint from resolve()'s shape kwargs: the query-count axis
    under each op's naming (kNN/ANN ``Q``, GNB/GMM ``B``, K-Means ``N``)."""
    for key in ("Q", "B", "N"):
        if key in shape_kw:
            return int(shape_kw[key])
    return None


# ---------------------------------------------------------------------------
# PrecisionPolicy — the paper's FP-backend axis (§3.4) as a value
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PrecisionPolicy:
    """Compute dtype + analytic cost backend.

    ``dtype`` is what estimators cast float inputs and params to: fp32
    (the paper's FPU-native arm) or bf16 (reduced precision); the fp
    kernels compute in fp32 either way.  ``int8`` is the quantized tier:
    inputs stay fp32 at the API and the estimators rewrite their fitted
    params onto the int8 lattice (``core/quantization.py``).
    ``cost_backend`` names a cycles-per-op vector in
    ``core.precision.BACKENDS`` for the analytic soft-float costing (the
    card has no FP-emulation mode to measure): ``estimated_cycles``, and
    the uncalibrated strategy costs ``resolve_strategy`` compares."""

    name: str
    dtype: torch.dtype
    cost_backend: str = "fpu"

    @property
    def quantized(self) -> bool:
        return self.name.split("@")[0] == "int8"

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        """Cast float tensors to the policy dtype; integers pass through."""
        if x.is_floating_point():
            return x.to(self.dtype)
        return x

    def with_cost_backend(self, backend: str) -> "PrecisionPolicy":
        if backend not in precision.BACKENDS:
            raise KeyError(f"unknown cost backend {backend!r}; known: "
                           f"{sorted(precision.BACKENDS)}")
        return replace(self, cost_backend=backend,
                       name=f"{self.name.split('@')[0]}@{backend}")

    def estimated_cycles(self, algorithm: str,
                         section: str = "total") -> float:
        """Analytic per-inference cycle cost of ``algorithm`` under this
        policy's cost backend (census x cycles-per-op, paper §5.2)."""
        key = _CENSUS_KEY.get(algorithm)
        if key is None or key not in precision.PAPER_CENSUSES:
            raise ValueError(
                f"no census for algorithm {algorithm!r} — known: "
                f"{sorted(_CENSUS_KEY)}; add a census_* entry to "
                "core/precision.py and map it in dispatch._CENSUS_KEY "
                "before costing it")
        census = precision.PAPER_CENSUSES[key]
        backend = precision.BACKENDS[self.cost_backend]
        return precision.predicted_cycles(census, backend, section)


POLICIES: Dict[str, PrecisionPolicy] = {
    "fp32": PrecisionPolicy("fp32", torch.float32, "fpu"),
    "bf16": PrecisionPolicy("bf16", torch.bfloat16, "fpu"),
    # float inputs pass through: the lattice step happens in the quant arms
    # and the quantized estimators, not as a cast; costed with the int8
    # SIMD backend (core/precision.py)
    "int8": PrecisionPolicy("int8", torch.float32, "int8"),
}
DEFAULT_POLICY = POLICIES["fp32"]


def get_policy(name: str) -> PrecisionPolicy:
    """``"fp32"``, ``"bf16"``, ``"int8"``, or ``"<dtype>@<cost_backend>"``
    (``"fp32@rvfplib"``)."""
    base, _, backend = name.partition("@")
    if base not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}"
                       " or <policy>@<cost backend>")
    policy = POLICIES[base]
    return policy.with_cost_backend(backend) if backend else policy


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


# ---------------------------------------------------------------------------
# Active cost model — analytic by default, calibrated when installed
# ---------------------------------------------------------------------------
#
# One process-wide CostModel (core/precision.py) that the path selection
# in resolve consults.  ``REPRO_CALIBRATION=<file>`` installs a calibrated
# model at first use; ``set_cost_model`` installs one programmatically
# (serve --calibration, chip_smoke.py's calibrate phase, tests).  The
# analytic model is inert in ``resolve`` (``preferred_path`` returns None
# without measured rows), so uncalibrated selection is the shape
# selectors' alone.

CALIBRATION_ENV_VAR = "REPRO_CALIBRATION"
_COST_MODEL = None
_ENV_CALIBRATION_LOADED = False


def set_cost_model(model) -> None:
    """Install (or with None, clear) the process-wide CostModel."""
    global _COST_MODEL, _ENV_CALIBRATION_LOADED
    _COST_MODEL = model
    _ENV_CALIBRATION_LOADED = model is not None


def active_cost_model():
    """The installed CostModel, loading ``REPRO_CALIBRATION`` once if set;
    falls back to the shared analytic model."""
    global _COST_MODEL, _ENV_CALIBRATION_LOADED
    if _COST_MODEL is None and not _ENV_CALIBRATION_LOADED:
        _ENV_CALIBRATION_LOADED = True
        src = os.environ.get(CALIBRATION_ENV_VAR, "").strip()
        if src:
            _COST_MODEL = precision.CostModel.from_calibration(src)
    if _COST_MODEL is None:
        _COST_MODEL = precision.CostModel.analytic()
    return _COST_MODEL


def arm_fits(algorithm: str, op: str, path: str, **shape_kw) -> bool:
    """Whether an arm takes these shapes at all: B1 keeps at most
    ``ops.TOPK_K_MAX`` neighbours, so fused kNN refuses a longer k.  A
    calibrated preference and the autotuner never route to an arm that
    refuses the shape; an explicit ``path=`` still reaches it, and
    raises."""
    if (algorithm, op, path) == ("knn", "distance_topk", "fused"):
        return shape_kw.get("k", 1) <= ops.TOPK_K_MAX
    return True


def measured_arm_ok(path: str, device=None) -> bool:
    """Whether a measurement (a calibrated preference, the autotuner) may
    route calls on ``device`` to ``path``: never to the lossy ``quant``,
    and on a card never to ``ref``, the plain version, however it timed.
    On the CPU (and with no device named) ``ref`` is an arm like any
    other, as in the JAX package."""
    if path == "quant":
        return False
    return not (path == "ref" and device is not None
                and torch.device(device).type == "cuda")


def resolve(algorithm: str, op: str, *, path: Optional[str] = None,
            policy: Optional[PrecisionPolicy] = None, cost_model=None,
            device=None, **shape_kw) -> KernelPath:
    """Pick the executable arm for ``(algorithm, op)`` at these shapes:
    explicit ``path=`` > ``REPRO_BACKEND`` (when the op has that arm) > a
    calibrated cost model's measured-fastest fp32 arm near this batch
    bucket (``cost_model``, else the active one) > the op's selector.
    ``device`` is where the operands lie.  The lossy ``quant`` arm is
    never picked implicitly, measured or not, nor ``ref`` on a card
    (``measured_arm_ok``)."""
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
        chosen = None
        cm = cost_model if cost_model is not None else active_cost_model()
        if cm.calibrated and not (policy is not None and policy.quantized):
            pref = cm.preferred_path(algorithm, bucket=_bucket_hint(shape_kw))
            if pref in paths and measured_arm_ok(pref, device) and \
                    arm_fits(algorithm, op, pref, **shape_kw):
                chosen = pref
        if chosen is None:
            chosen = _SELECTORS[key](policy=policy or DEFAULT_POLICY,
                                     **shape_kw)
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
                 device=c.device, N=N, d=d, Q=c.shape[0], k=k)
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
                 device=a.device, N=N, d=d, K=c.shape[0])
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
                 device=X.device, B=B, d=d, C=mu.shape[0])
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
                 device=X.device, B=X.shape[0], d=X.shape[1], k=mu.shape[0])
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
    kp = resolve("rf", "forest_votes", path=path, policy=policy,
                 device=X.device)
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
    kp = resolve("ann", "adc_topk", path=path, policy=policy,
                 device=qlut.device, Q=Q, L=L, m=m,
                 n_codes=qlut.shape[1] // max(m, 1), k=k)
    return kp.fn(qlut, codes, cand_ids, k)


# ---------------------------------------------------------------------------
# Mesh-aware arm — every hot-path op over a sharded data axis
# ---------------------------------------------------------------------------
#
# The sharded arm is keyed like the single-device registry plus a partition
# strategy: "query" shards the batch rows against a replicated model (no
# merge collective: the paper's Independent-Tasks framing); "reference"
# shards the model-side axis (kNN rows, centroids, classes, components,
# trees) and merges per-shard partials (the paper's OP3 master merge).
# Each shard runs the same registry-dispatched arm on its own shapes, so
# the shape selectors, ``path=``, ``REPRO_BACKEND`` and ``measured_arm_ok``
# hold per shard.  The implementations live in core/cluster.py over a
# single-process mesh (launch/mesh.py); the deferred imports break the
# core -> dispatch -> cluster -> core cycle.

STRATEGY_ENV_VAR = "REPRO_SHARD_STRATEGY"
STRATEGY_NAMES = ("single", "query", "reference")
# the arm ``Estimator.predict_batch_sharded_fn(mesh)`` takes when no
# strategy is named (kNN's reference partition; "query" for the others)
DEFAULT_STRATEGY = {"knn": "reference"}

_SHARDED: Dict[Tuple[str, str, str], Callable] = {}


def register_sharded(algorithm: str, op: str, strategy: str = "query"):
    if strategy not in STRATEGY_NAMES:
        raise ValueError(f"unknown strategy {strategy!r}; known: "
                         f"{STRATEGY_NAMES}")

    def deco(fn):
        _SHARDED[(algorithm, op, strategy)] = fn
        return fn

    return deco


def sharded(algorithm: str, op: str,
            strategy: Optional[str] = None) -> Callable:
    """The mesh-aware executor for ``(algorithm, op)`` under ``strategy``
    (None: the algorithm's default arm); raises KeyError for an op with no
    such sharded arm, as ``resolve`` does for an unknown key."""
    if strategy is None:
        strategy = DEFAULT_STRATEGY.get(algorithm, "query")
    key = (algorithm, op, strategy)
    if key not in _SHARDED:
        raise KeyError(f"no sharded arm for {key}; "
                       f"known: {sorted(_SHARDED)}")
    return _SHARDED[key]


def sharded_registered() -> Tuple[Tuple[str, str, str], ...]:
    """(algorithm, op, strategy) keys with a mesh-aware arm."""
    return tuple(sorted(_SHARDED))


def strategy_env_override() -> Optional[str]:
    """``REPRO_SHARD_STRATEGY``: pin the serving partition strategy, with
    ``REPRO_BACKEND``'s contract (a typo fails rather than running the
    default).  ``auto`` defers to the cost model, the default spelled
    out."""
    v = os.environ.get(STRATEGY_ENV_VAR, "").strip()
    if not v or v == "auto":
        return None
    if v not in STRATEGY_NAMES:
        raise ValueError(f"{STRATEGY_ENV_VAR}={v!r} is not one of "
                         f"{('auto',) + STRATEGY_NAMES}")
    return v


def resolve_strategy(algorithm: str, *, bucket: int, n_shards: int,
                     strategy: Optional[str] = None,
                     policy: Optional[PrecisionPolicy] = None,
                     shape: Optional[Dict[str, int]] = None,
                     quantized: Optional[bool] = None,
                     cost_model=None) -> str:
    """The serving partition strategy of one (algorithm, bucket, mesh)
    cell.

    Precedence as in ``resolve``: explicit ``strategy=`` >
    ``REPRO_SHARD_STRATEGY`` > the active cost model (Eq. 15's
    t_par / c + t_seq a partition: under the policy's ``cost_backend``
    when analytic, measured µs a query when calibrated).  Quantized arms
    (the int8 policy or ``REPRO_BACKEND=quant``) leave "reference" out:
    their lattices derive from the model-side operand, which a model
    partition would cut.  A strategy with no registered arm for the
    algorithm is dropped (ANN has no "reference")."""
    if strategy is not None and strategy != "auto":
        if strategy not in STRATEGY_NAMES:
            raise ValueError(f"strategy={strategy!r} is not one of "
                             f"{('auto',) + STRATEGY_NAMES}")
        return strategy
    env = strategy_env_override()
    if env is not None:
        return env
    if quantized is None:
        quantized = ((policy is not None and policy.quantized)
                     or env_override() == "quant")
    cm = cost_model if cost_model is not None else active_cost_model()
    if cm.calibrated:
        base = (policy or DEFAULT_POLICY).name.split("@")[0]
        costs = cm.strategy_costs(
            algorithm, bucket=bucket, n_shards=n_shards, shape=shape,
            quantized=quantized,
            tier=precision.tier_for(base, quantized=quantized))
    else:
        backend = precision.BACKENDS[(policy or DEFAULT_POLICY).cost_backend]
        costs = precision.serve_strategy_costs(
            algorithm, bucket=bucket, n_shards=n_shards, shape=shape,
            backend=backend, quantized=quantized)
    for cand in [s for s in costs if s != "single"]:
        if not any(a == algorithm and st == cand for a, _, st in _SHARDED):
            del costs[cand]
    return precision.pick_strategy(costs)


@register_sharded("knn", "distance_topk", "reference")
def distance_topk_sharded(a, c, k, *, mesh, axis="data", policy=None,
                          path=None, merge=None):
    """Reference rows sharded, the per-shard arm, the candidate merge
    (the butterfly on power-of-two meshes)."""
    from repro_torch.core import cluster
    return cluster.distance_topk_shardmap(a, c, k, mesh, axis,
                                          policy=policy, path=path,
                                          merge=merge)


@register_sharded("knn", "distance_topk", "query")
def distance_topk_query_sharded(a, c, k, *, mesh, axis="data", policy=None,
                                path=None):
    from repro_torch.core import cluster
    return cluster.distance_topk_query_shardmap(a, c, k, mesh, axis,
                                                policy=policy, path=path)


@register_sharded("ann", "adc_topk", "query")
def adc_topk_query_sharded(qlut, codes, cand_ids, k, *, mesh, axis="data",
                           policy=None, path=None):
    """Every ADC operand is indexed by query row: shards run the whole op
    on their rows, no merge."""
    from repro_torch.core import cluster
    return cluster.adc_topk_query_shardmap(qlut, codes, cand_ids, k, mesh,
                                           axis, policy=policy, path=path)


@register_sharded("kmeans", "distance_argmin", "query")
def distance_argmin_sharded(a, c, *, mesh, axis="data", policy=None,
                            path=None):
    from repro_torch.core import cluster
    return cluster.distance_argmin_shardmap(a, c, mesh, axis,
                                            policy=policy, path=path)


@register_sharded("kmeans", "distance_argmin", "reference")
def distance_argmin_centroid_sharded(a, c, *, mesh, axis="data",
                                     policy=None, path=None):
    from repro_torch.core import cluster
    return cluster.distance_argmin_centroid_shardmap(a, c, mesh, axis,
                                                     policy=policy,
                                                     path=path)


@register_sharded("gnb", "scores", "query")
def gnb_scores_sharded(X, mu, var, log_prior, *, mesh, axis="data",
                       policy=None, path=None):
    from repro_torch.core import cluster
    return cluster.gnb_scores_shardmap(X, mu, var, log_prior, mesh, axis,
                                       policy=policy, path=path)


@register_sharded("gnb", "scores", "reference")
def gnb_scores_class_sharded(X, mu, var, log_prior, *, mesh, axis="data",
                             policy=None, path=None):
    from repro_torch.core import cluster
    return cluster.gnb_scores_class_shardmap(X, mu, var, log_prior, mesh,
                                             axis, policy=policy, path=path)


@register_sharded("gmm", "responsibilities", "query")
def gmm_responsibilities_sharded(mu, var, log_pi, X, *, mesh, axis="data",
                                 policy=None, path=None, n_cores=8):
    from repro_torch.core import cluster
    return cluster.gmm_responsibilities_shardmap(mu, var, log_pi, X, mesh,
                                                 axis, policy=policy,
                                                 path=path, n_cores=n_cores)


@register_sharded("gmm", "responsibilities", "reference")
def gmm_responsibilities_comp_sharded(mu, var, log_pi, X, *, mesh,
                                      axis="data", policy=None, path=None,
                                      n_cores=8):
    from repro_torch.core import cluster
    return cluster.gmm_responsibilities_comp_shardmap(
        mu, var, log_pi, X, mesh, axis, policy=policy, path=path,
        n_cores=n_cores)


@register_sharded("rf", "forest_votes", "query")
def forest_votes_sharded(forest, X, *, mesh, axis="data", policy=None,
                         path=None, depth=None):
    from repro_torch.core import cluster
    return cluster.forest_votes_shardmap(forest, X, mesh, axis,
                                         policy=policy, path=path,
                                         depth=depth)


@register_sharded("rf", "forest_votes", "reference")
def forest_votes_tree_sharded(forest, X, *, mesh, axis="data", policy=None,
                              path=None, depth=None):
    from repro_torch.core import cluster
    return cluster.forest_votes_tree_shardmap(forest, X, mesh, axis,
                                              policy=policy, path=path,
                                              depth=depth)


# ---------------------------------------------------------------------------
# Grouped arm — one launch over a (G, ...) stacked model group
# ---------------------------------------------------------------------------
#
# Multi-tenant serving (serving/model_store.py): G same-shape fitted models
# stack along a leading axis (core.estimator.stack_params) and a whole
# group serves as one launch.  The reference vmaps the estimator's batch fn
# over the group, each lane running the registry-dispatched kernel
# unchanged; vmap cannot batch a ctypes launch, so here the kernels of the
# main path take the group themselves: B1 (kNN, k <= 32), B2 (K-Means) and
# B3 (GNB at d >= 64 and GMM's blocked arm) have a tenant axis, one launch
# for the group and each lane bit-equal to the one-tenant launch.  The
# paths with no kernel (the RF traversal, the GMM chunked E-step, GNB's
# plain version below d = 64) run their torch ops batched over the tenant
# axis.  An arm that has no tenant axis (kNN's blocked B4 + B5 past k = 32,
# the int8 tier's B6/B7 and affine scores, any ``quant`` arm) runs once a
# tenant inside the one grouped call, as ``_per_tenant`` says, and counts
# one launch a tenant.  The arm is registered per algorithm, so an
# algorithm whose params cannot stack (ANN: ragged inverted lists) refuses
# instead.

_GROUPED: Dict[str, Callable] = {}


def register_grouped(algorithm: str):
    def deco(fn):
        _GROUPED[algorithm] = fn
        return fn

    return deco


def grouped(algorithm: str) -> Callable:
    """The grouped-launch builder for ``algorithm``: called as
    ``grouped(alg)(estimator)`` it returns ``(stacked_params, Xg (G, B, d))
    -> (preds (G, B), aux (G, B, ...))`` with the estimator's static
    configuration (k, policy, path, n_class) closed over.  Raises KeyError
    for an algorithm with no grouped arm."""
    if algorithm not in _GROUPED:
        raise KeyError(f"no grouped serving arm for {algorithm!r}; "
                       f"known: {sorted(_GROUPED)}")
    return _GROUPED[algorithm]


def grouped_registered() -> Tuple[str, ...]:
    """Algorithms with a grouped (multi-tenant) arm."""
    return tuple(sorted(_GROUPED))


def _per_tenant(fn: Callable, *group):
    """``fn`` once a tenant over the leading axis of the ``group`` tensors
    (other arguments pass as they are), its outputs stacked: the grouped
    form of an arm that has no tenant axis."""
    G = next(a.shape[0] for a in group if isinstance(a, torch.Tensor))
    outs = [fn(*(a[t] if isinstance(a, torch.Tensor) else a
                 for a in group)) for t in range(G)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def _gmm_blocked_group(mu, var, log_pi, X, *, n_cores=8):
    joint = ops.gnb_scores_batch_group(X, mu, var, log_pi)
    norm = torch.logsumexp(joint, dim=2, keepdim=True)
    return joint - norm, torch.mean(norm[..., 0], dim=1)


def _gmm_ref_group(mu, var, log_pi, X, *, n_cores=8):
    from repro_torch.core.gmm import gmm_e_step_group
    return gmm_e_step_group(X, mu, var, log_pi, n_cores)


def _rf_ref_group(forest, X, *, depth=None):
    from repro_torch.core.random_forest import forest_classify_batch_group
    return forest_classify_batch_group(forest, X, depth=depth)


# (algorithm, op, arm) -> that arm over a group in one call
_GROUP_ARMS: Dict[Tuple[str, str, str], Callable] = {
    ("knn", "distance_topk", "fused"): ops.distance_topk_group,
    ("knn", "distance_topk", "ref"): ref.distance_topk_group,
    ("kmeans", "distance_argmin", "fused"): ops.distance_argmin_group,
    ("kmeans", "distance_argmin", "ref"): ref.distance_argmin_group,
    ("gnb", "scores", "blocked"): ops.gnb_scores_batch_group,
    ("gnb", "scores", "ref"): ref.gnb_scores_batch_group,
    ("gmm", "responsibilities", "blocked"): _gmm_blocked_group,
    ("gmm", "responsibilities", "ref"): _gmm_ref_group,
    ("rf", "forest_votes", "ref"): _rf_ref_group,
}


def group_arm(kp: KernelPath) -> Optional[Callable]:
    """The grouped form of a resolved arm, or None where the arm has no
    tenant axis (it then runs once a tenant)."""
    return _GROUP_ARMS.get((kp.algorithm, kp.op, kp.name))


def distance_topk_group(a, c, k: int, *,
                        policy: Optional[PrecisionPolicy] = None,
                        path: Optional[str] = None):
    """A (G, N, d) data, C (G, Q, d) queries -> (values (G, Q, k), indices
    (G, Q, k)), the arm ``distance_topk`` resolves for one tenant."""
    if policy is not None:
        a, c = policy.cast(a), policy.cast(c)
    G, N, d = a.shape
    kp = resolve("knn", "distance_topk", path=path, policy=policy,
                 device=c.device, N=N, d=d, Q=c.shape[1], k=k)
    arm = group_arm(kp)
    if arm is not None:
        return arm(a, c, k)
    return _per_tenant(kp.fn, a, c, k)


def distance_argmin_group(a, c, *, policy: Optional[PrecisionPolicy] = None,
                          path: Optional[str] = None):
    """A (G, N, d), centroids (G, K, d) -> (min sq-dist (G, N), nearest id
    (G, N))."""
    if policy is not None:
        a, c = policy.cast(a), policy.cast(c)
    G, N, d = a.shape
    kp = resolve("kmeans", "distance_argmin", path=path, policy=policy,
                 device=a.device, N=N, d=d, K=c.shape[1])
    arm = group_arm(kp)
    if arm is not None:
        return arm(a, c)
    return _per_tenant(kp.fn, a, c)


def gnb_scores_group(X, mu, var, log_prior, *,
                     policy: Optional[PrecisionPolicy] = None,
                     path: Optional[str] = None):
    """X (G, B, d) queries -> (G, B, C) joint log-likelihood."""
    if policy is not None:
        X, mu, var = policy.cast(X), policy.cast(mu), policy.cast(var)
    G, B, d = X.shape
    kp = resolve("gnb", "scores", path=path, policy=policy,
                 device=X.device, B=B, d=d, C=mu.shape[1])
    arm = group_arm(kp)
    if arm is not None:
        return arm(X, mu, var, log_prior)
    return _per_tenant(kp.fn, X, mu, var, log_prior)


def gmm_responsibilities_group(mu, var, log_pi, X, *,
                               policy: Optional[PrecisionPolicy] = None,
                               path: Optional[str] = None,
                               n_cores: int = 8):
    """X (G, B, d) -> (log-responsibilities (G, B, k), mean
    log-likelihood (G,))."""
    if policy is not None:
        mu, var, X = policy.cast(mu), policy.cast(var), policy.cast(X)
    kp = resolve("gmm", "responsibilities", path=path, policy=policy,
                 device=X.device, B=X.shape[1], d=X.shape[2], k=mu.shape[1])
    arm = group_arm(kp)
    if arm is not None:
        return arm(mu, var, log_pi, X, n_cores=n_cores)
    return _per_tenant(lambda m, v, lp, x: kp.fn(m, v, lp, x,
                                                 n_cores=n_cores),
                       mu, var, log_pi, X)


def forest_votes_group(forest, X, *,
                       policy: Optional[PrecisionPolicy] = None,
                       path: Optional[str] = None,
                       depth: Optional[int] = None):
    """Stacked forests (arrays (G, T, M)) + X (G, B, d) -> (classes (G, B)
    int32, votes (G, B, n_class) int32)."""
    if policy is not None:
        X = policy.cast(X)
    kp = resolve("rf", "forest_votes", path=path, policy=policy,
                 device=X.device)
    arm = group_arm(kp)
    if arm is not None:
        return arm(forest, X, depth=depth)
    from repro_torch.core.estimator import unstack_params
    outs = [kp.fn(unstack_params(forest, t), X[t])
            for t in range(X.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _loop_group(est) -> Callable:
    """The grouped call of an estimator whose hot path has no tenant axis
    (its int8 lattice form): ``predict_batch_fn`` once a tenant."""
    from repro_torch.core.estimator import unstack_params
    fn = est.predict_batch_fn()

    def group_fn(stacked, Xg):
        outs = [fn(unstack_params(stacked, t), Xg[t])
                for t in range(Xg.shape[0])]
        return tuple(torch.stack(parts) for parts in zip(*outs))

    return group_fn


@register_grouped("knn")
def _knn_grouped(est) -> Callable:
    if est.quantized:
        return _loop_group(est)
    from repro_torch.core.knn import vote_group
    k, policy, path = est.k, est.policy, est.path
    n_class = est.params.n_class

    def fn(stacked, Xg):
        Xg = policy.cast(Xg) if policy else Xg
        _, nbr = distance_topk_group(stacked.A, Xg, k, policy=policy,
                                     path=path)
        return vote_group(stacked.labels, nbr, n_class), nbr

    return fn


@register_grouped("kmeans")
def _kmeans_grouped(est) -> Callable:
    if est.quantized:
        return _loop_group(est)
    policy, path = est.policy, est.path

    def fn(stacked, Xg):
        Xg = policy.cast(Xg) if policy else Xg
        dist, ids = distance_argmin_group(Xg, stacked.centroids,
                                          policy=policy, path=path)
        return ids, dist

    return fn


@register_grouped("gnb")
def _gnb_grouped(est) -> Callable:
    if est.quantized:
        return _loop_group(est)
    policy, path = est.policy, est.path

    def fn(stacked, Xg):
        Xg = policy.cast(Xg) if policy else Xg
        scores = gnb_scores_group(Xg, stacked.mu, stacked.var,
                                  stacked.log_prior, policy=policy,
                                  path=path)
        return torch.argmax(scores, dim=2).to(torch.int32), scores

    return fn


@register_grouped("gmm")
def _gmm_grouped(est) -> Callable:
    if est.quantized:
        return _loop_group(est)
    policy, path, n_cores = est.policy, est.path, est.n_cores

    def fn(stacked, Xg):
        Xg = policy.cast(Xg) if policy else Xg
        lr, _ = gmm_responsibilities_group(
            stacked.mu, stacked.var, stacked.log_pi, Xg, policy=policy,
            path=path, n_cores=n_cores)
        return torch.argmax(lr, dim=2).to(torch.int32), lr

    return fn


@register_grouped("rf")            # after pad_nodes normalization
def _rf_grouped(est) -> Callable:
    if est.quantized:
        return _loop_group(est)
    policy, path = est.policy, est.path

    def fn(stacked, Xg):
        Xg = policy.cast(Xg) if policy else Xg
        return forest_votes_group(stacked, Xg, policy=policy, path=path)

    return fn
