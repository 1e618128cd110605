"""FP backend cost model (paper §3.4 / §5.2).

The port's copy of the JAX package's ``core/precision.py``: plain numpy,
the same tables and arithmetic.

The paper runs identical IEEE-754 FP32 algorithms under three backends —
libgcc soft-float, RVfplib optimised soft-float, FPU-native — plus a
Cortex-M4 port. A GPU has no FP-emulation mode either (its cores are
native bf16/f32), so the reproduction of Figures 9-11 / Tables 2-3 is
analytic:

  1. ``census_*`` — per-kernel FP-op counts (add/mul/div/cmp/exp) and
     inner-loop element counts derived from the algorithm structure of OUR
     implementation, split into parallel and sequential (OP3) sections —
     the software analogue of the paper's per-core performance counters.
  2. ``BACKENDS`` — cycles-per-op vectors for each backend (seeded from the
     RVfplib paper and FPnew latencies).
  3. ``fit_backend`` — least-squares refit of a backend's cost vector
     against the paper's measured single-core cycles (Table 2), so the
     claim "one cost vector explains all kernels" is testable; benchmarks
     report per-kernel relative error and cross-backend speedup ratios.

Cycle cost = sum_op census[op] * cost[op] + census[elem] * cost[overhead]
           + census[ielem] * cost[ielem].

``ielem`` is INTEGER traversal work (pointer chasing, index compare/branch —
RF's node walk): it does not shrink when the FP backend improves, which is
exactly the paper's "RF has 6.39% FLOP intensity, hence only 2.48x from the
FPU" observation (§5.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

OPS = ("add", "mul", "div", "cmp", "exp", "elem", "ielem")


@dataclass(frozen=True)
class BackendCosts:
    """Cycles per FP32 op. ``elem`` = per-inner-loop-element overhead
    (loads, index arithmetic, branches; PULP hardware loops make it small);
    ``ielem`` = integer-dominated per-node work (FP-backend invariant)."""

    name: str
    add: float
    mul: float
    div: float
    cmp: float
    exp: float     # transcendental (expf/logf class)
    elem: float
    ielem: float = 8.0

    def vector(self) -> np.ndarray:
        return np.array([self.add, self.mul, self.div, self.cmp,
                         self.exp, self.elem, self.ielem], dtype=np.float64)


# Seeds: libgcc/RVfplib soft-float latencies from the RVfplib paper (SAMOS'21)
# incl. calling-convention overhead; FPU from FPnew (shared, 1 pipe stage);
# M4 from the Cortex-M4 TRM (FPv4-SP: 1c add/mul, 14c div; no HW loops or
# post-increment addressing -> bigger per-element overhead).
BACKENDS: Dict[str, BackendCosts] = {
    "libgcc": BackendCosts("libgcc", add=85, mul=70, div=140, cmp=25,
                           exp=2400, elem=8, ielem=8),
    "rvfplib": BackendCosts("rvfplib", add=45, mul=38, div=160, cmp=12,
                            exp=2000, elem=8, ielem=8),
    "fpu": BackendCosts("fpu", add=1, mul=1, div=11, cmp=1, exp=75, elem=2,
                        ielem=7),
    # int8 SIMD (PULP-NN style): 4x 8-bit MACs per cycle on the paper's
    # RI5CY cores, so add/mul/cmp cost a quarter cycle in the steady
    # state; div/exp stay fp32 (the quant arms fold them into fp32 score
    # tables at calibration — core/quantization.py — so the per-inference
    # census keeps them only where a kernel genuinely evaluates them);
    # per-element overhead halves (loads move 4-packed bytes); integer
    # traversal work (ielem) is representation-invariant — the same
    # reason RF only gains 2.48x from the FPU (§5.2)
    "int8": BackendCosts("int8", add=0.25, mul=0.25, div=11, cmp=0.25,
                         exp=75, elem=1, ielem=7),
    "cortex-m4": BackendCosts("cortex-m4", add=1, mul=1, div=14, cmp=1.5,
                              exp=140, elem=7, ielem=9.5),
}


@dataclass
class Census:
    """Op counts for one kernel inference: parallel + sequential sections."""

    name: str
    parallel: Dict[str, float]
    sequential: Dict[str, float]

    def total(self) -> Dict[str, float]:
        return {op: self.parallel.get(op, 0.0) + self.sequential.get(op, 0.0)
                for op in OPS}

    def vector(self, section: str = "total") -> np.ndarray:
        src = (self.total() if section == "total"
               else getattr(self, section))
        return np.array([src.get(op, 0.0) for op in OPS], dtype=np.float64)


# ---------------------------------------------------------------------------
# Per-kernel censuses (paper datasets: MNIST d=784 C=10 for GEMM/GNB;
# ASD N=1000 d=21 for MS-based, k-Means k=2, kNN k=4; digits for RF)
# ---------------------------------------------------------------------------


def census_svm(d: int = 784, n_class: int = 10) -> Census:
    return Census(
        "svm",
        parallel={"mul": d * n_class, "add": d * n_class + n_class,
                  "elem": d * n_class},
        sequential={"cmp": 2 * n_class, "elem": n_class},  # sign + argmax
    )


def census_lr(d: int = 784, n_class: int = 10) -> Census:
    return Census(
        "lr",
        parallel={"mul": d * n_class, "add": d * n_class + n_class,
                  "elem": d * n_class},
        # softmax (exp, sum, div) + argmax on the master core
        sequential={"exp": n_class, "add": n_class, "div": n_class,
                    "cmp": n_class, "elem": 3 * n_class},
    )


def census_gnb(d: int = 784, n_class: int = 10) -> Census:
    # paper's formulation: per (class, feature): sub, 2 mul, div, exp
    per = d * n_class
    return Census(
        "gnb",
        parallel={"add": per, "mul": 2 * per, "div": per, "exp": per,
                  "elem": per},
        sequential={"mul": n_class, "cmp": n_class, "elem": n_class},
    )


def census_knn(n: int = 1000, d: int = 21, k: int = 4,
               n_cores: int = 1) -> Census:
    # distances: per element sub, mul, add; local SS: (n/c)*k cmps per core
    # (all cores concurrently); global merge: c*k cmps sequential
    return Census(
        "knn",
        parallel={"add": 2 * n * d, "mul": n * d, "elem": n * d,
                  "cmp": n * k},
        sequential={"cmp": n_cores * k * k + k, "elem": n_cores * k},
    )


def census_kmeans_iter(n: int = 1000, d: int = 21, k: int = 2) -> Census:
    # one Fig. 7 iteration: distances n*k*d, assign n*k cmp, local update
    # n*d add; global update k*d div (parallel over cores in OP4)
    return Census(
        "kmeans_iter",
        parallel={"add": 2 * n * k * d + n * d, "mul": n * k * d,
                  "cmp": n * k, "div": k * d, "elem": n * k * d},
        sequential={"add": k * d, "cmp": k, "elem": k},  # convergence check
    )


def census_rf(n_trees: int = 48, depth: int = 7, n_class: int = 10) -> Census:
    """Forest size is not given in the paper; (48 trees x depth 7) is fitted
    to the libgcc cycle budget (16.8k) and then held fixed — the other five
    backend/parallel numbers are predictions. Node traversal is integer work
    (gathers + branch), hence ``ielem``; only the threshold compare is FP."""
    per_tree = depth
    return Census(
        "rf",
        parallel={"cmp": n_trees * per_tree, "ielem": 3 * n_trees * per_tree},
        sequential={"cmp": n_class, "ielem": n_class},  # vote argmax (master)
    )


def census_gmm_iter(n: int = 1000, d: int = 21, k: int = 2) -> Census:
    """One EM iteration of the diagonal-covariance GMM (core/gmm.py) — the
    paper's §6 future-work kernel, costed with the same op-census scheme.
    E-step: per (sample, component, feature) sub/mul/div/add plus a
    per-(sample, component) exp for the responsibility normalisation;
    M-step: K-Means-style soft accumulate (2 mul+add per element for the
    s1/s2 sums) and a k*d divide in the global combine."""
    e_elem = n * k * d
    return Census(
        "gmm_iter",
        parallel={"add": 3 * e_elem + 2 * e_elem, "mul": e_elem + 2 * e_elem,
                  "div": e_elem, "exp": n * k, "elem": 2 * e_elem},
        # convergence check on the master: mean log-lik delta
        sequential={"add": n, "div": 1, "cmp": 1, "elem": n},
    )


PAPER_CENSUSES = {
    "svm": census_svm(),
    "lr": census_lr(),
    "gnb": census_gnb(),
    "knn": census_knn(),
    "kmeans_iter": census_kmeans_iter(),
    "gmm_iter": census_gmm_iter(),
    "rf": census_rf(),
}


# ---------------------------------------------------------------------------
# Cost evaluation + refit against measured cycles
# ---------------------------------------------------------------------------


def predicted_cycles(census: Census, backend: BackendCosts,
                     section: str = "total") -> float:
    return float(census.vector(section) @ backend.vector())


# ---------------------------------------------------------------------------
# Sharded-serving strategy cost model (Eq. 15 / §5.3)
# ---------------------------------------------------------------------------
#
# Eq. 15 bounds parallel speedup by t_par/c + t_seq: the sequential term is
# what each partition strategy changes.  "reference" (model partition,
# the paper's master-merge OP3) divides the per-query work by c but pays a
# per-launch merge collective; "query" (batch partition, the paper's
# Independent-Tasks framing / PULP-NN's replicated-weights layout) runs
# ceil(bucket/c) whole queries per shard with NO merge; "single" pays no
# mesh dispatch at all.  The constants are per-launch overheads in the
# same cycle units as ``BackendCosts``, the JAX package's values (fitted
# there to its own sharded measurements), not derived from hardware.  No
# selector of the port consults them until the sharded layer exists.

SHARD_STRATEGIES = ("single", "query", "reference")
SHARD_LAUNCH_CYCLES = 2000.0       # mesh dispatch: shard_map launch latency
COLLECTIVE_LAUNCH_CYCLES = 1000.0  # fixed cost of the merge collective
COLLECTIVE_ELEM_CYCLES = 1.0       # per element moved by the merge


@dataclass(frozen=True)
class StrategyCost:
    """Modelled cycles for serving one bucket under one partition."""

    strategy: str
    compute: float    # per-shard parallel-section cycles (t_par / c)
    overhead: float   # launch + merge-collective cycles (the t_seq term)

    @property
    def total(self) -> float:
        return self.compute + self.overhead


SERVE_CENSUS_ALGOS = ("knn", "kmeans", "gnb", "gmm", "rf", "ann")


def serve_census(algorithm: str, shape: Dict[str, int] = None) -> Census:
    """Per-QUERY op census of one serve inference (the fit-side loops and
    their convergence checks do not run at serve time, so K-Means/GMM get
    lightweight serve-only counts instead of their *_iter censuses)."""
    s = dict(shape or {})
    if algorithm == "knn":
        return census_knn(n=s.get("N", 1000), d=s.get("d", 21),
                          k=s.get("k", 4))
    if algorithm == "kmeans":
        K, d = s.get("K", 2), s.get("d", 21)
        return Census("kmeans_serve",
                      parallel={"add": 2 * K * d, "mul": K * d, "cmp": K,
                                "elem": K * d},
                      sequential={})
    if algorithm == "gnb":
        return census_gnb(d=s.get("d", 784), n_class=s.get("C", 10))
    if algorithm == "gmm":
        K, d = s.get("K", 2), s.get("d", 21)
        e = K * d
        return Census("gmm_serve",
                      parallel={"add": 3 * e, "mul": e, "div": e,
                                "exp": K, "elem": 2 * e},
                      sequential={"cmp": K, "elem": K})
    if algorithm == "rf":
        return census_rf(n_trees=s.get("T", 48), depth=s.get("depth", 7),
                         n_class=s.get("C", 10))
    if algorithm == "ann":
        # IVF-PQ serve: coarse probe = a kNN distance
        # pass over the C cell centroids; LUT build = m*n_codes subspace
        # distances of width dsub; ADC scoring = m integer table lookups
        # + adds per candidate (gather-bound -> ielem, the same
        # FP-backend-invariant class as RF traversal) + the top-k scan
        C, d = s.get("C", 64), s.get("d", 21)
        m, n_codes = s.get("m", 4), s.get("n_codes", 256)
        L, k = s.get("L", 512), s.get("k", 4)
        R = s.get("R", 0)          # exact refine rows per query (0 = off)
        dsub = max(1, -(-d // m))
        lut = m * n_codes * dsub
        return Census(
            "ann_serve",
            parallel={"add": 2 * C * d + 2 * lut + L * m + 2 * R * d,
                      "mul": C * d + lut + R * d, "cmp": C * k + L + R,
                      "elem": C * d + lut + R * d, "ielem": 2 * L * m},
            sequential={"cmp": k, "elem": k})
    raise ValueError(
        f"no serve census for {algorithm!r} — known: "
        f"{sorted(SERVE_CENSUS_ALGOS)}; add a census entry to "
        "core/precision.py::serve_census before costing it")


def merge_elems(algorithm: str, shape: Dict[str, int] = None,
                n_shards: int = 8) -> float:
    """Per-query elements the reference-strategy merge collective moves:
    kNN's butterfly exchanges (value, index) k-pairs for log2(c) rounds;
    the other merges move per-shard partials once."""
    s = dict(shape or {})
    if algorithm == "knn":
        rounds = max(1, (n_shards - 1).bit_length())
        return 2.0 * s.get("k", 4) * rounds
    if algorithm == "kmeans":
        return 2.0 * n_shards                  # c (min, argmin) pairs
    if algorithm == "gnb":
        return float(s.get("C", 10))           # gathered (B, C) scores
    if algorithm == "gmm":
        return float(s.get("K", 2))            # gathered (B, K) joint
    if algorithm == "rf":
        return float(s.get("C", 10) + 1)       # psum'd vote histogram
    if algorithm == "ann":
        # hypothetical cell-partition merge would move kNN-style (value,
        # position) k-pairs; ANN registers no "reference" arm, so
        # dispatch.resolve_strategy filters this candidate back out
        rounds = max(1, (n_shards - 1).bit_length())
        return 2.0 * s.get("k", 4) * rounds
    raise ValueError(
        f"no merge model for {algorithm!r} — known: "
        f"{sorted(SERVE_CENSUS_ALGOS)}; add a merge term to "
        "core/precision.py::merge_elems before costing it")


# Calibration tiers (core/calibrate.py): each maps a (policy, path) pair
# onto one refit us-per-op vector / one family of measured us-per-query rows.
CALIBRATION_TIERS = ("fp32-ref", "fused", "bf16", "int8", "grouped")


def tier_for(policy_name: str = "fp32", *, quantized: bool = False,
             path: str = None, grouped: bool = False) -> str:
    """Map a (policy, path, grouping) triple onto its calibration tier."""
    if grouped:
        return "grouped"
    if quantized or policy_name == "int8":
        return "int8"
    if policy_name == "bf16":
        return "bf16"
    return "fp32-ref" if path == "ref" else "fused"


@dataclass
class CostModel:
    """The one object every cost decision consults.

    Analytic by default: ``BackendCosts`` cycles x op censuses plus the
    Eq. 15 overhead constants, inert in ``dispatch.resolve``.  Calibrated
    when built from a calibration entry (``core/calibrate.py``'s
    ``fit_calibration``, or a file holding ``{"entries": [...]}``):
    measured us-per-query rows and refit per-tier us-per-op vectors
    replace the datasheet numbers wherever a measurement exists, and
    ``us_per_cycle`` rescales the launch/collective constants into the
    same units; anything unmeasured falls back to analytic.  The port
    builds one only from measurements taken on its own device.
    """

    backend: BackendCosts = None
    # tier -> us-per-op vector over OPS (refit by core/calibrate.py)
    vectors: Dict[str, np.ndarray] = field(default_factory=dict)
    # tier -> fitted per-launch overhead (us), amortised over the bucket —
    # the dispatch cost the per-op census cannot express
    launch_us: Dict[str, float] = field(default_factory=dict)
    # (algorithm, tier) -> sorted [(bucket, best measured us/query)]
    query_us: Dict[Tuple[str, str], List[Tuple[int, float]]] = \
        field(default_factory=dict)
    # (algorithm, bucket) -> {path: us/query} over the fp32 tiers — the
    # rows the path selector consults
    path_us: Dict[Tuple[str, int], Dict[str, float]] = \
        field(default_factory=dict)
    us_per_cycle: Optional[float] = None   # rescales Eq. 15 constants
    source: str = "analytic"

    def __post_init__(self):
        if self.backend is None:
            self.backend = BACKENDS["fpu"]

    @property
    def calibrated(self) -> bool:
        return bool(self.query_us or self.path_us or self.vectors)

    # -- construction -------------------------------------------------
    @classmethod
    def analytic(cls, backend: BackendCosts = None) -> "CostModel":
        return cls(backend=backend)

    @classmethod
    def from_calibration(cls, entry) -> "CostModel":
        """Build from a calibration entry dict, or the path of a file
        holding ``{"entries": [...]}`` (latest entry wins)."""
        if not isinstance(entry, dict):
            import json
            with open(entry) as fh:
                entry = json.load(fh)["entries"][-1]
        vectors = {tier: np.array([vec[op] for op in OPS], dtype=np.float64)
                   for tier, vec in entry.get("vectors", {}).items()}
        launch_us = {tier: float(vec.get("launch_us", 0.0))
                     for tier, vec in entry.get("vectors", {}).items()}
        query_us: Dict[Tuple[str, str], Dict[int, float]] = {}
        path_us: Dict[Tuple[str, int], Dict[str, float]] = {}
        for rec in entry["results"]:
            algo, tier = rec["algorithm"], rec["tier"]
            b, us = int(rec["bucket"]), float(rec["measured_us"])
            rows = query_us.setdefault((algo, tier), {})
            if b not in rows or us < rows[b]:
                rows[b] = us
            if tier in ("fp32-ref", "fused"):
                paths = path_us.setdefault((algo, b), {})
                p = rec["path"]
                if p not in paths or us < paths[p]:
                    paths[p] = us
        summary = entry.get("summary", {})
        return cls(vectors=vectors,
                   launch_us=launch_us,
                   query_us={k: sorted(v.items())
                             for k, v in query_us.items()},
                   path_us=path_us,
                   us_per_cycle=summary.get("us_per_cycle"),
                   source="calibrated")

    # -- queries ------------------------------------------------------
    @staticmethod
    def _nearest(rows: List[Tuple[int, float]], bucket: int) -> float:
        """Measured us/query at the log-nearest measured bucket."""
        b = max(int(bucket), 1)
        return min(rows, key=lambda r: abs(np.log(max(r[0], 1) / b)))[1]

    def serve_us(self, algorithm: str, *, shape: Dict[str, int] = None,
                 tier: str = "fused", bucket: int = 1) -> Optional[float]:
        """Calibrated per-query us estimate; None when uncalibrated for
        this (algorithm, tier)."""
        rows = self.query_us.get((algorithm, tier))
        if rows:
            return self._nearest(rows, bucket)
        vec = self.vectors.get(tier)
        if vec is not None:
            return (float(serve_census(algorithm, shape).vector() @ vec)
                    + self.launch_us.get(tier, 0.0) / max(int(bucket), 1))
        return None

    def preferred_path(self, algorithm: str,
                       bucket: int = None) -> Optional[str]:
        """Measured-fastest fp32 path near ``bucket``, or None when fewer
        than two paths were measured there — the analytic shape selector
        keeps deciding in that case, so an uncalibrated model is inert."""
        buckets = [b for (a, b) in self.path_us if a == algorithm]
        if not buckets:
            return None
        if bucket is None:
            b = max(buckets)
        else:
            ref = max(int(bucket), 1)
            b = min(buckets, key=lambda x: abs(np.log(max(x, 1) / ref)))
        paths = self.path_us[(algorithm, b)]
        if len(paths) < 2:
            return None
        return min(paths, key=paths.get)

    def strategy_costs(self, algorithm: str, *, bucket: int, n_shards: int,
                       shape: Dict[str, int] = None,
                       quantized: bool = False,
                       tier: str = None) -> Dict[str, StrategyCost]:
        """Eq. 15 costs per applicable partition strategy.

        ``quantized`` drops "reference": the int8 arms derive their
        lattices from the model-side operand, so a model partition changes
        the lattice per shard (core/cluster.py documents this per arm).
        Calibrated models swap the analytic per-query cycle weight for the
        measured us/query at the nearest bucket and rescale the overhead
        constants by ``us_per_cycle``; otherwise the numbers are identical
        to the historical ``serve_strategy_costs``."""
        tier = tier or ("int8" if quantized else "fused")
        w = unit = None
        if self.calibrated and self.us_per_cycle:
            w = self.serve_us(algorithm, shape=shape, tier=tier,
                              bucket=bucket)
            unit = self.us_per_cycle
        if w is None:
            w = predicted_cycles(serve_census(algorithm, shape),
                                 self.backend)
            unit = 1.0
        costs = {"single": StrategyCost("single", compute=bucket * w,
                                        overhead=0.0)}
        if n_shards > 1:
            per_shard = -(-bucket // n_shards)     # ceil: whole query rows
            costs["query"] = StrategyCost(
                "query", compute=per_shard * w,
                overhead=SHARD_LAUNCH_CYCLES * unit)
            if not quantized:
                moved = bucket * merge_elems(algorithm, shape, n_shards)
                costs["reference"] = StrategyCost(
                    "reference", compute=bucket * w / n_shards,
                    overhead=(SHARD_LAUNCH_CYCLES
                              + COLLECTIVE_LAUNCH_CYCLES) * unit
                    + moved * COLLECTIVE_ELEM_CYCLES * unit)
        return costs


def serve_strategy_costs(algorithm: str, *, bucket: int, n_shards: int,
                         shape: Dict[str, int] = None,
                         backend: BackendCosts = None,
                         quantized: bool = False
                         ) -> Dict[str, StrategyCost]:
    """Analytic Eq. 15 costs (back-compat wrapper over ``CostModel``)."""
    return CostModel.analytic(backend).strategy_costs(
        algorithm, bucket=bucket, n_shards=n_shards, shape=shape,
        quantized=quantized)


def pick_strategy(costs: Dict[str, StrategyCost]) -> str:
    """Cheapest modelled strategy; ties break toward the simpler partition
    (single < query < reference)."""
    return min(costs, key=lambda s: (costs[s].total,
                                     SHARD_STRATEGIES.index(s)))


def fit_backend(censuses, measured_cycles, seed: BackendCosts,
                iters: int = 2000, lr: float = 0.05) -> BackendCosts:
    """Refit a backend cost vector to measured per-kernel cycles.

    Multiplicative-update least squares in log space (costs stay positive,
    start from the literature seed). censuses: list[Census]; measured:
    list[float] (same order).
    """
    A = np.stack([c.vector() for c in censuses])           # (K, OPS)
    y = np.asarray(measured_cycles, dtype=np.float64)      # (K,)
    logc = np.log(seed.vector())
    for _ in range(iters):
        c = np.exp(logc)
        pred = A @ c
        # relative-error gradient (kernels span 4 orders of magnitude)
        resid = (pred - y) / y
        grad = (A * c[None, :]).T @ (resid / y)            # d/dlogc
        logc -= lr * grad / (np.linalg.norm(grad) + 1e-12)
    c = np.exp(logc)
    return BackendCosts(seed.name + "-fit", *c)


def relative_errors(censuses, measured_cycles, backend: BackendCosts):
    A = np.stack([c.vector() for c in censuses])
    y = np.asarray(measured_cycles, dtype=np.float64)
    pred = A @ backend.vector()
    return pred, (pred - y) / y
