"""Brownout degradation ladder, policy and per-tenant circuit breakers.

The port's copy of the JAX package's ``serving/degrade.py``.

``DegradePolicy`` is a hysteretic controller observed once per drain.
Single-model mode takes a ladder of ``DegradeTier``s, each a warmed
``NonNeuralServeEngine`` over a cheaper representation of the same fitted
model with a larger per-drain request budget (``capacity_factor``);
``tiers=None`` (multi-tenant mode) degrades by splitting the grouped
launch instead (``group_shift``).  Downshift triggers, any one of them:
queue backpressure over the threshold, a deadline shed this drain, a
non-ok straggler verdict, an eviction storm, or rolling-p95 headroom
below ``down_headroom``.  Recovery needs ``hold`` consecutive calm drains
AND a ``cooldown`` since the last shift, one level at a time.

``CircuitBreaker`` isolates a failing tenant: repeated failures open it,
after ``cooldown`` ticks one half-open probe is admitted, and a served
probe closes it.

``build_ladder`` builds the single-model ladder from one engine: tier 0
is the engine, then an int8 sibling (``engine.sibling(policy="int8")``)
and, for exact kNN, an IVF-PQ sibling over the same reference rows
(``ann_sibling``), every tier warmed over its whole bucket lattice up
front.  A rung's ``capacity_factor`` is measured on the card, per (rung,
algorithm) (``CAPACITY_FACTORS``): the largest power of two ``f`` for
which one ``classify`` of ``f · max_batch`` rows through the rung takes
no longer than one of ``max_batch`` rows through tier 0.  A rung whose
factor is 1 gains no capacity, and the default ladder leaves it out; a
caller's rung-keyed ``capacity_factors`` overrides the table for every
algorithm and builds the rung.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.runtime.events import Event, event


# --------------------------------------------------------------- breakers

@dataclass
class BreakerConfig:
    """Per-tenant circuit-breaker policy: ``fail_threshold`` consecutive
    failures open the breaker; after ``cooldown`` ticks one half-open
    probe is admitted."""

    fail_threshold: int = 3
    cooldown: int = 8


class CircuitBreaker:
    """closed -> open -> half_open -> closed, driven by drain ticks.

    ``allow``/``success``/``failure`` return the transition's event KIND
    (``"breaker_open"`` / ``"breaker_half_open"`` / ``"breaker_close"``)
    or None, so the scheduler, which knows the tick and the tenant, emits
    the typed event into its stream."""

    def __init__(self, cfg: BreakerConfig):
        self.cfg = cfg
        self.state = "closed"
        self.failures = 0
        self.opened_tick = 0
        self.probe_outstanding = False

    def allow(self, tick: int):
        """May a request for this tenant enter the queue at ``tick``?"""
        if self.state == "closed":
            return True, None
        if self.state == "open":
            if tick - self.opened_tick >= self.cfg.cooldown:
                self.state = "half_open"
                self.probe_outstanding = True
                return True, "breaker_half_open"
            return False, None
        # half_open: exactly one probe in flight at a time
        if self.probe_outstanding:
            return False, None
        self.probe_outstanding = True
        return True, None

    def success(self, tick: int) -> Optional[str]:
        if self.state == "half_open":
            self.state = "closed"
            self.failures = 0
            self.probe_outstanding = False
            return "breaker_close"
        self.failures = 0
        return None

    def failure(self, tick: int) -> Optional[str]:
        if self.state == "half_open":
            self.state = "open"
            self.opened_tick = tick
            self.probe_outstanding = False
            return "breaker_open"
        if self.state == "open":
            return None
        self.failures += 1
        if self.failures >= self.cfg.fail_threshold:
            self.state = "open"
            self.opened_tick = tick
            return "breaker_open"
        return None


# ----------------------------------------------------------------- ladder

class DegradeTier(NamedTuple):
    """One rung: a warmed engine over a cheaper representation of the
    same model, with the per-drain request budget it affords."""

    name: str                 # "full" | "int8" | "ann" | ...
    engine: object            # NonNeuralServeEngine
    capacity_factor: int = 1  # requests-per-drain multiplier vs tier 0


# (rung, algorithm) -> capacity factor, measured by chip_smoke.py's
# [ladder] phase (median of 5 host-clock timings of each classify, rows
# from host memory) at the paths' shapes: kNN N = 2^20, d = 21, k = 4;
# K-Means 262,144 x 21, K = 256; GNB 60,000 x 784, 10 classes; max_batch
# 1024.  Card: NVIDIA H100 80GB HBM3, power limit 700.00 W.  Time of the
# rung against tier 0's 1024 rows, three runs:
#   int8 kNN     1024 rows 0.552-0.609x, 2048 rows 1.419-1.839x -> 1
#   int8 K-Means 1024 rows 1.609-2.035x                          -> 1
#   int8 GNB     1024 rows 0.952-1.320x, 2048 rows 1.373-1.979x -> 1
#   ANN (64 cells, nprobe 4, refine 32) 1024 rows 2.480-2.609x  -> 1
# An algorithm or rung missing here has no measured gain and is not built
# by default.
CAPACITY_FACTORS = {("int8", "knn"): 1, ("int8", "kmeans"): 1,
                    ("int8", "gnb"): 1, ("ann", "knn"): 1}
RUNGS = ("int8", "ann")


def ann_sibling(engine, *, nprobe: int = 4, refine: Optional[int] = None,
                max_batch: Optional[int] = None):
    """An IVF-PQ ANN engine over the SAME reference rows an exact-kNN
    engine serves, on its device: the bottom brownout rung.  The index is
    fit from the fitted params (``A``/``labels``), so no training data is
    supplied again; ``refine`` defaults to 8k (an exact re-rank of the ADC
    survivors keeps label agreement with exact kNN high)."""
    from repro_torch.core.estimator import ANNKNNEstimator

    est = engine.estimator
    if est.algorithm != "knn" or est.quantized:
        raise ValueError(
            f"ann_sibling needs an unquantized exact-kNN engine (the ANN "
            f"index is fit from params.A/labels); got "
            f"{est.algorithm!r}" + (" (int8)" if est.quantized else ""))
    ann = ANNKNNEstimator(k=est.k, n_class=int(est.params.n_class),
                          nprobe=nprobe,
                          refine=8 * est.k if refine is None else refine,
                          device=engine.device)
    ann.fit(est.params.A, est.params.labels)
    return engine.sibling(estimator=ann, max_batch=max_batch
                          or engine.max_batch)


def build_ladder(engine, d: int, *, rungs: Sequence[str] = RUNGS,
                 capacity_factors=None, nprobe: int = 4,
                 refine: Optional[int] = None) -> List[DegradeTier]:
    """The brownout ladder for one engine: tier 0 is the engine itself,
    then one tier per applicable rung (``int8`` for any unquantized
    estimator but ANN; ``ann`` for exact kNN only) whose capacity factor
    is above 1: the measured ``CAPACITY_FACTORS`` entry for the engine's
    algorithm, or the caller's ``capacity_factors[rung]``, which builds
    the rung whatever its value.  EVERY tier is warmed over its whole
    bucket lattice here, up front: the scheduler coalesces only into
    warmed buckets, so a downshift is never what loads a bucket
    (``bucket_launches ⊆ warmed`` holds per tier)."""
    asked = dict(capacity_factors or {})
    tiers = [DegradeTier("full", engine, 1)]
    est = engine.estimator
    for rung in rungs:
        if rung not in RUNGS:
            raise ValueError(f"unknown brownout rung {rung!r} "
                             f"(known: {', '.join(RUNGS)})")
        if rung == "int8" and (est.quantized or est.algorithm == "ann"):
            continue        # already the int8 form; PQ codes ARE int8
        if rung == "ann" and (est.algorithm != "knn" or est.quantized):
            continue
        if rung in asked:
            f = int(asked[rung])
        else:
            f = int(CAPACITY_FACTORS.get((rung, est.algorithm), 1))
            if f <= 1:
                continue    # no measured capacity gain: not worth a rung
        if rung == "int8":
            sib = engine.sibling(policy="int8",
                                 max_batch=engine.max_batch * f)
        else:
            sib = ann_sibling(engine, nprobe=nprobe, refine=refine,
                              max_batch=engine.max_batch * f)
        tiers.append(DegradeTier(rung, sib, f))
    for tier in tiers:
        if not tier.engine.warmed:
            tier.engine.warmup_buckets(d)
    return tiers


# ----------------------------------------------------------------- policy

class DegradePolicy:
    """Hysteretic brownout controller, observed once per drain tick.

    ``tiers`` (single-model mode) is a ladder whose tier 0 MUST be the
    scheduler's own engine.  ``tiers=None`` (multi-tenant mode) degrades
    by group-splitting: ``group_shift`` caps the model-group bucket at
    ``gmax >> level`` up to ``split_levels``.

    Downshift is immediate on any trigger (modulo ``cooldown``); upshift
    needs ``hold`` consecutive calm drains.  Every shift is returned as a
    typed ``degrade_down``/``degrade_up`` event for the scheduler's stream.
    """

    def __init__(self, tiers: Optional[Sequence[DegradeTier]] = None, *,
                 deadline: Optional[int] = None, window: int = 32,
                 down_headroom: float = 0.25, up_headroom: float = 0.5,
                 pressure_threshold: float = 0.75, thrash_evictions: int = 8,
                 hold: int = 4, cooldown: int = 2, split_levels: int = 2):
        if tiers is not None:
            assert len(tiers) >= 1, "a ladder needs at least tier 0"
            assert tiers[0].capacity_factor == 1, \
                "tier 0 is the undegraded engine (capacity_factor 1)"
        self.tiers = list(tiers) if tiers is not None else None
        self.max_level = (len(self.tiers) - 1 if self.tiers is not None
                          else int(split_levels))
        self.deadline = deadline
        self.window = int(window)
        self.down_headroom = float(down_headroom)
        self.up_headroom = float(up_headroom)
        self.pressure_threshold = float(pressure_threshold)
        self.thrash_evictions = int(thrash_evictions)
        self.hold = int(hold)
        self.cooldown = int(cooldown)
        self.level = 0
        self._recent: deque = deque(maxlen=self.window)  # served latencies
        self._good = 0
        self._last_shift = -10**9

    # ------------------------------------------------------------ signals

    def tier_name(self, level: Optional[int] = None) -> str:
        level = self.level if level is None else level
        if self.tiers is not None:
            return self.tiers[level].name
        return f"split{1 << level}" if level else "full"

    @property
    def current(self) -> Optional[DegradeTier]:
        return self.tiers[self.level] if self.tiers is not None else None

    @property
    def group_shift(self) -> int:
        """Right-shift applied to the group bucket in split mode."""
        return self.level if self.tiers is None else 0

    def note_latency(self, queue_ticks: int) -> None:
        """Feed one served request's latency into the rolling window."""
        self._recent.append(int(queue_ticks))

    def _p95(self) -> Optional[float]:
        if len(self._recent) < 4:
            return None           # too few samples to call a tail
        vals = sorted(self._recent)
        rank = max(1, int(np.ceil(0.95 * len(vals))))
        return float(vals[rank - 1])

    def headroom(self) -> Optional[float]:
        """(deadline - rolling p95) / deadline, the budget slack the
        downshift trigger watches; None without a deadline or enough
        samples."""
        if self.deadline is None:
            return None
        p95 = self._p95()
        if p95 is None:
            return None
        return (self.deadline - p95) / self.deadline

    # ----------------------------------------------------------- observe

    def observe(self, tick: int, *, pressure: float = 0.0,
                straggler: bool = False, sheds: int = 0,
                evictions: int = 0) -> List[Event]:
        """One control step (call once per drain).  Returns the typed
        shift events (possibly empty) for the scheduler's stream."""
        head = self.headroom()
        reasons = []
        if pressure >= self.pressure_threshold:
            reasons.append("backpressure")
        if straggler:
            reasons.append("straggler")
        if sheds > 0:
            reasons.append("shed")
        if evictions >= self.thrash_evictions:
            reasons.append("thrash")
        if head is not None and head < self.down_headroom:
            reasons.append("headroom")
        evs: List[Event] = []
        if reasons:
            self._good = 0
            if self.level < self.max_level \
                    and tick - self._last_shift >= self.cooldown:
                self.level += 1
                self._last_shift = tick
                self._recent.clear()   # old-tier latencies are stale
                evs.append(event(
                    "degrade_down", tick, "degrade", level=self.level,
                    tier=self.tier_name(), trigger=",".join(reasons)))
            return evs
        calm = (pressure < 0.5 * self.pressure_threshold
                and (head is None or head >= self.up_headroom))
        if not calm:
            self._good = 0
            return evs
        self._good += 1
        if self.level > 0 and self._good >= self.hold \
                and tick - self._last_shift >= self.cooldown:
            self.level -= 1
            self._last_shift = tick
            self._good = 0
            self._recent.clear()
            evs.append(event("degrade_up", tick, "degrade",
                             level=self.level, tier=self.tier_name()))
        return evs
