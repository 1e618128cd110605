"""Brownout degradation policy and per-tenant circuit breakers.

The policy part of the JAX package's ``serving/degrade.py``: plain Python,
so the port keeps its own copy.

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

Not here (ROADMAP A13): the measured capacity factors, ``ann_sibling``
and ``build_ladder`` that build a ladder from one engine.  The JAX
package's factors (``CAPACITY_FACTORS``) come from CPU runs and the H100
rates contradict them, so the port's come from its own benchmarks.  A
ladder of hand-built ``DegradeTier``s works today.
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
