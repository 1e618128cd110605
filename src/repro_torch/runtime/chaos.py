"""Deterministic fault injection for the serving stack.

Counterpart of the JAX package's ``runtime/chaos.py``: the failure modes
the serving stack defends against (stragglers, poisoned model updates,
residency thrash, overload bursts) injected on a script, so a test or
``launch/serve.py --chaos`` replays the same failure sequence twice and
gets the same ``RequestResult`` and event streams.

  * ``ChaosPlan``: the script (which drain ticks stall and by what factor,
    which (tick, tenant) pairs receive a NaN-poisoned
    ``ModelStore.update``, which ticks evict every resident tenant, which
    ticks receive an arrival burst), generated from a seed
    (``ChaosPlan.generate``, numpy's generator, so a seed gives the JAX
    package's plan) or one of the named ``PRESETS``; it round-trips
    through JSON.
  * ``ChaosInjector``: ``attach(scheduler)`` replaces the scheduler's wall
    clock with a virtual one (each launch costs ``base_batch_time``,
    straggler ticks ``factor`` times that), so ``batch_time`` and every
    verdict and degrade decision downstream of it are functions of the
    plan; ``replay_trace(..., chaos=injector)`` calls
    ``extra_arrivals``/``apply`` at each tick.  The clock relies on the
    scheduler reading it exactly twice a launch, which both its drains do.

Every injected fault lands as a typed ``chaos_*`` event in the scheduler's
stream, beside the shed, degrade and breaker events it provokes.  A NaN
injection the store accepts is itself a failure: the injector raises
rather than let a poisoned generation serve.
"""
from __future__ import annotations

import copy
import json
from dataclasses import asdict, dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.runtime.events import event
from repro_torch.serving.model_store import PoisonedParamsError


@dataclass(frozen=True)
class ChaosPlan:
    """A seeded, serializable fault script over ``ticks`` drain ticks."""

    seed: int = 0
    ticks: int = 64
    #: drain ticks whose launch wall-time is inflated
    straggler_ticks: Tuple[int, ...] = ()
    straggler_factor: float = 8.0
    #: (tick, tenant_index) pairs: poison that tenant's next update
    nan_events: Tuple[Tuple[int, int], ...] = ()
    #: ticks on which every resident tenant is evicted
    storm_ticks: Tuple[int, ...] = ()
    #: tick -> extra arrivals injected on top of the base trace
    burst: Tuple[Tuple[int, int], ...] = ()

    def burst_at(self, tick: int) -> int:
        for t, n in self.burst:
            if t == tick:
                return n
        return 0

    # ------------------------------------------------------------ codecs

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ChaosPlan":
        raw = json.loads(text)
        for key in ("straggler_ticks", "storm_ticks"):
            raw[key] = tuple(int(t) for t in raw.get(key, ()))
        raw["nan_events"] = tuple((int(t), int(i))
                                  for t, i in raw.get("nan_events", ()))
        raw["burst"] = tuple((int(t), int(n))
                             for t, n in raw.get("burst", ()))
        return cls(**raw)

    # --------------------------------------------------------- generator

    @classmethod
    def generate(cls, *, seed: int = 0, ticks: int = 64,
                 n_stragglers: int = 0, straggler_factor: float = 8.0,
                 n_nan: int = 0, n_tenants: int = 0, n_storms: int = 0,
                 n_bursts: int = 0, burst_size: int = 64) -> "ChaosPlan":
        """A plan from a seed: fault ticks are drawn without replacement a
        fault class (a tick can carry a burst and a straggler), in the JAX
        package's order of draws."""
        rng = np.random.default_rng(seed)

        def pick(n):
            n = min(int(n), ticks)
            # keep the first ticks clean so warmup baselines calibrate
            lo = min(8, ticks // 4)
            return tuple(sorted(int(t) for t in rng.choice(
                np.arange(lo, ticks), size=n, replace=False))) if n else ()

        nan_events = tuple((t, int(rng.integers(0, max(1, n_tenants))))
                           for t in pick(n_nan))
        return cls(seed=seed, ticks=ticks,
                   straggler_ticks=pick(n_stragglers),
                   straggler_factor=float(straggler_factor),
                   nan_events=nan_events, storm_ticks=pick(n_storms),
                   burst=tuple((t, int(burst_size))
                               for t in pick(n_bursts)))

    @classmethod
    def preset(cls, name: str, *, seed: int = 0, ticks: int = 64,
               n_tenants: int = 0) -> "ChaosPlan":
        try:
            kw = dict(PRESETS[name])
        except KeyError:
            raise ValueError(f"unknown chaos preset {name!r} "
                             f"(known: {sorted(PRESETS)})") from None
        return cls.generate(seed=seed, ticks=ticks, n_tenants=n_tenants,
                            **kw)


#: named fault mixes for tests and --chaos NAME
PRESETS: Dict[str, Dict] = {
    # overload only: arrival bursts several times the per-drain capacity
    "burst": {"n_bursts": 4, "burst_size": 96},
    # slow silicon: inflated launch times trip the straggler escalation
    "straggler": {"n_stragglers": 12, "straggler_factor": 8.0},
    # sick tenants and residency churn (store-mode schedulers)
    "storm": {"n_nan": 4, "n_storms": 4, "n_bursts": 2, "burst_size": 48},
    # everything at once
    "mixed": {"n_bursts": 4, "burst_size": 96, "n_stragglers": 8,
              "straggler_factor": 8.0, "n_nan": 3, "n_storms": 2},
}


def _poison_first_leaf(params):
    """Params with a NaN written into the first element of the first
    float leaf (a copy; the minimal corruption a crashed trainer or a
    truncated checkpoint produces)."""
    out, done = [], False
    for leaf in params:
        if not done and isinstance(leaf, torch.Tensor) \
                and leaf.is_floating_point():
            leaf = leaf.clone()
            leaf.view(-1)[0] = float("nan")
            done = True
        out.append(leaf)
    assert done, "no float leaf to poison"
    return type(params)(*out)


class ChaosInjector:
    """Executes a ``ChaosPlan`` against one scheduler replay.

    ``base_batch_time`` is the virtual wall-time of one healthy launch
    (seconds); straggler ticks cost ``plan.straggler_factor`` times that.
    The virtual clock toggles: the scheduler reads it once before and once
    after each launch, so the first read returns the accumulated time and
    the second adds the launch's scripted cost."""

    def __init__(self, plan: ChaosPlan, *, store=None,
                 base_batch_time: float = 1e-3):
        self.plan = plan
        self.store = store
        self.base_batch_time = float(base_batch_time)
        self.sched = None
        self._vt = 0.0
        self._in_launch = False
        self._stragglers = frozenset(plan.straggler_ticks)
        self._storms = frozenset(plan.storm_ticks)
        self._nan_by_tick: Dict[int, List[int]] = {}
        for t, idx in plan.nan_events:
            self._nan_by_tick.setdefault(int(t), []).append(int(idx))
        self.injected: Dict[str, int] = {"straggler": 0, "nan": 0,
                                         "storm": 0, "burst": 0}

    # ------------------------------------------------------------- clock

    def attach(self, scheduler) -> "ChaosInjector":
        """Install the virtual clock; the plan owns time from here on."""
        self.sched = scheduler
        scheduler.clock = self._clock
        return self

    def _clock(self) -> float:
        if not self._in_launch:
            self._in_launch = True
            return self._vt
        self._in_launch = False
        factor = 1.0
        # the scheduler bumped .tick before the launch, so the current
        # tick is the one the plan scripts
        if self.sched is not None and self.sched.tick in self._stragglers:
            factor = self.plan.straggler_factor
            self.injected["straggler"] += 1
            self.sched.events.append(event(
                "chaos_straggler", self.sched.tick, "chaos",
                factor=factor))
        self._vt += self.base_batch_time * factor
        return self._vt

    # ------------------------------------------------------------ faults

    def extra_arrivals(self, tick: int) -> int:
        n = self.plan.burst_at(tick)
        if n and self.sched is not None:
            self.injected["burst"] += 1
            self.sched.events.append(event("chaos_burst", tick, "chaos",
                                           n=n))
        return n

    def apply(self, scheduler, tick: int) -> None:
        """Inject this tick's store-level faults (none without a store):
        NaN-poisoned tenant updates, which the store must refuse
        (``PoisonedParamsError``, fed to the tenant's circuit breaker), and
        eviction storms."""
        if self.store is None:
            return
        for idx in self._nan_by_tick.get(tick, ()):
            mids = self.store.model_ids
            if not mids:
                continue
            mid = mids[idx % len(mids)]
            bad = copy.copy(self.store.template)
            _gen, params = self.store.params_of(mid)
            bad._params = _poison_first_leaf(params)
            self.injected["nan"] += 1
            scheduler.events.append(event("chaos_nan", tick, "chaos",
                                          model=str(mid)))
            try:
                self.store.update(mid, bad)
            except PoisonedParamsError as e:
                scheduler.events.append(event(
                    "nan_rejected", tick, "scheduler", model=str(mid),
                    leaf=e.leaf_path))
                scheduler.record_failure(mid, reason="nan_rejected")
            else:
                raise AssertionError(
                    f"NaN-poisoned update for tenant {mid!r} was ACCEPTED "
                    f"by the store — the health-check invariant is broken")
        if tick in self._storms:
            n = 0
            for mid in list(self.store.resident_ids):
                self.store.evict(mid)
                n += 1
            self.injected["storm"] += 1
            scheduler.events.append(event("chaos_eviction_storm", tick,
                                          "chaos", evicted=n))
