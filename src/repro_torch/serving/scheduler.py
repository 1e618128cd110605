"""Request-stream scheduler with SLO accounting for NonNeuralServeEngine.

Counterpart of the JAX package's ``serving/scheduler.py``.  Many logical
clients ``submit()`` single queries (or
small batches); a ``drain()`` step coalesces the queue into the smallest
power-of-two bucket the engine has ALREADY warmed that holds it (never a
new one, so no kernel build or first load lands mid-stream), runs one
launch, and scatters per-request results back with per-request metrics
(``queue_time``, ``batch_time``, ``bucket``, ``deadline_missed``).

Time is measured in drain TICKS, not wall-clock: ``max_wait`` (the
coalescing window) and request deadlines are tick counts, so a replayed
trace is deterministic and the SLO accounting in ``ServingStats``
(p50/p95/p99 latency, throughput, bucket occupancy, cache hit-rate) is
the same in both packages for the same trace.  Wall-clock appears only in
``batch_time``, the launch read from an injectable ``clock`` around
``classify`` and a synchronize of the engine's device (``classify`` is
asynchronous on the card, so without it the clock would time only the
launch); it feeds the per-drain ``runtime/straggler.StepTimer``.

Overload is an outcome, not an error path.  Three mechanisms, all off by
default: admission control (``max_queue``: a full queue sheds new
arrivals with ``reason="queue_full"``), deadline-enforced shedding
(``shed_expired``: each drain first drops queued requests that would
already miss their deadline, ``reason="expired"``) and brownout
(``degrade=DegradePolicy(tiers)``: under pressure the drain reroutes
through cheaper warmed tiers of the same model, each with a larger
per-drain budget; their answers are never cached; in store mode
``DegradePolicy(None)`` splits the grouped launch instead).  Per-tenant
circuit breakers (``breaker=``, store mode) shed a tenant whose updates
keep failing the model store's health check (``reason="breaker_open"``).
Shed requests complete at once with ``prediction=None`` and never enter
the latency percentiles.

Results reach the host once per drain: one device-to-host copy of the
bucket's classes and one of its aux, whose rows the scatter and the LRU
cache hold as numpy (cached rows are copies).  Queries stay numpy float32
until the drain stacks them, so the cache key of a query, its fp32 bytes,
is the one the JAX package computes.

Store mode (``store=`` a ``serving.model_store.ModelStore``): requests
carry a ``model_id``, and one drain coalesces them across tenants into a
single (model group x bucket) grouped launch (``engine.classify_group``:
B1, B2 and B3 with a tenant axis), with per-tenant ``ServingStats`` in
``tenant_stats``.  Its two clock reads sit around the launch and its
synchronize, as the single-model drain's do, so a virtual clock (the
chaos harness's) sees two reads a launch in either mode.  Padded lanes
and padded rows never reach the result scatter or ``tenant_stats``.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.runtime.events import Event, event, straggler_event
from repro_torch.runtime.straggler import StepTimer
from repro_torch.serving.degrade import (BreakerConfig, CircuitBreaker,
                                         DegradePolicy)
from repro_torch.serving.engine import NonNeuralServeEngine

#: shed reasons a RequestResult may carry
SHED_REASONS = ("queue_full", "expired", "breaker_open")


@dataclass
class RequestResult:
    """One completed request: prediction + evidence + SLO accounting.
    A SHED request completes with ``prediction=None``, ``shed=True`` and
    a ``reason`` from ``SHED_REASONS``; ``tier`` names the brownout tier
    that served a non-shed request ("full" when undegraded)."""
    request_id: int
    prediction: Any            # scalar class / cluster id; None if shed
    aux: Any                   # per-query algorithm evidence row (numpy)
    queue_time: int            # drain ticks from submit to completion
    batch_time: float          # wall-clock seconds of the serving launch
    bucket: int                # bucket the launch ran in (0 = cache hit)
    deadline_missed: bool
    cache_hit: bool = False
    shed: bool = False
    reason: Optional[str] = None
    tier: str = "full"


@dataclass
class _Pending:
    request_id: int
    x: np.ndarray              # (d,) float32 query row
    submit_tick: int
    deadline: Optional[int]    # relative ticks, None = no SLO
    cache_key: Optional[Any]   # (engine/tenant fingerprint, dtype, bytes)
    model_id: Any = None       # tenant routing key (store mode)


class _TierState(NamedTuple):
    """A brownout tier as the scheduler routes to it: the warmed-bucket
    snapshot and per-drain request budget are frozen at init."""
    name: str
    engine: NonNeuralServeEngine
    capacity: int              # requests per drain at this tier
    warmed: frozenset
    cache_ok: bool             # only exact tier-0 results may be cached


class ServingStats:
    """SLO accumulator over completed requests and drains.

    Percentiles use the nearest-rank definition (sorted latencies,
    ``ceil(q * n)``-th value) so a hand-computed trace matches exactly.
    ``latencies`` holds SERVED requests only: cache hits complete with
    ``queue_time=0`` and are reported through ``hit_rate`` (they still
    count into ``completed``).  Shed requests never enter ``completed`` or
    the latency pool, so an all-shed window reads nan percentiles and zero
    throughput with a non-zero ``shed`` count.
    """

    def __init__(self):
        self.latencies: List[int] = []     # ticks, per SERVED request
        self.completed = 0
        self.cache_hits = 0
        self.deadline_misses = 0
        self.launches = 0
        self.ticks = 0
        self.occupancies: List[float] = []  # valid rows / bucket, per launch
        self.bucket_launches: Dict[int, int] = {}
        self.batch_times: List[float] = []
        self.shed = 0
        self.shed_reasons: Dict[str, int] = {}
        self.tier_launches: Dict[str, int] = {}
        self.tier_bucket_launches: Dict[str, Dict[int, int]] = {}
        self.tier_served: Dict[str, int] = {}
        self.downshifts = 0
        self.upshifts = 0

    def observe_tick(self) -> None:
        self.ticks += 1

    def observe_launch(self, bucket: int, n_valid: int, batch_time: float,
                       tier: Optional[str] = None) -> None:
        self.launches += 1
        self.occupancies.append(n_valid / bucket)
        self.bucket_launches[bucket] = \
            self.bucket_launches.get(bucket, 0) + 1
        self.batch_times.append(batch_time)
        if tier is not None:
            self.tier_launches[tier] = self.tier_launches.get(tier, 0) + 1
            per = self.tier_bucket_launches.setdefault(tier, {})
            per[bucket] = per.get(bucket, 0) + 1

    def observe(self, r: RequestResult) -> None:
        if r.shed:
            self.shed += 1
            reason = r.reason or "unknown"
            self.shed_reasons[reason] = \
                self.shed_reasons.get(reason, 0) + 1
            return
        self.completed += 1
        self.cache_hits += r.cache_hit
        self.deadline_misses += r.deadline_missed
        if not r.cache_hit:
            self.latencies.append(r.queue_time)
            self.tier_served[r.tier] = self.tier_served.get(r.tier, 0) + 1

    def observe_shift(self, down: bool) -> None:
        if down:
            self.downshifts += 1
        else:
            self.upshifts += 1

    @property
    def served(self) -> int:
        """Requests that went through a launch (completed minus hits)."""
        return self.completed - self.cache_hits

    @property
    def finished(self) -> int:
        """Everything that got an outcome: served, hit, or shed."""
        return self.completed + self.shed

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile of SERVED-request latency, in ticks."""
        if not self.latencies:
            return float("nan")
        vals = sorted(self.latencies)
        rank = max(1, int(np.ceil(q * len(vals))))
        return float(vals[rank - 1])

    @property
    def hit_rate(self) -> float:
        return self.cache_hits / self.completed if self.completed else 0.0

    @property
    def deadline_miss_rate(self) -> float:
        return self.deadline_misses / self.completed if self.completed \
            else 0.0

    @property
    def shed_rate(self) -> float:
        return self.shed / self.finished if self.finished else 0.0

    @property
    def miss_plus_shed_rate(self) -> float:
        """SLO-failure rate a client sees: a shed and a missed deadline
        are the same broken promise."""
        if not self.finished:
            return 0.0
        return (self.deadline_misses + self.shed) / self.finished

    @property
    def throughput(self) -> float:
        """Completed requests per drain tick (deterministic)."""
        return self.completed / self.ticks if self.ticks else 0.0

    @property
    def mean_occupancy(self) -> float:
        return float(np.mean(self.occupancies)) if self.occupancies \
            else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "completed": self.completed,
            "served": self.served,
            "ticks": self.ticks,
            "launches": self.launches,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
            "throughput": self.throughput,
            "occupancy": self.mean_occupancy,
            "hit_rate": self.hit_rate,
            "deadline_miss_rate": self.deadline_miss_rate,
            "shed": self.shed,
            "shed_rate": self.shed_rate,
            "miss_plus_shed_rate": self.miss_plus_shed_rate,
            "downshifts": self.downshifts,
        }


class RequestScheduler:
    """Micro-batching front of ``NonNeuralServeEngine`` (one model).

    Policy knobs:
      * ``max_wait``: coalescing window in drain ticks; a drain launches
        once the oldest pending request has waited that many ticks (or the
        queue already fills ``max_batch``), otherwise it keeps coalescing.
      * ``max_batch``: cap on requests per launch (default: the engine's).
      * ``cache_size``: optional LRU result cache keyed on (engine
        fingerprint, or ("tenant", model_id, generation) in store mode,
        query dtype, query bytes), 0 = off; a tenant's hot-swap bumps its
        generation and so invalidates its entries.
      * ``store``: a ``serving.model_store.ModelStore``; the scheduler
        routes ``submit(x, model_id=...)`` and drains grouped launches
        across tenants, with per-tenant ``tenant_stats``.
      * ``max_queue``: admission-control bound (None = unbounded).
      * ``shed_expired``: drop queued requests that would already miss
        their deadline before spending a launch slot on them.
      * ``degrade``: a ``serving.degrade.DegradePolicy`` over a ladder of
        warmed tiers whose tier 0 is this engine, or (store mode)
        ``DegradePolicy(None)``, which splits the group launch.
      * ``breaker``: a ``serving.degrade.BreakerConfig`` enabling
        per-tenant circuit breakers (store mode): repeated failures
        (expiry sheds, ``record_failure`` health rejections) open a
        tenant's breaker and its submits shed with
        ``reason="breaker_open"`` until a half-open probe is served.
      * ``timer``, ``host``: the ``StepTimer`` each drain's ``batch_time``
        feeds, and the host id it is recorded under.
      * ``clock``: the wall-clock source for ``batch_time`` (default
        ``time.perf_counter``); a virtual clock makes the straggler
        verdicts, and so the whole RequestResult stream, replay exactly.

    The engine must be warmed first (``engine.warmup_buckets(d)`` or
    ``engine.warmup(X)``; store mode: ``engine.warmup_groups``): drains
    coalesce ONLY into buckets (cells) warmed before the scheduler was
    built, so ``bucket_launches ⊆ warmed`` (``group_launches ⊆
    warmed_groups``) holds for a whole stream, per tier under brownout.
    """

    def __init__(self, engine: NonNeuralServeEngine, *, max_wait: int = 4,
                 max_batch: Optional[int] = None, cache_size: int = 0,
                 timer: Optional[StepTimer] = None, host: int = 0,
                 store=None, max_queue: Optional[int] = None,
                 shed_expired: bool = False,
                 degrade: Optional[DegradePolicy] = None,
                 breaker: Optional[BreakerConfig] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.store = store
        if store is None:
            assert engine.warmed, \
                "warm the engine first (engine.warmup_buckets(d)): the " \
                "scheduler only coalesces into already-warmed buckets"
        else:
            assert engine.warmed_groups, \
                "warm the grouped cells first (engine.warmup_groups): " \
                "tenant drains only coalesce into already-warmed " \
                "(group, bucket) cells"
        self.engine = engine
        self.max_wait = int(max_wait)
        self.max_batch = min(int(max_batch or engine.max_batch),
                             engine.max_batch)
        # snapshot NOW: engine.warmed grows with every launch, so checking
        # `bucket_launches ⊆ engine.warmed` afterwards would prove nothing
        self.warmed = frozenset(b for b in engine.warmed
                                if b <= self.max_batch)
        self.warmed_groups = frozenset(
            (g, b) for g, b in engine.warmed_groups if b <= self.max_batch)
        if store is None:
            assert self.warmed, (engine.warmed, self.max_batch)
        else:
            assert self.warmed_groups, (engine.warmed_groups,
                                        self.max_batch)
        self.cache_size = int(cache_size)
        self._cache: "OrderedDict[Any, Any]" = OrderedDict()
        self.timer = timer or StepTimer()
        self.host = host
        self.tick = 0
        self.queue: Deque[_Pending] = deque()
        self.stats = ServingStats()
        self.tenant_stats: Dict[Any, ServingStats] = {}
        self.results: Dict[int, RequestResult] = {}
        self.events: List[Event] = []   # typed runtime/events.py stream
        self._next_id = 0
        self.max_queue = int(max_queue) if max_queue is not None else None
        self.shed_expired = bool(shed_expired)
        self.clock = clock if clock is not None else time.perf_counter
        self.breaker_config = breaker
        self.breakers: Dict[Any, CircuitBreaker] = {}
        self.degrade = degrade
        self._tiers: Optional[List[_TierState]] = None
        self._last_evictions = store.evictions if store is not None else 0
        if degrade is not None and degrade.tiers is not None:
            assert store is None, \
                "store-mode degradation splits the group launch: build " \
                "the policy with DegradePolicy(tiers=None)"
            assert degrade.tiers[0].engine is engine, \
                "tier 0 of the ladder must be the scheduler's own engine"
            self._tiers = []
            for t in degrade.tiers:
                assert t.engine.warmed, \
                    f"brownout tier {t.name!r} is not warmed: degrading " \
                    f"must never be what builds or loads a bucket"
                capacity = min(self.max_batch * t.capacity_factor,
                               t.engine.max_batch)
                warmed = frozenset(b for b in t.engine.warmed
                                   if b <= capacity)
                assert warmed, (t.name, t.engine.warmed, capacity)
                self._tiers.append(_TierState(
                    t.name, t.engine, capacity, warmed,
                    cache_ok=t.engine is engine))
        self._tier0 = _TierState("full", engine, self.max_batch,
                                 self.warmed, cache_ok=True)
        #: per-tier init-time warmed snapshots, for invariant checks
        self.tier_warmed: Dict[str, frozenset] = \
            {t.name: t.warmed for t in (self._tiers or [self._tier0])}

    # ------------------------------------------------------------ submit

    @property
    def pending(self) -> int:
        return len(self.queue)

    def _cache_key(self, row: np.ndarray,
                   model_id=None) -> Optional[tuple]:
        """Result-cache key: the engine fingerprint (algorithm, policy,
        engine identity), or in store mode ("tenant", model_id,
        generation), with the query's dtype and bytes, so the same bytes
        against another engine, policy or tenant never cross-hit and a
        tenant's hot-swap invalidates its entries."""
        if not self.cache_size:
            return None
        if model_id is None:
            fp = self.engine.cache_fingerprint
        else:
            fp = ("tenant", model_id, self.store.generation(model_id))
        return (fp, row.dtype.str, row.tobytes())

    def _tenant_stats(self, model_id) -> ServingStats:
        st = self.tenant_stats.get(model_id)
        if st is None:
            st = self.tenant_stats[model_id] = ServingStats()
        return st

    def _record_shed(self, rid: int, reason: str, queue_time: int,
                     model_id=None) -> RequestResult:
        res = RequestResult(request_id=rid, prediction=None, aux=None,
                            queue_time=queue_time, batch_time=0.0,
                            bucket=0, deadline_missed=False, shed=True,
                            reason=reason)
        self.results[rid] = res
        self.stats.observe(res)
        detail = {"reason": reason, "request": rid}
        if model_id is not None:
            self._tenant_stats(model_id).observe(res)
            detail["model"] = str(model_id)
        self.events.append(event("shed", self.tick, "scheduler", **detail))
        return res

    def _breaker_failure(self, model_id, reason: str) -> None:
        br = self.breakers.setdefault(
            model_id, CircuitBreaker(self.breaker_config))
        kind = br.failure(self.tick)
        if kind:
            self.events.append(event(kind, self.tick, "scheduler",
                                     model=str(model_id), reason=reason))

    def record_failure(self, model_id, *, reason: str = "health") -> None:
        """Report an out-of-band tenant failure into its circuit breaker,
        such as a ``ModelStore.update`` refused by the health check
        (``PoisonedParamsError``).  Enough consecutive failures open the
        breaker, and that tenant's submits shed until a probe is
        served."""
        if self.breaker_config is None or model_id is None:
            return
        self._breaker_failure(model_id, reason)

    def _submit_one(self, row: np.ndarray, deadline: Optional[int],
                    model_id=None) -> int:
        rid = self._next_id
        self._next_id += 1
        if model_id is not None and self.breaker_config is not None:
            br = self.breakers.get(model_id)
            if br is not None:
                allowed, kind = br.allow(self.tick)
                if kind:
                    self.events.append(event(kind, self.tick, "scheduler",
                                             model=str(model_id)))
                if not allowed:
                    self._record_shed(rid, "breaker_open", 0, model_id)
                    return rid
        key = self._cache_key(row, model_id)
        if key is not None and key in self._cache:
            self._cache.move_to_end(key)
            pred, aux = self._cache[key]
            res = RequestResult(request_id=rid, prediction=pred, aux=aux,
                                queue_time=0, batch_time=0.0, bucket=0,
                                deadline_missed=False, cache_hit=True)
            self.results[rid] = res
            self.stats.observe(res)
            if model_id is not None:
                self._tenant_stats(model_id).observe(res)
            return rid
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._record_shed(rid, "queue_full", 0, model_id)
            return rid
        self.queue.append(_Pending(request_id=rid, x=row,
                                   submit_tick=self.tick,
                                   deadline=deadline, cache_key=key,
                                   model_id=model_id))
        return rid

    def submit(self, x, deadline: Optional[int] = None, model_id=None):
        """Enqueue one query (``(d,)`` -> request id) or a small batch
        (``(B, d)`` -> list of ids).  ``deadline`` is an SLO in drain
        ticks relative to now; a request completing later than that is
        counted as a deadline miss (it is still served).  ``model_id``
        routes to one of a store-mode scheduler's tenants.  The result
        for a returned id may already be a shed (admission control, an
        open breaker): check ``results[rid].shed``."""
        if self.store is not None:
            if model_id is None:
                raise ValueError("tenant scheduler: submit(x, model_id=...) "
                                 "— every request routes to one tenant")
            if model_id not in self.store:
                raise KeyError(f"model {model_id!r} is not registered in "
                               f"the store")
        elif model_id is not None:
            raise ValueError("model_id routing needs a store= scheduler "
                             "(RequestScheduler(engine, store=...))")
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            return self._submit_one(x, deadline, model_id)
        return [self._submit_one(row, deadline, model_id) for row in x]

    # ------------------------------------------------------------- drain

    def _pick_bucket(self, n: int, warmed=None) -> int:
        """The smallest WARMED bucket covering all ``n`` coalesced
        requests (padding the tail), or the biggest warmed bucket when the
        queue overflows it (the rest waits: backpressure)."""
        warmed = sorted(self.warmed if warmed is None else warmed)
        covering = [b for b in warmed if b >= n]
        return covering[0] if covering else warmed[-1]

    def _current_tier(self) -> _TierState:
        if self._tiers is not None and self.degrade is not None:
            return self._tiers[self.degrade.level]
        return self._tier0

    def _shed_expired_now(self) -> List[RequestResult]:
        """Deadline-enforced shedding, run BEFORE bucket selection: a
        queued request that would already exceed its deadline if launched
        this tick is dropped (reason="expired")."""
        if not self.shed_expired or not self.queue:
            return []
        out: List[RequestResult] = []
        kept: Deque[_Pending] = deque()
        while self.queue:
            p = self.queue.popleft()
            if p.deadline is not None \
                    and self.tick - p.submit_tick > p.deadline:
                out.append(self._record_shed(
                    p.request_id, "expired", self.tick - p.submit_tick,
                    p.model_id))
                if p.model_id is not None \
                        and self.breaker_config is not None:
                    self._breaker_failure(p.model_id, "expired")
            else:
                kept.append(p)
        self.queue = kept
        return out

    def _observe_degrade(self, *, straggler: bool, sheds: int) -> None:
        """One brownout control step per drain: pressure is queue depth
        over what the CURRENT tier can clear within the coalescing window
        (and over ``max_queue`` when bounded); thrash is the store's
        eviction count since the last drain."""
        if self.degrade is None:
            return
        cap = self._current_tier().capacity
        pressure = len(self.queue) / max(1.0, cap * max(1, self.max_wait))
        if self.max_queue:
            pressure = max(pressure, len(self.queue) / self.max_queue)
        evictions = 0
        if self.store is not None:
            now = self.store.evictions
            evictions = now - self._last_evictions
            self._last_evictions = now
        for e in self.degrade.observe(self.tick, pressure=pressure,
                                      straggler=straggler, sheds=sheds,
                                      evictions=evictions):
            self.events.append(e)
            self.stats.observe_shift(e.kind == "degrade_down")

    def _note_verdict(self, verdict) -> bool:
        if verdict.action != "ok":
            self.events.append(
                straggler_event(verdict, self.tick, "scheduler"))
            return True
        return False

    def drain(self, force: bool = False) -> List[RequestResult]:
        """One scheduler tick: shed expired work, coalesce + launch on
        the CURRENT brownout tier if the window expired (or ``force``),
        else keep coalescing.  Returns completed requests (served AND
        shed).  Store-mode schedulers coalesce ACROSS tenants into one
        (model group x bucket) grouped launch instead."""
        if self.store is not None:
            return self._drain_grouped(force)
        self.tick += 1
        self.stats.observe_tick()
        out: List[RequestResult] = list(self._shed_expired_now())
        sheds_now = len(out)
        ready = self.queue and (
            force
            or len(self.queue) >= self.max_batch
            or self.tick - self.queue[0].submit_tick >= self.max_wait)
        if not ready:
            self._observe_degrade(straggler=False, sheds=sheds_now)
            return out
        tier = self._current_tier()
        n = min(len(self.queue), tier.capacity)
        bucket = self._pick_bucket(n, tier.warmed)
        taken = [self.queue.popleft() for _ in range(min(n, bucket))]
        batch = np.stack([p.x for p in taken])
        if batch.shape[0] < bucket:      # pad to the warmed bucket, so the
            batch = np.concatenate(      # engine need not pad again
                [batch, np.zeros((bucket - batch.shape[0], batch.shape[1]),
                                 batch.dtype)])
        t0 = self.clock()
        res = tier.engine.classify(batch)
        tier.engine._sync()              # classify is asynchronous on the
        batch_time = self.clock() - t0   # card: time the work, not the launch

        verdict = self.timer.record(self.host, batch_time)
        straggling = self._note_verdict(verdict)
        self.stats.observe_launch(bucket, len(taken), batch_time,
                                  tier=tier.name)

        classes = res.classes.cpu().numpy()   # one copy of each per drain
        aux = res.aux.cpu().numpy()
        for i, p in enumerate(taken):
            queue_time = self.tick - p.submit_tick
            missed = p.deadline is not None and queue_time > p.deadline
            r = RequestResult(request_id=p.request_id,
                              prediction=classes[i], aux=aux[i],
                              queue_time=queue_time, batch_time=batch_time,
                              bucket=bucket, deadline_missed=missed,
                              tier=tier.name)
            self.results[p.request_id] = r
            self.stats.observe(r)
            if self.degrade is not None:
                self.degrade.note_latency(queue_time)
            if p.cache_key is not None and tier.cache_ok:
                # copies: a view would pin the whole bucket's arrays for
                # the entry's lifetime; degraded-tier answers are
                # approximations and are never replayed as exact ones
                self._cache[p.cache_key] = (classes[i].copy(),
                                            aux[i].copy())
                self._cache.move_to_end(p.cache_key)
                while len(self._cache) > self.cache_size:
                    self._cache.popitem(last=False)
            out.append(r)
        self._observe_degrade(straggler=straggling, sheds=sheds_now)
        return out

    def _drain_grouped(self, force: bool) -> List[RequestResult]:
        """Multi-tenant drain: walk the queue in order, bucketing requests
        by tenant (at most the largest warmed group of tenants, at most the
        largest warmed bucket of rows a tenant; the overflow waits for the
        next drain), snapshot the model group from the store (an update
        racing this drain lands wholly before the snapshot or wholly
        after), and run ONE grouped (model group x bucket) launch.  Under
        degradation the group bucket is split (``gmax >> level``): a
        smaller pin set a launch relieves a thrashing store."""
        self.tick += 1
        self.stats.observe_tick()
        for st in self.tenant_stats.values():
            st.observe_tick()
        out: List[RequestResult] = list(self._shed_expired_now())
        sheds_now = len(out)
        ready = self.queue and (
            force
            or len(self.queue) >= self.max_batch
            or self.tick - self.queue[0].submit_tick >= self.max_wait)
        if not ready:
            self._observe_degrade(straggler=False, sheds=sheds_now)
            return out
        gmax = max(g for g, _ in self.warmed_groups)
        if self.degrade is not None:
            gmax = max(1, gmax >> self.degrade.group_shift)
        bmax = max(b for _, b in self.warmed_groups)
        budget = min(len(self.queue), self.max_batch)
        taken_by: "OrderedDict[Any, List[_Pending]]" = OrderedDict()
        deferred: List[_Pending] = []
        count = 0
        while self.queue and count < budget:
            p = self.queue.popleft()
            rows = taken_by.get(p.model_id)
            if rows is None:
                if len(taken_by) >= gmax:
                    deferred.append(p)
                    continue
                rows = taken_by[p.model_id] = []
            if len(rows) >= bmax:
                deferred.append(p)
                continue
            rows.append(p)
            count += 1
        # deferred requests are older than everything still queued: back
        # to the front, their order kept
        self.queue.extendleft(reversed(deferred))
        ids = list(taken_by)
        g = len(ids)
        gb = min(gg for gg, _ in self.warmed_groups if gg >= g)
        maxc = max(len(rows) for rows in taken_by.values())
        covering = sorted(b for gg, b in self.warmed_groups
                          if gg == gb and b >= maxc)
        bucket = covering[0] if covering else \
            max(b for gg, b in self.warmed_groups if gg == gb)
        # pad the group by repeating tenant 0: the same warmed cell, and
        # the padded lanes' all-zero rows are never scattered
        padded_ids = ids + [ids[0]] * (gb - g)
        stacked, _gens = self.store.group(padded_ids)
        d = taken_by[ids[0]][0].x.shape[0]
        Xg = np.zeros((gb, bucket, d), np.float32)
        for gi, mid in enumerate(ids):
            for bi, p in enumerate(taken_by[mid]):
                Xg[gi, bi] = p.x
        t0 = self.clock()
        res = self.engine.classify_group(stacked, Xg)
        self.engine._sync()              # classify_group is asynchronous on
        batch_time = self.clock() - t0   # the card: time the work

        verdict = self.timer.record(self.host, batch_time)
        straggling = self._note_verdict(verdict)
        # occupancy is valid rows over the launch's whole footprint (group
        # lanes x bucket rows)
        tname = self.degrade.tier_name() if self.degrade is not None \
            else None
        self.stats.observe_launch(gb * bucket, count, batch_time,
                                  tier=tname)

        classes = res.classes.cpu().numpy()   # one copy of each per drain
        aux = res.aux.cpu().numpy()
        for gi, mid in enumerate(ids):
            rows = taken_by[mid]
            tstats = self._tenant_stats(mid)
            tstats.observe_launch(bucket, len(rows), batch_time)
            br = self.breakers.get(mid) \
                if self.breaker_config is not None else None
            for bi, p in enumerate(rows):
                queue_time = self.tick - p.submit_tick
                missed = p.deadline is not None and queue_time > p.deadline
                r = RequestResult(request_id=p.request_id,
                                  prediction=classes[gi, bi],
                                  aux=aux[gi, bi], queue_time=queue_time,
                                  batch_time=batch_time, bucket=bucket,
                                  deadline_missed=missed,
                                  tier=tname or "full")
                self.results[p.request_id] = r
                self.stats.observe(r)
                tstats.observe(r)
                if self.degrade is not None:
                    self.degrade.note_latency(queue_time)
                if br is not None:
                    kind = br.success(self.tick)
                    if kind:
                        self.events.append(event(
                            kind, self.tick, "scheduler", model=str(mid)))
                if p.cache_key is not None:
                    self._cache[p.cache_key] = (classes[gi, bi].copy(),
                                                aux[gi, bi].copy())
                    self._cache.move_to_end(p.cache_key)
                    while len(self._cache) > self.cache_size:
                        self._cache.popitem(last=False)
                out.append(r)
        self._observe_degrade(straggler=straggling, sheds=sheds_now)
        return out

    def flush(self) -> List[RequestResult]:
        """Drain until the queue is empty (end-of-trace)."""
        out: List[RequestResult] = []
        while self.queue:
            out.extend(self.drain(force=True))
        return out


# ----------------------------------------------------------------- traces

def poisson_trace(rate: float, ticks: int, seed: int = 0) -> np.ndarray:
    """Poisson arrival counts per drain tick from a seeded numpy rng: the
    deterministic open-loop load model (the JAX package's, draw for
    draw)."""
    rng = np.random.default_rng(seed)
    return rng.poisson(rate, size=int(ticks)).astype(np.int64)


def replay_trace(scheduler: RequestScheduler, queries: np.ndarray,
                 counts, *, deadline: Optional[int] = None,
                 model_ids=None, chaos=None) -> List[int]:
    """Open-loop replay: at each tick submit ``counts[t]`` queries (cycling
    the rows of ``queries``) then drain once; flush the tail at the end.
    ``model_ids`` (store-mode schedulers) cycles tenants round-robin over
    the arrivals.  ``chaos`` (a ``runtime.chaos.ChaosInjector``) attaches
    a virtual clock and injects the plan's faults (bursts, stragglers,
    NaN-poisoned updates, eviction storms) at their ticks, so the whole
    replay is reproducible.  Returns the request ids in submission
    order."""
    queries = np.asarray(queries, np.float32)
    if chaos is not None:
        chaos.attach(scheduler)
    ids: List[int] = []
    i = 0
    for t, c in enumerate(counts):
        c = int(c)
        if chaos is not None:
            c += chaos.extra_arrivals(t)
            chaos.apply(scheduler, t)
        for _ in range(c):
            mid = model_ids[i % len(model_ids)] if model_ids else None
            ids.append(scheduler.submit(queries[i % len(queries)],
                                        deadline=deadline, model_id=mid))
            i += 1
        scheduler.drain()
    scheduler.flush()
    return ids
