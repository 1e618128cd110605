"""Request-stream scheduler with SLO accounting for NonNeuralServeEngine.

Counterpart of the JAX package's ``serving/scheduler.py`` in its
single-model mode.  Many logical clients ``submit()`` single queries (or
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
per-drain budget; their answers are never cached).  Shed requests
complete at once with ``prediction=None`` and never enter the latency
percentiles.

Results reach the host once per drain: one device-to-host copy of the
bucket's classes and one of its aux, whose rows the scatter and the LRU
cache hold as numpy (cached rows are copies).  Queries stay numpy float32
until the drain stacks them, so the cache key of a query, its fp32 bytes,
is the one the JAX package computes.

Not here: the multi-tenant mode (``store=``, ``breaker=``, routing by
``model_id``, per-tenant circuit breakers and grouped launches, ROADMAP
A12).
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.runtime.events import Event, event, straggler_event
from repro_torch.runtime.straggler import StepTimer
from repro_torch.serving.degrade import DegradePolicy
from repro_torch.serving.engine import NonNeuralServeEngine

#: shed reasons a RequestResult may carry ("breaker_open" comes with the
#: multi-tenant mode, ROADMAP A12)
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
    cache_key: Optional[Any]   # (engine fingerprint, dtype, bytes)


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
        fingerprint, query dtype, query bytes), 0 = off.
      * ``max_queue``: admission-control bound (None = unbounded).
      * ``shed_expired``: drop queued requests that would already miss
        their deadline before spending a launch slot on them.
      * ``degrade``: a ``serving.degrade.DegradePolicy`` over a ladder of
        warmed tiers whose tier 0 is this engine.
      * ``timer``, ``host``: the ``StepTimer`` each drain's ``batch_time``
        feeds, and the host id it is recorded under.
      * ``clock``: the wall-clock source for ``batch_time`` (default
        ``time.perf_counter``); a virtual clock makes the straggler
        verdicts, and so the whole RequestResult stream, replay exactly.

    The engine must be warmed first (``engine.warmup_buckets(d)`` or
    ``engine.warmup(X)``): drains coalesce ONLY into buckets warmed before
    the scheduler was built, so ``bucket_launches ⊆ warmed`` holds for a
    whole stream, per tier under brownout.
    """

    def __init__(self, engine: NonNeuralServeEngine, *, max_wait: int = 4,
                 max_batch: Optional[int] = None, cache_size: int = 0,
                 timer: Optional[StepTimer] = None, host: int = 0,
                 store=None, max_queue: Optional[int] = None,
                 shed_expired: bool = False,
                 degrade: Optional[DegradePolicy] = None,
                 breaker=None,
                 clock: Optional[Callable[[], float]] = None):
        if store is not None or breaker is not None:
            raise NotImplementedError(
                "multi-tenant scheduling (store=, breaker=) is not ported "
                "yet (ROADMAP A12)")
        assert engine.warmed, \
            "warm the engine first (engine.warmup_buckets(d)): the " \
            "scheduler only coalesces into already-warmed buckets"
        self.engine = engine
        self.max_wait = int(max_wait)
        self.max_batch = min(int(max_batch or engine.max_batch),
                             engine.max_batch)
        # snapshot NOW: engine.warmed grows with every launch, so checking
        # `bucket_launches ⊆ engine.warmed` afterwards would prove nothing
        self.warmed = frozenset(b for b in engine.warmed
                                if b <= self.max_batch)
        assert self.warmed, (engine.warmed, self.max_batch)
        self.cache_size = int(cache_size)
        self._cache: "OrderedDict[Any, Any]" = OrderedDict()
        self.timer = timer or StepTimer()
        self.host = host
        self.tick = 0
        self.queue: Deque[_Pending] = deque()
        self.stats = ServingStats()
        self.results: Dict[int, RequestResult] = {}
        self.events: List[Event] = []   # typed runtime/events.py stream
        self._next_id = 0
        self.max_queue = int(max_queue) if max_queue is not None else None
        self.shed_expired = bool(shed_expired)
        self.clock = clock if clock is not None else time.perf_counter
        self.degrade = degrade
        self._tiers: Optional[List[_TierState]] = None
        if degrade is not None and degrade.tiers is not None:
            # DegradePolicy(None) splits grouped launches (ROADMAP A12):
            # here it only observes, and every drain stays on tier 0
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

    def _cache_key(self, row: np.ndarray) -> Optional[tuple]:
        """Result-cache key: the engine fingerprint (algorithm, policy,
        engine identity) with the query's dtype and bytes, so the same
        bytes against another engine or policy never cross-hit."""
        if not self.cache_size:
            return None
        return (self.engine.cache_fingerprint, row.dtype.str, row.tobytes())

    def _record_shed(self, rid: int, reason: str,
                     queue_time: int) -> RequestResult:
        res = RequestResult(request_id=rid, prediction=None, aux=None,
                            queue_time=queue_time, batch_time=0.0,
                            bucket=0, deadline_missed=False, shed=True,
                            reason=reason)
        self.results[rid] = res
        self.stats.observe(res)
        self.events.append(event("shed", self.tick, "scheduler",
                                 reason=reason, request=rid))
        return res

    def _submit_one(self, row: np.ndarray, deadline: Optional[int]) -> int:
        rid = self._next_id
        self._next_id += 1
        key = self._cache_key(row)
        if key is not None and key in self._cache:
            self._cache.move_to_end(key)
            pred, aux = self._cache[key]
            res = RequestResult(request_id=rid, prediction=pred, aux=aux,
                                queue_time=0, batch_time=0.0, bucket=0,
                                deadline_missed=False, cache_hit=True)
            self.results[rid] = res
            self.stats.observe(res)
            return rid
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self._record_shed(rid, "queue_full", 0)
            return rid
        self.queue.append(_Pending(request_id=rid, x=row,
                                   submit_tick=self.tick,
                                   deadline=deadline, cache_key=key))
        return rid

    def submit(self, x, deadline: Optional[int] = None):
        """Enqueue one query (``(d,)`` -> request id) or a small batch
        (``(B, d)`` -> list of ids).  ``deadline`` is an SLO in drain
        ticks relative to now; a request completing later than that is
        counted as a deadline miss (it is still served).  The result for
        a returned id may already be a shed (admission control): check
        ``results[rid].shed``."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            return self._submit_one(x, deadline)
        return [self._submit_one(row, deadline) for row in x]

    # ------------------------------------------------------------- drain

    def _pick_bucket(self, n: int, warmed=None) -> int:
        """The smallest WARMED bucket covering all ``n`` coalesced
        requests (padding the tail), or the biggest warmed bucket when the
        queue overflows it (the rest waits: backpressure)."""
        warmed = sorted(self.warmed if warmed is None else warmed)
        covering = [b for b in warmed if b >= n]
        return covering[0] if covering else warmed[-1]

    def _current_tier(self) -> _TierState:
        if self._tiers is not None:
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
                    p.request_id, "expired", self.tick - p.submit_tick))
            else:
                kept.append(p)
        self.queue = kept
        return out

    def _observe_degrade(self, *, straggler: bool, sheds: int) -> None:
        """One brownout control step per drain: pressure is queue depth
        over what the CURRENT tier can clear within the coalescing window
        (and over ``max_queue`` when bounded)."""
        if self.degrade is None:
            return
        cap = self._current_tier().capacity
        pressure = len(self.queue) / max(1.0, cap * max(1, self.max_wait))
        if self.max_queue:
            pressure = max(pressure, len(self.queue) / self.max_queue)
        for e in self.degrade.observe(self.tick, pressure=pressure,
                                      straggler=straggler, sheds=sheds):
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
        shed)."""
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
                 chaos=None) -> List[int]:
    """Open-loop replay: at each tick submit ``counts[t]`` queries (cycling
    the rows of ``queries``) then drain once; flush the tail at the end.
    ``chaos`` is a fault injector with ``attach(scheduler)``,
    ``extra_arrivals(tick)`` and ``apply(scheduler, tick)`` (the JAX
    package's ``runtime.chaos.ChaosInjector`` interface; the port's comes
    with ROADMAP A13).  Returns the request ids in submission order."""
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
            ids.append(scheduler.submit(queries[i % len(queries)],
                                        deadline=deadline))
            i += 1
        scheduler.drain()
    scheduler.flush()
    return ids
