"""One typed event vocabulary for the runtime and serving layers.

A copy of the JAX package's ``runtime/events.py`` (plain Python; the port
keeps its own because that package imports JAX).  Every producer speaks
this vocabulary, so a stream of events can be asserted on: "a straggler
escalation downshifted the tier", "the breaker opened before the shed".

``Event`` is a flat NamedTuple (kind, tick, source, detail): replays must
be deterministic, and NamedTuple equality over a detail tuple of sorted
(key, value) pairs makes two identical streams ``==``-comparable.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

# The closed vocabulary.  Producers MUST use one of these kinds:
# ``event()`` raises on anything else, so a mistyped kind fails when it is
# emitted, not in a consumer's filter.
EVENT_KINDS = frozenset({
    # straggler escalation ladder (runtime/straggler.py verdicts)
    "straggler_watch", "straggler_checkpoint", "straggler_evict",
    # fault-tolerant runner lifecycle
    "step_failure", "restored",
    # elastic capacity replanning
    "elastic_replan",
    # admission control / deadline shedding (serving/scheduler.py)
    "shed",
    # per-tenant circuit breaker transitions (serving/degrade.py)
    "breaker_open", "breaker_half_open", "breaker_close",
    # brownout degradation ladder (serving/degrade.py)
    "degrade_down", "degrade_up",
    # model-store health checks
    "nan_rejected",
    # injected faults, one per chaos-plan fault kind
    "chaos_burst", "chaos_straggler", "chaos_nan", "chaos_eviction_storm",
})


class Event(NamedTuple):
    """One typed event: what happened (``kind``), when (``tick``: drain
    ticks for serving events, step counter for training events), which
    layer said so (``source``), and a deterministic detail payload
    (sorted ``(key, value)`` pairs)."""

    kind: str
    tick: int
    source: str
    detail: Tuple[Tuple[str, object], ...] = ()

    def get(self, key: str, default=None):
        for k, v in self.detail:
            if k == key:
                return v
        return default


def event(kind: str, tick: int, source: str, **detail) -> Event:
    """Build a vocabulary-checked ``Event``; raises ``ValueError`` on a
    kind outside ``EVENT_KINDS``."""
    if kind not in EVENT_KINDS:
        raise ValueError(
            f"event kind {kind!r} is not in the shared vocabulary "
            f"(runtime/events.py EVENT_KINDS); add it there or fix the "
            f"producer")
    return Event(kind=kind, tick=int(tick), source=source,
                 detail=tuple(sorted(detail.items())))


def straggler_event(verdict, tick: int, source: str) -> Event:
    """Map a ``StragglerVerdict`` non-ok action onto the vocabulary."""
    assert verdict.action != "ok", "only non-ok verdicts become events"
    return event(f"straggler_{verdict.action}", tick, source,
                 host=verdict.host, ratio=round(float(verdict.ratio), 6))


def kinds(events, *wanted: str):
    """The sub-stream of ``events`` whose kind is in ``wanted``."""
    return [e for e in events if e.kind in wanted]
