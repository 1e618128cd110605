"""Elastic scaling: replan the mesh when hosts/chips drop or join.

Counterpart of the JAX package's ``runtime/elastic.py`` (plain Python):
the same plans and the same typed event.

Policy (1000+-node design): the model axis is sacred (param shards must stay
complete), so capacity changes reshape the DATA axes only. On failure:
  1. plan_mesh() finds the largest (pods, data, model) <= available chips
     with the model axis preserved,
  2. the train driver rebuilds its specs from the same logical rules
     (``sharding/partitioning.py``, ``models/factory.py``),
  3. Checkpointer.restore brings the last good step back,
  4. TokenBatcher's step-indexed addressing keeps the data order exact.

As in the reference, the runner (``runtime/fault_tolerance.py``) records
an evicted straggler in the typed event stream and calls no replan
itself: a driver reads the stream, calls ``replan_after_failure`` and
emits ``replan_event``.

Batch invariance: global_batch stays fixed; the per-replica microbatch count
grows when replicas shrink (gradient accumulation absorbs the difference).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import MeshConfig
from repro_torch.runtime.events import Event, event


@dataclass(frozen=True)
class ElasticPlan:
    mesh: MeshConfig
    microbatch_multiplier: int   # extra grad-accum steps vs. the full mesh
    dropped_chips: int


def replan_event(plan: Optional["ElasticPlan"], tick: int,
                 source: str = "elastic") -> Event:
    """The typed ``elastic_replan`` event for one replan outcome — the
    same runtime/events.py vocabulary the scheduler's straggler
    escalations and the chaos harness emit into, so a consumer can read
    "evict verdict -> replan" off ONE stream instead of correlating
    ad-hoc tuples across modules.  ``plan=None`` (capacity below one
    model group) is recorded as ``feasible=False``."""
    if plan is None:
        return event("elastic_replan", tick, source, feasible=False)
    return event("elastic_replan", tick, source, feasible=True,
                 data=plan.mesh.data, model=plan.mesh.model,
                 pods=plan.mesh.pods, dropped=plan.dropped_chips,
                 microbatch_multiplier=plan.microbatch_multiplier)


def plan_mesh(available_chips: int, target: MeshConfig,
              global_batch: int) -> Optional[ElasticPlan]:
    """Largest data axis that fits; model axis (and pod count if possible)
    preserved. Returns None if even one model group doesn't fit."""
    model = target.model
    if available_chips < model:
        return None
    pods = target.pods
    while pods >= 1:
        per_pod = available_chips // pods
        data = min(target.data, per_pod // model)
        if data >= 1:
            # data axis must divide the global batch for clean sharding
            while data > 1 and global_batch % (data * pods) != 0:
                data -= 1
            new = MeshConfig(data=data, model=model, pods=pods)
            full_replicas = target.pods * target.data
            new_replicas = pods * data
            mult = max(1, math.ceil(full_replicas / new_replicas))
            return ElasticPlan(
                mesh=new,
                microbatch_multiplier=mult,
                dropped_chips=available_chips - new.n_devices,
            )
        pods -= 1
    return None


def replan_after_failure(current: MeshConfig, failed_chips: int,
                         global_batch: int) -> Optional[ElasticPlan]:
    return plan_mesh(current.n_devices - failed_chips, current, global_batch)
