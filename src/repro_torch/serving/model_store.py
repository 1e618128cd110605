"""Multi-tenant model zoo: many small per-tenant estimators behind one
serving stack.

Counterpart of the JAX package's ``serving/model_store.py``.  The paper's
setting is per-device personalization, every edge node fitting its own
small model, so the serving analogue of many users is a fleet of many
small fitted models.  ``ModelStore`` is that fleet's registry, on one
device (the card unless ``device="cpu"`` is named):

  * **Same-shape registration.**  Params NamedTuples whose tensor leaves
    have the same shapes across same-config fits stack into one (G, ...)
    leading axis (``core.estimator.stack_params``) and serve as one
    grouped launch (``NonNeuralServeEngine.classify_group``: B1, B2, B3
    with a tenant axis).  RF forests are padded to a common node capacity
    on registration (``random_forest.pad_nodes``: padding nodes are never
    visited).

  * **LRU residency.**  ``resident_bytes`` bounds the fleet's summed
    full-precision param bytes.  Evicted tenants keep only the int8
    at-rest form (``serving/quant.py``'s per-channel ``QuantTensor``
    leaves) and are dequantized on admission.  The at-rest payload is
    cached on the slot, so evict -> admit -> evict round trips are
    deterministic (requantizing a dequantized tensor gives it back).

  * **Hot-swap on refit.**  ``update()`` builds the replacement slot
    completely, then publishes it with one dict assignment and a
    generation bump.  Slots are immutable and group snapshots hold
    references, so a drain in flight finishes on the old params; the next
    ``group()`` sees the new generation (which also invalidates the
    scheduler's result-cache keys and the stacked-group cache, both keyed
    on generations).

  * **Health check.**  A registration or update whose float params hold a
    NaN or Inf is refused (``PoisonedParamsError``) before anything is
    published; the previous generation keeps serving.  The check reads the
    device once a call (one flag a leaf, reduced on the device).

Resident params and at-rest payloads live on the store's device:
admission dequantizes there.
"""
from __future__ import annotations

import copy
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import estimator as _est
from repro_torch.core import random_forest as _rf
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving import quant as _q


class PoisonedParamsError(ValueError):
    """A registration or update carried non-finite (NaN/Inf) params.  The
    publish is refused (the previous generation keeps serving) and the
    offending leaf is named by its path (``.A``, ``.mu``), as the JAX
    package names it."""

    def __init__(self, leaf_path: str, model_id=None):
        self.leaf_path = leaf_path
        self.model_id = model_id
        who = f"model {model_id!r}: " if model_id is not None else ""
        super().__init__(
            f"{who}non-finite (NaN/Inf) values in params leaf "
            f"{leaf_path!r} — rejecting the slot; the previous generation "
            f"keeps serving (a poisoned tenant must never answer queries)")


def validate_finite(params, model_id=None) -> None:
    """Health check on a params NamedTuple: every float leaf must be
    finite.  Raises ``PoisonedParamsError`` naming the first offending
    leaf.  One flag a float leaf, reduced on the params' device and read
    once."""
    floats = [(name, leaf) for name, leaf in zip(params._fields, params)
              if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()]
    if not floats:
        return
    ok = torch.stack([torch.isfinite(leaf).all() for _, leaf in floats])
    bad = (~ok).nonzero()
    if bad.numel():
        raise PoisonedParamsError(f".{floats[int(bad[0, 0])][0]}",
                                  model_id=model_id)


class _Slot(NamedTuple):
    """One tenant's published state.  Immutable: ``update``/evict/admit
    build a full replacement and swap it in with one dict assignment, so a
    reader holding a slot keeps a consistent params NamedTuple."""

    generation: int
    params: Optional[NamedTuple]    # full precision, resident (None =
                                    # evicted to the int8 at-rest form)
    qparams: Optional[Any]          # cached at-rest form (QuantTensor
                                    # leaves); survives admission so a
                                    # re-eviction is free and deterministic
    resident_bytes: int
    at_rest_bytes: int

    @property
    def resident(self) -> bool:
        return self.params is not None


class ModelStore:
    """Registry of same-shape fitted estimators with LRU residency, on one
    device.

    ``resident_bytes`` bounds the summed full-precision param bytes held
    resident (None = unbounded).  The bound is soft around an active
    group: ``group(ids)`` pins its members during admission so a stacked
    launch never reads a half-evicted tenant; a group larger than the
    budget overshoots until the next access.  ``min_size`` is the at-rest
    quantization threshold of ``serving.quant.quantize_params`` (default 1:
    tenant models are small, so every float matrix quantizes).
    """

    def __init__(self, *, resident_bytes: Optional[int] = None,
                 min_size: int = 1, group_cache_entries: int = 2,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.budget = resident_bytes
        self.min_size = int(min_size)
        self._slots: Dict[Any, _Slot] = {}
        self._lru: "OrderedDict[Any, None]" = OrderedDict()  # resident ids
        self._resident_total = 0
        self._template = None            # shallow copy of the first one
        self._node_capacity = 0          # RF node-axis normalization
        self._group_cache: "OrderedDict[Tuple, Any]" = OrderedDict()
        self._group_cache_entries = int(group_cache_entries)
        # health and thrash accounting (the degrade policy reads the
        # eviction count; the chaos harness the poisoned rejections)
        self.evictions = 0
        self.admissions = 0
        self.poisoned_rejections = 0
        self.group_misses = 0            # stacked-group cache misses

    # ------------------------------------------------------------- intro

    @property
    def algorithm(self) -> str:
        assert self._template is not None, "register a model first"
        return self._template.algorithm

    @property
    def template(self):
        """The estimator whose static configuration serves the whole
        fleet: a shallow copy of the first registration, params
        included."""
        assert self._template is not None, "register a model first"
        return self._template

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, model_id) -> bool:
        return model_id in self._slots

    @property
    def model_ids(self) -> List[Any]:
        return list(self._slots)

    @property
    def resident_ids(self) -> List[Any]:
        return list(self._lru)

    def generation(self, model_id) -> int:
        return self._slots[model_id].generation

    def stats(self) -> Dict[str, Any]:
        at_rest = sum(s.at_rest_bytes for s in self._slots.values()
                      if not s.resident)
        n_res = len(self._lru)
        return {
            "n_models": len(self._slots),
            "n_resident": n_res,
            "resident_frac": n_res / len(self._slots) if self._slots else 0.0,
            "resident_bytes": self._resident_total,
            "at_rest_bytes": at_rest,
            "budget_bytes": self.budget,
        }

    # ---------------------------------------------------------- register

    def _normalize(self, estimator) -> NamedTuple:
        """Check a registration against the fleet signature and return its
        params in the store's canonical shape (RF: node axis padded to the
        fleet capacity)."""
        assert estimator.fitted, "fit the estimator before registering it"
        if estimator.device != self.device:
            raise ValueError(f"estimator lives on {estimator.device}, the "
                             f"store on {self.device}")
        params = estimator.params
        if self._template is None:
            if estimator.algorithm == "ann":
                # fail at registration, not at the first grouped launch
                estimator.predict_batch_group_fn()
            return params
        t = self._template
        if estimator.algorithm != t.algorithm:
            raise ValueError(
                f"model algorithm {estimator.algorithm!r} != the store's "
                f"{t.algorithm!r} — one ModelStore serves one algorithm "
                f"(one grouped launch serves every lane)")
        if t.algorithm == "rf":
            M = params.feature.shape[1]
            if M > self._node_capacity:
                self._grow_node_capacity(M)
            elif M < self._node_capacity:
                params = _rf.pad_nodes(params, self._node_capacity)
        # stack_params against the template raises the leaf-path error for
        # any shape, dtype or static mismatch
        _est.stack_params([self._template_params(), params])
        return params

    def _template_params(self) -> NamedTuple:
        params = self._template.params
        if self._template.algorithm == "rf" and self._node_capacity \
                and params.feature.shape[1] < self._node_capacity:
            params = _rf.pad_nodes(params, self._node_capacity)
        return params

    def _grow_node_capacity(self, capacity: int) -> None:
        """A new tenant's forest outgrew the fleet's node axis: re-pad
        every published slot (resident params directly; at-rest payloads
        by dequantize -> pad -> requantize, lossless on the original
        channels because the lattice is a requantization fixed point and
        the new channels are exact zeros)."""
        self._node_capacity = capacity
        for mid, slot in list(self._slots.items()):
            params = slot.params
            qparams = slot.qparams
            if params is not None:
                params = _rf.pad_nodes(params, capacity)
            if qparams is not None:
                fp = _q.dequantize_params(qparams, dtype=torch.float32)
                qparams = _q.quantize_params(_rf.pad_nodes(fp, capacity),
                                             min_size=self.min_size)
            nbytes = _q.param_bytes(params) if params is not None else 0
            self._resident_total += nbytes - slot.resident_bytes
            self._slots[mid] = slot._replace(
                params=params, qparams=qparams, resident_bytes=nbytes,
                at_rest_bytes=_q.quant_bytes(
                    params if params is not None
                    else _q.dequantize_params(qparams, dtype=torch.float32),
                    min_size=self.min_size))
        self._group_cache.clear()

    def register(self, model_id, estimator) -> None:
        """Publish a fitted estimator as tenant ``model_id`` (resident; the
        LRU may at once evict it or others to honour the budget).  A known
        id goes through ``update()``: re-registering would skip the
        generation bump that invalidates caches."""
        if model_id in self._slots:
            raise ValueError(f"model {model_id!r} already registered — "
                             f"use update() to hot-swap a refit")
        self._health_check(estimator, model_id)
        params = self._normalize(estimator)
        if self._template is None:
            self._template = copy.copy(estimator)
            if estimator.algorithm == "rf":
                self._node_capacity = params.feature.shape[1]
        self._publish(model_id, params, generation=0)

    def update(self, model_id, estimator) -> int:
        """Hot-swap tenant ``model_id`` with a refit estimator: the new
        slot is built completely before one dict assignment publishes it,
        and the generation bump invalidates the stale at-rest payload, the
        stacked-group cache and any generation-keyed result-cache entries.
        Drains holding the old slot's params finish on them.  Returns the
        new generation."""
        if model_id not in self._slots:
            raise KeyError(f"model {model_id!r} is not registered")
        self._health_check(estimator, model_id)
        params = self._normalize(estimator)
        gen = self._slots[model_id].generation + 1
        self._publish(model_id, params, generation=gen)
        return gen

    def _health_check(self, estimator, model_id) -> None:
        """Refuse NaN/Inf params before anything publishes (or changes the
        fleet signature): the previous generation must keep serving, so the
        refusal comes before the swap and before any RF capacity growth the
        poisoned fit could trigger."""
        assert estimator.fitted, "fit the estimator before registering it"
        try:
            validate_finite(estimator.params, model_id=model_id)
        except PoisonedParamsError:
            self.poisoned_rejections += 1
            raise

    def _publish(self, model_id, params, *, generation: int) -> None:
        slot = _Slot(generation=generation, params=params, qparams=None,
                     resident_bytes=_q.param_bytes(params),
                     at_rest_bytes=_q.quant_bytes(params,
                                                  min_size=self.min_size))
        old = self._slots.get(model_id)
        if old is not None and old.resident:
            self._resident_total -= old.resident_bytes
            self._lru.pop(model_id, None)
        self._slots[model_id] = slot          # the atomic publish
        self._lru[model_id] = None
        self._resident_total += slot.resident_bytes
        self._group_cache.clear()
        self._evict_to_budget(pinned=frozenset((model_id,)))

    def set_budget(self, resident_bytes: Optional[int]) -> None:
        """Re-bound the resident footprint (None = unbounded), evicting the
        least recently used tenants to fit."""
        self.budget = resident_bytes
        self._evict_to_budget(pinned=frozenset())

    # ---------------------------------------------------------- residency

    def _evict_to_budget(self, pinned: frozenset) -> None:
        if self.budget is None:
            return
        for mid in list(self._lru):
            if self._resident_total <= self.budget:
                return
            if mid not in pinned:
                self.evict(mid)

    def evict(self, model_id) -> None:
        """Demote a tenant to the int8 at-rest form, reusing the cached
        payload where there is one (repeated round trips are free and
        bit-identical)."""
        slot = self._slots[model_id]
        if not slot.resident:
            return
        qparams = slot.qparams
        if qparams is None:
            qparams = _q.quantize_params(slot.params,
                                         min_size=self.min_size)
        self._resident_total -= slot.resident_bytes
        self._lru.pop(model_id, None)
        self._slots[model_id] = slot._replace(params=None, qparams=qparams,
                                              resident_bytes=0)
        self.evictions += 1

    def admit(self, model_id) -> None:
        """Promote a tenant back to residency: dequantize the at-rest
        payload on the store's device (keeping it cached for the next
        eviction) and restore the fleet's resident dtypes."""
        slot = self._slots[model_id]
        if slot.resident:
            self._lru.move_to_end(model_id)
            return
        params = _q.dequantize_params(slot.qparams, dtype=torch.float32)
        # the payload passed the publish-time check, but one corrupted
        # after publish (the chaos harness's at-rest fault) is caught here
        validate_finite(params, model_id=model_id)
        self.admissions += 1
        tp = self._template_params()
        params = type(params)(*(
            p.to(t.dtype) if isinstance(p, torch.Tensor)
            and isinstance(t, torch.Tensor) and p.dtype != t.dtype else p
            for p, t in zip(params, tp)))
        nbytes = _q.param_bytes(params)
        self._slots[model_id] = slot._replace(params=params,
                                              resident_bytes=nbytes)
        self._lru[model_id] = None
        self._resident_total += nbytes
        self._evict_to_budget(pinned=frozenset((model_id,)))

    # ------------------------------------------------------------- access

    def params_of(self, model_id) -> Tuple[int, NamedTuple]:
        """(generation, resident params) of one tenant, admitting it first
        if evicted and touching the LRU."""
        if model_id not in self._slots:
            raise KeyError(f"model {model_id!r} is not registered")
        self.admit(model_id)
        slot = self._slots[model_id]
        self._lru.move_to_end(model_id)
        return slot.generation, slot.params

    def group(self, model_ids: Sequence[Any]
              ) -> Tuple[NamedTuple, Tuple[int, ...]]:
        """(stacked params (G, ...), the tenants' generations) for one
        grouped launch.  Every member is admitted and pinned meanwhile
        (eviction to the budget skips group members, so the stack never
        reads a half-evicted tenant).  The stack is cached on (ids,
        generations): a hot-swap bumps a generation and misses
        (``group_misses`` counts the stacks built)."""
        ids = tuple(model_ids)
        assert ids, "group() needs at least one model id"
        for mid in ids:
            if mid not in self._slots:
                raise KeyError(f"model {mid!r} is not registered")
        pinned = frozenset(ids)
        # admit with the budget suspended: one member's admission must not
        # evict a member admitted a moment earlier; the whole group is
        # pinned and the budget is enforced once below
        budget, self.budget = self.budget, None
        try:
            for mid in ids:
                if not self._slots[mid].resident:
                    self.admit(mid)
        finally:
            self.budget = budget
        gens = tuple(self._slots[mid].generation for mid in ids)
        for mid in ids:
            self._lru.move_to_end(mid)
        self._evict_to_budget(pinned=pinned)
        key = (ids, gens)
        stacked = self._group_cache.get(key)
        if stacked is None:
            stacked = _est.stack_params(
                [self._slots[mid].params for mid in ids])
            self.group_misses += 1
            self._group_cache[key] = stacked
            while len(self._group_cache) > self._group_cache_entries:
                self._group_cache.popitem(last=False)
        else:
            self._group_cache.move_to_end(key)
        return stacked, gens

    # ------------------------------------------------------------- engine

    def make_engine(self, **engine_kw):
        """A ``NonNeuralServeEngine`` over the fleet template, on the
        store's device: the engine whose grouped cells (``warmup_groups``,
        ``classify_group``) this store's groups feed."""
        from repro_torch.serving.engine import NonNeuralServeEngine
        engine_kw.setdefault("device", self.device)
        return NonNeuralServeEngine(self.template, **engine_kw)
