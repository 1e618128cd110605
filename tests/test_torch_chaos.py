"""The port's fault injection (``runtime/chaos.py``) against the JAX
package's.

A plan from a seed or a preset is the JAX package's plan, field for field
and in its JSON form.  Replayed through the port's scheduler and the JAX
package's over the same fitted params (carried across with
``repro_torch.convert``), a chaos run gives the same ``RequestResult``
stream (prediction, shed and reason, tier, bucket, queue time, deadline
miss, and the virtual ``batch_time``) and the same typed event stream
(kind, tick, source, detail), in single-model and store mode; and two
port runs of one plan are identical.  The behaviours mirror
``tests/test_chaos.py``; a hand-built int8 tier stands in for its
``build_ladder`` here, and ``tests/test_torch_degrade.py`` replays its
ladder test through both packages' ``build_ladder``.
"""
import re

import jax
import numpy as np
import pytest

from repro.core import estimator as jest
from repro.launch import serve as jserve
from repro.runtime import chaos as jchaos
from repro.serving import DegradePolicy as JaxDegradePolicy
from repro.serving import ModelStore as JaxStore
from repro.serving import NonNeuralServeEngine as JaxEngine
from repro.serving import RequestScheduler as JaxScheduler
from repro.serving import replay_trace as jax_replay
from repro_torch import convert
from repro_torch.core import estimator as tst
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import serve as tserve
from repro_torch.runtime.chaos import PRESETS, ChaosInjector, ChaosPlan
from repro_torch.serving import (BreakerConfig, DegradePolicy, DegradeTier,
                                 ModelStore, NonNeuralServeEngine,
                                 RequestScheduler, poisson_trace,
                                 replay_trace)


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


@pytest.fixture(scope="module")
def blobs():
    return class_blobs(n=160, d=8, n_class=3, seed=0)


_FITS = {}


def _fit(X, y, algo="gnb"):
    """(JAX estimator, the port's over the same params)."""
    key = (algo, X.shape)
    if key not in _FITS:
        jfit = jest.make_fitted(algo, X, y, n_groups=3)
        params = convert.params_from_numpy(
            algo, jax.tree.map(np.asarray, jfit.params), device="cpu")
        _FITS[key] = (jfit, tst.ESTIMATORS[algo].from_params(params,
                                                             device="cpu"))
    return _FITS[key]


class _Clock:
    """A fixed 1 ms a launch (two clock reads a launch): straggler
    verdicts the same in both packages' runs where no plan owns time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 5e-4
        return self.t


def _result_key(r):
    pred = None if r.prediction is None else int(r.prediction)
    return (r.request_id, r.shed, r.reason, pred, r.tier, r.bucket,
            r.queue_time, r.deadline_missed, r.batch_time)


def _events(sched):
    return [(e.kind, e.tick, e.source, e.detail) for e in sched.events]


# ------------------------------------------------------------------ plans


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_plans_match_jax_and_round_trip(name):
    for seed, ticks, G in ((0, 64, 0), (3, 64, 4), (5, 24, 3)):
        t = ChaosPlan.preset(name, seed=seed, ticks=ticks, n_tenants=G)
        j = jchaos.ChaosPlan.preset(name, seed=seed, ticks=ticks,
                                    n_tenants=G)
        assert t.to_json() == j.to_json()
        assert ChaosPlan.from_json(t.to_json()) == t
        assert ChaosPlan.from_json(j.to_json()) == t
    a = ChaosPlan.preset("mixed", seed=3, ticks=64, n_tenants=4)
    assert a != ChaosPlan.preset("mixed", seed=4, ticks=64, n_tenants=4)
    assert a.straggler_ticks and a.nan_events and a.burst
    faulty = (set(a.straggler_ticks) | set(a.storm_ticks)
              | {t for t, _ in a.nan_events} | {t for t, _ in a.burst})
    assert min(faulty) >= min(8, 64 // 4)
    with pytest.raises(ValueError, match="unknown chaos preset"):
        ChaosPlan.preset("nope")
    assert set(PRESETS) == set(jchaos.PRESETS)


# ------------------------------------------------------- replay identity


def _single_replays(X, y, plan_name="mixed"):
    """The same chaos replay through the port's scheduler and the JAX
    package's (single-model, admission control and expiry shedding)."""
    jfit, tfit = _fit(X, y)
    jeng = JaxEngine(jfit, max_batch=8)
    teng = NonNeuralServeEngine(tfit, max_batch=8, device="cpu")
    jeng.warmup_buckets(X.shape[1])
    teng.warmup_buckets(X.shape[1])
    kw = dict(max_wait=2, max_queue=16, shed_expired=True)
    out = []
    for sched_cls, eng, chaos_mod, replay in (
            (RequestScheduler, teng, None, replay_trace),
            (JaxScheduler, jeng, jchaos, jax_replay)):
        sched = sched_cls(eng, **kw)
        plan_cls = ChaosPlan if chaos_mod is None else chaos_mod.ChaosPlan
        inj_cls = ChaosInjector if chaos_mod is None \
            else chaos_mod.ChaosInjector
        plan = plan_cls.preset(plan_name, seed=0, ticks=24)
        ids = replay(sched, X[:40], poisson_trace(4.0, 24, seed=1),
                     deadline=4, chaos=inj_cls(plan))
        out.append((sched, ids))
    return out


def test_chaos_replay_is_deterministic_and_matches_jax(blobs):
    """Same plan, fresh schedulers: two port runs are identical, and the
    JAX package's run gives the same results (virtual batch_time
    included) and the same typed events."""
    X, y = blobs
    (t1, ids1), (j1, jids) = _single_replays(X, y)
    (t2, ids2), _ = _single_replays(X, y)
    assert ids1 == ids2 == jids
    key1 = [_result_key(t1.results[i]) for i in ids1]
    assert key1 == [_result_key(t2.results[i]) for i in ids2]
    assert key1 == [_result_key(j1.results[i]) for i in jids]
    assert t1.events == t2.events
    assert _events(t1) == _events(j1)
    assert any(e.kind == "chaos_burst" for e in t1.events)
    assert any(e.kind == "chaos_straggler" for e in t1.events)
    assert t1.stats.summary() == j1.stats.summary()


def _ladder_replay(X, y, degrade_on):
    """A brownout ladder built by hand (tier 0 and an int8 engine over
    the same estimator with four times the budget), under the mixed
    plan."""
    _, tfit = _fit(X, y)
    eng = NonNeuralServeEngine(tfit, max_batch=8, device="cpu")
    eng.warmup_buckets(X.shape[1])
    degrade = None
    if degrade_on:
        low = NonNeuralServeEngine(tfit, max_batch=32, device="cpu",
                                   policy="int8")
        low.warmup_buckets(X.shape[1])
        degrade = DegradePolicy([DegradeTier("full", eng, 1),
                                 DegradeTier("int8", low, 4)], deadline=4)
    sched = RequestScheduler(eng, max_wait=2, max_queue=64,
                             shed_expired=True, degrade=degrade)
    plan = ChaosPlan.preset("mixed", seed=0, ticks=24)
    ids = replay_trace(sched, X[:40], poisson_trace(4.0, 24, seed=1),
                       deadline=4, chaos=ChaosInjector(plan))
    return sched, ids


def test_brownout_under_faults_stays_in_warmed_buckets(blobs):
    """Under injected faults a downshift never runs an unwarmed bucket,
    the replay is deterministic, and the armed ladder cuts miss+shed
    against admission control and shedding alone."""
    X, y = blobs
    on, ids = _ladder_replay(X, y, True)
    again, ids2 = _ladder_replay(X, y, True)
    off, ids_off = _ladder_replay(X, y, False)
    assert [_result_key(on.results[i]) for i in ids] == \
        [_result_key(again.results[i]) for i in ids2]
    assert on.stats.downshifts > 0
    for tier, per in on.stats.tier_bucket_launches.items():
        assert set(per) <= set(on.tier_warmed[tier]), tier
    assert off.stats.miss_plus_shed_rate > 0
    assert on.stats.miss_plus_shed_rate < off.stats.miss_plus_shed_rate
    assert on.stats.finished == off.stats.finished == len(ids)
    assert on.stats.tier_served.get("int8", 0) > 0


# ------------------------------------------------------ store-level chaos


def _tenant_pair(X, y, *, breaker=False, degrade=None, max_wait=2):
    """Three tenants (one fit) in the port's store and the JAX package's,
    behind store-mode schedulers."""
    jfit, tfit = _fit(X, y)
    out = []
    for store_cls, sched_cls, est, kw in (
            (ModelStore, RequestScheduler, tfit, {"device": "cpu"}),
            (JaxStore, JaxScheduler, jfit, {})):
        store = store_cls(**kw)
        for t in range(3):
            store.register(t, est)
        eng = store.make_engine(max_batch=8, max_group=4)
        eng.warmup_groups(store.group([0])[0], X.shape[1])
        port = store_cls is ModelStore
        pol = None
        if degrade is not None:
            pol = (DegradePolicy if port else JaxDegradePolicy)(None,
                                                                **degrade)
        br = None
        if breaker:
            from repro.serving import BreakerConfig as JaxBreakerConfig
            br = (BreakerConfig if port else JaxBreakerConfig)(
                fail_threshold=2, cooldown=3)
        out.append((store, sched_cls(eng, store=store, max_wait=max_wait,
                                     shed_expired=True, degrade=pol,
                                     breaker=br, clock=_Clock())))
    return out


def _store_replays(X, y, plan_kw, rate, degrade=None):
    (tstore, tsched), (jstore, jsched) = _tenant_pair(X, y, degrade=degrade)
    plan = dict(seed=0, ticks=12, **plan_kw)
    tids = replay_trace(tsched, X[:30], poisson_trace(rate, 12, seed=2),
                        model_ids=[0, 1, 2],
                        chaos=ChaosInjector(ChaosPlan(**plan),
                                            store=tstore))
    jids = jax_replay(jsched, X[:30], poisson_trace(rate, 12, seed=2),
                      model_ids=[0, 1, 2],
                      chaos=jchaos.ChaosInjector(jchaos.ChaosPlan(**plan),
                                                 store=jstore))
    assert tids == jids
    assert [_result_key(tsched.results[i]) for i in tids] == \
        [_result_key(jsched.results[i]) for i in jids]
    assert _events(tsched) == _events(jsched)
    for mid, st in tsched.tenant_stats.items():
        assert st.summary() == jsched.tenant_stats[mid].summary()
    return tstore, tsched, tids


def test_nan_injection_never_serves_poison(blobs):
    """A NaN-poisoned update is refused by the store's health check: the
    previous generation keeps serving, predictions stay finite, and the
    refusals land as typed nan_rejected events naming the leaf, as in
    the JAX package's run."""
    X, y = blobs
    store, sched, ids = _store_replays(
        X, y, {"nan_events": ((2, 0), (5, 1), (8, 0))}, 3.0)
    assert store.poisoned_rejections == 3
    assert [store.generation(t) for t in range(3)] == [0, 0, 0]
    served = [sched.results[i] for i in ids if not sched.results[i].shed]
    assert served
    assert all(np.isfinite(np.asarray(r.aux, np.float64)).all()
               for r in served)
    rej = [e for e in sched.events if e.kind == "nan_rejected"]
    assert len(rej) == 3 and all(e.get("leaf") == ".mu" for e in rej)


def test_eviction_storm_recovers_and_splits(blobs):
    """Storm ticks evict every resident tenant; drains re-admit on demand
    and the split-mode policy downshifts on the eviction count, keeping
    the group launches inside the warmed cells."""
    X, y = blobs
    _, sched, ids = _store_replays(
        X, y, {"storm_ticks": (3, 5, 7)}, 4.0,
        degrade=dict(deadline=4, thrash_evictions=2, split_levels=2))
    assert sum(e.kind == "chaos_eviction_storm" for e in sched.events) == 3
    assert sched.stats.downshifts > 0
    assert set(sched.stats.tier_served) > {"full"}
    assert set(sched.engine.group_launches) <= sched.engine.warmed_groups
    assert all(not sched.results[i].shed
               or sched.results[i].reason == "expired" for i in ids)


def test_breaker_lifecycle_through_scheduler(blobs):
    """Repeated expiry sheds open a tenant's breaker (its submits shed
    with reason breaker_open while the others serve); after the cooldown
    a probe is admitted and a served probe closes it, in both
    packages."""
    X, y = blobs
    streams = []
    for store, sched in _tenant_pair(X, y, breaker=True, max_wait=8):
        for i in range(2):                          # two expiry failures
            sched.submit(X[i], deadline=0, model_id=0)
            sched.drain()
        rid = sched.submit(X[2], deadline=4, model_id=0)
        assert sched.results[rid].reason == "breaker_open"
        ok = sched.submit(X[3], deadline=4, model_id=1)
        assert ok not in sched.results
        sched.drain(force=True)
        while sched.tick < 5:
            sched.drain()
        probe = sched.submit(X[4], deadline=8, model_id=0)
        assert probe not in sched.results
        sched.drain(force=True)
        assert not sched.results[probe].shed
        assert [e.kind for e in sched.events if e.kind.startswith(
            "breaker")] == ["breaker_open", "breaker_half_open",
                            "breaker_close"]
        assert sched.stats.shed_reasons["breaker_open"] == 1
        assert sched.tenant_stats[0].shed == 3
        streams.append(_events(sched))
    assert streams[0] == streams[1]


def test_chaos_cli_matches_jax(capsys):
    """``serve --stream --chaos straggler`` prints the JAX CLI's plan,
    stream counts and robustness events."""
    flags = ["--algo", "gnb", "--batch", "8", "--stream", "--rate", "4",
             "--ticks", "24", "--deadline", "4", "--max-queue", "16",
             "--chaos", "straggler", "--train-size", "120"]
    tserve.main(flags + ["--device", "cpu"])
    port = capsys.readouterr().out
    jserve.main(flags)
    ref = capsys.readouterr().out

    def lines(out):
        keep = [ln for ln in out.splitlines()
                if ln.startswith(("[chaos]", "[robust]"))]
        served = re.search(r"served (\d+) requests .*\((\d+) launches",
                           out)
        assert served and keep, out
        return served.groups(), keep

    assert lines(port) == lines(ref)
