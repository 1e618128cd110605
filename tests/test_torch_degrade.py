"""The PyTorch port's degradation policy, circuit breaker and shed
accounting against the JAX package's.

Mirrors ``tests/test_degrade.py`` and the ladder test of
``tests/test_chaos.py``: the breaker and policy state machines give the
same transitions and events as the JAX package's on the same inputs;
admission control, expiry shedding and the all-shed stats match request
for request through both schedulers (the JAX engine, and the port's on
``device="cpu"`` over the same params carried across with
``repro_torch.convert``); a ladder, hand-built or from ``build_ladder``,
never caches a degraded answer.  ``build_ladder`` and ``ann_sibling``
run through both packages with the JAX package's factors passed in
(``capacity_factors={"int8": 4, "ann": 8}``): the same rung names,
factors, ``max_batch`` and warmed lattices, int8-tier classes and ANN
neighbours bit-equal, and a replay of one trace (with and without a chaos
plan) the same per-request tiers and answers; the port's default factors
(measured on the card, per rung and algorithm) leave a factor-1 rung out.
Per request every field but ``batch_time`` is equal; float aux agrees to
``rtol = atol = 1e-5``, integer aux exactly.
"""
import copy
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.serving import BreakerConfig as JaxBreakerConfig
from repro.serving import CircuitBreaker as JaxBreaker
from repro.serving import DegradePolicy as JaxPolicy
from repro.serving import DegradeTier as JaxTier
from repro.serving import NonNeuralServeEngine as JaxEngine
from repro.serving import RequestScheduler as JaxScheduler
from repro.serving import build_ladder as jax_build_ladder
from repro.serving import replay_trace as jax_replay
from repro.serving.degrade import ann_sibling as jax_ann_sibling
from repro.runtime.chaos import ChaosInjector as JaxInjector
from repro.runtime.chaos import ChaosPlan as JaxPlan
from repro_torch import convert
from repro_torch.core import estimator as port_est
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.serving import (BreakerConfig, CircuitBreaker,
                                 DegradePolicy, DegradeTier,
                                 NonNeuralServeEngine, RequestScheduler,
                                 build_ladder, poisson_trace, replay_trace)
from repro_torch.runtime.chaos import ChaosInjector, ChaosPlan
from repro_torch.serving import degrade as tdegrade

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("queue_time", "bucket", "deadline_missed", "cache_hit", "shed",
          "reason", "tier")


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


@pytest.fixture(scope="module")
def blobs():
    return class_blobs(n=160, d=8, n_class=3, seed=0)


_FITS = {}


def _fits(algo, X, y):
    if algo not in _FITS:
        jfit = jest.make_fitted(algo, X, y, n_groups=3)
        params = convert.params_from_numpy(
            algo, jax.tree.map(np.asarray, jfit.params), device="cpu")
        kw = {"k": jfit.k} if algo == "knn" else {}
        _FITS[algo] = (jfit, port_est.ESTIMATORS[algo].from_params(
            params, device="cpu", **kw))
    return _FITS[algo]


def _calibrated_fits(algo, X, y):
    """``_fits``, with the port's estimator holding the JAX fit's
    per-feature |X| maxima too, so both packages' int8 copies take the
    same lattice (a ``from_params`` estimator otherwise bounds it from
    its params)."""
    key = algo + "+absmax"
    if key not in _FITS:
        jfit, tfit = _fits(algo, X, y)
        tfit = copy.copy(tfit)
        tfit._cal_absmax = torch.from_numpy(np.array(jfit._cal_absmax))
        _FITS[key] = (jfit, tfit)
    return _FITS[key]


def _engines(algo, X, y, max_batch=8, policy=None, fits=_fits):
    jfit, tfit = fits(algo, X, y)
    jeng = JaxEngine(jfit, max_batch=max_batch, policy=policy)
    teng = NonNeuralServeEngine(tfit, max_batch=max_batch, device="cpu",
                                policy=policy)
    jeng.warmup_buckets(X.shape[1])
    teng.warmup_buckets(X.shape[1])
    return jeng, teng


def same_results(jsched, tsched):
    assert sorted(jsched.results) == sorted(tsched.results)
    for i, a in jsched.results.items():
        b = tsched.results[i]
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (i, f)
        if a.prediction is None:
            assert b.prediction is None and b.aux is None
            continue
        assert int(a.prediction) == int(b.prediction), i
        want, got = np.asarray(a.aux), np.asarray(b.aux)
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_array_equal(got, want)
    js, ts = jsched.stats.summary(), tsched.stats.summary()
    assert set(js) == set(ts)
    for key, want in js.items():
        if isinstance(want, float) and np.isnan(want):
            assert np.isnan(ts[key]), key
        else:
            assert ts[key] == pytest.approx(want), key
    assert tsched.stats.shed_reasons == jsched.stats.shed_reasons
    assert tsched.events == jsched.events


# ------------------------------------------------------- circuit breaker

def _breaker_script(br):
    """The JAX test's transitions, returned as a list to compare."""
    out = [br.allow(0), br.failure(1), br.failure(2), br.failure(3),
           br.allow(4), br.allow(6), br.allow(7), br.allow(7),
           br.success(8), (br.state, br.failures), br.allow(9)]
    return out


def test_breaker_open_half_open_close():
    cfg = dict(fail_threshold=3, cooldown=4)
    got = _breaker_script(CircuitBreaker(BreakerConfig(**cfg)))
    assert got == _breaker_script(JaxBreaker(JaxBreakerConfig(**cfg)))
    assert got == [(True, None), None, None, "breaker_open", (False, None),
                   (False, None), (True, "breaker_half_open"),
                   (False, None), "breaker_close", ("closed", 0),
                   (True, None)]


def test_breaker_failed_probe_reopens():
    for br in (CircuitBreaker(BreakerConfig(fail_threshold=1, cooldown=2)),
               JaxBreaker(JaxBreakerConfig(fail_threshold=1, cooldown=2))):
        assert br.failure(0) == "breaker_open"
        assert br.allow(2) == (True, "breaker_half_open")
        assert br.failure(3) == "breaker_open"      # probe died -> reopen
        assert br.allow(4) == (False, None)         # cooldown restarts at 3


# ------------------------------------------------- hysteretic tier policy

def _drive(policy, script):
    """Feed ``script`` (tick, kwargs, latencies before) to ``policy``;
    return every event and the level after each step."""
    out = []
    for tick, kw, lats in script:
        for q in lats:
            policy.note_latency(q)
        out.append((policy.observe(tick, **kw), policy.level,
                    policy.headroom(), policy.tier_name()))
    return out


SCRIPTS = {
    "down_immediate_up_hysteretic": (
        dict(hold=3, cooldown=2, split_levels=2),
        [(t, {"pressure": p}, ()) for t, p in
         [(1, 0.9), (2, 0.9), (3, 0.9), (4, 0.9), (5, 0.0), (6, 0.0),
          (7, 0.0), (8, 0.0), (9, 0.6), (10, 0.0), (11, 0.0), (12, 0.0)]]),
    "headroom_and_stale_window": (
        dict(deadline=4, down_headroom=0.25, hold=1, cooldown=0,
             split_levels=1),
        [(1, {}, (4, 4, 4, 4)), (2, {}, (1, 1, 1, 1)), (3, {}, ())]),
    "straggler": (dict(cooldown=0, split_levels=1),
                  [(1, {"straggler": True}, ())]),
    "shed": (dict(cooldown=0, split_levels=1), [(1, {"sheds": 2}, ())]),
    "thrash": (dict(cooldown=0, split_levels=1),
               [(1, {"evictions": 99}, ())]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_policy_state_machine_matches_jax(name):
    kw, script = SCRIPTS[name]
    got = _drive(DegradePolicy(None, **kw), script)
    assert got == _drive(JaxPolicy(None, **kw), script)
    first = got[0][0]
    assert len(first) == 1 and first[0].kind == "degrade_down"
    trigger = {"down_immediate_up_hysteretic": "backpressure",
               "headroom_and_stale_window": "headroom"}.get(name, name)
    assert first[0].get("trigger") == trigger


def test_policy_levels_and_window():
    """The JAX test's expectations, on the port alone."""
    pol = DegradePolicy(None, hold=3, cooldown=2, split_levels=2)
    assert pol.observe(1, pressure=0.9)[0].get("tier") == "split2"
    assert pol.observe(2, pressure=0.9) == []       # cooldown blocks
    assert pol.observe(3, pressure=0.9)[0].get("tier") == "split4"
    assert pol.level == 2 and pol.group_shift == 2 and pol.current is None
    pol = DegradePolicy(None, deadline=4, hold=1, cooldown=0,
                        split_levels=1)
    for q in (4, 4, 4, 4):
        pol.note_latency(q)
    assert pol.headroom() == 0.0
    pol.observe(1)
    assert pol.level == 1 and pol.headroom() is None  # window cleared


def test_ladder_helpers_wait_for_a13():
    """The ladder builders are in (ROADMAP A13 is done): the capacity
    factors are the port's own, per (rung, algorithm), powers of two of at
    least 1, never the JAX package's rung-keyed CPU table; a ladder's tier
    0 is still the undegraded engine."""
    assert callable(tdegrade.build_ladder) and callable(tdegrade.ann_sibling)
    assert tdegrade.RUNGS == ("int8", "ann")
    assert tdegrade.CAPACITY_FACTORS
    for (rung, algo), f in tdegrade.CAPACITY_FACTORS.items():
        assert rung in tdegrade.RUNGS and algo in tdispatch.HOT_OPS
        assert isinstance(f, int) and f >= 1 and f & (f - 1) == 0
    assert set(tdegrade.CAPACITY_FACTORS) >= {
        ("int8", "knn"), ("int8", "kmeans"), ("int8", "gnb"), ("ann", "knn")}
    with pytest.raises(AssertionError, match="tier 0"):
        DegradePolicy([DegradeTier("int8", object(), 4)])


# ------------------------------------------------------------------ ladder

JAX_FACTORS = {"int8": 4, "ann": 8}


def _rungs(tiers):
    return [(t.name, t.capacity_factor, t.engine.max_batch,
             sorted(t.engine.warmed), dict(t.engine.bucket_launches))
            for t in tiers]


def test_build_ladder_knn_full_int8_ann(blobs):
    X, y = blobs
    jeng, teng = _engines("knn", X, y, fits=_calibrated_fits)
    jt = jax_build_ladder(jeng, X.shape[1], capacity_factors=JAX_FACTORS)
    tt = build_ladder(teng, X.shape[1], capacity_factors=JAX_FACTORS)
    assert _rungs(tt) == _rungs(jt)
    assert [t.name for t in tt] == ["full", "int8", "ann"]
    assert tt[0].engine is teng and tt[0].capacity_factor == 1
    assert [t.capacity_factor for t in tt] == [1, 4, 8]
    assert tt[1].engine.estimator.quantized
    assert not teng.estimator.quantized          # the caller's stays fp32
    assert tt[2].engine.estimator.algorithm == "ann"
    for t in tt:                                 # warmed up front
        assert t.engine.warmed and t.engine.bucket_launches == {}
        assert t.engine.device == teng.device
    assert max(tt[1].engine.warmed) >= 8 * 4
    # the int8 tier's classes and neighbours bit-equal across packages
    for i in (1, 2):
        got, want = tt[i].engine.classify(X[:37]), jt[i].engine.classify(
            X[:37])
        np.testing.assert_array_equal(got.classes.numpy(),
                                      np.asarray(want.classes))
        np.testing.assert_array_equal(got.aux.numpy(), np.asarray(want.aux))


@pytest.mark.parametrize("algo", ["gnb", "kmeans", "gmm", "rf"])
def test_build_ladder_non_knn_skips_ann(algo, blobs):
    X, y = blobs
    jeng, teng = _engines(algo, X, y, fits=_calibrated_fits)
    jt = jax_build_ladder(jeng, X.shape[1], capacity_factors=JAX_FACTORS)
    tt = build_ladder(teng, X.shape[1], capacity_factors=JAX_FACTORS)
    assert [t.name for t in tt] == [t.name for t in jt] == ["full", "int8"]
    assert _rungs(tt) == _rungs(jt)
    got, want = tt[1].engine.classify(X[:19]), jt[1].engine.classify(X[:19])
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))


def test_build_ladder_rejects_unknown_rungs(blobs):
    X, y = blobs
    _, teng = _engines("gnb", X, y)
    with pytest.raises(ValueError, match="unknown brownout rung"):
        build_ladder(teng, X.shape[1], rungs=("int8", "fp16"))


def test_default_factors_skip_factor_one_rungs(blobs, monkeypatch):
    """A rung whose measured factor is 1 gains no capacity and is left
    out; an algorithm with no measured factor too; a caller's factor
    builds the rung whatever it is."""
    X, y = blobs
    _, teng = _engines("knn", X, y)
    monkeypatch.setattr(tdegrade, "CAPACITY_FACTORS",
                        {("int8", "knn"): 2, ("ann", "knn"): 1,
                         ("int8", "gnb"): 1})
    tt = build_ladder(teng, X.shape[1])
    assert [(t.name, t.capacity_factor, t.engine.max_batch)
            for t in tt] == [("full", 1, 8), ("int8", 2, 16)]
    _, geng = _engines("gnb", X, y)
    assert [t.name for t in build_ladder(geng, X.shape[1])] == ["full"]
    _, meng = _engines("gmm", X, y)
    assert [t.name for t in build_ladder(meng, X.shape[1])] == ["full"]
    forced = build_ladder(geng, X.shape[1], capacity_factors={"int8": 1})
    assert [(t.name, t.capacity_factor) for t in forced] == \
        [("full", 1), ("int8", 1)]
    both = build_ladder(teng, X.shape[1], capacity_factors={"ann": 4})
    assert [(t.name, t.capacity_factor) for t in both] == \
        [("full", 1), ("int8", 2), ("ann", 4)]
    # the table the port ships: every factor-1 rung is absent by default
    monkeypatch.undo()
    for algo in ("knn", "kmeans", "gnb"):
        _, eng = _engines(algo, X, y)
        names = [t.name for t in build_ladder(eng, X.shape[1])]
        for rung in tdegrade.RUNGS:
            f = tdegrade.CAPACITY_FACTORS.get((rung, algo), 1)
            assert (rung in names) == (f > 1), (algo, rung, f)


def test_ann_sibling_rejects_non_knn(blobs):
    X, y = blobs
    jeng, teng = _engines("gnb", X, y)
    with pytest.raises(ValueError, match="exact-kNN") as terr:
        tdegrade.ann_sibling(teng)
    with pytest.raises(ValueError, match="exact-kNN") as jerr:
        jax_ann_sibling(jeng)
    assert str(terr.value) == str(jerr.value)
    _, q8 = _engines("knn", X, y, policy="int8")
    with pytest.raises(ValueError, match="int8"):
        tdegrade.ann_sibling(q8)


def test_ann_sibling_label_agreement(blobs):
    """The bottom rung serves the SAME reference rows: refined IVF-PQ
    agrees with exact kNN on >= 95% of labels, and its index and answers
    are the JAX package's."""
    X, y = blobs
    jeng, teng = _engines("knn", X, y, fits=_calibrated_fits)
    sib, jsib = tdegrade.ann_sibling(teng), jax_ann_sibling(jeng)
    assert sib.estimator.refine == jsib.estimator.refine == 8 * teng.\
        estimator.k
    assert sib.estimator.serve_cost_shape() == \
        jsib.estimator.serve_cost_shape()
    np.testing.assert_array_equal(sib.estimator.params.codes.numpy(),
                                  np.asarray(jsib.estimator.params.codes))
    exact, _ = teng.estimator.predict_batch(X[:64])
    approx, nbr = sib.estimator.predict_batch(X[:64])
    agree = float((exact == approx).float().mean())
    assert agree >= 0.95, agree
    jc, jn = jsib.estimator.predict_batch(X[:64])
    np.testing.assert_array_equal(approx.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jn))
    assert sib.max_batch == teng.max_batch
    assert tdegrade.ann_sibling(teng, nprobe=2, refine=0,
                                max_batch=32).max_batch == 32


def test_sibling_shares_geometry_and_device(blobs):
    X, y = blobs
    _, teng = _engines("kmeans", X, y)
    sib = teng.sibling(policy="int8")
    assert sib.max_batch == teng.max_batch and sib.device == teng.device
    assert sib.estimator.quantized and not teng.estimator.quantized
    assert sib.cache_fingerprint != teng.cache_fingerprint
    assert teng.sibling(max_batch=64).estimator is teng.estimator


# ---------------------------------------------------- degraded-tier cache

def _pinned_tier_run(Scheduler, Policy, Tier, eng, eng8, X):
    pol = Policy([Tier("full", eng, 1), Tier("int8", eng8, 4)],
                 hold=10**9)
    sched = Scheduler(eng, max_wait=1, cache_size=8, degrade=pol)
    pol.level = 1                                   # pin the int8 tier
    sched.submit(X[0])
    (r,) = sched.drain(force=True)
    assert r.tier == "int8" and not r.cache_hit
    sched.submit(X[0])                              # same bytes again
    (r2,) = sched.drain(force=True)
    assert not r2.cache_hit                         # nothing was cached
    pol.level = 0
    sched.submit(X[0])
    (r3,) = sched.drain(force=True)
    assert r3.tier == "full" and not r3.cache_hit
    assert sched.results[sched.submit(X[0])].cache_hit   # tier 0 cached
    return sched


@pytest.mark.parametrize("algo", ["gnb", "knn"])
def test_built_ladder_results_never_cached(algo, blobs):
    """The JAX test's form: the ladder from ``build_ladder``."""
    X, y = blobs
    jeng, teng = _engines(algo, X, y, fits=_calibrated_fits)
    jt = jax_build_ladder(jeng, X.shape[1], capacity_factors=JAX_FACTORS)
    tt = build_ladder(teng, X.shape[1], capacity_factors=JAX_FACTORS)
    scheds = []
    for Scheduler, Policy, eng, tiers in (
            (JaxScheduler, JaxPolicy, jeng, jt),
            (RequestScheduler, DegradePolicy, teng, tt)):
        pol = Policy(tiers, hold=10**9)
        sched = Scheduler(eng, max_wait=1, cache_size=8, degrade=pol)
        pol.level = 1                               # pin the int8 tier
        sched.submit(X[0])
        (r,) = sched.drain(force=True)
        assert r.tier == "int8" and not r.cache_hit
        sched.submit(X[0])
        (r2,) = sched.drain(force=True)
        assert not r2.cache_hit
        pol.level = 0
        sched.submit(X[0])
        (r3,) = sched.drain(force=True)
        assert r3.tier == "full" and not r3.cache_hit
        assert sched.results[sched.submit(X[0])].cache_hit
        scheds.append(sched)
    same_results(*scheds)


def _ladder_stream(Scheduler, Policy, build, replay, eng, X, counts,
                   **kw):
    pol = Policy(build(eng, X.shape[1], capacity_factors=JAX_FACTORS),
                 deadline=4, hold=3)
    sched = Scheduler(eng, degrade=pol, clock=itertools.count().__next__,
                      max_wait=2, max_queue=64, shed_expired=True)
    replay(sched, X[:60], counts, deadline=4, **kw)
    return sched


def test_built_ladder_replay_matches_jax(blobs):
    """An overloaded kNN stream down the whole ladder (fp32, int8 x4, ANN
    x8): the same per-request tiers, sheds and answers in both packages
    (int8 kNN and ANN are integer work, so neighbours are equal too)."""
    X, y = blobs
    jeng, teng = _engines("knn", X, y, max_batch=4,
                          fits=_calibrated_fits)
    counts = np.concatenate([poisson_trace(1.0, 8, seed=1),
                             poisson_trace(40.0, 24, seed=2),
                             poisson_trace(0.5, 40, seed=3)])
    js = _ladder_stream(JaxScheduler, JaxPolicy, jax_build_ladder,
                        jax_replay, jeng, X, counts)
    ts = _ladder_stream(RequestScheduler, DegradePolicy, build_ladder,
                        replay_trace, teng, X, counts)
    same_results(js, ts)
    st = ts.stats
    assert st.downshifts >= 2 and st.upshifts >= 1
    assert st.tier_served.get("ann", 0) > 0 and st.tier_served["full"] > 0
    for tier, per in st.tier_bucket_launches.items():
        assert set(per) <= ts.tier_warmed[tier], tier
    for t in ts.degrade.tiers:
        assert set(t.engine.bucket_launches) <= t.engine.warmed


def test_chaos_ladder_replay_matches_jax(blobs):
    """``tests/test_chaos.py``'s ladder replay through both packages: a
    GNB ladder under the mixed plan, the same results, events and
    per-tier launches, every tier inside its warmed buckets."""
    X, y = blobs
    out = []
    for Scheduler, Policy, build, replay, Plan, Injector, eng in (
            (JaxScheduler, JaxPolicy, jax_build_ladder, jax_replay, JaxPlan,
             JaxInjector, None),
            (RequestScheduler, DegradePolicy, build_ladder, replay_trace,
             ChaosPlan, ChaosInjector, None)):
        jeng, teng = _engines("gnb", X, y, fits=_calibrated_fits)
        eng = jeng if Scheduler is JaxScheduler else teng
        degrade = Policy(build(eng, X.shape[1],
                               capacity_factors=JAX_FACTORS), deadline=4)
        sched = Scheduler(eng, max_wait=2, max_queue=64, shed_expired=True,
                          degrade=degrade)
        plan = Plan.preset("mixed", seed=0, ticks=24)
        ids = replay(sched, X[:40], poisson_trace(4.0, 24, seed=1),
                     deadline=4, chaos=Injector(plan))
        out.append((sched, ids))
    (js, jids), (ts, tids) = out
    assert jids == tids
    same_results(js, ts)
    assert [r.batch_time for r in ts.results.values()] == \
        [r.batch_time for r in js.results.values()]
    assert ts.stats.downshifts > 0
    assert set(ts.stats.tier_bucket_launches) > {"full"}
    assert ts.stats.tier_bucket_launches == js.stats.tier_bucket_launches
    for tier, per in ts.stats.tier_bucket_launches.items():
        assert set(per) <= set(ts.tier_warmed[tier]), tier
    for t in ts.degrade.tiers:
        assert t.engine.warmed >= set(
            ts.stats.tier_bucket_launches.get(t.name, {}))


@pytest.mark.parametrize("algo", ["gnb", "knn"])
def test_degraded_tier_results_never_cached(algo, blobs):
    """Only exact tier-0 answers enter the LRU: an int8 answer cached
    during a brownout would keep serving as exact after recovery."""
    X, y = blobs
    jeng, teng = _engines(algo, X, y)
    jeng8, teng8 = _engines(algo, X, y, max_batch=32, policy="int8")
    assert teng8.estimator.quantized and not teng.estimator.quantized
    jsched = _pinned_tier_run(JaxScheduler, JaxPolicy, JaxTier, jeng,
                              jeng8, X)
    tsched = _pinned_tier_run(RequestScheduler, DegradePolicy, DegradeTier,
                              teng, teng8, X)
    assert tsched.tier_warmed == {"full": frozenset({1, 2, 4, 8}),
                                  "int8": frozenset({1, 2, 4, 8, 16, 32})}
    for i, a in jsched.results.items():
        b = tsched.results[i]
        assert (a.tier, a.cache_hit, int(a.prediction)) == \
            (b.tier, b.cache_hit, int(b.prediction))


def test_brownout_stream_matches_jax(blobs):
    """An overloaded kNN stream over a fp32 and an int8 tier with
    admission control and expiry shedding: the same downshifts,
    upshifts, sheds and answers on the same requests (int8 kNN is
    integer work, so its neighbours are equal too).  Each scheduler reads
    a clock that advances one second a read, so every launch takes the
    same time and no straggler verdict, which wall time would make differ
    between the two runs, reaches the policy."""
    X, y = blobs
    jeng, teng = _engines("knn", X, y, max_batch=4)
    jeng8, teng8 = _engines("knn", X, y, max_batch=16, policy="int8")
    kw = dict(max_wait=2, max_queue=12, shed_expired=True)
    counts = np.concatenate([poisson_trace(1.0, 10, seed=1),
                             poisson_trace(9.0, 20, seed=2),
                             poisson_trace(1.0, 30, seed=3)])
    scheds = []
    for Scheduler, Policy, Tier, replay, e, e8 in (
            (JaxScheduler, JaxPolicy, JaxTier, jax_replay, jeng, jeng8),
            (RequestScheduler, DegradePolicy, DegradeTier, replay_trace,
             teng, teng8)):
        pol = Policy([Tier("full", e, 1), Tier("int8", e8, 4)],
                     deadline=4, hold=3)
        sched = Scheduler(e, degrade=pol,
                          clock=itertools.count().__next__, **kw)
        replay(sched, X[:40], counts, deadline=4)
        scheds.append(sched)
        assert set(sched.stats.tier_bucket_launches["full"]) <= \
            sched.tier_warmed["full"]
        assert set(sched.stats.tier_bucket_launches["int8"]) <= \
            sched.tier_warmed["int8"]
    same_results(*scheds)
    st = scheds[1].stats
    assert st.downshifts >= 1 and st.upshifts >= 1 and st.shed > 0
    assert set(st.shed_reasons) <= {"queue_full", "expired"}
    assert st.tier_served["int8"] > 0 and st.tier_served["full"] > 0


# -------------------------------------------------------- shed accounting

def test_admission_control_sheds_queue_full(blobs):
    X, y = blobs
    jeng, teng = _engines("gnb", X, y)
    scheds = [S(e, max_wait=2, max_queue=3) for S, e in
              ((JaxScheduler, jeng), (RequestScheduler, teng))]
    for sched in scheds:
        ids = sched.submit(X[:5])
        shed = [sched.results[i] for i in ids if i in sched.results]
        assert [r.reason for r in shed] == ["queue_full", "queue_full"]
        assert all(r.shed and r.prediction is None for r in shed)
        assert sched.pending == 3
        sched.flush()
        assert sched.stats.completed == 3 and sched.stats.shed == 2
        assert sched.stats.shed_reasons == {"queue_full": 2}
        assert sched.stats.finished == 5
        assert sched.stats.shed_rate == pytest.approx(2 / 5)
    same_results(*scheds)


def test_expired_requests_shed_before_launch(blobs):
    X, y = blobs
    jeng, teng = _engines("gnb", X, y)
    scheds = [S(e, max_wait=4, shed_expired=True) for S, e in
              ((JaxScheduler, jeng), (RequestScheduler, teng))]
    for sched in scheds:
        rid = sched.submit(X[0], deadline=1)
        assert sched.drain() == []                  # tick 1: still live
        (r,) = sched.drain()                        # tick 2: 2 > 1 -> shed
        assert r.request_id == rid and r.reason == "expired"
        assert r.queue_time == 2 and sched.pending == 0
        assert sched.stats.launches == 0            # no slot was wasted
        (ev,) = sched.events
        assert ev.kind == "shed" and ev.get("reason") == "expired"
    same_results(*scheds)


def test_all_shed_window_stats_safe(blobs):
    """A window where everything was shed reads nan percentiles and zero
    throughput with non-zero shed counts; summary() does not raise."""
    X, y = blobs
    jeng, teng = _engines("gnb", X, y)
    scheds = [S(e, max_wait=1, max_queue=0) for S, e in
              ((JaxScheduler, jeng), (RequestScheduler, teng))]
    for sched in scheds:
        for i in range(4):
            sched.submit(X[i], deadline=1)
        sched.drain()
        s = sched.stats.summary()
        assert s["completed"] == 0 and s["shed"] == 4
        assert np.isnan(s["p50"]) and np.isnan(s["p95"]) and \
            np.isnan(s["p99"])
        assert s["throughput"] == 0.0 and s["shed_rate"] == 1.0
        assert s["miss_plus_shed_rate"] == 1.0
        assert sched.stats.finished == 4
    same_results(*scheds)


def test_single_model_stream_degrade_cli(monkeypatch, capsys):
    """``serve --stream --degrade`` builds the ladder of the engine (the
    measured factors; here a table with an int8 gain), prints the JAX
    CLI's ladder line and sheds expired requests."""
    from repro_torch.launch import serve
    monkeypatch.setattr(tdegrade, "CAPACITY_FACTORS",
                        {("int8", "knn"): 2, ("ann", "knn"): 1})
    serve.main(["--device", "cpu", "--algo", "knn", "--batch", "8",
                "--train-size", "200", "--stream", "--rate", "24",
                "--ticks", "30", "--deadline", "4", "--degrade"])
    out = capsys.readouterr().out
    assert "[degrade] ladder: full (x1) -> int8 (x2)" in out
    assert "[stream] served" in out
    assert "downshifts=" in out and "tiers={'full'" in out
