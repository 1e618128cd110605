"""The PyTorch port's degradation policy, circuit breaker and shed
accounting against the JAX package's.

Mirrors ``tests/test_degrade.py`` (its ``build_ladder``/``ann_sibling``
tests wait for ROADMAP A13): the breaker and policy state machines give
the same transitions and events as the JAX package's on the same inputs;
admission control, expiry shedding and the all-shed stats match request
for request through both schedulers (the JAX engine, and the port's on
``device="cpu"`` over the same params carried across with
``repro_torch.convert``); a ladder of hand-built ``DegradeTier``s (fp32
and ``policy="int8"`` engines over one estimator) never caches a
degraded answer.  Per request every field but ``batch_time`` is equal;
float aux agrees to ``rtol = atol = 1e-5``, integer aux exactly.
"""
import itertools

import jax
import numpy as np
import pytest

from repro.core import estimator as jest
from repro.serving import BreakerConfig as JaxBreakerConfig
from repro.serving import CircuitBreaker as JaxBreaker
from repro.serving import DegradePolicy as JaxPolicy
from repro.serving import DegradeTier as JaxTier
from repro.serving import NonNeuralServeEngine as JaxEngine
from repro.serving import RequestScheduler as JaxScheduler
from repro.serving import replay_trace as jax_replay
from repro_torch import convert
from repro_torch.core import estimator as port_est
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.serving import (BreakerConfig, CircuitBreaker,
                                 DegradePolicy, DegradeTier,
                                 NonNeuralServeEngine, RequestScheduler,
                                 poisson_trace, replay_trace)
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


def _engines(algo, X, y, max_batch=8, policy=None):
    jfit, tfit = _fits(algo, X, y)
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
    """The policy part only: the measured capacity factors and the
    ladder builders come with ROADMAP A13."""
    for name in ("CAPACITY_FACTORS", "build_ladder", "ann_sibling"):
        assert not hasattr(tdegrade, name)
    with pytest.raises(AssertionError, match="tier 0"):
        DegradePolicy([DegradeTier("int8", object(), 4)])


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
