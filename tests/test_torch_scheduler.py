"""The PyTorch port's request-stream scheduler against the JAX package's.

The same seeded Poisson trace is replayed through the JAX package's
``RequestScheduler`` (JAX engine) and the port's (engine on
``device="cpu"``), each over the same fitted params: the JAX fit, carried
across with ``repro_torch.convert``.  Per request, prediction, queue
time, bucket, deadline miss, cache hit, shed, reason and tier are equal;
float aux agrees to ``rtol = atol = 1e-5`` (integer aux exactly);
``ServingStats.summary()`` is equal (it holds no wall-clock field).  The
behaviours mirror ``tests/test_scheduler.py`` (its sharded test waits
for ROADMAP A15).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.core import estimator as jest
from repro.runtime.straggler import StepTimer as JaxStepTimer
from repro.serving import NonNeuralServeEngine as JaxEngine
from repro.serving import RequestScheduler as JaxScheduler
from repro.serving import poisson_trace as jax_trace
from repro.serving import replay_trace as jax_replay
from repro_torch import convert
from repro_torch.core import estimator as port_est
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.runtime import events as tevents
from repro_torch.runtime.straggler import StepTimer, StragglerVerdict
from repro_torch.serving import (NonNeuralServeEngine, RequestScheduler,
                                 poisson_trace, replay_trace)

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
ALGOS = sorted(port_est.ESTIMATORS)
FIELDS = ("queue_time", "bucket", "deadline_missed", "cache_hit", "shed",
          "reason", "tier")


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


@pytest.fixture(scope="module")
def blobs():
    return class_blobs(n=240, d=13, n_class=3, seed=0)


_FITS = {}


def _fits(algo, X, y):
    """(JAX estimator, the port's estimator over the same params)."""
    key = (algo, X.shape)
    if key not in _FITS:
        jfit = jest.make_fitted(algo, X, y, n_groups=3)
        params = convert.params_from_numpy(
            algo, jax.tree.map(np.asarray, jfit.params), device="cpu")
        kw = {}
        if algo in ("knn", "ann"):
            kw["k"] = jfit.k
        if algo == "ann":
            kw.update(nprobe=jfit.nprobe, refine=jfit.refine)
        _FITS[key] = (jfit, port_est.ESTIMATORS[algo].from_params(
            params, device="cpu", **kw))
    return _FITS[key]


def _engines(algo, X, y, max_batch=8):
    jfit, tfit = _fits(algo, X, y)
    jeng = JaxEngine(jfit, max_batch=max_batch)
    teng = NonNeuralServeEngine(tfit, max_batch=max_batch, device="cpu")
    jeng.warmup_buckets(X.shape[1])
    teng.warmup_buckets(X.shape[1])
    assert set(jeng.warmed) == set(teng.warmed)
    return jeng, teng


def same_results(jsched, tsched, ids):
    """Per-request parity of two schedulers over the same request ids."""
    assert sorted(jsched.results) == sorted(tsched.results)
    for i in ids:
        a, b = jsched.results[i], tsched.results[i]
        for f in FIELDS:
            assert getattr(a, f) == getattr(b, f), (i, f)
        if a.prediction is None:
            assert b.prediction is None and b.aux is None
            continue
        assert int(a.prediction) == int(b.prediction), i
        want, got = np.asarray(a.aux), np.asarray(b.aux)
        assert got.shape == want.shape
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_array_equal(got, want)


def same_summary(jsched, tsched):
    js, ts = jsched.stats.summary(), tsched.stats.summary()
    assert set(js) == set(ts)
    for key, want in js.items():
        got = ts[key]
        if isinstance(want, float) and np.isnan(want):
            assert np.isnan(got), key
        else:
            assert got == pytest.approx(want), key
    assert jsched.stats.bucket_launches == tsched.stats.bucket_launches


# ------------------------------------------------------- streaming parity

@pytest.mark.parametrize("algo", ALGOS)
def test_stream_matches_jax_and_oneshot(algo, blobs):
    """Every request through the coalescing stream: the JAX scheduler's
    result field for field, and the prediction one-shot classify gives
    the concatenated queries."""
    X, y = blobs
    jeng, teng = _engines(algo, X, y, max_batch=16)
    jsched = JaxScheduler(jeng, max_wait=3)
    tsched = RequestScheduler(teng, max_wait=3)
    counts = poisson_trace(2.5, 40, seed=7)
    np.testing.assert_array_equal(counts, jax_trace(2.5, 40, seed=7))
    jids = jax_replay(jsched, X[:60], counts)
    ids = replay_trace(tsched, X[:60], counts)
    assert ids == jids and tsched.pending == 0 and len(ids) > 40
    same_results(jsched, tsched, ids)
    same_summary(jsched, tsched)
    Q = X[np.arange(len(ids)) % 60]
    want_cls, _ = teng.estimator.predict_batch(Q)
    got = np.array([tsched.results[i].prediction for i in ids])
    np.testing.assert_array_equal(got, want_cls.numpy())
    assert teng.bucket_launches == jeng.bucket_launches


@pytest.mark.parametrize("algo", ["gnb", "knn"])
def test_cached_deadline_stream_matches_jax(algo, blobs):
    """A stream that repeats queries under a deadline and a small LRU:
    hits, misses and evictions land on the same requests."""
    X, y = blobs
    jeng, teng = _engines(algo, X, y, max_batch=8)
    kw = dict(max_wait=2, cache_size=6)
    jsched, tsched = JaxScheduler(jeng, **kw), RequestScheduler(teng, **kw)
    counts = poisson_trace(5.0, 30, seed=3)
    jids = jax_replay(jsched, X[:12], counts, deadline=1)
    ids = replay_trace(tsched, X[:12], counts, deadline=1)
    assert ids == jids
    same_results(jsched, tsched, ids)
    same_summary(jsched, tsched)
    s = tsched.stats.summary()
    assert 0.0 < s["hit_rate"] < 1.0
    assert 0.0 < s["deadline_miss_rate"] < 1.0


# ------------------------------------------------- steady-state buckets

def test_steady_state_uses_only_warmed_buckets(blobs):
    """After warmup_buckets a whole stream reuses warmed buckets only:
    bucket_launches keys ⊆ warmed, and warmed never grows."""
    X, y = blobs
    _, teng = _engines("kmeans", X, y, max_batch=16)
    warmed = set(teng.warmed)
    assert teng.bucket_launches == {}      # warmup left the counters clean
    sched = RequestScheduler(teng, max_wait=2)
    replay_trace(sched, X[:50], poisson_trace(5.0, 30, seed=3))
    assert sched.stats.completed > 100
    assert set(teng.bucket_launches) <= warmed == set(sched.warmed)
    assert teng.warmed == warmed


def test_padded_batch_hits_the_warmed_bucket_exactly(blobs, monkeypatch):
    """The drain pads on the host to the bucket it picked, so the engine
    gets exactly a warmed shape and pads nothing again."""
    X, y = blobs
    _, teng = _engines("gnb", X, y, max_batch=8)
    shapes = []
    inner = teng._fn
    monkeypatch.setattr(teng, "_fn", lambda p, q: shapes.append(
        tuple(q.shape)) or inner(p, q))
    sched = RequestScheduler(teng, max_wait=1)
    for n in (1, 3, 5, 8, 11):
        sched.submit(X[:n])
        sched.flush()
    assert shapes == [(1, 13), (4, 13), (8, 13), (8, 13), (8, 13),
                      (4, 13)]
    assert {s[0] for s in shapes} <= set(sched.warmed)


def test_unwarmed_engine_rejected(blobs):
    X, y = blobs
    _, tfit = _fits("gnb", X, y)
    eng = NonNeuralServeEngine(tfit, max_batch=8, device="cpu")
    with pytest.raises(AssertionError, match="warm"):
        RequestScheduler(eng)


# ------------------------------------------------------- SLO accounting

def test_stats_match_hand_computed_trace(blobs):
    """The JAX test's hand-computed trace (warmed buckets {1, 2, 4, 8}):
    five queries launch in bucket 8 at tick 2, a resubmit hits the LRU,
    a late query misses its deadline in bucket 1."""
    X, y = blobs
    _, teng = _engines("gnb", X, y, max_batch=8)
    assert teng.warmed == {1, 2, 4, 8}
    sched = RequestScheduler(teng, max_wait=2, cache_size=8)
    ids = sched.submit(X[:5], deadline=2)
    assert sched.drain() == []
    done = sched.drain()
    assert [r.request_id for r in done] == ids
    assert all(r.queue_time == 2 and r.bucket == 8 and not r.cache_hit
               and not r.deadline_missed for r in done)
    hit = sched.results[sched.submit(X[0], deadline=2)]
    assert hit.cache_hit and hit.queue_time == 0 and hit.bucket == 0
    np.testing.assert_array_equal(hit.aux, done[0].aux)
    late = sched.submit(X[10], deadline=1)
    assert sched.drain() == []
    (r,) = sched.drain()
    assert r.request_id == late and r.queue_time == 2 and r.deadline_missed

    s = sched.stats.summary()
    assert s["completed"] == 7 and s["ticks"] == 4 and s["launches"] == 2
    assert s["p50"] == 2.0 and s["p95"] == 2.0 and s["p99"] == 2.0
    assert s["throughput"] == pytest.approx(7 / 4)
    assert s["occupancy"] == pytest.approx((5 / 8 + 1 / 1) / 2)
    assert s["hit_rate"] == pytest.approx(1 / 7)
    assert s["deadline_miss_rate"] == pytest.approx(1 / 7)
    assert sched.stats.bucket_launches == {8: 1, 1: 1}


def test_lru_cache_eviction(blobs):
    """cache_size=2 LRU: the oldest entry falls out, recent ones hit, in
    both packages on the same requests."""
    X, y = blobs
    jeng, teng = _engines("gnb", X, y)
    scheds = [JaxScheduler(jeng, max_wait=1, cache_size=2),
              RequestScheduler(teng, max_wait=1, cache_size=2)]
    for sched in scheds:
        for i in (0, 1, 2):               # inserts x0, x1, x2 -> evicts x0
            sched.submit(X[i])
            sched.drain()
        rid = sched.submit(X[0])          # x0 was evicted -> queued
        sched.drain()
        assert not sched.results[rid].cache_hit
        assert sched.results[sched.submit(X[2])].cache_hit
    same_results(*scheds, range(5))


def test_cache_keys_fold_in_the_engine(blobs):
    """The same bytes against two engines (fp32 and int8 over one
    estimator) never share a cache entry: the key holds the engine's
    fingerprint, which is unique per engine."""
    X, y = blobs
    _, tfit = _fits("knn", X, y)
    a = NonNeuralServeEngine(tfit, max_batch=8, device="cpu")
    b = NonNeuralServeEngine(tfit, max_batch=8, device="cpu", policy="int8")
    assert a.cache_fingerprint[:2] == ("knn", "None")
    assert b.cache_fingerprint[:2] == ("knn", "int8")
    assert a.cache_fingerprint[2] != b.cache_fingerprint[2]
    for eng in (a, b):
        eng.warmup_buckets(X.shape[1])
    sa = RequestScheduler(a, max_wait=1, cache_size=4)
    key = sa._cache_key(np.asarray(X[0], np.float32))
    assert key == (a.cache_fingerprint, "<f4", X[0].tobytes())
    assert RequestScheduler(b, max_wait=1, cache_size=4)._cache_key(
        np.asarray(X[0], np.float32)) != key


# -------------------------------------------------- straggler escalation

class VirtualClock:
    """Deterministic clock: launch k takes ``durations[k]`` seconds (the
    scheduler reads the clock twice a launch)."""

    def __init__(self, durations):
        self.durations, self.t, self.calls = list(durations), 0.0, 0

    def __call__(self):
        if self.calls % 2:
            self.t += self.durations[min(self.calls // 2,
                                         len(self.durations) - 1)]
        self.calls += 1
        return self.t


def test_straggler_escalation_matches_jax(blobs):
    """Six fast launches then slow ones on the same virtual clock: the
    single-host baseline rule escalates watch -> checkpoint -> evict at
    the same ticks with the same ratios in both packages."""
    X, y = blobs
    jeng, teng = _engines("gnb", X, y)
    durations = [1.0] * 6 + [4.0] * 20
    jsched = JaxScheduler(jeng, max_wait=1, clock=VirtualClock(durations))
    tsched = RequestScheduler(teng, max_wait=1,
                              clock=VirtualClock(durations))
    for sched in (jsched, tsched):
        for i in range(26):
            sched.submit(X[i])
            sched.drain()
    assert tsched.events == jsched.events
    kinds = [e.kind for e in tsched.events]
    assert kinds[0] == "straggler_watch" and "straggler_checkpoint" in \
        kinds and kinds[-1] == "straggler_evict"
    assert [r.batch_time for r in tsched.results.values()] == \
        [jsched.results[i].batch_time for i in tsched.results]
    same_results(jsched, tsched, range(26))


def test_drain_feeds_straggler_escalation(blobs):
    """Per-drain batch_time feeds the timer; a non-ok verdict lands in
    scheduler.events as one typed Event."""
    X, y = blobs
    _, teng = _engines("gnb", X, y)

    class Scripted:
        calls = 0

        def record(self, host, dt):
            Scripted.calls += 1
            action = "checkpoint" if Scripted.calls == 2 else "ok"
            return StragglerVerdict(host=host, ratio=9.9, action=action)

    sched = RequestScheduler(teng, max_wait=1, timer=Scripted())
    for i in range(3):
        sched.submit(X[i])
        sched.drain()
    assert Scripted.calls == 3
    assert [(e.kind, e.tick, e.get("ratio")) for e in sched.events] == \
        [("straggler_checkpoint", 2, 9.9)]


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_step_timer_matches_jax(hosts):
    """The same step times give the same verdicts: the single-host
    baseline rule, the fleet median with more hosts, each action."""
    rng = np.random.default_rng(hosts)
    jt, tt = JaxStepTimer(), StepTimer()
    first = []
    for step in range(40):
        for h in range(hosts):
            dt = float(rng.uniform(0.9, 1.1)) * (4.0 if h == 0 and step > 8
                                                  else 1.0)
            if h == 0 and step < tt.warmup:
                first.append(dt)
            a, b = jt.record(h, dt), tt.record(h, dt)
            assert (a.host, a.action) == (b.host, b.action)
            assert a.ratio == pytest.approx(b.ratio, rel=1e-12)
            if h == 0:
                slow = b
    assert tt.slowest_hosts() == jt.slowest_hosts()
    assert tt.hosts[0].baseline == pytest.approx(np.mean(first))
    # host 0 runs 4x slower from step 9: alone it is judged against its
    # warmup baseline, else against the fleet median (with two hosts the
    # mean of both, a ratio of ~1.6), and escalates to evict either way
    assert slow.action == "evict"


# ----------------------------------------------------------------- errors

def test_multi_tenant_mode_raises(blobs):
    """Store mode (ROADMAP A12, ported) refuses an engine whose grouped
    cells were never warmed, and a single-model scheduler refuses tenant
    routing, as the JAX package's do."""
    X, y = blobs
    jeng, teng = _engines("gnb", X, y)
    with pytest.raises(AssertionError, match="warmup_groups"):
        RequestScheduler(teng, store=object())
    with pytest.raises(AssertionError, match="warmup_groups"):
        JaxScheduler(jeng, store=object())
    sched = RequestScheduler(teng, breaker=None)
    with pytest.raises(ValueError, match="store="):
        sched.submit(X[0], model_id=0)


def test_unknown_event_kind_raises():
    with pytest.raises(ValueError, match="vocabulary"):
        tevents.event("straggler_panic", 1, "scheduler")
    ev = tevents.event("shed", 3, "scheduler", request=4, reason="expired")
    assert ev.detail == (("reason", "expired"), ("request", 4))
    assert ev.get("reason") == "expired" and ev.get("missing", 7) == 7
    assert tevents.kinds([ev], "shed") == [ev]


# -------------------------------------------------------------------- CLI

def _stream_counts(out: str):
    """(requests, launches, buckets, ticks line) of the [stream] lines."""
    served = re.search(r"served (\d+) requests .*\((\d+) launches, "
                       r"buckets=(\{[^}]*\})", out)
    latency = re.search(r"\[stream\] latency ticks .*", out)
    assert served and latency, out
    return served.groups() + (latency.group(0),)


def test_stream_cli_matches_jax():
    flags = ["--algo", "gnb", "--batch", "16", "--stream", "--rate", "4",
             "--ticks", "40", "--cache-size", "64", "--deadline", "8"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop(tdispatch.ENV_VAR, None)
    port = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu"] + flags, capture_output=True, text=True, env=env,
        timeout=300)
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve"]
                         + flags, capture_output=True, text=True, env=env,
                         timeout=300)
    assert port.returncode == 0 and ref.returncode == 0, \
        port.stderr[-2000:] + ref.stderr[-2000:]
    assert _stream_counts(port.stdout) == _stream_counts(ref.stdout)
