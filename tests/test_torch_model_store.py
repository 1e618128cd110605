"""The port's multi-tenant model store (``serving/model_store.py``), its
grouped engine path and the store-mode scheduler, against the JAX
package's.

Each tenant is fitted by the JAX package and carried across with
``repro_torch.convert`` (the port's estimators on ``device="cpu"``), so
both stores hold the same fleet.  Held equal: classes and neighbour
indices of ``classify_group`` exactly, float aux to ``rtol = atol =
1e-5`` scaled (ROADMAP C); the int8 at-rest payload (``q`` and
``scale``) and the params an evict -> admit round trip restores, bit for
bit; LRU order, evictions and stats; error messages; and a store-mode
trace replayed through both schedulers, request for request (prediction,
queue time, bucket, shed reason, tier), with equal ``tenant_stats``.
The behaviours mirror ``tests/test_model_store.py``.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.launch import serve as jserve
from repro.serving import BreakerConfig as JaxBreakerConfig
from repro.serving import DegradePolicy as JaxDegradePolicy
from repro.serving import ModelStore as JaxStore
from repro.serving import RequestScheduler as JaxScheduler
from repro.serving import replay_trace as jax_replay
from repro_torch import convert
from repro_torch.core import estimator as tst
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import serve as tserve
from repro_torch.serving import (BreakerConfig, DegradePolicy, ModelStore,
                                 PoisonedParamsError, RequestScheduler,
                                 poisson_trace, replay_trace)

ALGOS = ("knn", "kmeans", "gnb", "gmm", "rf")
D, NC = 9, 3
TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("queue_time", "bucket", "deadline_missed", "cache_hit", "shed",
          "reason", "tier")


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


_FITS = {}


def _fit(algo, seed, n=64, d=D):
    """(JAX estimator, the port's over the same params)."""
    key = (algo, seed, n, d)
    if key not in _FITS:
        X, y = class_blobs(n=n, d=d, n_class=NC, seed=seed)
        jfit = jest.make_fitted(algo, X, y, n_groups=NC)
        params = convert.params_from_numpy(
            algo, jax.tree.map(np.asarray, jfit.params), device="cpu")
        kw = {"k": jfit.k} if algo in ("knn", "ann") else {}
        _FITS[key] = (jfit, tst.ESTIMATORS[algo].from_params(
            params, device="cpu", **kw))
    return _FITS[key]


def _stores(algo, G, n=64, d=D):
    jstore, tstore = JaxStore(), ModelStore(device="cpu")
    for t in range(G):
        jfit, tfit = _fit(algo, t, n, d)
        jstore.register(t, jfit)
        tstore.register(t, tfit)
    return jstore, tstore


def _queries(G, B, d=D):
    return np.stack([class_blobs(n=B, d=d, n_class=NC, seed=100 + t)[0]
                     for t in range(G)])


def _same_params(tp, jp):
    for name, t, j in zip(tp._fields, tp, jp):
        if isinstance(t, torch.Tensor):
            assert np.array_equal(t.numpy(), np.asarray(j)), name
        else:
            assert t == j, name


class _Clock:
    """A fixed 1 ms a launch (the scheduler reads its clock twice a
    launch), so that straggler verdicts, and the degrade decisions they
    feed, are the same in both packages' runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 5e-4
        return self.t


_JAX_ENGINES = {}


def _jax_engine(jstore, algo, **kw):
    """One JAX engine per (algorithm, shape knobs): its jitted grouped
    launch compiles once for every store of the module."""
    key = (algo,) + tuple(sorted(kw.items()))
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = jstore.make_engine(**kw)
    return _JAX_ENGINES[key]


# --------------------------------------------------- grouped conformance


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("at_rest", [False, True],
                         ids=["fp32", "int8-roundtrip"])
def test_grouped_launch_equal_to_loop_and_jax(algo, at_rest):
    """One grouped (G, B) call equals the per-tenant loop lane for lane
    (classes exactly) and the JAX package's grouped launch, for resident
    fp32 params and for params back from the int8 at-rest round trip."""
    G, B = 3, 5                       # non-pow2 G and B: both pads active
    jstore, tstore = _stores(algo, G)
    if at_rest:
        for t in range(G):
            jstore.evict(t)
            tstore.evict(t)
        assert tstore.stats() == jstore.stats()
    engine = tstore.make_engine(max_batch=8, max_group=4)
    Xg = _queries(G, B)
    stacked, gens = tstore.group(list(range(G)))
    jstacked, jgens = jstore.group(list(range(G)))
    assert gens == jgens == (0,) * G
    _same_params(stacked, jstacked)
    res = engine.classify_group(stacked, Xg)
    assert res.classes.shape == (G, B) and res.launches == 1
    assert engine.group_launches == {(4, 8): 1}
    fn = tstore.template.predict_batch_fn()
    for t in range(G):
        cls, aux = fn(tstore.params_of(t)[1], torch.from_numpy(Xg[t]))
        assert torch.equal(res.classes[t], cls)
        if algo in ("knn", "rf"):
            assert torch.equal(res.aux[t], aux)
        else:
            assert torch.allclose(res.aux[t], aux, **TOL)
    jres = _jax_engine(jstore, algo, max_batch=8, max_group=4
                       ).classify_group(jstacked, jnp.asarray(Xg))
    assert np.array_equal(res.classes.numpy(), np.asarray(jres.classes))
    if algo in ("knn", "rf"):
        assert np.array_equal(res.aux.numpy(), np.asarray(jres.aux))
    else:
        assert np.allclose(res.aux.numpy(), np.asarray(jres.aux),
                           rtol=1e-5, atol=1e-4)


def test_grouped_splits_along_queries_and_tenants():
    """B past max_batch splits along the queries, G past the max_group
    bucket along the tenants, one launch a piece, lanes unchanged."""
    G, B = 5, 11
    _, tstore = _stores("gnb", G)
    engine = tstore.make_engine(max_batch=4, max_group=2)
    Xg = _queries(G, B)
    stacked, _ = tstore.group(list(range(G)))
    res = engine.classify_group(stacked, Xg)
    assert res.classes.shape == (G, B) and res.aux.shape == (G, B, NC)
    assert res.launches == 3 * 3       # 3 tenant pieces x 3 query chunks
    assert engine.group_launches == {(2, 4): 6, (1, 4): 3}
    fn = tstore.template.predict_batch_fn()
    for t in range(G):
        cls, _ = fn(tstore.params_of(t)[1], torch.from_numpy(Xg[t]))
        assert torch.equal(res.classes[t], cls)


def test_rf_node_capacity_grows_with_new_tenants():
    """Forests on different data have different node counts: the store
    pads every slot to the fleet capacity (pad_nodes), as the JAX store
    does, and the padded lanes answer as their own forests."""
    jstore, tstore = JaxStore(), ModelStore(device="cpu")
    (js, ts), (jb, tb) = _fit("rf", 0, n=32), _fit("rf", 1, n=256)
    assert ts.params.feature.shape[1] != tb.params.feature.shape[1]
    for t, (j, p) in enumerate(((js, ts), (jb, tb))):
        jstore.register(t, j)
        tstore.register(t, p)         # the second grows the capacity
    stacked, _ = tstore.group([0, 1])
    _same_params(stacked, jstore.group([0, 1])[0])
    cap = max(ts.params.feature.shape[1], tb.params.feature.shape[1])
    assert stacked.feature.shape == (2, ts.params.feature.shape[0], cap)
    engine = tstore.make_engine(max_batch=8, max_group=2)
    Xg = _queries(2, 6)
    res = engine.classify_group(stacked, Xg)
    for t, est in enumerate((ts, tb)):
        cls, _ = est.predict_batch_fn()(est.params, torch.from_numpy(Xg[t]))
        assert torch.equal(res.classes[t], cls)


# ----------------------------------------------------------- validation


def test_store_validation_errors():
    _, store = _stores("gnb", 2)
    with pytest.raises(ValueError, match="already registered"):
        store.register(0, _fit("gnb", 9)[1])
    with pytest.raises(ValueError, match="one ModelStore serves one"):
        store.register(9, _fit("knn", 9)[1])
    with pytest.raises(KeyError):
        store.params_of("nope")
    with pytest.raises(KeyError):
        store.update("nope", _fit("gnb", 9)[1])
    with pytest.raises(KeyError):
        store.group([0, "nope"])


def test_ann_refuses_grouped_serving():
    """ANN params are ragged a fit, so both stores refuse at registration
    with the same reason."""
    X, y = class_blobs(n=128, d=D, n_class=NC, seed=0)
    with pytest.raises(NotImplementedError, match="grouped") as terr:
        ModelStore(device="cpu").register(0, tst.make_fitted(
            "ann", X, y, n_groups=NC, device="cpu"))
    with pytest.raises(NotImplementedError) as jerr:
        JaxStore().register(0, jest.make_fitted("ann", X, y, n_groups=NC))
    assert str(terr.value) == str(jerr.value)


def test_mismatched_leaf_shapes_raise_with_leaf_path():
    jstore, tstore = _stores("knn", 1)
    jbad, tbad = _fit("knn", 5, n=96)   # another reference-set size
    with pytest.raises(ValueError, match=r"\.A") as terr:
        tstore.register(1, tbad)
    with pytest.raises(ValueError) as jerr:
        jstore.register(1, jbad)
    assert str(terr.value) == str(jerr.value)


def test_poisoned_update_is_refused_and_names_the_leaf():
    """A NaN update is refused before it publishes: the previous
    generation keeps serving, and both packages name the same leaf."""
    jstore, tstore = _stores("gnb", 2)
    import copy
    jbad, tbad = copy.copy(_fit("gnb", 7)[0]), copy.copy(_fit("gnb", 7)[1])
    tbad._params = tbad.params._replace(var=tbad.params.var.clone())
    tbad._params.var[1, 2] = float("inf")
    jbad._params = jbad.params._replace(
        var=jbad.params.var.at[1, 2].set(jnp.inf))
    with pytest.raises(PoisonedParamsError) as terr:
        tstore.update(1, tbad)
    with pytest.raises(Exception) as jerr:
        jstore.update(1, jbad)
    assert str(terr.value) == str(jerr.value) and terr.value.leaf_path == \
        ".var"
    assert tstore.generation(1) == 0 and tstore.poisoned_rejections == 1
    _same_params(tstore.params_of(1)[1], _fit("gnb", 1)[1].params)


# ------------------------------------------------------------ residency


def test_lru_at_rest_payload_bit_equal_to_jax():
    """Eviction writes the JAX package's int8 payload (q and scale, bit
    for bit); admission restores the same fp32 params as the JAX store's;
    a second eviction reuses the cached payload; LRU order and stats are
    the JAX store's."""
    jstore, tstore = _stores("gnb", 3)
    full = tstore.stats()["resident_bytes"]
    assert full == jstore.stats()["resident_bytes"]
    for store in (jstore, tstore):
        store.set_budget(full * 2 // 3 + 4)      # room for 2 of 3
    assert tstore.resident_ids == jstore.resident_ids == [1, 2]
    assert tstore.stats() == jstore.stats()
    tq, jq = tstore._slots[0].qparams, jstore._slots[0].qparams
    for name in ("mu", "var"):
        assert np.array_equal(getattr(tq, name).q.numpy(),
                              np.asarray(getattr(jq, name).q))
        assert np.array_equal(getattr(tq, name).scale.numpy(),
                              np.asarray(getattr(jq, name).scale))
    _, p0 = tstore.params_of(0)
    _same_params(p0, jstore.params_of(0)[1])
    assert tstore.resident_ids == jstore.resident_ids == [2, 0]
    tstore.evict(0)
    assert tstore._slots[0].qparams is tq       # cached, not recomputed
    _, p0b = tstore.params_of(0)
    for a, b in zip(p0, p0b):
        assert torch.equal(a, b)
    assert tstore.evictions == jstore.evictions + 1


def test_group_pins_members_against_budget_eviction():
    """group() never returns a half-evicted stack: members stay pinned
    during admission even when the group alone overflows the budget."""
    jstore, tstore = _stores("gnb", 4)
    per = tstore.stats()["resident_bytes"] // 4
    for store in (jstore, tstore):
        store.set_budget(per * 2 + 4)
    stacked, gens = tstore.group([0, 1, 2, 3])
    jstacked, _ = jstore.group([0, 1, 2, 3])
    assert stacked.mu.shape[0] == 4 and gens == (0, 0, 0, 0)
    _same_params(stacked, jstacked)
    assert tstore.resident_ids == jstore.resident_ids
    assert tstore.stats() == jstore.stats()


# ------------------------------------------------------------- hot-swap


def test_hot_swap_bumps_generation_and_invalidates_group():
    _, store = _stores("kmeans", 3)
    s1, g1 = store.group([0, 1, 2])
    assert store.group([0, 1, 2])[0] is s1 and store.group_misses == 1
    assert store.update(1, _fit("kmeans", 11)[1]) == 1
    s2, g2 = store.group([0, 1, 2])
    assert g2 == (0, 1, 0) and s2 is not s1 and store.group_misses == 2
    # the old snapshot is untouched: a drain in flight finishes on it
    assert torch.equal(s1.centroids[1],
                       _fit("kmeans", 1)[1].params.centroids)
    assert torch.equal(s2.centroids[1],
                       _fit("kmeans", 11)[1].params.centroids)


def test_cache_no_cross_tenant_hit():
    """The same query bytes for two tenants never share a cache entry, and
    a hot-swap invalidates the tenant's entries (its generation is in the
    key)."""
    G = 2
    _, store = _stores("knn", G)
    engine = store.make_engine(max_batch=4, max_group=G)
    engine.warmup_groups(store.group([0, 1])[0], D)
    sched = RequestScheduler(engine, max_wait=1, cache_size=16, store=store)
    row = _queries(1, 1)[0, 0]
    a = sched.submit(row, model_id=0)
    b = sched.submit(row, model_id=1)
    sched.flush()
    assert not sched.results[b].cache_hit
    c = sched.submit(row, model_id=1)
    assert sched.results[c].cache_hit
    assert sched.results[c].prediction == sched.results[b].prediction
    store.update(1, _fit("knn", 5)[1])
    d = sched.submit(row, model_id=1)
    assert d not in sched.results          # a miss: queued, not answered
    sched.flush()
    assert not sched.results[d].cache_hit and not sched.results[a].cache_hit


# ---------------------------------------------- store-mode stream parity


def _tenant_schedulers(algo, G, budget_frac=None, robust=False):
    jstore, tstore = _stores(algo, G)
    if budget_frac is not None:
        full = tstore.stats()["resident_bytes"]
        for store in (jstore, tstore):
            store.set_budget(int(full * budget_frac))
    jeng = jstore.make_engine(max_batch=4, max_group=G)
    teng = tstore.make_engine(max_batch=4, max_group=G)
    jeng.warmup_groups(jstore.group(list(range(G)))[0], D)
    teng.warmup_groups(tstore.group(list(range(G)))[0], D)
    kw = dict(max_wait=2, cache_size=8)
    if robust:
        jkw = dict(kw, shed_expired=True, breaker=JaxBreakerConfig(),
                   degrade=JaxDegradePolicy(None, deadline=4), max_queue=24)
        tkw = dict(kw, shed_expired=True, breaker=BreakerConfig(),
                   degrade=DegradePolicy(None, deadline=4), max_queue=24)
    else:
        jkw = tkw = kw
    return (JaxScheduler(jeng, store=jstore, clock=_Clock(), **jkw),
            RequestScheduler(teng, store=tstore, clock=_Clock(), **tkw),
            teng)


@pytest.mark.parametrize("algo,budget_frac,robust", [
    ("gnb", 0.5, True),     # evictions, admissions, sheds, group splits
    ("knn", None, False),
])
def test_tenant_stream_matches_jax(algo, budget_frac, robust):
    G = 4
    jsched, tsched, teng = _tenant_schedulers(algo, G, budget_frac, robust)
    X = class_blobs(n=24, d=D, n_class=NC, seed=8)[0]
    counts = poisson_trace(6.0 if robust else 3.0, 16, seed=2)
    mids = list(np.random.default_rng(3).integers(0, G, size=200))
    tids = replay_trace(tsched, X, counts, deadline=3, model_ids=mids)
    jids = jax_replay(jsched, X, counts, deadline=3, model_ids=mids)
    assert tids == jids
    for rid in tids:
        t, j = tsched.results[rid], jsched.results[rid]
        for f in FIELDS:
            assert getattr(t, f) == getattr(j, f), (rid, f)
        if t.prediction is not None:
            assert int(t.prediction) == int(j.prediction), rid
            assert np.allclose(t.aux, np.asarray(j.aux), **TOL)
    assert tsched.stats.summary() == jsched.stats.summary()
    assert set(tsched.tenant_stats) == set(jsched.tenant_stats)
    for mid, st in tsched.tenant_stats.items():
        assert st.summary() == jsched.tenant_stats[mid].summary(), mid
    assert [(e.kind, e.tick) for e in tsched.events] == \
        [(e.kind, e.tick) for e in jsched.events]
    assert set(teng.group_launches) <= tsched.warmed_groups
    if robust:
        assert tsched.store.evictions == jsched.store.evictions > 0
        assert tsched.stats.shed > 0


def test_tenant_stream_matches_oneshot_grouped():
    """Every prediction of a tenant stream equals the one-shot grouped
    call for that tenant's params: drains route, they do not
    recompute."""
    G = 4
    _, store = _stores("kmeans", G)
    engine = store.make_engine(max_batch=4, max_group=G)
    engine.warmup_groups(store.group(list(range(G)))[0], D)
    sched = RequestScheduler(engine, max_wait=2, store=store)
    X = class_blobs(n=32, d=D, n_class=NC, seed=8)[0]
    counts = poisson_trace(3.0, 10, seed=2)
    rids = replay_trace(sched, X, counts, model_ids=list(range(G)))
    assert len(rids) == int(counts.sum())
    fn = store.template.predict_batch_fn()
    for i, rid in enumerate(rids):
        mid, row = i % G, X[i % len(X)]
        cls, _ = fn(store.params_of(mid)[1], torch.from_numpy(row[None]))
        assert int(sched.results[rid].prediction) == int(cls[0]), (i, mid)
    assert set(engine.group_launches) <= engine.warmed_groups
    assert all(st.completed > 0 for st in sched.tenant_stats.values())


def test_tenants_cli_matches_jax(capsys):
    """``serve --tenants 4 --stream --degrade --chaos storm`` on the CPU
    prints the JAX CLI's stream counts: requests, grouped launches and
    cells, and the latency line (the plan's virtual clock makes the
    degrade decisions the same in both runs)."""
    flags = ["--algo", "gnb", "--tenants", "4", "--batch", "4",
             "--resident-frac", "0.5", "--stream", "--rate", "3",
             "--ticks", "12", "--deadline", "4", "--degrade",
             "--chaos", "storm", "--train-size", "64"]
    tserve.main(flags + ["--device", "cpu"])
    port = capsys.readouterr().out
    jserve.main(flags)
    ref = capsys.readouterr().out

    def counts(out):
        served = re.search(r"served (\d+) requests .*\((\d+) grouped "
                           r"launches, cells=(\{[^}]*\})", out)
        latency = re.search(r"\[tenants/stream\] latency ticks .*", out)
        resident = re.search(r"resident (\d+/\d+)", out)
        assert served and latency and resident, out
        return served.groups() + (latency.group(0), resident.group(1))

    assert counts(port) == counts(ref)
    tserve.main(["--algo", "kmeans", "--tenants", "3", "--batch", "4",
                 "--train-size", "48", "--device", "cpu"])
    assert "grouped classes equal to the loop's" in capsys.readouterr().out
