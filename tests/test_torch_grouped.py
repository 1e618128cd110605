"""The port's grouped (multi-tenant) arm against the JAX package.

B1, B2 and B3 take a model group in one launch (a tenant axis in
``csrc/distance_topk.cu``, ``distance_argmin.cu``, ``gnb_score.cu``); on
the CPU their wrappers run the grouped plain versions
(``kernels/ref.py``), which these tests hold against the per-tenant loop
of the one-tenant plain versions (indices and classes exactly; values to
``rtol = atol = 1e-5`` scaled to the size of the terms, ROADMAP C: a
batched product sums in another order than a 2-D one) and against the
JAX package's vmapped grouped arm (``predict_batch_group_fn``), the same
stacked params carried across with ``convert.group_from_numpy``.  The
CUDA branch of each grouped wrapper is driven on the CPU by presenting
the inputs as device tensors and recording the launcher's C arguments:
one launch with the tenant count G, counted once in ``LAUNCHES`` and in
``GROUP_LAUNCHES``.  Also: the generic int8 codec (``serving/quant.py``)
bit-equal to the JAX package's, ``random_forest.pad_nodes``, and
``stack_params``'s leaf-path errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.core import random_forest as jrf
from repro.serving import quant as jquant
from repro_torch import convert
from repro_torch.core import estimator as tst
from repro_torch.core import random_forest as trf
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import distance_argmin as tda
from repro_torch.kernels import distance_topk as tdt
from repro_torch.kernels import gnb_score as tgs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.serving import quant as tquant

TOL = dict(rtol=1e-5, atol=1e-5)
ALGOS = ("knn", "kmeans", "gnb", "gmm", "rf")


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def _near(got, want, scale):
    return bool(((got - want).abs() <= TOL["atol"] + TOL["rtol"] * scale)
                .all())


# ------------------------------------------- grouped plain versions = loop


@pytest.mark.parametrize("G,N,d,Q,k", [(3, 37, 5, 7, 4), (4, 96, 16, 9, 8),
                                       (1, 20, 3, 2, 1)])
def test_grouped_topk_equals_per_tenant_loop(G, N, d, Q, k):
    a, c = _rand(0, G, N, d), _rand(1, G, Q, d)
    for fn in (tref.distance_topk_group, tops.distance_topk_group):
        v, i = fn(a, c, k)
        assert v.shape == i.shape == (G, Q, k) and i.dtype == torch.int32
        for t in range(G):
            lv, li = tref.distance_topk(a[t], c[t], k)
            assert torch.equal(i[t], li)
            scale = (a[t] * a[t]).sum(1)[li.long()] + \
                (c[t] * c[t]).sum(1)[:, None]
            assert _near(v[t], lv, scale)


@pytest.mark.parametrize("G,N,K,d", [(3, 37, 4, 5), (5, 16, 8, 16),
                                     (2, 9, 1, 1)])
def test_grouped_argmin_equals_per_tenant_loop(G, N, K, d):
    a, c = _rand(2, G, N, d), _rand(3, G, K, d)
    for fn in (tref.distance_argmin_group, tops.distance_argmin_group):
        v, i = fn(a, c)
        assert v.shape == i.shape == (G, N) and i.dtype == torch.int32
        for t in range(G):
            lv, li = tref.distance_argmin(a[t], c[t])
            assert torch.equal(i[t], li)
            scale = (a[t] * a[t]).sum(1) + (c[t] * c[t]).sum(1)[li.long()]
            assert _near(v[t], lv, scale)


@pytest.mark.parametrize("G,B,C,d", [(3, 5, 3, 16), (2, 1, 10, 70)])
def test_grouped_gnb_equals_per_tenant_loop(G, B, C, d):
    X, mu = _rand(4, G, B, d), _rand(5, G, C, d)
    var = _rand(6, G, C, d).abs() + 0.25
    lp = torch.log_softmax(_rand(7, G, C), dim=1)
    for fn in (tref.gnb_scores_batch_group, tops.gnb_scores_batch_group):
        s = fn(X, mu, var, lp)
        assert s.shape == (G, B, C)
        for t in range(G):
            assert torch.allclose(
                s[t], tref.gnb_scores_batch(X[t], mu[t], var[t], lp[t]),
                **TOL)


# ------------------------------------- the CUDA branch: one grouped launch


def _recorder(monkeypatch, mod, sms=132):
    """Run ``mod``'s launcher on CPU tensors: record the C function's
    arguments and the shapes it allocates, launch nothing."""
    calls, shapes = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(mod, "_fn", lambda *names: (
        lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(mod, "sm_count", lambda device: sms)
    monkeypatch.setattr(mod, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    return calls, shapes


def _as_card(monkeypatch):
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])


@pytest.mark.parametrize("G,N,d,Q,k,way", [(64, 4096, 21, 16, 4, "bulk"),
                                           (3, 37, 5, 7, 4, "plain"),
                                           (2, 300, 40, 5, 8, "plain")])
def test_grouped_topk_is_one_launch(monkeypatch, G, N, d, Q, k, way):
    calls, shapes = _recorder(monkeypatch, tdt)
    _as_card(monkeypatch)
    tops.reset_launches()
    a, c = torch.zeros((G, N, d)), torch.zeros((G, Q, d))
    assert tdt.route(a) == way
    vals, idx = tops.distance_topk_group(a, c, k)
    n_splits, rows = tdt.split_rows(N, Q, 132, G)
    (args,), = [calls]
    assert args[6:15] == (N, Q, d, k, n_splits, rows, int(way == "bulk"), G,
                          0)
    assert shapes == [(G * Q, n_splits * k)] * 2 + [(G, Q, k)] * 2
    assert vals.shape == idx.shape == (G, Q, k)
    assert tops.LAUNCHES["distance_topk"] == 1
    assert tops.GROUP_LAUNCHES == {"distance_topk": 1, "distance_argmin": 0,
                                   "gnb_scores_batch": 0}
    assert tdt.ROUTE_LAUNCHES == {"bulk": int(way == "bulk"),
                                  "plain": int(way == "plain")}
    # the tenants x splits x query tiles fill the card, one tile a tenant
    assert n_splits * G * -(-Q // tdt.QUERY_TILE) >= \
        min(tdt.BLOCKS_PER_SM * 132, G * -(-N // tdt.SPLIT_ROWS))


@pytest.mark.parametrize("G,N,K,d,way", [(64, 16, 8, 21, "narrow"),
                                         (3, 4096, 256, 21, "bulk"),
                                         (3, 4099, 8, 21, "plain"),
                                         (4, 100, 16, 1, "rows"),
                                         (2, 500, 1000, 21, "stream")])
def test_grouped_argmin_is_one_launch(monkeypatch, G, N, K, d, way):
    calls, shapes = _recorder(monkeypatch, tda)
    _as_card(monkeypatch)
    tops.reset_launches()
    a, c = torch.zeros((G, N, d)), torch.zeros((G, K, d))
    assert tda.route(a, c) == way
    vals, idx = tops.distance_argmin_group(a, c)
    (args,), = [calls]
    assert args[4:] == (N, K, d, tda.ROUTES.index(way),
                        tda.plan(N, K, 132, way, G), G, 0)
    assert shapes == [(G, N), (G, N)] and vals.shape == (G, N)
    assert tops.GROUP_LAUNCHES["distance_argmin"] == 1
    assert tops.LAUNCHES["distance_argmin"] == 1
    assert tda.ROUTE_LAUNCHES == {r: int(r == way) for r in tda.ROUTES}


@pytest.mark.parametrize("G,B,C,d", [(64, 16, 10, 784), (3, 33, 17, 100)])
def test_grouped_gnb_is_one_launch(monkeypatch, G, B, C, d):
    calls, shapes = _recorder(monkeypatch, tgs)
    _as_card(monkeypatch)
    tops.reset_launches()
    X = torch.zeros((G, B, d))
    mu, var = torch.zeros((G, C, d)), torch.ones((G, C, d))
    lp = torch.zeros((G, C))
    out = tops.gnb_scores_batch_group(X, mu, var, lp)
    (args,), = [calls]
    split, f, grid = tgs.plan(B, C, d, 132)
    # the one-tenant launch's warps a query: every sum in its order
    assert args[5:13] == (B, C, d, split, f,
                          min(grid, -(-tgs.BLOCKS_PER_SM * 132 // G)), G, 0)
    assert shapes == [(G, B, C)] and out.shape == (G, B, C)
    assert tops.GROUP_LAUNCHES["gnb_scores_batch"] == 1
    assert tgs.ROUTE_LAUNCHES[tgs.route(C, d)] == 1


def test_grouped_wrappers_validate_inputs():
    a = torch.zeros((3, 10, 4))
    with pytest.raises(ValueError, match="tenant axes"):
        tops.distance_topk_group(a, torch.zeros((2, 5, 4)), 2)
    with pytest.raises(ValueError, match="k=40"):
        tops.distance_topk_group(a, torch.zeros((3, 5, 4)), 40)
    with pytest.raises(ValueError):
        tops.distance_argmin_group(a, torch.zeros((3, 5, 3)))
    with pytest.raises(ValueError, match="3-D"):
        tops.gnb_scores_batch_group(a[0], a[:, :2], a[:, :2] + 1,
                                    torch.zeros((3, 2)))


# --------------------------------------------- the grouped arm against JAX


def _jax_group(algo, G, n=64, d=9, **kw):
    fits = []
    for t in range(G):
        X, y = class_blobs(n=n, d=d, n_class=3, seed=t)
        fits.append(jest.make_fitted(algo, X, y, n_groups=3, **kw))
    params = [f.params for f in fits]
    if algo == "rf":
        cap = max(p.feature.shape[1] for p in params)
        params = [jrf.pad_nodes(p, cap) for p in params]
    return fits[0], jest.stack_params(params)


def _port_estimator(algo, jfit):
    params = convert.params_from_numpy(
        algo, jax.tree.map(np.asarray, jfit.params), device="cpu")
    kw = {"k": jfit.k} if algo == "knn" else {}
    return tst.ESTIMATORS[algo].from_params(params, device="cpu", **kw)


@pytest.mark.parametrize("algo", ALGOS)
def test_grouped_arm_matches_jax(algo):
    G, B, d = 3, 5, 9
    jfit, jstacked = _jax_group(algo, G, d=d)
    Xg = np.stack([class_blobs(n=B, d=d, n_class=3, seed=50 + t)[0]
                   for t in range(G)])
    jcls, jaux = jfit.predict_batch_group_fn()(jstacked, jnp.asarray(Xg))
    tstacked = convert.group_from_numpy(
        algo, jax.tree.map(np.asarray, jstacked), device="cpu")
    tfit = _port_estimator(algo, jfit)
    cls, aux = tfit.predict_batch_group_fn()(tstacked, torch.from_numpy(Xg))
    assert np.array_equal(cls.numpy(), np.asarray(jcls))
    if algo in ("knn", "rf"):
        assert np.array_equal(aux.numpy(), np.asarray(jaux))
    elif algo == "kmeans":
        c = tstacked.centroids
        scale = (torch.from_numpy(Xg) ** 2).sum(2) + \
            torch.gather((c * c).sum(2), 1, cls.long())
        assert _near(aux, torch.from_numpy(np.asarray(jaux)), scale)
    else:
        assert np.allclose(aux.numpy(), np.asarray(jaux), rtol=1e-5,
                           atol=1e-4)
    # each lane against the one-tenant call on its params
    fn = tfit.predict_batch_fn()
    for t in range(G):
        lc, _ = fn(tst.unstack_params(tstacked, t), torch.from_numpy(Xg[t]))
        assert torch.equal(cls[t], lc)


def test_grouped_registry_and_per_tenant_arms(monkeypatch):
    """Five algorithms stack, ANN refuses; an arm with no tenant axis (kNN
    past k = 32: B4 then B5; the int8 tier) runs once a tenant inside the
    one grouped call, with the same answers."""
    assert tdispatch.grouped_registered() == ("gmm", "gnb", "kmeans", "knn",
                                              "rf")
    with pytest.raises(KeyError, match="ann"):
        tdispatch.grouped("ann")
    G, n, d = 3, 80, 6
    fits = [tst.make_fitted("knn", *class_blobs(n=n, d=d, n_class=3,
                                                   seed=t), n_groups=3,
                              device="cpu", k=40) for t in range(G)]
    stacked = tst.stack_params([f.params for f in fits])
    Xg = torch.stack([torch.from_numpy(class_blobs(n=4, d=d, n_class=3,
                                                   seed=9 + t)[0])
                      for t in range(G)])
    kp = tdispatch.resolve("knn", "distance_topk", N=n, d=d, Q=4, k=40)
    assert kp.name == "blocked" and tdispatch.group_arm(kp) is None
    cls, nbr = fits[0].predict_batch_group_fn()(stacked, Xg)
    for t in range(G):
        lc, ln = fits[t].predict_batch_fn()(fits[t].params, Xg[t])
        assert torch.equal(cls[t], lc) and torch.equal(nbr[t], ln)
    q = [f.quantized_copy() for f in fits]
    qstacked = tst.stack_params([f.params for f in q])
    qcls, _ = q[0].predict_batch_group_fn()(qstacked, Xg)
    for t in range(G):
        assert torch.equal(qcls[t], q[t].predict_batch_fn()(q[t].params,
                                                            Xg[t])[0])


# --------------------------------------------- stacking, pad_nodes, codec


def test_stack_params_errors_match_jax():
    jfit, _ = _jax_group("knn", 1)
    jp = jfit.params
    tp = _port_estimator("knn", jfit).params
    cases = [(jp._replace(A=jp.A[:-1]), tp._replace(A=tp.A[:-1])),
             (jp._replace(n_class=7), tp._replace(n_class=7)),
             (jp._replace(labels=jp.labels.astype(jnp.float32)),
              tp._replace(labels=tp.labels.float()))]
    for jbad, tbad in cases:
        with pytest.raises(ValueError) as jerr:
            jest.stack_params([jp, jbad])
        with pytest.raises(ValueError) as terr:
            tst.stack_params([tp, tbad])
        assert str(terr.value) == str(jerr.value)
    stacked = tst.stack_params([tp, tp])
    assert tst.group_axes(stacked) == type(tp)(A=0, labels=0, n_class=None)
    lane = tst.unstack_params(stacked, 1)
    assert torch.equal(lane.A, tp.A) and lane.n_class == tp.n_class


def test_pad_nodes_matches_jax():
    jfit, _ = _jax_group("rf", 1)
    tf = _port_estimator("rf", jfit).params
    M = tf.feature.shape[1]
    jp = jrf.pad_nodes(jfit.params, M + 5)
    tp = trf.pad_nodes(tf, M + 5)
    for name in ("feature", "threshold", "left", "right"):
        assert np.array_equal(getattr(tp, name).numpy(),
                              np.asarray(getattr(jp, name)))
    assert trf.pad_nodes(tf, M) is tf
    X = torch.from_numpy(class_blobs(n=7, d=9, n_class=3, seed=3)[0])
    for a, b in zip(trf.forest_classify_batch(tf, X),
                    trf.forest_classify_batch(tp, X)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="capacity"):
        trf.pad_nodes(tf, M - 1)


@pytest.mark.parametrize("shape,axis", [((16, 9), -1), ((3, 5, 7), -1),
                                        ((9, 4), 0), ((6,), -1)])
def test_quant_codec_bit_equal_to_jax(shape, axis):
    w = np.random.default_rng(11).normal(size=shape).astype(np.float32) * 3
    w.flat[0] = 0.0
    jq = jquant.quantize_weight(jnp.asarray(w), axis=axis)
    tq = tquant.quantize_weight(torch.from_numpy(w), axis=axis)
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert np.array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    deq = tquant.dequantize(tq, torch.float32)
    assert np.array_equal(deq.numpy(),
                          np.asarray(jquant.dequantize(jq, jnp.float32)))
    again = tquant.quantize_weight(deq, axis=axis)     # a fixed point
    assert torch.equal(again.q, tq.q) and torch.equal(again.scale, tq.scale)
    assert tquant.relative_error(torch.from_numpy(w), tq) == pytest.approx(
        jquant.relative_error(jnp.asarray(w), jq), rel=1e-6)


def test_quantize_params_matches_jax_bytes():
    jfit, _ = _jax_group("gnb", 1, d=9)
    tp = _port_estimator("gnb", jfit).params
    jq = jquant.quantize_params(jfit.params, min_size=1)
    tq = tquant.quantize_params(tp, min_size=1)
    assert isinstance(tq.mu, tquant.QuantTensor)
    assert not isinstance(tq.log_prior, tquant.QuantTensor)
    for name in ("mu", "var"):
        assert np.array_equal(getattr(tq, name).q.numpy(),
                              np.asarray(getattr(jq, name).q))
    assert tquant.param_bytes(tq) == jquant.param_bytes(jq)
    assert tquant.quant_bytes(tp, min_size=1) == \
        jquant.quant_bytes(jfit.params, min_size=1)
    back = tquant.dequantize_params(tq, torch.float32)
    assert np.array_equal(back.var.numpy(), np.asarray(
        jquant.dequantize_params(jq, jnp.float32).var))
