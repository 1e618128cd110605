"""Parity of the PyTorch port's pipelines with the JAX package: kNN (Fig. 6),
K-Means (Fig. 7), GNB (Fig. 5), the seeded blobs, and the dispatch registry.

Inputs are numpy arrays made from a seed and handed to both packages; the
port runs on ``device="cpu"`` (the kernels' plain versions), the JAX
package on the CPU with its Pallas kernels in interpret mode.  Indices,
classes and iteration counts compare exactly; fitted K-Means centroids,
GNB moments and scores to ``rtol = atol = 1e-5``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gnb as jgnb
from repro.core import kmeans as jkm
from repro.core import knn as jknn
from repro.data import datasets as jdata
from repro.kernels import dispatch as jdispatch
from repro_torch.core import estimator as port_est
from repro_torch.core import gnb as tgnb
from repro_torch.core import kmeans as tkm
from repro_torch.core import knn as tknn
from repro_torch.data import datasets as tdata
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    """Both packages pick their arms by shape, whatever REPRO_BACKEND the
    surrounding run sets; tests that need it set it themselves."""
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _blobs(n, d, n_class, seed):
    X, y = tdata.class_blobs(n=n, d=d, n_class=n_class, seed=seed)
    return X, y


# ------------------------------------------------------------------ data


@pytest.mark.parametrize("n,d,n_class,seed,chunk", [
    (257, 21, 3, 0, None), (100, 5, 7, 3, 13), (1, 1, 2, 1, None),
    (64, 784, 10, 5, 7),
])
def test_class_blobs_bit_identical(n, d, n_class, seed, chunk):
    jX, jy = jdata.class_blobs(n=n, d=d, n_class=n_class, seed=seed,
                               chunk=chunk)
    tX, ty = tdata.class_blobs(n=n, d=d, n_class=n_class, seed=seed,
                               chunk=chunk)
    assert tX.dtype == jX.dtype and ty.dtype == jy.dtype
    assert tX.tobytes() == jX.tobytes() and ty.tobytes() == jy.tobytes()
    parts = list(tdata.class_blobs_stream(n, d=d, n_class=n_class,
                                          seed=seed, chunk=chunk or 16))
    assert np.concatenate([p[0] for p in parts]).tobytes() == jX.tobytes()
    assert np.concatenate([p[1] for p in parts]).tobytes() == jy.tobytes()


# ------------------------------------------------------------------ kNN


def _knn_models(N=203, d=21, n_class=3, seed=1):
    X, y = _blobs(N + 9, d, n_class, seed)
    jm = jknn.KNNModel(A=jnp.asarray(X[:N]), labels=jnp.asarray(y[:N]),
                       n_class=n_class)
    tm = tknn.KNNModel(A=torch.from_numpy(X[:N]),
                       labels=torch.from_numpy(y[:N]), n_class=n_class)
    return jm, tm, X[N:]


@pytest.mark.parametrize("k,n_cores", [(5, 8), (3, 3)])
def test_knn_classify_matches_jax(k, n_cores):
    jm, tm, Q = _knn_models()
    for x in Q[:4]:
        jc, ji = jknn.knn_classify(jm, jnp.asarray(x), k, n_cores)
        tc, ti = tknn.knn_classify(tm, torch.from_numpy(x), k, n_cores)
        assert int(tc) == int(jc)
        assert ti.dtype == torch.int32
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("path", [None, "ref"])
def test_knn_classify_batch_matches_jax(path):
    jm, tm, Q = _knn_models()
    jc, ji = jknn.knn_classify_batch(jm, jnp.asarray(Q), 4, path=path)
    tc, ti = tknn.knn_classify_batch(tm, torch.from_numpy(Q), 4, path=path)
    assert tc.dtype == torch.int32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_vote_ties_go_to_lowest_class():
    labels = torch.tensor([2, 1, 1, 2, 0, 0], dtype=torch.int32)
    nbr = torch.tensor([[0, 1, 2, 3], [4, 0, 5, 3], [1, 4, 2, 5]],
                       dtype=torch.int32)
    out = tknn._vote(labels, nbr, 3)
    ref = [int(jknn._vote(jnp.asarray(labels.numpy()),
                          jnp.asarray(r), 3)) for r in nbr.numpy()]
    assert out.tolist() == ref == [1, 0, 0]


# --------------------------------------------------------------- K-Means


def test_kmeans_iteration_matches_jax():
    X, _ = _blobs(203, 6, 4, 2)                     # N not a multiple of 8
    c0 = X[:4] + 0.5
    jc, jids = jkm.kmeans_iteration(jnp.asarray(X), jnp.asarray(c0))
    tc, tids = tkm.kmeans_iteration(torch.from_numpy(X),
                                    torch.from_numpy(c0))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_kmeans_fit_matches_jax():
    X, _ = _blobs(600, 8, 4, 3)
    jst, jids = jkm.kmeans_fit(jnp.asarray(X), 4)
    tst, tids = tkm.kmeans_fit(torch.from_numpy(X), 4)
    assert int(tst.n_iter) == int(jst.n_iter)
    np.testing.assert_allclose(tst.centroids.numpy(),
                               np.asarray(jst.centroids), **TOL)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(
        float(tkm.inertia(torch.from_numpy(X), tst.centroids, tids)),
        float(jkm.inertia(jnp.asarray(X), jst.centroids, jids)), **TOL)


def test_kmeans_fit_stops_at_max_iters():
    X, _ = _blobs(64, 3, 3, 4)
    st, _ = tkm.kmeans_fit(torch.from_numpy(X), 5, threshold=-1.0,
                           max_iters=3)
    jst, _ = jkm.kmeans_fit(jnp.asarray(X), 5, threshold=-1.0, max_iters=3)
    assert int(st.n_iter) == int(jst.n_iter) == 3


# ------------------------------------------------------------------ GNB


def _gnb_models(d, n_class=3, N=300, seed=5):
    X, y = _blobs(N + 7, d, n_class, seed)
    jm = jgnb.fit_gnb(jnp.asarray(X[:N]), jnp.asarray(y[:N]), n_class)
    tm = tgnb.fit_gnb(torch.from_numpy(X[:N]), torch.from_numpy(y[:N]),
                      n_class)
    return jm, tm, X[N:]


@pytest.mark.parametrize("d", [21, 70])
def test_fit_gnb_matches_jax(d):
    jm, tm, _ = _gnb_models(d)
    for name in ("mu", "var", "log_prior"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), **TOL)


def test_gnb_decision_matches_jax():
    jm, tm, Q = _gnb_models(13)
    for x in Q[:3]:
        jc, jy = jgnb.gnb_decision(jm, jnp.asarray(x))
        tc, ty = tgnb.gnb_decision(tm, torch.from_numpy(x))
        assert int(tc) == int(jc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("d", [21, 70])   # ref arm / blocked (kernel) arm
def test_gnb_classify_batch_matches_jax(d):
    jm, tm, Q = _gnb_models(d)
    jc, js = jgnb.gnb_classify_batch(jm, jnp.asarray(Q))
    tc, ts = tgnb.gnb_classify_batch(tm, torch.from_numpy(Q))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)


# --------------------------------------------------------------- dispatch


def test_registered_arms():
    assert tdispatch.registered() == {
        ("gnb", "scores"): ("blocked", "ref"),
        ("kmeans", "distance_argmin"): ("fused", "ref"),
        ("knn", "distance_topk"): ("fused", "ref"),
    }


@pytest.mark.parametrize("algo,op,kw", [
    ("knn", "distance_topk", dict(N=300, d=21, Q=8, k=4)),
    ("kmeans", "distance_argmin", dict(N=8, d=21, K=4)),
    ("gnb", "scores", dict(B=8, d=784, C=10)),
    ("gnb", "scores", dict(B=8, d=21, C=3)),
])
def test_selectors_agree_with_jax(algo, op, kw):
    assert tdispatch.resolve(algo, op, **kw).name == \
        jdispatch.resolve(algo, op, **kw).name


def test_resolve_precedence(monkeypatch):
    kw = dict(N=300, d=21, Q=8, k=4)
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)
    assert tdispatch.resolve("knn", "distance_topk", **kw).name == "fused"
    monkeypatch.setenv(tdispatch.ENV_VAR, "ref")
    for algo, op, skw in (("knn", "distance_topk", kw),
                          ("kmeans", "distance_argmin",
                           dict(N=8, d=21, K=4)),
                          ("gnb", "scores", dict(B=8, d=784, C=10))):
        assert tdispatch.resolve(algo, op, **skw).name == "ref"
    # explicit path= beats the environment
    assert tdispatch.resolve("knn", "distance_topk", path="fused",
                             **kw).name == "fused"
    # an arm the op lacks in the environment falls through to the selector
    monkeypatch.setenv(tdispatch.ENV_VAR, "blocked")
    assert tdispatch.resolve("knn", "distance_topk", **kw).name == "fused"
    assert tdispatch.resolve("gnb", "scores", B=8, d=784,
                             C=10).name == "blocked"
    # a typo, or the int8 tier this package has no arm for, raises
    for bad in ("fsued", "quant"):
        monkeypatch.setenv(tdispatch.ENV_VAR, bad)
        with pytest.raises(ValueError, match=bad):
            tdispatch.resolve("knn", "distance_topk", **kw)
    monkeypatch.delenv(tdispatch.ENV_VAR)
    with pytest.raises(KeyError):
        tdispatch.resolve("knn", "distance_topk", path="blocked", **kw)
    with pytest.raises(KeyError):
        tdispatch.resolve("gmm", "responsibilities", B=8, d=4, k=2)


def test_k_above_kernel_limit_resolves_to_ref(no_backend_env):
    lim = tops.TOPK_K_MAX
    kw = dict(N=300, d=21, Q=8)
    assert tdispatch.resolve("knn", "distance_topk", k=lim,
                             **kw).name == "fused"
    assert tdispatch.resolve("knn", "distance_topk", k=lim + 1,
                             **kw).name == "ref"
    # and the estimator path serves such a k through the plain arm
    X, y = _blobs(80, 4, 2, 0)
    est = port_est.make_fitted("knn", X, y, k=lim + 3, device="cpu")
    cls, nbr = est.predict_batch(X[:3])
    assert tuple(nbr.shape) == (3, lim + 3)
    assert tdispatch.resolve("gnb", "scores", B=1, d=63, C=2).name == "ref"
    assert tdispatch.resolve("gnb", "scores", B=1, d=64,
                             C=2).name == "blocked"


def test_policies_and_hot_shapes():
    assert tdispatch.POLICIES["fp32"].dtype == torch.float32
    assert tdispatch.POLICIES["bf16"].dtype == torch.bfloat16
    assert tdispatch.get_policy("bf16") is tdispatch.POLICIES["bf16"]
    with pytest.raises(NotImplementedError, match="int8"):
        tdispatch.get_policy("int8")
    with pytest.raises(KeyError):
        tdispatch.get_policy("fp16")
    ints = torch.arange(3, dtype=torch.int32)
    assert tdispatch.POLICIES["bf16"].cast(ints) is ints
    assert tdispatch.POLICIES["bf16"].cast(
        torch.ones(2)).dtype == torch.bfloat16
    assert tdispatch.HOT_OPS == {a: jdispatch.HOT_OPS[a]
                                 for a in ("knn", "kmeans", "gnb")}
    shapes = {"knn": {"N": 100, "d": 21, "k": 4},
              "kmeans": {"K": 8, "d": 21}, "gnb": {"C": 3, "d": 70}}
    for algo, s in shapes.items():
        assert tdispatch.hot_shape_kw(algo, s, 16) == \
            jdispatch.hot_shape_kw(algo, s, 16)


def test_unported_algorithms_raise():
    for algo in ("gmm", "rf", "ann"):
        with pytest.raises(KeyError, match="not yet ported"):
            port_est.make_estimator(algo, device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        port_est.make_estimator("svm", device="cpu")
    assert sorted(port_est.ESTIMATORS) == ["gnb", "kmeans", "knn"]
