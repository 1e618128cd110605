"""GMM (EM, the paper's §6 kernel) and RF (Fig. 8) of the PyTorch port
against the JAX package.

The same seeded numpy blobs go to both packages; the port runs on
``device="cpu"``.  Tolerances, stated per check:
  * GMM ``_log_gauss``, E-step and M-step: ``rtol = atol = 1e-5`` (the
    GEMM identity's products are summed in another order by each BLAS).
    A log-responsibility is the difference of two joint log-densities, so
    its rounding follows their size, not its own: there rtol applies to
    the joint's magnitude, the rule ROADMAP C sets for a squared distance
    and ‖a‖² + ‖c‖²;
  * a GMM fit: the same iteration count, fitted params to
    ``rtol = atol = 1e-4`` (a few EM iterations compound the per-step
    differences above);
  * RF: training is the same numpy code, so forests are bit-equal, and
    the traversal is integer work, so votes and classes are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.core import gmm as jgmm
from repro.core import random_forest as jrf
from repro.serving.engine import NonNeuralServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import estimator as port_est
from repro_torch.core import gmm as tgmm
from repro_torch.core import random_forest as trf
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.serving import NonNeuralServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _blobs(n, d, n_class, seed):
    return class_blobs(n=n, d=d, n_class=n_class, seed=seed)


def _moments(seed, k, d):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=(k, d)).astype(np.float32) * 2
    var = (rng.random((k, d)) + 0.5).astype(np.float32)
    log_pi = np.log(rng.dirichlet(np.ones(k))).astype(np.float32)
    return mu, var, log_pi


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ GMM


@pytest.mark.parametrize("m,d,k", [(13, 21, 3), (40, 70, 10), (1, 1, 2)])
def test_log_gauss_matches_jax(m, d, k):
    x = np.random.default_rng(m).normal(size=(m, d)).astype(np.float32)
    mu, var, _ = _moments(d, k, d)
    want = jgmm._log_gauss(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(var))
    got = tgmm._log_gauss(torch.from_numpy(x), torch.from_numpy(mu),
                          torch.from_numpy(var))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("N,n_cores", [(203, 8), (64, 8), (50, 3)])
def test_e_step_matches_jax(N, n_cores):
    X, _ = _blobs(N, 21, 3, 1)
    mu, var, log_pi = _moments(2, 3, 21)
    jlr, jll = jgmm.gmm_e_step(*map(jnp.asarray, (X, mu, var, log_pi)),
                               n_cores)
    tlr, tll = tgmm.gmm_e_step(*map(torch.from_numpy, (X, mu, var, log_pi)),
                               n_cores)
    assert tlr.shape == (N, 3)
    joint = np.asarray(jgmm._log_gauss(*map(jnp.asarray, (X, mu, var)))
                       + log_pi)
    err = np.abs(tlr.numpy() - np.asarray(jlr))
    assert (err <= TOL["atol"] + TOL["rtol"] * np.abs(joint)).all(), \
        err.max()
    np.testing.assert_allclose(float(tll), float(jll), **TOL)


@pytest.mark.parametrize("N,n_cores", [(203, 8), (50, 3)])
def test_m_step_matches_jax(N, n_cores):
    X, _ = _blobs(N, 21, 3, 3)
    mu, var, log_pi = _moments(4, 3, 21)
    jlr, _ = jgmm.gmm_e_step(*map(jnp.asarray, (X, mu, var, log_pi)))
    lr = np.array(jlr)
    want = jgmm.gmm_m_step(jnp.asarray(X), jnp.asarray(lr), n_cores=n_cores)
    got = tgmm.gmm_m_step(torch.from_numpy(X), torch.from_numpy(lr),
                          n_cores=n_cores)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("N,d,k,seed,max_iters", [
    (400, 21, 3, 0, 100),      # converges by tol
    (203, 8, 4, 5, 100),
    (300, 70, 3, 2, 100),
    (120, 5, 3, 7, 2),         # stops at max_iters
])
def test_gmm_fit_matches_jax(N, d, k, seed, max_iters):
    X, _ = _blobs(N, d, k, seed)
    jst, jresp = jgmm.gmm_fit(jnp.asarray(X), k, max_iters=max_iters)
    tst, tresp = tgmm.gmm_fit(torch.from_numpy(X), k, max_iters=max_iters)
    assert int(tst.n_iter) == int(jst.n_iter)
    assert tst.n_iter.dtype == torch.int32
    for name in ("mu", "var", "log_pi", "log_lik"):
        np.testing.assert_allclose(_np(getattr(tst, name)),
                                   np.asarray(getattr(jst, name)), **FIT_TOL)
    np.testing.assert_allclose(tresp.numpy(), np.asarray(jresp), **FIT_TOL)
    np.testing.assert_array_equal(
        tgmm.gmm_predict(tst, torch.from_numpy(X)).numpy(),
        np.asarray(jgmm.gmm_predict(jst, jnp.asarray(X))))


@pytest.mark.parametrize("d", [21, 70])       # selector: ref / blocked
@pytest.mark.parametrize("path", [None, "ref", "blocked"])
def test_gmm_arms_match_classify_batch(d, path):
    X, _ = _blobs(211, d, 3, d)
    jst, _ = jgmm.gmm_fit(jnp.asarray(X[:200]), 3)
    st = convert.params_from_numpy("gmm", jax.tree.map(np.asarray, jst),
                                   device="cpu")
    Q = X[200:]
    jc, jlr = jgmm.gmm_classify_batch(jst, jnp.asarray(Q), path=path)
    tc, tlr = tgmm.gmm_classify_batch(st, torch.from_numpy(Q), path=path)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tlr.numpy(), np.asarray(jlr), **TOL)
    want = "blocked" if d >= 64 else "ref"
    assert tdispatch.resolve("gmm", "responsibilities", B=11, d=d,
                             k=3, path=path).name == (path or want)


# ------------------------------------------------------------------- RF


def _forest_pair(N=300, d=21, n_class=3, seed=0, **kw):
    X, y = _blobs(N, d, n_class, seed)
    jf = jrf.train_forest(X, y, n_class, **kw)
    tf = trf.train_forest(X, y, n_class, **kw)
    return jf, tf, X


@pytest.mark.parametrize("kw", [
    dict(), dict(n_trees=5, max_depth=3, seed=4), dict(min_samples=9),
])
def test_forest_training_bit_equal(kw):
    jf, tf, _ = _forest_pair(**kw)
    for name in ("feature", "threshold", "left", "right"):
        got, want = getattr(tf, name).numpy(), np.asarray(getattr(jf, name))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name
    assert tf.n_class == jf.n_class


@pytest.mark.parametrize("kw,n_cores", [    # n_cores: the reference's
    (dict(), 8),                          # 16 trees fill 8 cores
    (dict(n_trees=5, max_depth=3), 8),    # ragged: the reference pads
    (dict(n_trees=7, seed=3), 3),
])
def test_forest_votes_match_jax(kw, n_cores):
    jf, tf, X = _forest_pair(**kw)
    Q = _blobs(37, 21, 3, 9)[0]
    jc, jv = jrf.forest_classify_batch(jf, jnp.asarray(Q), n_cores)
    tc, tv = trf.forest_classify_batch(tf, torch.from_numpy(Q))
    assert tc.dtype == torch.int32 and tv.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tv.sum(1) == tf.feature.shape[0]).all()


def test_forest_depth_is_the_longest_path():
    _, tf, _ = _forest_pair(n_trees=6, max_depth=5)
    feature, left, right = (t.numpy() for t in (tf.feature, tf.left,
                                                tf.right))

    def depth(t, i):
        if feature[t, i] < 0:
            return 0
        return 1 + max(depth(t, left[t, i]), depth(t, right[t, i]))

    want = max(depth(t, 0) for t in range(feature.shape[0]))
    assert trf.forest_depth(tf) == want and 1 <= want <= 5
    # the traversal works the same depth out when the caller has none
    X = torch.from_numpy(_blobs(200, 21, 3, 1)[0])
    full = trf.forest_classify_batch(tf, X, depth=want)[1]
    assert torch.equal(full, trf.forest_classify_batch(tf, X)[1])


# ------------------------------------------- estimators, engine, convert


CASES = {"gmm": (21, 3), "rf": (21, 3)}


def _data(algo, n=300, n_q=11, seed=0):
    d, groups = CASES[algo]
    X, y = class_blobs(n=n + n_q, d=d, n_class=groups, seed=seed)
    return X[:n], y[:n], X[n:], y[n:]


@pytest.mark.parametrize("algo", sorted(CASES))
def test_served_through_the_engine_like_jax(algo):
    X, y, Q, _ = _data(algo)
    groups = CASES[algo][1]
    jfit = jest.make_fitted(algo, X, y, n_groups=groups)
    jengine = JaxEngine(jfit, max_batch=8)
    jres = jengine.classify(Q)                     # 11 queries: buckets 8, 4
    tfit = port_est.make_fitted(algo, X, y, n_groups=groups, device="cpu")
    carried = type(tfit).from_params(
        convert.params_from_numpy(algo, jax.tree.map(np.asarray,
                                                     jfit.params),
                                  device="cpu"), device="cpu")
    for est in (tfit, carried):
        engine = NonNeuralServeEngine(est, max_batch=8, device="cpu")
        assert engine.warmup_buckets(X.shape[1]) == 4
        warmed = set(engine.warmed)
        res = engine.classify(Q)
        assert set(engine.bucket_launches) <= warmed
        assert res.launches == jres.launches == 2
        assert engine.bucket_launches == jengine.bucket_launches
        np.testing.assert_array_equal(res.classes.numpy(),
                                      np.asarray(jres.classes))
        if algo == "rf":
            assert res.aux.dtype == torch.int32
            np.testing.assert_array_equal(res.aux.numpy(),
                                          np.asarray(jres.aux))
        else:
            np.testing.assert_allclose(res.aux.numpy(),
                                       np.asarray(jres.aux), **TOL)
    assert tuple(tfit.empty_aux().shape) == tuple(jfit.empty_aux().shape)
    assert str(tfit.empty_aux().dtype).split(".")[-1] == \
        str(jfit.empty_aux().dtype)


@pytest.mark.parametrize("algo", sorted(CASES))
def test_params_from_numpy(algo):
    X, y, _, _ = _data(algo, n=120)
    jfit = jest.make_fitted(algo, X, y, n_groups=3)
    leaves = jax.tree.map(np.asarray, jfit.params)
    params = convert.params_from_numpy(algo, leaves, device="cpu")
    assert type(params) is convert.PARAM_TYPES[algo]
    for name, leaf in params._asdict().items():
        want = getattr(leaves, name)
        if name == "n_class":
            assert leaf == want and isinstance(leaf, int)
        else:
            assert leaf.numpy().dtype == np.asarray(want).dtype
            assert leaf.numpy().tobytes() == np.asarray(want).tobytes()
    with pytest.raises(KeyError, match="lack"):
        convert.params_from_numpy(algo, {"feature": 0}, device="cpu")


def test_policy_bf16_casts_gmm_params_and_rf_queries():
    X, y, Q, _ = _data("gmm")
    bf16 = tdispatch.get_policy("bf16")
    g = port_est.make_fitted("gmm", X, y, n_groups=3, policy=bf16,
                             device="cpu")
    assert g.params.mu.dtype == torch.bfloat16
    assert g.params.log_pi.dtype == torch.float32
    cls, lr = g.predict_batch(Q)
    assert cls.shape == (len(Q),) and torch.isfinite(lr.float()).all()
    r = port_est.make_fitted("rf", X, y, policy=bf16, device="cpu")
    assert r.params.threshold.dtype == torch.float32
    cls, votes = r.predict_batch(Q)
    assert votes.dtype == torch.int32 and (votes.sum(1) == 16).all()
