"""The PyTorch port's GEMM-based pair (LR and SVM, paper §4.2 and Fig. 4)
and the per-query kNN and GNB pipelines against the JAX package.

Mirrors ``tests/test_core_algorithms.py:24-50``.  The same seeded numpy
blobs go to both packages; the port runs on ``device="cpu"``.
Tolerances:
  * decisions on JAX-trained weights carried across with
    ``convert.linear_from_numpy``: classes exact, LR probabilities and
    the SVM's raw margins to ``rtol = atol = 1e-5``, signs exact where
    the margin is more than 1e-5 from 0;
  * ``_descend_lr``/``_descend_svm`` started from the JAX package's
    ``init_linear(PRNGKey(0))``: ``W`` and ``b`` to ``rtol = atol = 1e-4``
    after the default 300 steps (each step's gradient sums associate in
    another order), predictions equal;
  * the port's own training: accuracy above 0.95, the JAX tests' bar;
  * n_cores invariance and ``knn_predict_batch``/``gnb_predict_batch``:
    classes exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gemm_based as G
from repro.core import gnb as jgnb
from repro.core import knn as jknn
from repro.data import datasets as jdata
from repro_torch import convert
from repro_torch.core import gemm_based as TG
from repro_torch.core import gnb as tgnb
from repro_torch.core import knn as tknn
from repro_torch.data import datasets as tdata
from repro_torch.data.datasets import class_blobs

TOL = dict(rtol=1e-5, atol=1e-5)
FIT_TOL = dict(rtol=1e-4, atol=1e-4)
N_CLASS = 3


@pytest.fixture(scope="module")
def blobs():
    return class_blobs(n=400, d=21, n_class=N_CLASS, seed=0)


@pytest.fixture(scope="module")
def jax_models(blobs):
    X, y = blobs
    return {"lr": G.train_lr(jnp.asarray(X), jnp.asarray(y), N_CLASS),
            "svm": G.train_svm(jnp.asarray(X), jnp.asarray(y), N_CLASS)}


def _carry(model):
    return convert.linear_from_numpy(jax.tree.map(np.asarray, model),
                                     device="cpu")


# ------------------------------------------- decisions on carried weights

@pytest.mark.parametrize("n_cores", [1, 8])
def test_lr_decision_matches_jax(blobs, jax_models, n_cores):
    X, _ = blobs
    jm = jax_models["lr"]
    tm = _carry(jm)
    for i in (0, 5, 123):
        jcls, jprobs = G.lr_decision(jm, jnp.asarray(X[i]), n_cores)
        tcls, tprobs = TG.lr_decision(tm, X[i], n_cores)
        assert int(tcls) == int(jcls)
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                                   **TOL)
    want = np.asarray(G.lr_predict_batch(jm, X, n_cores))
    got = TG.lr_predict_batch(tm, X, n_cores)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_cores", [1, 8])
def test_svm_decision_matches_jax(blobs, jax_models, n_cores):
    X, _ = blobs
    jm = jax_models["svm"]
    tm = _carry(jm)
    margins = X @ np.asarray(jm.W).T + np.asarray(jm.b)
    for i in (0, 7, 311):
        jcls, jsigns = G.svm_decision(jm, jnp.asarray(X[i]), n_cores)
        tcls, tsigns = TG.svm_decision(tm, X[i], n_cores)
        assert int(tcls) == int(jcls)
        assert tsigns.shape == (N_CLASS,)
        away = np.abs(margins[i]) > TOL["atol"]
        np.testing.assert_array_equal(tsigns.numpy()[away],
                                      np.asarray(jsigns)[away])
    # the raw margins behind the signs (OP1 + OP2)
    from repro.core.distribution import two_phase_matvec as jmv
    from repro_torch.core.distribution import two_phase_matvec as tmv
    np.testing.assert_allclose(
        tmv(tm.W, torch.from_numpy(X[:16]), tm.b, n_cores).numpy(),
        np.stack([np.asarray(jmv(jm.W, jnp.asarray(x), jm.b, n_cores))
                  for x in X[:16]]), **TOL)
    want = np.asarray(G.svm_predict_batch(jm, X, n_cores))
    np.testing.assert_array_equal(TG.svm_predict_batch(tm, X,
                                                       n_cores).numpy(),
                                  want)


def test_svm_winner_margin_is_positive(blobs, jax_models):
    """A well-trained one-vs-all SVM gives its winner a positive margin."""
    X, _ = blobs
    tm = _carry(jax_models["svm"])
    cls, signs = TG.svm_decision(tm, X[0])
    assert signs.shape == (N_CLASS,) and int(cls) in range(N_CLASS)
    assert float(signs[int(cls)]) == 1.0


def test_argmax_ties_go_to_the_first_class():
    """OP3's ArgMax keeps the first of equal scores, as jnp.argmax."""
    tm = TG.LinearModel(W=torch.zeros((4, 3)),
                        b=torch.tensor([0.0, 1.0, 1.0, 0.5]))
    x = np.ones((2, 3), np.float32)
    jm = G.LinearModel(W=jnp.zeros((4, 3)),
                       b=jnp.asarray([0.0, 1.0, 1.0, 0.5]))
    assert TG.lr_predict_batch(tm, x).tolist() == [1, 1] == \
        np.asarray(G.lr_predict_batch(jm, x)).tolist()
    assert TG.svm_predict_batch(tm, x).tolist() == [1, 1] == \
        np.asarray(G.svm_predict_batch(jm, x)).tolist()


# ----------------------------------------- descent from JAX's init weights

@pytest.mark.parametrize("algo", ["lr", "svm"])
def test_descent_from_jax_init_matches_jax(blobs, jax_models, algo):
    X, y = blobs
    init = G.init_linear(jax.random.PRNGKey(0), N_CLASS, X.shape[1])
    descend = TG._descend_lr if algo == "lr" else TG._descend_svm
    tm = descend(_carry(init), torch.from_numpy(X),
                 torch.from_numpy(y).long(), N_CLASS)
    jm = jax_models[algo]
    np.testing.assert_allclose(tm.W.numpy(), np.asarray(jm.W), **FIT_TOL)
    np.testing.assert_allclose(tm.b.numpy(), np.asarray(jm.b), **FIT_TOL)
    predict = TG.lr_predict_batch if algo == "lr" else TG.svm_predict_batch
    jpredict = G.lr_predict_batch if algo == "lr" else G.svm_predict_batch
    np.testing.assert_array_equal(predict(tm, X).numpy(),
                                  np.asarray(jpredict(jm, X)))


def test_own_training_accuracy(blobs):
    X, y = blobs
    lr = TG.train_lr(X, y, N_CLASS, device="cpu")
    svm = TG.train_svm(X, y, N_CLASS, device="cpu")
    assert float((TG.lr_predict_batch(lr, X).numpy() == y).mean()) > 0.95
    assert float((TG.svm_predict_batch(svm, X).numpy() == y).mean()) > 0.95


def test_init_linear_is_seeded():
    a = TG.init_linear(torch.Generator().manual_seed(3), 4, 9, device="cpu")
    b = TG.init_linear(torch.Generator().manual_seed(3), 4, 9, device="cpu")
    assert torch.equal(a.W, b.W) and a.W.shape == (4, 9)
    assert torch.equal(a.b, torch.zeros(4))
    assert float(a.W.std()) == pytest.approx(0.01, rel=0.5)


def test_training_raises_without_a_card(blobs, monkeypatch):
    X, y = blobs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TG.train_lr(X, y, N_CLASS, steps=1)
    with pytest.raises(RuntimeError):
        convert.linear_from_numpy({"W": np.zeros((2, 3)), "b": np.zeros(2)})


def test_linear_from_numpy_checks_fields():
    with pytest.raises(KeyError, match="b"):
        convert.linear_from_numpy({"W": np.zeros((2, 3))}, device="cpu")
    with pytest.raises(ValueError):
        convert.linear_from_numpy({"W": np.zeros((2, 3)), "b": np.zeros(3)},
                                  device="cpu")
    m = convert.linear_from_numpy({"W": np.ones((2, 3)), "b": np.zeros(2)},
                                  device="cpu")
    assert m.W.dtype == torch.float32 and m.b.shape == (2,)


# --------------------------------------------------------- n_cores

@pytest.mark.parametrize("n_cores", [1, 2, 4, 8, 16])
def test_lr_svm_n_cores_invariance(blobs, jax_models, n_cores):
    X, _ = blobs
    for algo, predict in (("lr", TG.lr_predict_batch),
                          ("svm", TG.svm_predict_batch)):
        tm = _carry(jax_models[algo])
        base = predict(tm, X[:64], n_cores=8)
        np.testing.assert_array_equal(predict(tm, X[:64],
                                              n_cores=n_cores).numpy(),
                                      base.numpy())


# ---------------------------------------------- per-query kNN and GNB

@pytest.mark.parametrize("n_cores", [1, 4, 8])
def test_knn_predict_batch_matches_jax(blobs, n_cores):
    X, y = blobs
    jm = jknn.KNNModel(A=jnp.asarray(X), labels=jnp.asarray(y),
                       n_class=N_CLASS)
    tm = tknn.KNNModel(A=torch.from_numpy(X), labels=torch.from_numpy(y),
                       n_class=N_CLASS)
    want = np.asarray(jknn.knn_predict_batch(jm, X[:32], k=4,
                                             n_cores=n_cores))
    got = tknn.knn_predict_batch(tm, torch.from_numpy(X[:32]), k=4,
                                 n_cores=n_cores)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_cores", [1, 8])
def test_gnb_predict_batch_matches_jax(blobs, n_cores):
    X, y = blobs
    jm = jgnb.fit_gnb(jnp.asarray(X), jnp.asarray(y), N_CLASS)
    tm = tgnb.GNBModel(*(torch.tensor(np.asarray(a)) for a in jm))
    want = np.asarray(jgnb.gnb_predict_batch(jm, X[:48], n_cores))
    got = tgnb.gnb_predict_batch(tm, torch.from_numpy(X[:48]), n_cores)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float((got.numpy() == y[:48]).mean()) > 0.95


# ------------------------------------------------------ dataset profiles

@pytest.mark.parametrize("name,kw", [("mnist_like", dict(n=300, seed=0)),
                                     ("asd_like", dict(n=200, seed=1)),
                                     ("asd_like", dict(n=90, n_class=3,
                                                       seed=4)),
                                     ("digits_like", dict(n=250, seed=2))])
def test_dataset_profiles_match_jax(name, kw):
    X, y = getattr(tdata, name)(**kw)
    jX, jy = getattr(jdata, name)(**kw)
    assert X.dtype == np.float32 and y.dtype == np.int32
    np.testing.assert_array_equal(X, jX)
    np.testing.assert_array_equal(y, jy)


def test_lr_on_mnist_like():
    """The datasets module's GEMM-based benchmark data: the port's LR
    and the JAX package's both clear the accuracy bar on it."""
    X, y = tdata.mnist_like(n=600, seed=0)
    tm = TG.train_lr(X, y, 10, steps=100, device="cpu")
    jm = G.train_lr(jnp.asarray(X), jnp.asarray(y), 10, steps=100)
    acc = float((TG.lr_predict_batch(tm, X).numpy() == y).mean())
    jacc = float(np.mean(np.asarray(G.lr_predict_batch(jm, X)) == y))
    assert acc > 0.95 and jacc > 0.95
