"""The int8 tier of the PyTorch port against the JAX package.

B6 ``distance_topk_q8``, B7 ``distance_argmin_q8`` and B5's int32 key mode
through their plain versions (CPU tensors), the lattice helpers of
``core/quantization.py``, the five estimators under ``policy="int8"``,
the ``quant`` arms that ``REPRO_BACKEND=quant`` forces, and the engine's
int8 tier.  The same numpy inputs, made from a seed, go through both
packages; the JAX Pallas kernels run in interpret mode on the CPU.

Tolerances: everything integer (lattice rows, distances, neighbour ids,
assignments, votes, classes) compares exactly.  Scales, which both
packages compute as one IEEE division, compare exactly too.  The GNB/GMM
score tables and scores are sums taken in another order, so they compare
to ``rtol = 1e-5`` of the size of the terms they are sums of (ROADMAP C).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.core import quantization as jcq
from repro.kernels import dispatch as jdispatch
from repro.kernels import quantized as jqk
from repro.serving.engine import NonNeuralServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import estimator as port_est
from repro_torch.core import quantization as tcq
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantized as tqk
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_select as tts
from repro_torch.serving import NonNeuralServeEngine

RTOL = 1e-5
INT8 = jdispatch.get_policy("int8")


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    """Both packages pick their arms by shape, whatever REPRO_BACKEND the
    surrounding run sets; tests that need it set it themselves."""
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _lattice(seed, n, d, dup=False, sat=False):
    """(n, d) int8 on the lattice.  ``dup``: rows drawn with repetition
    from a few small ones (exact ties); ``sat``: every value ±127."""
    rng = np.random.default_rng(seed)
    if sat:
        return np.where(rng.random((n, d)) < 0.5, -127, 127).astype(np.int8)
    if dup:
        base = rng.integers(-3, 4, size=(max(1, n // 3), d))
        return base[rng.integers(0, len(base), size=n)].astype(np.int8)
    return rng.integers(-127, 128, size=(n, d)).astype(np.int8)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ B6 and B7


@pytest.mark.parametrize("N,d,Q,k,kind", [
    (203, 1, 5, 1, "dup"),        # d = 1, duplicate rows
    (203, 3, 7, 4, "dup"),
    (999, 21, 5, 33, "normal"),   # k past the kernel's lists
    (999, 21, 3, 999, "normal"),  # k = N
    (77, 64, 9, 4, "dup"),
    (130, 21, 4, 130, "dup"),     # k = N on ties
    (101, 21, 6, 4, "sat"),       # saturated ±127 values
])
def test_distance_topk_q8_matches_jax(N, d, Q, k, kind):
    a = _lattice(0, N, d, dup=kind == "dup", sat=kind == "sat")
    c = _lattice(1, Q, d, dup=kind == "dup", sat=kind == "sat")
    jv, ji = jqk.distance_topk_q8(jnp.asarray(a), jnp.asarray(c), k)
    ov, oi = jqk.ref_distance_topk_q8(jnp.asarray(a), jnp.asarray(c), k)
    tv, ti = tops.distance_topk_q8(*_t(a, c), k)
    assert tv.dtype == torch.int32 and ti.dtype == torch.int32
    assert tuple(tv.shape) == (Q, k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ov))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(oi))


@pytest.mark.parametrize("N,d,K,kind", [
    (203, 1, 1, "dup"), (203, 3, 5, "dup"), (999, 21, 257, "normal"),
    (130, 64, 33, "dup"), (77, 21, 9, "sat"),
])
def test_distance_argmin_q8_matches_jax(N, d, K, kind):
    a = _lattice(2, N, d, dup=kind == "dup", sat=kind == "sat")
    c = _lattice(3, K, d, dup=kind == "dup", sat=kind == "sat")
    jv, ji = jqk.distance_argmin_q8(jnp.asarray(a), jnp.asarray(c))
    tv, ti = tops.distance_argmin_q8(*_t(a, c))
    assert tv.dtype == torch.int32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_lattice_width_limit_raises_on_both():
    a, c = _lattice(0, 40, 833), _lattice(1, 3, 833)
    for fn in (lambda: jqk.distance_topk_q8(jnp.asarray(a), jnp.asarray(c),
                                            2),
               lambda: jqk.distance_argmin_q8(jnp.asarray(a),
                                              jnp.asarray(c)),
               lambda: tops.distance_topk_q8(*_t(a, c), 2),
               lambda: tops.distance_argmin_q8(*_t(a, c))):
        with pytest.raises(ValueError, match="832"):
            fn()
    # d = 832 is inside the contract
    a, c = _lattice(0, 40, 832), _lattice(1, 3, 832)
    tv, ti = tops.distance_topk_q8(*_t(a, c), 2)
    jv, ji = jqk.ref_distance_topk_q8(jnp.asarray(a), jnp.asarray(c), 2)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_lattice_contract_constants_match_jax():
    assert tqk._MAX_D == jqk._MAX_D and tqk._QMAX == jqk._QMAX
    for d in (1, 21, 784, 832):
        assert tqk.dist_span(d) == jqk.dist_span(d)
        assert tqk.packed_rows_limit(d) == jqk.packed_rows_limit(d)


def test_q8_wrappers_validate_inputs():
    a, c = _t(_lattice(0, 20, 4), _lattice(1, 3, 4))
    with pytest.raises(TypeError):
        tops.distance_topk_q8(a.float(), c, 2)
    with pytest.raises(ValueError):
        tops.distance_topk_q8(a, c, 21)                 # k > N
    with pytest.raises(ValueError):
        tops.distance_argmin_q8(a, c[:, :3])
    with pytest.raises(ValueError, match="contiguous"):
        tops.distance_argmin_q8(a.t(), c.t())


# ------------------------------------------------------ B5 int32 key mode


@pytest.mark.parametrize("R,n,k", [(3, 50, 1), (4, 50, 50), (2, 300, 33)])
def test_topk_smallest_int32_mode(R, n, k):
    """int32 rows select on (value, index): INT_MIN first, INT_MAX last,
    ties to the first index, values stay int32 (exact past 2^24)."""
    rng = np.random.default_rng(R)
    x = rng.integers(-4, 4, size=(R, n)).astype(np.int32)
    x[:, ::7] = np.iinfo(np.int32).max
    x[:, ::11] = np.iinfo(np.int32).min
    x[:, 1] = (1 << 24) + 1                      # not representable in fp32
    tv, ti = tops.topk_smallest(*_t(x), k)
    order = np.argsort(x, axis=1, kind="stable")[:, :k]
    assert tv.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), order)
    np.testing.assert_array_equal(tv.numpy(),
                                  np.take_along_axis(x, order, axis=1))


# ------------------------------------------------ wrappers on the card


def _as_device(monkeypatch):
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])


def test_q8_wrappers_on_device_tensors_launch(monkeypatch):
    """The branch a CUDA tensor takes, driven on the CPU by presenting the
    inputs as device tensors: B6 at k <= 32 and B7 launch once each; B6
    past the lists launches its matrix kernel per query chunk and B5's
    int32 mode per chunk, and gives the plain version's answer; no plain
    version is called for the whole op."""
    calls = []

    def launcher(name, fn):
        def run(*args):
            calls.append((name, [a.dtype for a in args
                                 if isinstance(a, torch.Tensor)]))
            return fn(*args)
        return run

    def boom(*_):
        raise AssertionError("a device tensor reached a plain version")

    monkeypatch.setattr(tqk, "launch_topk", launcher("topk", lambda a, c, k:
                                                     "launched"))
    monkeypatch.setattr(tqk, "launch_argmin", launcher("argmin",
                                                       lambda a, c:
                                                       "launched"))
    monkeypatch.setattr(tqk, "launch_dist", launcher(
        "dist", lambda a, c: tref._lattice_dist(a, c)))
    monkeypatch.setattr(tts, "launch", launcher("select", tref.topk_smallest))
    for name in ("distance_topk_q8", "distance_argmin_q8"):
        monkeypatch.setattr(tref, name, boom)
    monkeypatch.setattr(tdispatch, "BLOCKED_BYTES", 4 * 60 * 3 + 1)
    _as_device(monkeypatch)
    tops.reset_launches()
    a, c = _t(_lattice(0, 60, 5, dup=True), _lattice(1, 7, 5, dup=True))
    assert tops.distance_topk_q8(a, c, 4) == "launched"
    assert tops.distance_argmin_q8(a, c) == "launched"
    v, i = tops.distance_topk_q8(a, c, 40)
    jv, ji = jqk.ref_distance_topk_q8(jnp.asarray(a.numpy()),
                                      jnp.asarray(c.numpy()), 40)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    # 7 queries in chunks of 3: three matrix launches, three selections
    assert tops.LAUNCHES["distance_topk_q8"] == 1 + 3
    assert tops.LAUNCHES["distance_argmin_q8"] == 1
    assert tops.LAUNCHES["topk_smallest"] == 3
    assert [n for n, _ in calls] == ["topk", "argmin"] + ["dist",
                                                          "select"] * 3
    assert all(dt in (torch.int8, torch.int32) for _, dts in calls
               for dt in dts)


@pytest.mark.parametrize("N,d,Q,k,offset,route", [
    (5000, 21, 1024, 4, 0, "bulk"),       # kNN int8: one full bucket
    (5000, 21, 1024, 4, 1, "plain"),      # A[1:]: 21 bytes off
    (5000, 21, 37, 4, 16, "bulk"),        # A[16:]: 336 bytes, aligned
    (500, 832, 3, 32, 0, "plain"),        # d past the bulk route
    (256, 128, 5, 7, 0, "bulk"),          # the bulk route's widest row
])
def test_q8_launch_topk_arguments(monkeypatch, N, d, Q, k, offset, route):
    """B6's launcher plans as B1's (``split_rows``), stages by the same
    alignment rule with its own width, hands the C function one list of k
    per (query, split) as scratch, and counts the launch per route."""
    from repro_torch.kernels import distance_topk as tdt
    calls, shapes = [], []
    real_empty = torch.empty

    def empty(shape, **kw):
        shapes.append(tuple(shape))
        return real_empty(shape, **kw)

    monkeypatch.setattr(tqk, "_fn", lambda name, argtypes: (
        lambda *args: calls.append((name, args)) or 0))
    monkeypatch.setattr(tqk, "sm_count", lambda device: 132)
    monkeypatch.setattr(tqk, "_stream", lambda: 0)
    monkeypatch.setattr(torch, "empty", empty)
    a = torch.zeros((N + offset, d), dtype=torch.int8)[offset:]
    c = torch.zeros((Q, d), dtype=torch.int8)
    tops.reset_launches()
    vals, idx = tqk.launch_topk(a, c, k)
    n_splits, rows = tdt.split_rows(N, Q, 132)
    (name, args), = calls
    assert name == "distance_topk_q8"
    assert args[6:13] == (N, Q, d, k, n_splits, rows, int(route == "bulk"))
    assert shapes == [(Q, n_splits * k)] * 2 + [(Q, k)] * 2
    assert vals.shape == idx.shape == (Q, k) and vals.dtype == torch.int32
    assert tqk.ROUTE_LAUNCHES == {"bulk": int(route == "bulk"),
                                  "plain": int(route == "plain")}
    assert tdt.ROUTE_LAUNCHES == {"bulk": 0, "plain": 0}


def test_q8_wrappers_on_cpu_tensors_count_nothing(monkeypatch):
    def boom(*_):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    for name in ("launch_topk", "launch_argmin", "launch_dist"):
        monkeypatch.setattr(tqk, name, boom)
    monkeypatch.setattr(tts, "launch", boom)
    tops.reset_launches()
    a, c = _t(_lattice(0, 60, 5), _lattice(1, 7, 5))
    tops.distance_topk_q8(a, c, 4)
    tops.distance_topk_q8(a, c, 40)
    tops.distance_argmin_q8(a, c)
    tops.topk_smallest(tref._lattice_dist(a, c), 3)
    assert set(tops.LAUNCHES.values()) == {0}


# ------------------------------------------------ core/quantization.py


def _blobs(n, d, n_class, seed=0):
    return class_blobs(n=n, d=d, n_class=n_class, seed=seed)


ALGOS = {"knn": 3, "kmeans": 4, "gnb": 3, "gmm": 3, "rf": 3}
JQ = {"knn": (jcq.quantize_knn, jcq.dequantize_knn),
      "kmeans": (jcq.quantize_kmeans, jcq.dequantize_kmeans),
      "gnb": (jcq.quantize_gnb, jcq.dequantize_gnb),
      "gmm": (jcq.quantize_gmm, jcq.dequantize_gmm),
      "rf": (jcq.quantize_forest, jcq.dequantize_forest)}
TQ = {"knn": (tcq.quantize_knn, tcq.dequantize_knn),
      "kmeans": (tcq.quantize_kmeans, tcq.dequantize_kmeans),
      "gnb": (tcq.quantize_gnb, tcq.dequantize_gnb),
      "gmm": (tcq.quantize_gmm, tcq.dequantize_gmm),
      "rf": (tcq.quantize_forest, tcq.dequantize_forest)}


def _jax_fit(algo, d, policy=None, n=240, seed=0):
    X, y = _blobs(n, d, ALGOS[algo], seed)
    kw = {"n_trees": 6, "max_depth": 5} if algo == "rf" else {}
    est = jest.make_fitted(algo, X, y, n_groups=ALGOS[algo], policy=policy,
                           **kw)
    return est, X, y


def _close_scaled(got, want, scale):
    diff = np.abs(_np(got) - np.asarray(want))
    assert np.all(diff <= RTOL * (1.0 + np.asarray(scale))), diff.max()


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("calibrated", [True, False])
def test_quantize_matches_jax(algo, calibrated):
    """The reference's fp32 params carried across, quantized in both
    packages with the same calibration (the fit's abs-max, or the
    params' own fallback bound): int8 arrays and scales equal, score
    tables to rtol scaled to their terms."""
    jest_fp, X, _ = _jax_fit(algo, 21)
    jp = jest_fp.params
    tp = convert.params_from_numpy(algo, jp, device="cpu")
    absmax = np.asarray(jest_fp._cal_absmax) if calibrated else None
    jq = JQ[algo][0](jp, None if absmax is None else jnp.asarray(absmax))
    tq = TQ[algo][0](tp, None if absmax is None
                     else torch.from_numpy(absmax.copy()))
    assert type(tq).__name__ == type(jq).__name__
    assert tcq.is_quantized_params(tq)
    for name in jq._fields:
        jv, tv = getattr(jq, name), getattr(tq, name)
        if name == "n_class":
            assert tv == jv
            continue
        assert str(tv.dtype).split(".")[-1] == str(jv.dtype), name
        if tv.dtype in (torch.int8, torch.int32) or name == "scale":
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=name)
        elif name == "const":
            mu, var = np.asarray(jp.mu), np.asarray(jp.var)
            terms = np.sum(mu * mu / var + np.abs(np.log(var)) + 2.0, 1)
            _close_scaled(tv, jv, terms)
        else:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=RTOL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_dequantize_round_trip_within_half_a_step(algo):
    jest_fp, X, _ = _jax_fit(algo, 21)
    tp = convert.params_from_numpy(algo, jest_fp.params, device="cpu")
    quant, dequant = TQ[algo]
    qp = quant(tp, tcq.calibrate_absmax(X))
    back = dequant(qp)
    half = qp.scale.numpy() / 2 + 1e-6
    if algo == "knn":
        assert np.all(np.abs(back.A.numpy() - tp.A.numpy()) <= half)
        assert torch.equal(back.labels, tp.labels)
    elif algo == "kmeans":
        assert np.all(np.abs(back.centroids.numpy()
                             - tp.centroids.numpy()) <= half)
    elif algo == "rf":
        f = tp.feature.numpy()
        inner = f >= 0
        err = np.abs(back.threshold.numpy() - tp.threshold.numpy())
        assert np.all(err[inner] <= half[f[inner]])
        assert torch.equal(back.feature, tp.feature)
    else:          # the table algebra inverts up to float rounding
        np.testing.assert_allclose(back.mu.numpy(), tp.mu.numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(back.var.numpy(), tp.var.numpy(),
                                   rtol=1e-4)


def test_calibration_helpers_match_jax():
    X, y = _blobs(200, 21, 3)
    np.testing.assert_array_equal(tcq.calibrate_absmax(X).numpy(),
                                  np.asarray(jcq.calibrate_absmax(X)))
    rng = np.random.default_rng(0)
    mu = rng.normal(size=(3, 21)).astype(np.float32)
    var = (rng.random((3, 21)) + 0.1).astype(np.float32)
    np.testing.assert_allclose(tcq.gauss_absmax(*_t(mu, var)).numpy(),
                               np.asarray(jcq.gauss_absmax(
                                   jnp.asarray(mu), jnp.asarray(var))),
                               rtol=1e-6)
    scale = tqk.feature_scales(torch.from_numpy(np.abs(mu).max(0)))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(
        jqk.feature_scales(jnp.asarray(np.abs(mu).max(0)))))
    Xq = tqk.quantize_rows(torch.from_numpy(X), scale)
    np.testing.assert_array_equal(Xq.numpy(), np.asarray(
        jqk.quantize_rows(jnp.asarray(X), jnp.asarray(scale.numpy()))))
    # half a step rounds to even, and the lattice saturates at ±127
    s = torch.ones(1)
    got = tqk.quantize_rows(torch.tensor([[0.5], [1.5], [-2.5], [300.0],
                                          [-300.0]]), s)
    assert got.flatten().tolist() == [0, 2, -2, 127, -127]


def test_forest_absmax_matches_jax():
    jest_rf, X, _ = _jax_fit("rf", 21)
    f, t = jest_rf.params.feature, jest_rf.params.threshold
    got = tcq.forest_absmax(*_t(np.asarray(f), np.asarray(t)), 25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jcq.forest_absmax(f, t, 25)))
    assert got[21:].tolist() == [1.0] * 4          # never tested: neutral


# --------------------------------------- estimators under policy="int8"


def _jax_predict(est, Q):
    cls, aux = est.predict_batch(jnp.asarray(Q))
    return np.asarray(cls), np.asarray(aux)


def _gauss_terms(qp, Q):
    """Size of the affine score's terms per (query, class)."""
    xq = np.asarray(jqk.quantize_rows(jnp.asarray(Q),
                                      jnp.asarray(qp.scale)),
                    np.float64)
    quad, lin = np.abs(np.asarray(qp.quad)), np.abs(np.asarray(qp.lin))
    return (xq * xq) @ quad.T + np.abs(xq) @ lin.T + \
        np.abs(np.asarray(qp.const))[None, :]


@pytest.mark.parametrize("algo", sorted(ALGOS))
@pytest.mark.parametrize("d", [21, 64])
def test_int8_estimators_match_jax(algo, d):
    """Fit under the int8 policy in JAX, carry the quantized params
    across, serve the same queries: kNN, K-Means and RF exact (neighbour
    ids, lattice-derived distances, votes), GNB and GMM scores to the
    scaled rtol with equal classes (batch against batch: the reference's
    own GMM int8 row-vs-batch disagreement is ROADMAP C)."""
    jfit, X, y = _jax_fit(algo, d, policy=INT8, n=200 if algo != "rf"
                          else 240, seed=d)
    assert jfit.quantized
    Q = _blobs(40, d, ALGOS[algo], seed=d + 100)[0]
    jcls, jaux = _jax_predict(jfit, Q)
    tp = convert.params_from_numpy(algo, jfit.params, device="cpu")
    assert tcq.is_quantized_params(tp)
    kw = {"k": jfit.k} if algo == "knn" else {}
    est = port_est.ESTIMATORS[algo].from_params(tp, device="cpu", **kw)
    assert est.quantized
    cls, aux = est.predict_batch(Q)
    np.testing.assert_array_equal(cls.numpy(), jcls)
    if algo in ("knn", "rf"):
        np.testing.assert_array_equal(aux.numpy(), jaux)
    elif algo == "kmeans":
        np.testing.assert_allclose(aux.numpy(), jaux, rtol=RTOL)
    else:
        terms = _gauss_terms(jfit.params, Q)
        _close_scaled(aux, jaux, terms)
    # the plain versions, asked for by path, give the same answer
    ref_est = port_est.ESTIMATORS[algo].from_params(tp, device="cpu",
                                                    path="ref", **kw)
    rcls, raux = ref_est.predict_batch(Q)
    assert torch.equal(rcls, cls) and torch.equal(raux, aux)


@pytest.mark.parametrize("algo", ["knn", "rf"])
def test_port_int8_fit_matches_jax_params(algo):
    """Where the fp32 fit is bit-equal (kNN stores the data, RF's CART is
    copied line for line), the port's own int8 fit gives the reference's
    quantized params exactly."""
    jfit, X, y = _jax_fit(algo, 21, policy=INT8)
    kw = {"n_trees": 6, "max_depth": 5} if algo == "rf" else {}
    est = port_est.make_fitted(algo, X, y, n_groups=ALGOS[algo],
                               policy=tdispatch.get_policy("int8"),
                               device="cpu", **kw)
    assert est.quantized and type(est.params).__name__ == \
        type(jfit.params).__name__
    for name in jfit.params._fields:
        jv, tv = getattr(jfit.params, name), getattr(est.params, name)
        if name == "n_class":
            assert tv == jv
        else:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_quantize_api_contracts():
    X, y = _blobs(120, 21, 3)
    est = port_est.make_fitted("knn", X, y, device="cpu")
    fp = est.params
    copy = est.quantized_copy()
    assert copy.quantized and not est.quantized and est.params is fp
    assert copy.quantized_copy() is copy
    with pytest.raises(ValueError, match="not quantized"):
        est.dequantize_params()
    assert est.quantize() is est and est.quantized
    assert est.quantize().params is est.params            # idempotent
    back = est.dequantize_params()
    assert back.A.dtype == torch.float32 and back.A.shape == fp.A.shape
    assert est.serve_cost_shape() == {"N": 120, "d": 21, "k": 4}
    with pytest.raises(ValueError, match="fit"):
        port_est.make_estimator("gnb", device="cpu").quantize()
    gnb = port_est.make_fitted("gnb", X, y, device="cpu",
                               policy=tdispatch.get_policy("int8"))
    assert gnb.quantized and tuple(gnb.empty_aux().shape) == (0, 3)
    assert gnb.serve_cost_shape() == {"C": 3, "d": 21}


# ------------------------------------- REPRO_BACKEND=quant and selectors


def test_quant_arms_registered_and_never_selected(monkeypatch):
    for key in (("knn", "distance_topk"), ("kmeans", "distance_argmin"),
                ("gnb", "scores"), ("gmm", "responsibilities"),
                ("rf", "forest_votes")):
        assert "quant" in tdispatch.registered()[key]
        assert "quant" in jdispatch.registered()[key]
    assert "quant" not in tdispatch.registered()[("ann", "adc_topk")]
    cases = [("knn", "distance_topk", dict(N=300, d=21, Q=q, k=k))
             for q in (1, 8, 1024) for k in (1, 4, 32, 33, 300)]
    cases += [("kmeans", "distance_argmin", dict(N=q, d=d, K=K))
              for q in (1, 1024) for d in (1, 21, 784) for K in (1, 256)]
    cases += [("gnb", "scores", dict(B=8, d=d, C=3)) for d in (21, 784)]
    cases += [("gmm", "responsibilities", dict(B=8, d=d, k=3))
              for d in (21, 784)]
    cases += [("rf", "forest_votes", {}),
              ("ann", "adc_topk", dict(Q=8, L=64, m=4, n_codes=16, k=4))]
    for policy in (None, tdispatch.get_policy("int8")):
        for algo, op, kw in cases:
            assert tdispatch.resolve(algo, op, policy=policy,
                                     **kw).name != "quant"
    monkeypatch.setenv(tdispatch.ENV_VAR, "quant")
    for algo, op, kw in cases[:-1]:
        assert tdispatch.resolve(algo, op, **kw).name == "quant"
    # an op without a quant arm falls through to its selector
    assert tdispatch.resolve(*cases[-1][:2], **cases[-1][2]).name == "fused"


def _forest():
    jest_rf, X, _ = _jax_fit("rf", 21)
    return jest_rf.params, convert.params_from_numpy("rf", jest_rf.params,
                                                     device="cpu")


@pytest.mark.parametrize("op", ["knn", "kmeans", "gnb", "gmm", "rf"])
def test_env_quant_matches_jax(monkeypatch, op):
    """``REPRO_BACKEND=quant`` forces each op's int8 arm in both packages,
    with the scales taken from the model-side operand."""
    monkeypatch.setenv(tdispatch.ENV_VAR, "quant")
    rng = np.random.default_rng(7)
    X = rng.normal(size=(50, 21)).astype(np.float32) * 2
    M = rng.normal(size=(9, 21)).astype(np.float32) * 2
    var = (rng.random((9, 21)) + 0.2).astype(np.float32)
    lp = np.log(np.full(9, 1 / 9, np.float32))
    if op == "knn":
        jv, ji = jdispatch.distance_topk(jnp.asarray(M), jnp.asarray(X), 4)
        tv, ti = tdispatch.distance_topk(*_t(M, X), 4)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    elif op == "kmeans":
        jv, ji = jdispatch.distance_argmin(jnp.asarray(X), jnp.asarray(M))
        tv, ti = tdispatch.distance_argmin(*_t(X, M))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL)
    elif op == "gnb":
        js = jdispatch.gnb_scores(*map(jnp.asarray, (X, M, var, lp)))
        ts = tdispatch.gnb_scores(*_t(X, M, var, lp))
        scale = np.asarray(jqk.feature_scales(jcq.gauss_absmax(
            jnp.asarray(M), jnp.asarray(var))))
        qp = jcq.QuantGNBParams(*jcq.gauss_score_tables(
            jnp.asarray(M), jnp.asarray(var), jnp.asarray(scale)), lp,
            scale)
        _close_scaled(ts, js, _gauss_terms(qp, X))
        np.testing.assert_array_equal(ts.argmax(1).numpy(),
                                      np.asarray(js).argmax(1))
    elif op == "gmm":
        jl, jm = jdispatch.gmm_responsibilities(
            *map(jnp.asarray, (M, var, lp, X)))
        tl, tm = tdispatch.gmm_responsibilities(*_t(M, var, lp, X))
        scale = np.asarray(jqk.feature_scales(jcq.gauss_absmax(
            jnp.asarray(M), jnp.asarray(var))))
        qp = jcq.QuantGMMParams(*jcq.gauss_score_tables(
            jnp.asarray(M), jnp.asarray(var), jnp.asarray(scale)), lp,
            scale)
        _close_scaled(tl, jl, _gauss_terms(qp, X))
        np.testing.assert_array_equal(tl.argmax(1).numpy(),
                                      np.asarray(jl).argmax(1))
    else:
        jf, tf = _forest()
        Xr = _blobs(40, 21, 3, seed=5)[0]
        jc, jvts = jdispatch.forest_votes(jf, jnp.asarray(Xr))
        tc, tvts = tdispatch.forest_votes(tf, torch.from_numpy(Xr))
        np.testing.assert_array_equal(tvts.numpy(), np.asarray(jvts))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_quant_arm_scales_come_from_the_model_side():
    """A query's answer does not depend on the batch it arrives in."""
    rng = np.random.default_rng(3)
    M = rng.normal(size=(70, 21)).astype(np.float32)
    X = rng.normal(size=(9, 21)).astype(np.float32) * 5
    _, batch = tdispatch.distance_topk(*_t(M, X), 4, path="quant")
    for i in range(len(X)):
        _, one = tdispatch.distance_topk(*_t(M, X[i:i + 1]), 4,
                                         path="quant")
        assert torch.equal(one[0], batch[i])


# ------------------------------------------------------------ the engine


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_int8_engine_serves_a_local_quantized_copy(algo):
    X, y = _blobs(200, 21, ALGOS[algo])
    Q = _blobs(23, 21, ALGOS[algo], seed=9)[0]
    kw = {"n_trees": 6, "max_depth": 5} if algo == "rf" else {}
    est = port_est.make_fitted(algo, X, y, n_groups=ALGOS[algo],
                               device="cpu", **kw)
    fp = est.params
    engine = NonNeuralServeEngine(est, max_batch=8, device="cpu",
                                  policy="int8")
    res = engine.classify(Q)
    want_cls, want_aux = est.quantized_copy().predict_batch(Q)
    assert torch.equal(res.classes, want_cls)
    if algo in ("gnb", "gmm"):
        # the CPU's fp32 matmul may block a bucket of 8 and a batch of 23
        # differently: the scores agree to rtol scaled to their terms
        qp = engine.estimator.params
        _close_scaled(res.aux, want_aux.numpy(), _gauss_terms(
            qp._replace(**{f: getattr(qp, f).numpy() for f in
                           ("quad", "lin", "const", "scale")}), Q))
    else:
        assert torch.equal(res.aux, want_aux)
    assert not est.quantized and est.params is fp          # caller's intact
    assert engine.estimator.quantized
    # the same fit in JAX gives the same byte report
    jfit = jest.make_fitted(algo, X, y, n_groups=ALGOS[algo], **kw)
    jeng = JaxEngine(jfit, max_batch=8, policy="int8")
    assert engine.quant_report == jeng.quant_report
    # an estimator fitted under the int8 policy passes through
    q_est = port_est.make_fitted(algo, X, y, n_groups=ALGOS[algo],
                                 device="cpu",
                                 policy=tdispatch.get_policy("int8"), **kw)
    q_eng = NonNeuralServeEngine(q_est, max_batch=8, device="cpu",
                                 policy="int8")
    assert q_eng.estimator is q_est
    assert q_eng.quant_report == jeng.quant_report
    assert NonNeuralServeEngine(est, device="cpu").quant_report is None
