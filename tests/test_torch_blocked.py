"""The blocked two-pass arm of the PyTorch port against the JAX package.

B4 ``pairwise_sq_dist``, B5 ``topk_smallest`` and B9 ``gnb_scores``: the
same numpy inputs go through ``repro.kernels.ops`` (the Pallas kernels, in
interpret mode on the CPU), ``repro.kernels.ref`` (the jnp oracles) and
``repro_torch.kernels.ops`` on CPU tensors, which run the kernels' plain
PyTorch versions; then the blocked kNN and K-Means arms through both
registries.  Tolerances: indices exact; fp32 values ``rtol = atol = 1e-5``
(the packages sum the distance expansion and the GNB terms in different
orders).  The CUDA kernels themselves are held against the plain versions
on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dispatch as jdispatch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import estimator as port_est
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import gnb_score as tgs
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_sq_dist as tpd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_select as tts

TOL = dict(rtol=1e-5, atol=1e-5)
INF = float("inf")


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    """Both packages pick their arms by shape, whatever REPRO_BACKEND the
    surrounding run sets; tests that need it set it themselves."""
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


def _points(seed, n, d, dup=False):
    """(n, d) float32.  ``dup``: small integer rows drawn with repetition,
    so distances are exact small integers and equal rows tie exactly."""
    rng = np.random.default_rng(seed)
    if dup:
        base = rng.integers(-2, 3, size=(max(1, n // 3), d))
        return base[rng.integers(0, len(base), size=n)].astype(np.float32)
    return rng.normal(size=(n, d)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------------------ B4


@pytest.mark.parametrize("N,d,K", [
    (999, 21, 7),       # ragged N at the asd_like width
    (37, 5, 1),         # one centroid
    (3, 784, 65),       # ragged K at the mnist_like width
    (257, 1, 40),       # one feature
])
@pytest.mark.parametrize("col_major", [False, True])
def test_pairwise_sq_dist_matches_jax(N, d, K, col_major):
    a, c = _points(N, N, d), _points(K + 1, K, d)
    je = np.asarray(jops.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(c)))
    re = np.asarray(jref.pairwise_sq_dist(jnp.asarray(a), jnp.asarray(c)))
    te = tops.pairwise_sq_dist(*_t(a, c), col_major=col_major)
    assert te.shape == (N, K) and te.dtype == torch.float32
    # col_major: the transpose is the contiguous (K, N) buffer
    assert te.T.is_contiguous() if col_major else te.is_contiguous()
    np.testing.assert_allclose(te.numpy(), je, **TOL)
    np.testing.assert_allclose(te.numpy(), re, **TOL)


# ------------------------------------------------------------------ B5


def _topk_rows(seed, R, n, dup):
    rng = np.random.default_rng(seed)
    if dup:    # few distinct values: long runs of exact ties
        return rng.integers(0, 4, size=(R, n)).astype(np.float32)
    return rng.normal(size=(R, n)).astype(np.float32)


@pytest.mark.parametrize("R,n,k,dup", [
    (5, 300, 4, False),       # ragged R (the Pallas wrapper pads to 8)
    (3, 50, 1, True),         # k = 1 on ties
    (8, 40, 40, True),        # k = n
    (9, 200, 33, False),      # k past B1's lists
    (2, 1000, 64, True),      # the kNN path's k, on ties
    (1, 7, 7, False),         # one row
])
def test_topk_smallest_matches_jax(R, n, k, dup):
    x = _topk_rows(R * n + k, R, n, dup)
    jv, ji = (np.asarray(v) for v in jops.topk_smallest(jnp.asarray(x), k))
    rv, ri = (np.asarray(v) for v in jref.topk_smallest(jnp.asarray(x), k))
    tv, ti = tops.topk_smallest(torch.from_numpy(x), k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert tuple(ti.shape) == (R, k)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(ti.numpy(), ri)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tv.numpy(), rv)
    if dup and k > 1:    # ties resolved to the first index, rank by rank
        tied = tv[:, 1:] == tv[:, :-1]
        assert bool(tied.any())
        assert bool((ti[:, 1:] > ti[:, :-1])[tied].all())


def test_topk_distinct_where_the_pallas_kernel_repeats():
    """The reference's B5 writes +inf over each pick, so once a row's k
    smallest reach +inf its next pass finds the same first index again.
    The port gives the oracle's distinct indices."""
    x = np.array([[1.0, INF, INF, 0.5]], np.float32)
    _, pallas = jops.topk_smallest(jnp.asarray(x), 4)
    _, oracle = jref.topk_smallest(jnp.asarray(x), 4)
    vals, idx = tops.topk_smallest(torch.from_numpy(x), 4)
    assert np.asarray(pallas).tolist() == [[3, 0, 0, 0]]
    assert np.asarray(oracle).tolist() == [[3, 0, 1, 2]]
    assert idx.tolist() == [[3, 0, 1, 2]]
    assert vals.tolist() == [[0.5, 1.0, INF, INF]]


def test_topk_ranks_nan_last_and_zeros_alike():
    """B1's rule: NaN after every number (ties among NaN to the first
    index), -0 equal to +0; indices stay distinct for every k."""
    nan = float("nan")
    x = torch.tensor([[nan, 0.0, -0.0, INF, nan, -INF],
                      [2.0, nan, 1.0, 2.0, -1.0, nan]])
    for k in range(1, 7):
        vals, idx = tops.topk_smallest(x, k)
        want = [[5, 1, 2, 3, 0, 4], [4, 2, 0, 3, 1, 5]]
        assert idx.tolist() == [w[:k] for w in want]
        torch.testing.assert_close(vals, torch.gather(x, 1, idx.long()),
                                   rtol=0, atol=0, equal_nan=True)


def test_topk_takes_the_transposed_view_without_a_copy(monkeypatch):
    """The kNN arm hands B5 the transpose of B4's column-major output: a
    view with contiguous rows.  Column-strided input is refused, on the
    CPU as on the card."""
    a, c = _t(_points(0, 70, 5), _points(1, 6, 5))
    e = tops.pairwise_sq_dist(a, c, col_major=True)          # (70, 6)
    assert e.T.is_contiguous() and e.T.data_ptr() == e.data_ptr()
    vals, idx = tops.topk_smallest(e.T, 9)
    rv, ri = tref.topk_smallest(e.T.contiguous(), 9)
    assert torch.equal(idx, ri) and torch.equal(vals, rv)
    with pytest.raises(ValueError, match="contiguous rows"):
        tops.topk_smallest(tops.pairwise_sq_dist(a, c).T, 9)
    sliced = e.T[::2]                                         # row stride 140
    assert torch.equal(tops.topk_smallest(sliced, 3)[1], ri[::2, :3])


def test_topk_validates_k():
    x = torch.zeros((3, 5))
    for bad in (0, 6):
        with pytest.raises(ValueError, match="outside"):
            tops.topk_smallest(x, bad)
    # int32 rows take B5's int32 key mode; other integer types raise
    assert tops.topk_smallest(x.to(torch.int32), 2)[0].dtype == torch.int32
    for dtype in (torch.int64, torch.int8):
        with pytest.raises(TypeError):
            tops.topk_smallest(x.to(dtype), 2)


# ------------------------------------------------------------------ B9


def _gnb_inputs(seed, d, C):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(d,)).astype(np.float32)
    mu = rng.normal(size=(C, d)).astype(np.float32)
    var = (rng.random((C, d)) + 0.25).astype(np.float32)
    log_prior = np.log(rng.dirichlet(np.ones(C))).astype(np.float32)
    return x, mu, var, log_prior


@pytest.mark.parametrize("d,C", [(70, 3), (128, 10), (1, 2), (300, 1)])
def test_gnb_scores_matches_jax(d, C):
    args = _gnb_inputs(d + C, d, C)
    js = np.asarray(jops.gnb_scores(*map(jnp.asarray, args)))
    rs = np.asarray(jref.gnb_scores(*map(jnp.asarray, args)))
    ts = tops.gnb_scores(*_t(*args))
    assert ts.shape == (C,) and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, **TOL)
    np.testing.assert_allclose(ts.numpy(), rs, **TOL)
    batch = tops.gnb_scores_batch(*_t(args[0][None], *args[1:]))[0]
    np.testing.assert_allclose(ts.numpy(), batch.numpy(), **TOL)


@pytest.mark.parametrize("d", [21, 70])     # ref arm / B3 at B = 1
def test_gnb_single_query_predict_matches_batch(d):
    from repro_torch.data.datasets import class_blobs
    X, y = class_blobs(n=120, d=d, n_class=3, seed=d)
    est = port_est.make_fitted("gnb", X[:100], y[:100], device="cpu")
    cls, scores = est.predict_batch(X[100:])
    for i in range(5):
        c, s = est.predict(X[100 + i])
        assert int(c) == int(cls[i])
        np.testing.assert_allclose(s.numpy(), scores[i].numpy(), **TOL)


# ------------------------------------------------- the arms, end to end


@pytest.mark.parametrize("N,d,Q,k,dup", [
    (300, 21, 6, 40, False),     # k > 32: the port's selector takes blocked
    (200, 4, 3, 200, True),      # k = N on ties
    (97, 21, 5, 64, False),
])
def test_knn_blocked_arm_matches_jax(N, d, Q, k, dup):
    a, c = _points(N + 3, N, d, dup), _points(Q + 4, Q, d, dup)
    assert tdispatch.resolve("knn", "distance_topk", N=N, d=d, Q=Q,
                             k=k).name == "blocked"
    tv, ti = tdispatch.distance_topk(*_t(a, c), k)
    ja, jc = jnp.asarray(a), jnp.asarray(c)
    for path in (None, "blocked"):          # JAX: fused, then two-pass
        jv, ji = (np.asarray(v) for v in jdispatch.distance_topk(
            ja, jc, k, path=path))
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(tv.numpy(), jv, **TOL)


@pytest.mark.parametrize("Q,k", [(7, 40), (5, 300)])
def test_knn_blocked_arm_chunks_queries(monkeypatch, Q, k):
    """Under the byte budget the queries go through B4 and B5 in chunks
    (here 2 queries each); the result equals the one-chunk result."""
    a, c = _points(11, 300, 21, True), _points(12, Q, 21, True)
    whole = tdispatch.distance_topk(*_t(a, c), k, path="blocked")
    monkeypatch.setattr(tdispatch, "BLOCKED_BYTES", 2 * 4 * 300 + 5)
    calls = []
    real = tops.pairwise_sq_dist
    monkeypatch.setattr(tops, "pairwise_sq_dist",
                        lambda a, c, **kw: calls.append(c.shape[0]) or
                        real(a, c, **kw))
    v, i = tdispatch.distance_topk(*_t(a, c), k, path="blocked")
    assert calls == [2] * (Q // 2) + [1] * (Q % 2)
    assert torch.equal(i, whole[1]) and torch.equal(v, whole[0])
    np.testing.assert_array_equal(i.numpy(), np.asarray(
        jdispatch.distance_topk(jnp.asarray(a), jnp.asarray(c), k,
                                path="blocked")[1]))


@pytest.mark.parametrize("dup", [False, True])
def test_kmeans_blocked_arm_matches_jax(dup):
    a, c = _points(5, 203, 21, dup), _points(6, 9, 21, dup)
    if dup:
        c[5:] = c[:4]                      # repeated centroids: first wins
    tv, ti = tdispatch.distance_argmin(*_t(a, c), path="blocked")
    jv, ji = (np.asarray(v) for v in jdispatch.distance_argmin(
        jnp.asarray(a), jnp.asarray(c), path="blocked"))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, **TOL)
    fv, fi = tdispatch.distance_argmin(*_t(a, c), path="fused")
    assert torch.equal(fi, ti)


# ------------------------------------------------------ wrapper contract


def test_new_wrappers_on_device_tensors_launch(monkeypatch):
    """The branch a CUDA tensor takes, driven on the CPU by presenting the
    inputs as device tensors: each launcher runs once with fp32 inputs,
    its count grows by one, and no plain version is called."""
    def boom(*_):
        raise AssertionError("a device tensor reached a plain version")

    calls = []

    def launcher(name):
        def fn(*args):
            calls.append((name, [a.dtype for a in args
                                 if isinstance(a, torch.Tensor)], args[-1]))
            return "launched" if name != "gnb" else ["launched"]
        return fn

    for name in ("pairwise_sq_dist", "topk_smallest", "gnb_scores"):
        monkeypatch.setattr(tref, name, boom)
    monkeypatch.setattr(tpd, "launch", launcher("dist"))
    monkeypatch.setattr(tts, "launch", launcher("topk"))
    monkeypatch.setattr(tgs, "launch_scores_batch", launcher("gnb"))
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    tops.reset_launches()
    a, c = _t(_points(0, 30, 4), _points(1, 3, 4))
    assert tops.pairwise_sq_dist(a.bfloat16(), c,
                                 col_major=True) == "launched"
    assert tops.topk_smallest(a.T.contiguous().bfloat16(), 20) == "launched"
    assert tops.gnb_scores(*_t(*_gnb_inputs(0, 4, 3))) == "launched"
    assert [tops.LAUNCHES[n] for n in ("pairwise_sq_dist", "topk_smallest",
                                       "gnb_scores")] == [1, 1, 1]
    assert sum(tops.LAUNCHES.values()) == 3
    assert [n for n, _, _ in calls] == ["dist", "topk", "gnb"]
    assert calls[0][2] is True and calls[1][2] == 20
    assert all(dt == torch.float32 for _, dts, _ in calls for dt in dts)


def test_new_wrappers_on_cpu_tensors_count_nothing(monkeypatch):
    def boom(*_):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    monkeypatch.setattr(tpd, "launch", boom)
    monkeypatch.setattr(tts, "launch", boom)
    monkeypatch.setattr(tgs, "launch_scores_batch", boom)
    tops.reset_launches()
    a, c = _t(_points(0, 30, 4), _points(1, 3, 4))
    e = tops.pairwise_sq_dist(a, c, col_major=True)
    tops.topk_smallest(e.T, 30)
    tops.gnb_scores(*_t(*_gnb_inputs(0, 4, 3)))
    assert set(tops.LAUNCHES.values()) == {0}
