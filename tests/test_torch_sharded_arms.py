"""The port's sharded GNB and GMM serving, int8 query tier and
reference-kNN merges against the JAX package's.

``tests/test_torch_sharded.py``'s set-up: one JAX subprocess with eight
forced host devices fits GNB and GMM on ``tests/test_mesh_parity.py``'s
ragged data and serves them under both strategies at c in
{1, 2, 3, 4, 8}, serves the int8 tier of five estimators one-device and
query-sharded at c = 3, and runs its reference-kNN merges (gather at
c = 3, butterfly at c = 8); the port serves the same params on
``make_local_mesh(c, "cpu")``.  Classes equal the JAX engine's and the
port's one-device engine's; GNB scores to rtol = atol = 1e-5 on the score,
GMM log-responsibilities to that tolerance scaled to the terms of the
Gaussian log-density (ROADMAP C).  Then the auto strategy: its routes are
``dispatch.resolve_strategy``'s and its classes the one-device engine's.
The int8 classes equal the JAX package's one-device and sharded int8
engines'; the merges are bit-equal to each other and meet the one-device
``distance_topk`` and the JAX merges (indices exactly, squared distances
at the fp32 bar scaled to ‖a‖² + ‖c‖²).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import cluster
from repro_torch.core import estimator as port_est
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serving import NonNeuralServeEngine
from test_torch_sharded import (BATCHES, MESHES, PAYLOAD, TOL,
                                assert_dist_close, port_params, run_jax)

ALGOS = ("gmm", "gnb")
INT8_ALGOS = ("gmm", "gnb", "kmeans", "knn", "rf")


@pytest.fixture(autouse=True)
def no_pins(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)
    monkeypatch.delenv(tdispatch.STRATEGY_ENV_VAR, raising=False)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    payload = f"ALGOS = {ALGOS!r}\nINT8 = True\n" + PAYLOAD
    return run_jax(payload, tmp_path_factory.mktemp("arms") / "jax.npz")


_EST = {}


def _estimator(out, algo):
    if algo not in _EST:
        _EST[algo] = port_est.ESTIMATORS[algo].from_params(
            port_params(out, algo), device="cpu")
    return _EST[algo]


def _scale(algo, est, X):
    """The size a score's rounding follows: the score itself for GNB, the
    terms of the GEMM-identity log-density for a GMM log-responsibility."""
    if algo == "gnb":
        return None
    p = est.params
    X = torch.as_tensor(X, dtype=torch.float64)
    mu, var = p.mu.double(), p.var.double()
    inv = 1.0 / var
    return ((X * X) @ (0.5 * inv).T + X.abs() @ (mu * inv).abs().T
            + 0.5 * (mu * mu * inv + torch.log(var).abs()
                     + np.log(2 * np.pi)).sum(1)).numpy()


def _close(tag, got, want, scale):
    got, want = np.asarray(got), np.asarray(want)
    if scale is None:
        np.testing.assert_allclose(got, want, **TOL, err_msg=tag)
        return
    bad = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * scale
    assert not bad.any(), (tag, got[bad], want[bad])


@pytest.mark.parametrize("strategy", ("query", "reference"))
@pytest.mark.parametrize("c", MESHES)
@pytest.mark.parametrize("algo", ALGOS)
def test_sharded_scores_match_jax(jax_out, algo, c, strategy):
    est = _estimator(jax_out, algo)
    X = jax_out["X"]
    single = NonNeuralServeEngine(est, max_batch=16, device="cpu")
    eng = NonNeuralServeEngine(est, max_batch=16, device="cpu",
                               mesh=make_local_mesh(c, "cpu"),
                               strategy=strategy)
    for B in BATCHES:
        tag = f"{algo} c={c} {strategy} B={B}"
        got = eng.classify(X[:B])
        key = f"{algo}/{c}/{strategy}/{B}"
        scale = _scale(algo, est, X[:B])
        np.testing.assert_array_equal(got.classes.numpy(),
                                      jax_out[key + "/cls"], err_msg=tag)
        _close(tag, got.aux, jax_out[key + "/aux"], scale)
        want = single.classify(X[:B])
        assert torch.equal(got.classes, want.classes), tag
        _close(tag + " vs one device", got.aux, want.aux, scale)
    assert all(b % c == 0 for b in eng.bucket_launches), eng.bucket_launches
    assert set(eng.bucket_strategies.values()) == {strategy}


@pytest.mark.parametrize("c", (3, 8))
@pytest.mark.parametrize("algo", ALGOS)
def test_auto_routes_by_the_cost_model(jax_out, algo, c):
    """``strategy="auto"``: each bucket takes ``resolve_strategy``'s
    partition for its (algorithm, bucket, mesh) cell, and serves the
    one-device engine's classes."""
    est = _estimator(jax_out, algo)
    X = jax_out["X"]
    eng = NonNeuralServeEngine(est, max_batch=16, device="cpu",
                               mesh=make_local_mesh(c, "cpu"))
    single = NonNeuralServeEngine(est, max_batch=16, device="cpu")
    for B in (1, 5, 19):
        got = eng.classify(X[:B])
        assert torch.equal(got.classes, single.classify(X[:B]).classes)
    for bucket, s in eng.bucket_strategies.items():
        assert s == tdispatch.resolve_strategy(
            algo, bucket=bucket, n_shards=c, shape=est.serve_cost_shape())


@pytest.mark.parametrize("c", (2, 3, 4, 8))
@pytest.mark.parametrize("k", (1, 5, 16))
def test_butterfly_and_gather_merges(jax_out, c, k):
    """The butterfly merge equals the gather merge bit for bit; both equal
    the one-device ``distance_topk`` (indices exactly, values at the fp32
    bar) and, where the JAX side ran them, the JAX merges; k = 16 exceeds
    a shard's 12 rows at c = 8 (the local clamp).  The tree merge refuses
    a non-power-of-two mesh; the default there is the gather merge."""
    X = torch.as_tensor(jax_out["X"])
    qs = X[:7]
    mesh = make_local_mesh(c, "cpu")
    merges = ("gather",) if c & (c - 1) else ("tree", "gather", None)
    got = {m: cluster.distance_topk_shardmap(X, qs, k, mesh, merge=m)
           for m in merges}
    wv, wi = tdispatch.distance_topk(X, qs, k)
    rows = X[wi.long()]
    for m, (v, i) in got.items():
        assert torch.equal(v, got["gather"][0]), m
        assert torch.equal(i, got["gather"][1]), m
        assert torch.equal(i, wi), (m, c, k)
        assert_dist_close(v, wv, rows, qs, f"{m} c={c} k={k}")
    key = f"merge/{c}/{k}"
    if key + "/i" in jax_out:
        np.testing.assert_array_equal(got["gather"][1].numpy(),
                                      jax_out[key + "/i"])
        assert_dist_close(got["gather"][0], jax_out[key + "/v"], rows, qs)
    if c & (c - 1):
        with pytest.raises(ValueError, match="power-of-two"):
            cluster.distance_topk_shardmap(X, qs, k, mesh, merge="tree")
        v, i = cluster.distance_topk_shardmap(X, qs, k, mesh)
        assert torch.equal(i, got["gather"][1])


@pytest.mark.parametrize("algo", INT8_ALGOS)
def test_int8_query_and_reference_refusal(jax_out, algo):
    """The int8 tier serves sharded through the query partition (the
    quantized model replicated a shard): classes equal the JAX package's
    one-device and 3-shard int8 engines', aux the port's one-device int8
    engine's; auto never routes quantized params to ``reference``, and a
    pinned ``reference`` refuses, as does ``fit_sharded`` under the int8
    policy."""
    X = jax_out["X"]
    est = port_est.ESTIMATORS[algo].from_params(
        port_params(jax_out, algo, f"int8/{algo}"), device="cpu")
    assert est.quantized
    mesh = make_local_mesh(3, "cpu")
    one = NonNeuralServeEngine(est, max_batch=16, device="cpu",
                               policy="int8").classify(X[:19])
    qry = NonNeuralServeEngine(est, max_batch=16, device="cpu", mesh=mesh,
                               policy="int8", strategy="query")
    got = qry.classify(X[:19])
    for name in ("single", "query"):
        np.testing.assert_array_equal(got.classes.numpy(),
                                      jax_out[f"int8/{algo}/{name}/cls"],
                                      err_msg=f"{algo} {name}")
    assert torch.equal(got.classes, one.classes)
    # int8 lattice work: neighbours, votes, dequantized lattice distances
    # and the affine scores of each row do not depend on the shard
    np.testing.assert_allclose(got.aux.numpy(), one.aux.numpy(), **TOL)
    auto = NonNeuralServeEngine(est, max_batch=16, device="cpu", mesh=mesh,
                                policy="int8")
    assert torch.equal(auto.classify(X[:19]).classes, one.classes)
    assert "reference" not in set(auto.bucket_strategies.values())
    with pytest.raises(NotImplementedError, match="model-partition"):
        NonNeuralServeEngine(est, max_batch=16, device="cpu", mesh=mesh,
                             policy="int8", strategy="reference")
    fresh = port_est.make_estimator(algo, device="cpu",
                                    policy=tdispatch.get_policy("int8"))
    with pytest.raises(NotImplementedError, match="single-device"):
        fresh.fit_sharded(X, jax_out["y"], mesh=mesh)


def test_reference_knn_refuses_the_quant_arm(jax_out):
    X = torch.as_tensor(jax_out["X"])
    with pytest.raises(NotImplementedError, match="no quant tier"):
        cluster.distance_topk_shardmap(X, X[:3], 4, make_local_mesh(2, "cpu"),
                                       path="quant")
