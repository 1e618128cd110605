"""The port's sharded fits and the paper-fidelity single-query mesh ports
against the JAX package's.

One JAX subprocess with eight forced host devices (as
``tests/test_mesh_parity.py``) runs ``make_fitted(..., mesh=_mk((c,)))``
for all six estimators at c in {1, 2, 3, 4, 8} on that test's ragged
data, and the single-query ``*_shardmap`` ports of Figs. 4-8 on
``tests/test_cluster_shardmap.py``'s data (N = 640, d = 24, 4 classes) on
the 8-device mesh.  The port runs the same on ``make_local_mesh(c,
"cpu")``.  The tolerances are ``test_mesh_parity.py``'s: kNN and RF fits
bit for bit (the kNN reference set with its ``_FAR`` residency rows), the
psum'd K-Means, GNB and GMM fits to rtol = atol = 2e-4, against the JAX
package's sharded fit and against the port's own one-device fit (loop
metadata ``shift``, ``n_iter``, ``log_lik`` aside); ANN's replicated
index keeps its integer leaves exact.  The single-query ports meet the
JAX outputs and the port's chunked ``n_cores`` forms as
``test_cluster_shardmap.py`` holds them, and refuse an indivisible mesh
naming the shape and the mesh.
"""
import numpy as np
import pytest
import torch

from repro.core import random_forest as JRF
from repro_torch.core import cluster
from repro_torch.core import estimator as port_est
from repro_torch.core import gnb as NB
from repro_torch.core import kmeans as KM
from repro_torch.core import knn as KNN
from repro_torch.core import random_forest as RF
from repro_torch.core.distribution import (two_phase_matvec,
                                           two_phase_matvec_shardmap)
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch.mesh import make_local_mesh
from test_torch_sharded import MESHES, run_jax

ALGOS = ("ann", "gmm", "gnb", "kmeans", "knn", "rf")
EXACT_FIT = ("knn", "rf")
META = ("shift", "n_iter", "log_lik")
FIT_TOL = dict(rtol=2e-4, atol=2e-4)

PAYLOAD = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.core import cluster, gnb as NB, random_forest as RF
from repro.core.distribution import two_phase_matvec_shardmap
from repro.core.estimator import ESTIMATORS, make_fitted
from repro.core.knn import KNNModel
from repro.launch.mesh import _mk

rng = np.random.default_rng(0)
N, d, C = 93, 13, 3
centers = rng.normal(size=(C, d)) * 3.0
y = rng.integers(0, C, size=N).astype(np.int32)
X = (centers[y] + rng.normal(size=(N, d))).astype(np.float32)
out = {"X": X, "y": y}
for c in (1, 2, 3, 4, 8):
    mesh = _mk((c,), ("data",))
    for algo in sorted(ESTIMATORS):
        est = make_fitted(algo, X, y, n_groups=C, mesh=mesh)
        for name, v in est.params._asdict().items():
            out[f"fit/{algo}/{c}/{name}"] = np.asarray(v)

# the single-query ports (tests/test_cluster_shardmap.py's data)
mesh = _mk((8,), ("data",))
rng = np.random.default_rng(0)
N, d, C = 640, 24, 4
centers = rng.normal(size=(C, d)) * 3
y2 = rng.integers(0, C, size=N).astype(np.int32)
X2 = (centers[y2] + rng.normal(size=(N, d))).astype(np.float32)
W = rng.normal(size=(C, d)).astype(np.float32)
b = rng.normal(size=(C,)).astype(np.float32)
out.update(X2=X2, y2=y2, W=W, b=b)
out["matvec"] = np.asarray(two_phase_matvec_shardmap(W, X2[0], b, mesh))
model = KNNModel(A=jnp.asarray(X2), labels=jnp.asarray(y2), n_class=C)
out["knn"] = np.array([int(cluster.knn_classify_shardmap(
    model, X2[i], 4, mesh)) for i in (0, 5)])
cents, ids = cluster.kmeans_iteration_shardmap(X2, X2[:C], mesh)
out["km_c"], out["km_ids"] = np.asarray(cents), np.asarray(ids)
gm = NB.fit_gnb(jnp.asarray(X2), jnp.asarray(y2), C)
cls, scores = cluster.gnb_decision_shardmap(gm, X2[3], mesh)
out["gnb_cls"], out["gnb_scores"] = np.asarray(cls), np.asarray(scores)
f = RF.train_forest(X2, y2, C, n_trees=16, max_depth=5)
for i in (0, 9):
    cls, votes = cluster.forest_predict_shardmap(f, X2[i], mesh)
    out[f"rf_cls/{i}"], out[f"rf_votes/{i}"] = (np.asarray(cls),
                                                np.asarray(votes))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(autouse=True)
def no_pins(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    return run_jax(PAYLOAD, tmp_path_factory.mktemp("fit") / "jax.npz")


_SINGLE = {}


def _single(out, algo):
    """The port's one-device fit on the same data."""
    if algo not in _SINGLE:
        _SINGLE[algo] = port_est.make_fitted(algo, out["X"], out["y"],
                                             n_groups=3, device="cpu")
    return _SINGLE[algo]


def _compare(tag, algo, name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    if algo in EXACT_FIT or not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=tag)
    else:
        np.testing.assert_allclose(got, want, **FIT_TOL, err_msg=tag)


@pytest.mark.parametrize("c", MESHES)
@pytest.mark.parametrize("algo", ALGOS)
def test_fit_sharded_matches_jax_and_one_device(jax_out, algo, c):
    mesh = make_local_mesh(c, "cpu")
    sh = port_est.make_fitted(algo, jax_out["X"], jax_out["y"], n_groups=3,
                              device="cpu", mesh=mesh)
    assert sh.mesh is mesh and sh.mesh_axis == "data"
    one = _single(jax_out, algo)
    for name, got, ref in zip(sh.params._fields, sh.params, one.params):
        tag = f"{algo}/{name} c={c}"
        if not isinstance(got, torch.Tensor):
            assert got == ref == int(jax_out[f"fit/{algo}/{c}/{name}"]), tag
            continue
        if name in META:
            continue
        want = jax_out[f"fit/{algo}/{c}/{name}"]
        assert tuple(got.shape) == want.shape, tag
        _compare(tag + " vs jax", algo, name, got.numpy(), want)
        if algo == "knn" and name == "A":
            # shard residency pads the rows with far rows
            n = ref.shape[0]
            assert bool((got[n:] == cluster._FAR).all())
            got = got[:n]
        _compare(tag + " vs one device", algo, name, got.numpy(),
                 ref.numpy())


@pytest.mark.parametrize("n_shards", (1, 3, 6, 10, 16))
def test_rf_tree_parallel_fit_ragged_shards(n_shards):
    """The tree-parallel RF fit is bit-equal to the sequential fit and to
    the JAX package's tree-parallel fit for any shard count, those that
    do not divide the trees and those past them included."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(80, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=80).astype(np.int32)
    ref = RF.train_forest(X, y, 3, n_trees=10, max_depth=4, seed=2)
    got = RF.train_forest_sharded(X, y, 3, n_shards, n_trees=10,
                                  max_depth=4, seed=2)
    want = JRF.train_forest_sharded(X, y, 3, n_shards, n_trees=10,
                                    max_depth=4, seed=2)
    for name, r, g, w in zip(ref._fields, ref, got, want):
        if isinstance(r, torch.Tensor):
            assert torch.equal(g, r), (name, n_shards)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            assert g == r == w


def _mesh8():
    return make_local_mesh(8, "cpu")


def test_single_query_ports_match_jax(jax_out):
    """Figs. 4-8 over an 8-shard axis, as ``test_cluster_shardmap.py``:
    against the JAX ports and the port's chunked ``n_cores = 8`` forms."""
    mesh = _mesh8()
    X = torch.as_tensor(jax_out["X2"])
    y = torch.as_tensor(jax_out["y2"])
    W, b = torch.as_tensor(jax_out["W"]), torch.as_tensor(jax_out["b"])
    C = 4
    got = two_phase_matvec_shardmap(W, X[0], b, mesh)
    for want in (two_phase_matvec(W, X[0], b, 8), jax_out["matvec"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    assert torch.equal(cluster.matvec_shardmap(W, X[0], b, mesh), got)
    model = KNN.KNNModel(A=X, labels=y, n_class=C)
    for j, i in enumerate((0, 5)):
        cls = int(cluster.knn_classify_shardmap(model, X[i], 4, mesh))
        assert cls == int(jax_out["knn"][j]) == \
            int(KNN.knn_classify(model, X[i], 4, n_cores=8)[0])
    cents, ids = cluster.kmeans_iteration_shardmap(X, X[:C], mesh)
    want_c, want_ids = KM.kmeans_iteration(X, X[:C], n_cores=8)
    for wc, wi in ((want_c, want_ids), (jax_out["km_c"], jax_out["km_ids"])):
        np.testing.assert_allclose(cents.numpy(), np.asarray(wc),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(wi))
    gm = NB.fit_gnb(X, y, C)
    cls, scores = cluster.gnb_decision_shardmap(gm, X[3], mesh)
    want_cls, want_scores = NB.gnb_decision(gm, X[3], n_cores=8)
    assert int(cls) == int(want_cls) == int(jax_out["gnb_cls"])
    for ws in (want_scores, jax_out["gnb_scores"]):
        np.testing.assert_allclose(scores.numpy(), np.asarray(ws),
                                   rtol=1e-4, atol=1e-4)
    f = RF.train_forest(jax_out["X2"], jax_out["y2"], C, n_trees=16,
                        max_depth=5)
    for i in (0, 9):
        cls, votes = cluster.forest_predict_shardmap(f, X[i], mesh)
        want_cls, want_votes = RF.forest_classify_batch(f, X[i][None])
        assert int(cls) == int(want_cls[0]) == int(jax_out[f"rf_cls/{i}"])
        assert torch.equal(votes, want_votes[0])
        np.testing.assert_array_equal(votes.numpy(),
                                      jax_out[f"rf_votes/{i}"])


@pytest.mark.parametrize("what", ("N=93", "d=13", "T=10"))
def test_single_query_ports_refuse_an_indivisible_mesh(jax_out, what):
    """The JAX package's ValueError, naming the shape and the mesh."""
    mesh = _mesh8()
    X = torch.as_tensor(jax_out["X2"])
    y = torch.as_tensor(jax_out["y2"])
    if what == "N=93":
        bad = KNN.KNNModel(A=X[:93], labels=y[:93], n_class=4)
        calls = [lambda: cluster.knn_classify_shardmap(bad, X[0], 4, mesh),
                 lambda: cluster.kmeans_iteration_shardmap(X[:93], X[:4],
                                                           mesh)]
    elif what == "d=13":
        gm = NB.fit_gnb(X[:, :13], y, 4)
        calls = [lambda: cluster.gnb_decision_shardmap(gm, X[3, :13], mesh)]
    else:
        f10 = RF.train_forest(jax_out["X2"], jax_out["y2"], 4, n_trees=10,
                              max_depth=4)
        calls = [lambda: cluster.forest_predict_shardmap(f10, X[0], mesh)]
    for call in calls:
        with pytest.raises(ValueError) as e:
            call()
        msg = str(e.value)
        assert what in msg and "'data'" in msg and "8-shard" in msg, msg
