"""The port's sharded serve layer against the JAX package's.

The JAX side runs once for the file, in one subprocess with eight forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_mesh_parity.py`` does): it fits kNN, K-Means, RF and IVF-PQ
ANN on that test's ragged data (N = 93, d = 13, 3 classes), serves them
through its ``NonNeuralServeEngine(mesh=...)`` under each registered
strategy at c in {1, 2, 3, 4, 8} shards, lists its autotune candidates on
a mesh, and writes params and outputs to an ``.npz``.  The port serves the same params (``repro_torch.convert``)
in-process on ``make_local_mesh(c, "cpu")``.  Classes and neighbour
indices equal the JAX package's and the port's one-device engine's; float
aux meets the fp32 bar (rtol = atol = 1e-5, ROADMAP C): on the CPU the
plain versions' ``torch.matmul`` rounds a row by the operand's shape (a
one-row shard takes a matrix-vector kernel), so a sharded float row is
not bit-equal to the one-device row as it is in the JAX package.  Every
launched bucket is a multiple of the shard count.  GNB and GMM serving,
the int8 query tier and the reference-kNN merges are
``tests/test_torch_sharded_arms.py``; the fits are
``tests/test_torch_sharded_fit.py``.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.base import MeshConfig as JaxMeshConfig
from repro.kernels import dispatch as jdispatch
from repro_torch import convert
from repro_torch.configs.base import MeshConfig
from repro_torch.core import estimator as port_est
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serving import NonNeuralServeEngine

ROOT = Path(__file__).resolve().parents[1]
MESHES = (1, 2, 3, 4, 8)
BATCHES = (1, 19)              # 19 > max_batch: a 16 bucket and a tail
ALGOS = ("ann", "kmeans", "knn", "rf")
TOL = dict(rtol=1e-5, atol=1e-5)

PAYLOAD = textwrap.dedent("""
    import sys
    import numpy as np
    from repro.core import cluster
    from repro.core.estimator import make_fitted
    from repro.kernels.dispatch import get_policy
    from repro.launch.mesh import _mk
    from repro.serving import NonNeuralServeEngine

    rng = np.random.default_rng(0)
    N, d, C = 93, 13, 3                    # ragged: 93 % {2,4,8} != 0
    centers = rng.normal(size=(C, d)) * 3.0
    y = rng.integers(0, C, size=N).astype(np.int32)
    X = (centers[y] + rng.normal(size=(N, d))).astype(np.float32)
    out = {"X": X, "y": y}

    def keep(prefix, params):
        for name, v in params._asdict().items():
            out[f"{prefix}/p/{name}"] = np.asarray(v)

    for algo in ALGOS:
        est = make_fitted(algo, X, y, n_groups=C)
        keep(algo, est.params)
        for c in (1, 2, 3, 4, 8):
            mesh = _mk((c,), ("data",))
            for strat in ("query", "reference"):
                if algo == "ann" and strat == "reference":
                    continue
                eng = NonNeuralServeEngine(est, max_batch=16, mesh=mesh,
                                           strategy=strat)
                for B in (1, 19):
                    r = eng.classify(X[:B])
                    key = f"{algo}/{c}/{strat}/{B}"
                    out[key + "/cls"] = np.asarray(r.classes)
                    out[key + "/aux"] = np.asarray(r.aux)
    for algo in ALGOS:                     # autotune's candidate lists
        est = make_fitted(algo, X, y, n_groups=C)
        for c in (3, 8):
            eng = NonNeuralServeEngine(est, max_batch=16,
                                       mesh=_mk((c,), ("data",)))
            for b in (1, 16):
                out[f"cands/{algo}/{c}/{b}"] = np.array(repr(
                    eng._autotune_candidates(eng._bucket(b))))
    if INT8:
        mesh3 = _mk((3,), ("data",))
        for algo in ("gmm", "gnb", "kmeans", "knn", "rf"):
            est = make_fitted(algo, X, y, n_groups=C,
                              policy=get_policy("int8"))
            keep(f"int8/{algo}", est.params)
            for name, eng in (
                    ("single", NonNeuralServeEngine(est, max_batch=16,
                                                    policy="int8")),
                    ("query", NonNeuralServeEngine(
                        est, max_batch=16, mesh=mesh3, policy="int8",
                        strategy="query"))):
                r = eng.classify(X[:19])
                out[f"int8/{algo}/{name}/cls"] = np.asarray(r.classes)
                out[f"int8/{algo}/{name}/aux"] = np.asarray(r.aux)
        for c, merge in ((3, "gather"), (8, "tree")):
            for k in (5, 16):              # 16 > 93 // 8: the local clamp
                v, i = cluster.distance_topk_shardmap(
                    X, X[:7], k, _mk((c,), ("data",)), "data", merge=merge)
                out[f"merge/{c}/{k}/v"] = np.asarray(v)
                out[f"merge/{c}/{k}/i"] = np.asarray(i)
    np.savez(sys.argv[1], **out)
""")


def run_jax(payload: str, path: Path, timeout: int = 600) -> dict:
    """Run ``payload`` (which writes ``sys.argv[1]``) with eight forced
    host devices and no backend pins; return the ``.npz`` it wrote."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", payload, str(path)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, (res.stdout[-800:], res.stderr[-3000:])
    with np.load(path) as f:
        return dict(f)


def port_params(out: dict, algo: str, prefix: str = None):
    """The JAX params saved under ``prefix`` carried across to the CPU."""
    prefix = prefix or algo
    head = f"{prefix}/p/"
    leaves = {k[len(head):]: v for k, v in out.items()
              if k.startswith(head)}
    return convert.params_from_numpy(algo, leaves, device="cpu")


def assert_dist_close(got, want, rows, queries, tag=""):
    """Squared distances at the fp32 bar of ROADMAP C: rtol applies to
    ‖a‖² + ‖c‖², the size of the expansion's terms (a self-distance
    cancels to a few ulps of them either side of 0).  ``rows`` (Q, k, d)
    or (Q, d) are the matched rows of each query (Q, d)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rows, queries = np.asarray(rows, np.float64), np.asarray(queries,
                                                             np.float64)
    qn = (queries ** 2).sum(-1)
    scale = (rows ** 2).sum(-1) + (qn[:, None] if got.ndim == 2 else qn)
    bad = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * scale
    assert not bad.any(), (tag, got[bad], want[bad])


def check_rows(tag, got, want_cls, want_aux, dist_of=None):
    """Classes equal; aux equal, or, for K-Means' distances (``dist_of``:
    the assigned centroids' rows and the queries), at the fp32 bar."""
    np.testing.assert_array_equal(got.classes.numpy(), want_cls,
                                  err_msg=tag)
    if dist_of is None:
        np.testing.assert_array_equal(got.aux.numpy(), want_aux,
                                      err_msg=tag)
    else:
        assert_dist_close(got.aux.numpy(), want_aux, *dist_of, tag=tag)


@pytest.fixture(autouse=True)
def no_pins(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)
    monkeypatch.delenv(tdispatch.STRATEGY_ENV_VAR, raising=False)


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    payload = f"ALGOS = {ALGOS!r}\nINT8 = False\n" + PAYLOAD
    return run_jax(payload, tmp_path_factory.mktemp("sharded") / "jax.npz")


_EST = {}


def _estimator(out, algo):
    if algo not in _EST:
        _EST[algo] = port_est.ESTIMATORS[algo].from_params(
            port_params(out, algo), device="cpu")
    return _EST[algo]


# every registered (algorithm, strategy) arm at every shard count; ANN has
# no reference arm (test_ann_refuses_reference)
CELLS = [(a, c, s) for a in ALGOS for c in MESHES
         for s in ("query", "reference") if (a, s) != ("ann", "reference")]


@pytest.mark.parametrize("algo,c,strategy", CELLS)
def test_sharded_serve_matches_jax(jax_out, algo, c, strategy):
    """One engine a (algorithm, shard count, strategy): classes and
    integer aux equal the JAX engine's and the port's one-device
    engine's, float aux at the fp32 bar; ragged batches; every bucket a
    shard multiple, every bucket routed to the pinned strategy."""
    est = _estimator(jax_out, algo)
    X = jax_out["X"]
    single = NonNeuralServeEngine(est, max_batch=16, device="cpu")
    eng = NonNeuralServeEngine(est, max_batch=16, device="cpu",
                               mesh=make_local_mesh(c, "cpu"),
                               strategy=strategy)
    assert eng.sharded and eng.n_shards == c
    for B in BATCHES:
        tag = f"{algo} c={c} {strategy} B={B}"
        got = eng.classify(X[:B])
        dist_of = None
        if algo == "kmeans":
            dist_of = (est.params.centroids[got.classes.long()], X[:B])
        key = f"{algo}/{c}/{strategy}/{B}"
        check_rows(tag, got, jax_out[key + "/cls"], jax_out[key + "/aux"],
                   dist_of)
        want = single.classify(X[:B])
        check_rows(tag + " vs one device", got, want.classes.numpy(),
                   want.aux.numpy(), dist_of)
    assert all(b % c == 0 for b in eng.bucket_launches), eng.bucket_launches
    assert set(eng.bucket_strategies.values()) == {strategy}
    empty = eng.classify(X[:0])
    assert empty.classes.shape == (0,) and empty.launches == 0


@pytest.mark.parametrize("c", (3, 8))
@pytest.mark.parametrize("algo", ALGOS)
def test_mesh_autotune_candidates_are_jax_without_bn(jax_out, algo, c):
    """On a mesh the candidates are the JAX engine's without its ``bn``
    arms (the CUDA kernels have no row-block knob); on the CPU ``ref``
    stays, as there."""
    est = _estimator(jax_out, algo)
    eng = NonNeuralServeEngine(est, max_batch=16, device="cpu",
                               mesh=make_local_mesh(c, "cpu"))
    for b in (1, 16):
        want = [arm for arm in eval(str(jax_out[f"cands/{algo}/{c}/{b}"]))
                if arm[2] is None]
        assert eng._autotune_candidates(eng._bucket(b)) == want, (algo, b)


def test_ann_refuses_reference(jax_out):
    est = _estimator(jax_out, "ann")
    mesh = make_local_mesh(2, "cpu")
    with pytest.raises(NotImplementedError, match="model-partition"):
        est.predict_batch_sharded_fn(mesh, strategy="reference")
    # auto never routes ANN to the partition it does not register
    eng = NonNeuralServeEngine(est, max_batch=16, device="cpu", mesh=mesh)
    eng.warmup_buckets(jax_out["X"].shape[1])
    assert "reference" not in set(eng.bucket_strategies.values())


def test_sharded_arm_registry_covers_every_hot_op():
    """Every one-device hot op owns a mesh-aware arm, the JAX registry's
    keys exactly."""
    assert tdispatch.sharded_registered() == jdispatch.sharded_registered()
    assert {(a, o) for a, o, _ in tdispatch.sharded_registered()} \
        == set(tdispatch.registered())
    with pytest.raises(KeyError):
        tdispatch.sharded("svm", "qp")
    with pytest.raises(KeyError):
        tdispatch.sharded("knn", "distance_topk", "single")
    assert tdispatch.sharded("knn", "distance_topk") is \
        tdispatch.sharded("knn", "distance_topk", "reference")
    assert tdispatch.DEFAULT_STRATEGY == jdispatch.DEFAULT_STRATEGY


def test_mesh_builders():
    """A local mesh puts every shard on its one device; the card meshes
    raise naming the count where too few cards are visible; the
    production config is the JAX package's."""
    mesh = make_local_mesh(3, "cpu")
    assert mesh.shape == {"data": 3} and mesh.size == 3
    assert mesh.shard_devices("data") == [torch.device("cpu")] * 3
    with pytest.raises(KeyError):
        mesh.shard_devices("model")
    two = tmesh._mk((2, 2), ("data", "model"), devices=["cpu"] * 4)
    assert two.shape == {"data": 2, "model": 2}
    assert len(two.shard_devices("model")) == 2
    n = len(tmesh.visible_cards())
    with pytest.raises(RuntimeError, match=f"needs {n + 1} devices, only "
                       f"{n} visible"):
        tmesh._mk((n + 1,), ("data",))
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        tmesh.make_mesh_from_config(tmesh.mesh_config())
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        tmesh.make_production_mesh(multi_pod=True)
    for multi in (False, True):
        got = tmesh.mesh_config(multi_pod=multi)
        want = JaxMeshConfig(data=16, model=16, pods=2 if multi else 1)
        assert isinstance(got, MeshConfig)
        assert (got.shape, got.axis_names, got.dp_axes, got.n_devices) == \
            (want.shape, want.axis_names, want.dp_axes, want.n_devices)


def test_estimator_mesh_contracts(jax_out):
    """``fit_sharded`` records its mesh; a mesh that does not hold the
    estimator's device refuses; the sharded fn needs a mesh."""
    X, y = jax_out["X"], jax_out["y"]
    mesh = make_local_mesh(2, "cpu")
    est = port_est.make_fitted("kmeans", X, y, n_groups=3, device="cpu",
                               mesh=mesh)
    assert est.mesh is mesh and est.mesh_axis == "data"
    eng = NonNeuralServeEngine(est, max_batch=8, device="cpu", sharded=True)
    assert eng.mesh is mesh and eng.n_shards == 2
    plain = port_est.make_fitted("kmeans", X, y, n_groups=3, device="cpu")
    with pytest.raises(ValueError, match="fit_sharded first"):
        plain.predict_batch_sharded_fn()
    with pytest.raises(ValueError, match="mesh's devices"):
        plain.predict_batch_sharded_fn(make_local_mesh(2, "meta"))
    with pytest.raises(ValueError, match="mesh's devices"):
        NonNeuralServeEngine(plain, device="cpu",
                             mesh=make_local_mesh(2, "meta"))
    with pytest.raises(ValueError, match="strategy="):
        plain.predict_batch_sharded_fn(mesh, strategy="rows")
    assert plain.predict_batch_sharded_fn(mesh, strategy="single") \
        is not None
