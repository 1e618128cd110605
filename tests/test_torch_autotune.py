"""``warmup(autotune=True)`` in the port against the JAX package's: the
measured arm choice at warmup (paper §5.2 profile-then-optimize).

Mirrors ``tests/test_autotune.py``.  Both engines serve the same fit (the
JAX package's params carried across with ``repro_torch.convert``), both
``_measure`` seams are scripted with the same timings, and both pick the
same winner ``(strategy, path)``.  The port's candidates are the JAX
package's without its ``bn`` arms (a Pallas row-block size the CUDA
kernels do not have); an explicit ``path=``, ``REPRO_BACKEND`` and the
int8 policy collapse the path axis in both; ``bucket_launches ⊆ warmed``
holds after autotuned serving, and the tuned classify equals the JAX
engine's (classes exactly, float aux at the fp32 bar) and the port's
``predict_batch``.  On a card the port never times or routes to ``ref``
(the JAX package's candidates keep it); on the CPU the lists agree.
The JAX test's ``test_scripted_bn_winner`` has no counterpart.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.core import estimator as jest
from repro.kernels import dispatch as jdispatch
from repro.serving import NonNeuralServeEngine as JaxEngine
from repro_torch import convert
from repro_torch.core import estimator as port_est
from repro_torch.data.datasets import class_blobs
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import serve as tserve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.serving import NonNeuralServeEngine, TunedArm

ALGOS = ("knn", "kmeans", "gnb", "gmm", "rf", "ann")


@pytest.fixture(autouse=True)
def no_backend_env(monkeypatch):
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)


@pytest.fixture(scope="module")
def blobs():
    return class_blobs(n=240, d=16, n_class=3, seed=0)


_FITS = {}


def _fits(algo, X, y, **kw):
    """One JAX fit and the port's estimator over its params."""
    key = (algo, tuple(sorted(kw.items())))
    if key not in _FITS:
        extra = dict(n_cells=8, pq_m=4, n_codes=16) if algo == "ann" else {}
        jfit = jest.make_fitted(algo, X, y, n_groups=3, **extra, **kw)
        params = convert.params_from_numpy(
            algo, jax.tree.map(np.asarray, jfit.params), device="cpu")
        tkw = {a: getattr(jfit, a) for a in ("k", "nprobe", "refine")
               if hasattr(jfit, a) and algo in ("knn", "ann")}
        _FITS[key] = (jfit, port_est.ESTIMATORS[algo].from_params(
            params, device="cpu", **tkw))
    return _FITS[key]


def _engines(X, y, algo="knn", *, path=None, policy=None, max_batch=64,
             **kw):
    jfit, tfit = _fits(algo, X, y, **kw)
    if path is not None:            # copies: the fits are shared
        jfit, tfit = copy.copy(jfit), copy.copy(tfit)
        jfit.path = tfit.path = path
    jeng = JaxEngine(jfit, max_batch=max_batch, policy=policy)
    teng = NonNeuralServeEngine(tfit, max_batch=max_batch, device="cpu",
                                policy=policy)
    return jeng, teng


def _script(engine, pick):
    """Replace the timing seam: the arm matching ``pick`` measures fast,
    everything else slow.  Relies on ``_autotune_bucket`` iterating
    ``_autotune_candidates`` in order."""
    state = {"cands": None, "i": 0}

    def fake(fn, params, chunk, iters=3):
        arm = state["cands"][state["i"]]
        state["i"] += 1
        return 5.0 if pick(arm) else 50.0

    orig = engine._autotune_candidates

    def candidates(bucket):
        state["cands"] = orig(bucket)
        state["i"] = 0
        return state["cands"]

    engine._autotune_candidates = candidates
    engine._measure = fake


def _winner(arm):
    return arm.strategy, arm.path


def _classes_equal(teng, jeng, Q):
    """The tuned classify against the JAX engine's: classes exactly,
    integer aux exactly, float aux at the fp32 bar (rtol = 1e-5, atol
    1e-5 scaled to the largest term)."""
    got = teng.classify(Q)
    want = jeng.classify(Q)
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    ga, wa = got.aux.numpy(), np.asarray(want.aux)
    assert ga.shape == wa.shape
    if np.issubdtype(wa.dtype, np.floating):
        np.testing.assert_allclose(
            ga, wa, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(wa).max())))
    else:
        np.testing.assert_array_equal(ga, wa)
    tc, _ = teng.estimator.predict_batch(Q)
    assert torch.equal(got.classes, tc)
    assert set(teng.bucket_launches) <= teng.warmed
    return got


def test_scripted_flip_routes_through_ref(blobs):
    X, y = blobs
    jeng, teng = _engines(X, y, "knn")
    for e in (jeng, teng):
        _script(e, lambda arm: arm[1] == "ref")
        e.warmup(X[:32], autotune=True)
    arm, jarm = teng.tuned[32], jeng.tuned[32]
    assert _winner(arm) == _winner(jarm) == ("single", "ref")
    assert arm.static_path == jarm.static_path == "fused"
    assert arm.differs and jarm.differs
    assert arm.us < arm.static_us
    assert arm.bn is None
    assert teng._choice(32) == ("single", "ref", None)
    _classes_equal(teng, jeng, X[:32])
    assert teng.bucket_launches == {32: 1}


def test_scripted_static_winner_does_not_differ(blobs):
    X, y = blobs
    jeng, teng = _engines(X, y, "knn")
    for e in (jeng, teng):
        _script(e, lambda arm, e=e: arm == (e._route(32), None, None))
        e.warmup(X[:32], autotune=True)
    for arm in (teng.tuned[32], jeng.tuned[32]):
        assert arm.path is None and arm.bn is None
        assert not arm.differs
        assert arm.us == arm.static_us


def _script_us(engine, us_of):
    """Replace the timing seam with ``us_of(arm)`` for every candidate
    arm, in ``_autotune_candidates`` order."""
    state = {"cands": None, "i": 0}

    def fake(fn, params, chunk, iters=3):
        arm = state["cands"][state["i"]]
        state["i"] += 1
        return us_of(arm)

    orig = engine._autotune_candidates

    def candidates(bucket):
        state["cands"] = orig(bucket)
        state["i"] = 0
        return state["cands"]

    engine._autotune_candidates = candidates
    engine._measure = fake


@pytest.mark.parametrize("ref_us,displaces", [
    (49.0, False), (46.0, False), (45.5, False), (45.0, True),
    (44.0, True), (5.0, True)])
def test_margin_guards_the_static_arm(blobs, ref_us, displaces):
    """An arm other than the static arm (50 us) displaces it only where
    it times faster by ``AUTOTUNE_MARGIN`` (10%): ``ref_us * 1.1 < 50``.
    The JAX engine has no margin and takes ``ref`` whenever it is the
    least: that difference is deliberate."""
    from repro_torch.serving import engine as tengine
    assert tengine.AUTOTUNE_MARGIN == 0.10
    X, y = blobs
    jeng, teng = _engines(X, y, "knn")

    def us_of(arm):
        return {None: 50.0, "fused": 50.0, "ref": ref_us}.get(arm[1], 60.0)

    for e in (jeng, teng):
        _script_us(e, us_of)
        e.warmup(X[:32], autotune=True)
    arm, jarm = teng.tuned[32], jeng.tuned[32]
    assert _winner(jarm) == ("single", "ref") and jarm.differs
    assert arm.static_path == jarm.static_path == "fused"
    assert arm.static_us == 50.0
    assert {c[1]: c[3] for c in arm.candidates}["ref"] == ref_us
    if displaces:
        assert _winner(arm) == ("single", "ref") and arm.differs
        assert arm.us == ref_us
        assert teng._choice(32) == ("single", "ref", None)
    else:
        assert not arm.differs and arm.us == arm.static_us
        assert teng._choice(32)[1] in (None, "fused")
    got = teng.classify(X[:32])
    assert torch.equal(got.classes, teng.estimator.predict_batch(X[:32])[0])
    assert teng.bucket_launches == {32: 1}


def _jax_candidates_without_bn(jeng, bucket):
    return [c for c in jeng._autotune_candidates(bucket) if c[2] is None]


@pytest.mark.parametrize("algo", ALGOS)
def test_candidates_are_jax_without_bn(algo, blobs):
    X, y = blobs
    jeng, teng = _engines(X, y, algo)
    regd = tdispatch.registered()[(algo, tdispatch.HOT_OPS[algo])]
    for bucket in (1, 8, 64):
        cands = teng._autotune_candidates(bucket)
        assert cands == _jax_candidates_without_bn(jeng, bucket)
        assert cands[0] == ("single", None, None)     # the static arm
        for s, p, bn in cands:
            assert s == "single" and bn is None
            assert p is None or p in regd
            assert p != "quant"
        assert teng._static_arm(bucket) == jeng._static_arm(bucket)


@pytest.mark.parametrize("algo", ALGOS)
def test_scripted_winner_matches_jax(algo, blobs):
    """Each registered arm, scripted fastest, wins in both packages, and
    the port's tuned classify equals the JAX package's for every
    algorithm."""
    X, y = blobs
    for want in tdispatch.registered()[(algo, tdispatch.HOT_OPS[algo])]:
        if want == "quant":
            continue
        jeng, teng = _engines(X, y, algo, max_batch=16)
        for e in (jeng, teng):
            _script(e, lambda arm, want=want: arm[1] == want)
            e.warmup_buckets(X.shape[1], autotune=True)
        assert sorted(teng.tuned) == sorted(jeng.tuned) == \
            sorted(teng.warmed) == [1, 2, 4, 8, 16]
        for b in teng.tuned:
            assert _winner(teng.tuned[b]) == _winner(jeng.tuned[b]) == \
                ("single", want)
            assert teng.tuned[b].static_path == jeng.tuned[b].static_path
        _classes_equal(teng, jeng, X[:21])


def test_explicit_path_collapses_path_axis(blobs):
    X, y = blobs
    jeng, teng = _engines(X, y, "knn", path="ref")
    cands = teng._autotune_candidates(32)
    assert cands == _jax_candidates_without_bn(jeng, 32)
    assert all(p is None for _, p, _ in cands)
    for e in (jeng, teng):
        e.warmup(X[:32], autotune=True)
    for arm in (teng.tuned[32], jeng.tuned[32]):
        assert arm.path is None
        assert arm.static_path == "ref"


def test_env_override_collapses_path_axis(blobs, monkeypatch):
    X, y = blobs
    jeng, teng = _engines(X, y, "knn")
    monkeypatch.setenv(tdispatch.ENV_VAR, "ref")
    assert tdispatch.ENV_VAR == jdispatch.ENV_VAR
    cands = teng._autotune_candidates(32)
    assert all(p is None for _, p, _ in cands)
    assert cands == _jax_candidates_without_bn(jeng, 32)
    assert teng._static_arm(32) == jeng._static_arm(32) == ("single", "ref")


@pytest.mark.parametrize("algo", ["knn", "kmeans", "gnb"])
def test_quantized_engine_never_explores_paths(algo, blobs):
    X, y = blobs
    jeng, teng = _engines(X, y, algo, policy="int8")
    assert teng._quantized and jeng._quantized
    cands = teng._autotune_candidates(32)
    assert all(p is None for _, p, _ in cands)
    assert cands == _jax_candidates_without_bn(jeng, 32)
    assert teng._static_arm(32)[1] == jeng._static_arm(32)[1] == "quant"
    teng.warmup_buckets(X.shape[1], autotune=True)
    assert all(a.path is None for a in teng.tuned.values())
    got = teng.classify(X[:40])
    assert torch.equal(got.classes, teng.estimator.predict_batch(X[:40])[0])
    assert set(teng.bucket_launches) <= teng.warmed


def test_real_autotune_end_to_end(blobs):
    """No scripting: really time the arms; the tuned winner never loses to
    the static arm it was measured against."""
    X, y = blobs
    _, teng = _engines(X, y, "knn")
    teng.warmup(X[:32], autotune=True)
    arm = teng.tuned.get(32)
    assert isinstance(arm, TunedArm)
    assert arm.us <= arm.static_us * 1.001
    assert len(arm.candidates) >= 3        # static + real alternatives
    assert {c[1] for c in arm.candidates} == {None, "fused", "blocked",
                                              "ref"}
    res = teng.classify(X[:40])            # 32 + trailing 8 bucket
    assert set(teng.bucket_launches) <= teng.warmed
    want, _ = teng.estimator.predict_batch(X[:40])
    assert torch.equal(res.classes, want)


def test_arm_past_b1_lists_is_not_timed(blobs):
    """At k > 32 fused kNN refuses the shape: it stays a candidate, as in
    the JAX package's list, but is never timed or chosen."""
    X, y = blobs
    est = port_est.make_fitted("knn", X, y, n_groups=3, k=40, device="cpu")
    teng = NonNeuralServeEngine(est, max_batch=16, device="cpu")
    assert ("single", "fused", None) in teng._autotune_candidates(16)
    _script(teng, lambda arm: arm[1] == "fused")
    teng.warmup_buckets(X.shape[1], autotune=True)
    for arm in teng.tuned.values():
        assert arm.static_path == "blocked"
        assert "fused" not in {c[1] for c in arm.candidates}
        assert arm.path != "fused"
    res = teng.classify(X[:20])
    assert torch.equal(res.classes, est.predict_batch(X[:20])[0])


def test_warmup_and_timing_never_count_as_launches(blobs):
    X, y = blobs
    _, teng = _engines(X, y, "gnb", max_batch=8)
    teng.warmup_buckets(X.shape[1], autotune=True)
    assert teng.bucket_launches == {}
    assert sorted(teng.warmed) == sorted(teng.tuned) == [1, 2, 4, 8]
    teng.classify(X[:11])
    assert teng.bucket_launches == {8: 1, 4: 1}


def test_warmup_without_autotune_leaves_tuned_empty(blobs):
    X, y = blobs
    _, teng = _engines(X, y, "gnb")
    teng.warmup(X[:32])
    assert teng.tuned == {}
    s, p, bn = teng._choice(32)
    assert (p, bn) == (None, None)


def test_fn_for_copies_the_estimator_per_arm(blobs):
    """A per-arm executor closes over a shallow copy with ``.path`` set;
    the engine's estimator keeps its own path, and each arm is built
    once."""
    X, y = blobs
    _, teng = _engines(X, y, "knn")
    fn = teng._fn_for("single", "ref")
    assert teng._fn_for("single", "ref") is fn
    assert teng._fn_for("single") is teng._fn
    assert teng.estimator.path is None
    c_ref, _ = fn(teng.estimator.params, torch.as_tensor(X[:8]))
    assert torch.equal(c_ref, teng.estimator.predict_batch(X[:8])[0])
    # the query arm builds on a mesh engine and agrees with single
    meng = NonNeuralServeEngine(teng.estimator, max_batch=64, device="cpu",
                                mesh=make_local_mesh(2, "cpu"))
    qfn = meng._fn_for("query")
    assert meng._fn_for("query") is qfn
    Xq = torch.as_tensor(X[:9])
    c_q, a_q = qfn(meng._params_for("query"), Xq)
    c_s, a_s = meng._fn_for("single")(meng._params_for("single"), Xq)
    assert torch.equal(c_q, c_s) and torch.equal(a_q, a_s)
    with pytest.raises(NotImplementedError, match="row-block"):
        teng._fn_for("single", "fused", 64)


def test_serve_cli_autotune(capsys):
    """``serve --autotune`` prints the JAX CLI's tuned-arms line, one
    stream too."""
    tserve.main(["--device", "cpu", "--algo", "knn", "--batch", "16",
                 "--requests", "40", "--train-size", "120", "--autotune"])
    out = capsys.readouterr().out
    assert "[autotune] tuned arms (* = differs from static): 8->single/" \
        in out
    assert "16->single/" in out and "[serve] algo=knn" in out
    tserve.main(["--device", "cpu", "--algo", "gnb", "--batch", "8",
                 "--train-size", "120", "--stream", "--rate", "4",
                 "--ticks", "12", "--autotune"])
    out = capsys.readouterr().out
    assert "[autotune] tuned arms" in out and "1->single/" in out
    assert "[stream] served" in out


@pytest.mark.parametrize("algo", ALGOS)
def test_card_engine_never_times_ref(algo, blobs):
    """On a card the candidates are the CPU list without ``ref``: the plain
    version serves no production launch there.  The engine is built on the
    CPU and only its device is switched: building the list touches no
    tensor."""
    X, y = blobs
    _, teng = _engines(X, y, algo)
    cpu = teng._autotune_candidates(8)
    teng.device = torch.device("cuda")
    card = teng._autotune_candidates(8)
    assert card == [c for c in cpu if c[1] != "ref"]
    assert card[0] == ("single", None, None)
    regd = tdispatch.registered()[(algo, tdispatch.HOT_OPS[algo])]
    if "ref" in regd:
        assert ("single", "ref", None) in cpu
