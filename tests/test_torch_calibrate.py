"""The port's calibration loop (``repro_torch.core.calibrate`` and
``precision.CostModel``) against the JAX package's.

Mirrors the fit, artifact, resolve and env tests of
``tests/test_calibrate.py``: the same seeded rows go through both
``fit_calibration``s and the results compare at ``rtol=1e-12`` (one numpy
arithmetic); a calibration file written under ``tmp_path`` (by the JAX
package's writer, and as plain JSON) loads into equal cost models; a
calibrated model flips the port's ``dispatch.resolve`` as it flips the
JAX package's, and is inert when absent.  Reading rows from benchmark
files (``collect_rows``) waits for the port's own benchmarks.
"""
import json

import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core import precision as jprec
from repro.kernels import dispatch as jdispatch
from repro_torch.core import calibrate as tcal
from repro_torch.core import precision as tprec
from repro_torch.kernels import dispatch as tdispatch

RTOL = 1e-12
KNN_SHAPE = {"N": 1024, "d": 32, "k": 8}


@pytest.fixture(autouse=True)
def clean_selection(monkeypatch):
    """No REPRO_BACKEND, and no cost model left behind in either
    package."""
    monkeypatch.delenv(tdispatch.ENV_VAR, raising=False)
    monkeypatch.delenv(tdispatch.CALIBRATION_ENV_VAR, raising=False)
    yield
    for d in (tdispatch, jdispatch):
        d.set_cost_model(None)
        d._ENV_CALIBRATION_LOADED = False


def _synthetic_rows(true_vec, tier="fused", path="fused", seed=None):
    """Rows whose measured_us comes from a known us-per-op vector over
    enough distinct shapes to constrain the refit (the JAX test's), with
    seeded multiplicative noise when ``seed`` is given."""
    rows = []
    shapes = [("knn", {"N": n, "d": d, "k": 4})
              for n, d in [(200, 8), (400, 16), (800, 24), (1600, 32)]] + \
        [("gnb", {"C": c, "d": d}) for c, d in [(3, 8), (5, 16), (10, 32)]] + \
        [("kmeans", {"K": k, "d": d}) for k, d in [(2, 8), (4, 16), (8, 32)]]
    rng = np.random.default_rng(seed) if seed is not None else None
    for i, (algo, shape) in enumerate(shapes):
        us = float(tprec.serve_census(algo, shape).vector() @ true_vec)
        if rng is not None:
            us *= float(rng.uniform(0.7, 1.4))
        rows.append({"tier": tier, "algorithm": algo,
                     "op": tdispatch.HOT_OPS[algo],
                     "bucket": 8 * (1 + i % 3), "path": path,
                     "measured_us": us, "shape": shape})
    return rows


def _mixed_rows(seed):
    """Seeded rows over three tiers, two paths at one bucket."""
    base = tprec.BACKENDS["fpu"].vector() * 0.017
    return (_synthetic_rows(base, seed=seed)
            + _synthetic_rows(base * 3.0, tier="fp32-ref", path="ref",
                              seed=seed + 1)
            + _synthetic_rows(base * 0.5, tier="int8", path="quant",
                              seed=seed + 2)[:5])


def same_fit(t, j):
    assert [(r["tier"], r["algorithm"], r["op"], r["bucket"], r["path"])
            for r in t["results"]] == \
        [(r["tier"], r["algorithm"], r["op"], r["bucket"], r["path"])
         for r in j["results"]]
    for key in ("measured_us", "predicted_us", "rel_err"):
        np.testing.assert_allclose([r[key] for r in t["results"]],
                                   [r[key] for r in j["results"]],
                                   rtol=RTOL, atol=0)
    assert t["vectors"].keys() == j["vectors"].keys()
    for tier, vec in t["vectors"].items():
        assert vec.keys() == j["vectors"][tier].keys()
        np.testing.assert_allclose(list(vec.values()),
                                   list(j["vectors"][tier].values()),
                                   rtol=RTOL, atol=1e-300)
    ts, js = t["summary"], j["summary"]
    assert ts["n_rows"] == js["n_rows"]
    assert ts["tiers"].keys() == js["tiers"].keys()
    for tier, s in ts["tiers"].items():
        assert s["n"] == js["tiers"][tier]["n"]
        np.testing.assert_allclose(s["median_abs_rel_err"],
                                   js["tiers"][tier]["median_abs_rel_err"],
                                   rtol=RTOL)
    if js["us_per_cycle"] is None:
        assert ts["us_per_cycle"] is None
    else:
        np.testing.assert_allclose(ts["us_per_cycle"], js["us_per_cycle"],
                                   rtol=RTOL)


def same_model(t, j):
    assert (t.source, t.calibrated) == (j.source, j.calibrated)
    assert t.vectors.keys() == j.vectors.keys()
    for tier in t.vectors:
        np.testing.assert_allclose(t.vectors[tier], j.vectors[tier],
                                   rtol=RTOL, atol=1e-300)
    assert t.launch_us == pytest.approx(j.launch_us, rel=RTOL)
    assert t.query_us == j.query_us
    assert t.path_us == j.path_us
    assert t.us_per_cycle == j.us_per_cycle


# ------------------------------------------------------------------ fits

def test_fit_tier_recovers_synthetic_vector_predictions():
    true_vec = tprec.BACKENDS["fpu"].vector() * 0.017
    rows = _synthetic_rows(true_vec)
    fitted, launch_us, pred = tcal.fit_tier(rows, iters=2000)
    y = np.array([r["measured_us"] for r in rows])
    rel = np.abs(pred - y) / y
    assert np.median(rel) < 0.05, rel
    assert launch_us < 0.05 * float(y.min()) * 8 + 1e-6
    jfit, jlaunch, jpred = jcal.fit_tier(rows, iters=2000)
    np.testing.assert_allclose(fitted.vector(), jfit.vector(), rtol=RTOL,
                               atol=1e-300)
    np.testing.assert_allclose(launch_us, jlaunch, rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(pred, jpred, rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_tier_with_polish_matches_jax(seed):
    """Noisy rows whose least-squares solution goes negative take the
    multiplicative polish: the same result in both packages."""
    rows = _synthetic_rows(tprec.BACKENDS["rvfplib"].vector() * 1e-3,
                           seed=seed)
    t = tcal.fit_tier(rows, iters=300)
    j = jcal.fit_tier(rows, iters=300)
    np.testing.assert_allclose(t[0].vector(), j[0].vector(), rtol=RTOL,
                               atol=1e-300)
    np.testing.assert_allclose(t[1], j[1], rtol=RTOL, atol=1e-300)
    np.testing.assert_allclose(t[2], j[2], rtol=RTOL)


def test_fit_calibration_summary_and_vectors():
    true_vec = tprec.BACKENDS["fpu"].vector() * 0.017
    rows = _synthetic_rows(true_vec)
    fit = tcal.fit_calibration(rows, iters=2000)
    assert set(fit["vectors"]) == {"fused"}
    assert set(fit["vectors"]["fused"]) == set(tprec.OPS) | {"launch_us"}
    ts = fit["summary"]["tiers"]["fused"]
    assert ts["n"] == len(rows)
    assert ts["median_abs_rel_err"] < 0.05
    assert fit["summary"]["us_per_cycle"] == pytest.approx(0.017, rel=0.05)
    same_fit(fit, jcal.fit_calibration(rows, iters=2000))


@pytest.mark.parametrize("seed", [0, 5])
def test_fit_calibration_matches_jax_over_tiers(seed):
    rows = _mixed_rows(seed)
    fit = tcal.fit_calibration(rows, iters=400)
    assert set(fit["vectors"]) == {"fp32-ref", "fused", "int8"}
    same_fit(fit, jcal.fit_calibration(rows, iters=400))


def test_single_row_tier_keeps_scaled_seed():
    rows = _synthetic_rows(tprec.BACKENDS["fpu"].vector() * 0.5)[:1]
    fitted, launch_us, pred = tcal.fit_tier(rows)
    assert launch_us == 0.0
    assert pred[0] == pytest.approx(rows[0]["measured_us"], rel=1e-6)
    jfit, _, jpred = jcal.fit_tier(rows)
    np.testing.assert_allclose(fitted.vector(), jfit.vector(), rtol=RTOL)


# ------------------------------------------------------------- artifacts

def test_calibration_artifact_roundtrip(tmp_path):
    """A file written by the JAX package's schema-checked writer loads
    into the same cost model in both packages."""
    report = jcal._report()
    rows = _synthetic_rows(tprec.BACKENDS["fpu"].vector() * 0.01)
    fit = tcal.fit_calibration(rows, iters=500)
    path = tmp_path / "CALIBRATION.json"
    report.write_calibration_entry(fit["results"], vectors=fit["vectors"],
                                   summary=fit["summary"], path=path)
    cm = tprec.CostModel.from_calibration(str(path))
    assert cm.calibrated and cm.source == "calibrated"
    assert cm.us_per_cycle == pytest.approx(fit["summary"]["us_per_cycle"])
    assert cm.serve_us("knn", tier="fused", bucket=8) > 0
    same_model(cm, jprec.CostModel.from_calibration(str(path)))


def test_entry_dict_and_plain_file_load_alike(tmp_path):
    """``from_calibration`` takes an entry dict or a file of
    ``{"entries": [...]}`` whose latest entry wins."""
    old = tcal.fit_calibration(_mixed_rows(3), iters=200)
    new = tcal.fit_calibration(_mixed_rows(4), iters=200)
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps({"entries": [old, new]}))
    from_file = tprec.CostModel.from_calibration(str(path))
    same_model(from_file, tprec.CostModel.from_calibration(new))
    same_model(from_file, jprec.CostModel.from_calibration(new))
    for algo in ("knn", "gnb", "kmeans"):
        for tier in ("fused", "fp32-ref", "int8", "bf16"):
            for b in (1, 8, 16, 1000):
                assert from_file.serve_us(algo, tier=tier, bucket=b) == \
                    jprec.CostModel.from_calibration(new).serve_us(
                        algo, tier=tier, bucket=b)
        for b in (None, 1, 8, 24, 512):
            assert from_file.preferred_path(algo, bucket=b) == \
                jprec.CostModel.from_calibration(new).preferred_path(
                    algo, bucket=b)


@pytest.mark.parametrize("algo", ["knn", "gnb", "kmeans"])
def test_calibrated_strategy_costs_match_jax(algo):
    entry = tcal.fit_calibration(_mixed_rows(7), iters=200)
    tcm = tprec.CostModel.from_calibration(entry)
    jcm = jprec.CostModel.from_calibration(entry)
    shape = {"knn": KNN_SHAPE, "gnb": {"C": 10, "d": 64},
             "kmeans": {"K": 8, "d": 21}}[algo]
    for bucket in (1, 8, 64):
        for n_shards in (1, 8):
            for quantized in (False, True):
                t = tcm.strategy_costs(algo, bucket=bucket,
                                       n_shards=n_shards, shape=shape,
                                       quantized=quantized)
                j = jcm.strategy_costs(algo, bucket=bucket,
                                       n_shards=n_shards, shape=shape,
                                       quantized=quantized)
                assert t.keys() == j.keys()
                for s in t:
                    np.testing.assert_allclose(
                        [t[s].compute, t[s].overhead],
                        [j[s].compute, j[s].overhead], rtol=RTOL)
                assert tprec.pick_strategy(t) == jprec.pick_strategy(j)


# ------------------------------------------------------- decision flips

def _flip_model(ref_fast=True, fast_path="ref", slow_path="fused",
                bucket=32):
    """A calibrated model whose fp32 rows at ``bucket`` say ``fast_path``
    beats ``slow_path`` (or the reverse)."""
    fast, slow = (50.0, 200.0)
    tiers = {"ref": "fp32-ref"}
    entry = {"results": [
        {"tier": tiers.get(fast_path, "fused"), "algorithm": "knn",
         "op": "distance_topk", "bucket": bucket, "path": fast_path,
         "measured_us": fast if ref_fast else slow,
         "predicted_us": 0.0, "rel_err": 0.0},
        {"tier": tiers.get(slow_path, "fused"), "algorithm": "knn",
         "op": "distance_topk", "bucket": bucket, "path": slow_path,
         "measured_us": slow if ref_fast else fast,
         "predicted_us": 0.0, "rel_err": 0.0},
    ]}
    return entry


def test_preferred_path_flips_resolve():
    shape = dict(N=4096, d=32, Q=32, k=8)
    for d, prec in ((tdispatch, tprec), (jdispatch, jprec)):
        assert d.resolve("knn", "distance_topk", **shape).name == "fused"
        cm = prec.CostModel.from_calibration(_flip_model(ref_fast=True))
        assert cm.preferred_path("knn", bucket=32) == "ref"
        assert d.resolve("knn", "distance_topk", cost_model=cm,
                         **shape).name == "ref"
        cm2 = prec.CostModel.from_calibration(_flip_model(ref_fast=False))
        assert d.resolve("knn", "distance_topk", cost_model=cm2,
                         **shape).name == "fused"


def test_blocked_preference_flips_resolve():
    """The card's own case: rows that time blocked B4 + B5 faster than
    fused B1 at a bucket route kNN there, for any k (the preference keys
    on (algorithm, bucket), as in the JAX package)."""
    cm = tprec.CostModel.from_calibration(_flip_model(
        fast_path="blocked", slow_path="fused", bucket=1024))
    for k in (4, 32):
        assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                                 N=1 << 20, d=21, Q=1024, k=k).name == \
            "blocked"
    # nearest measured bucket on a log scale: 256 is nearer 1024 than 1
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             N=1 << 20, d=21, Q=256, k=4).name == "blocked"


def test_preference_never_routes_to_an_arm_that_refuses_the_shape():
    """A preference for fused kNN does not reach k past B1's lists: the
    selector's blocked arm serves there."""
    cm = tprec.CostModel.from_calibration(_flip_model(
        fast_path="fused", slow_path="blocked", bucket=1024))
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             N=1 << 20, d=21, Q=1024, k=32).name == "fused"
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             N=1 << 20, d=21, Q=1024, k=64).name == "blocked"
    assert not tdispatch.arm_fits("knn", "distance_topk", "fused", k=33)
    assert tdispatch.arm_fits("knn", "distance_topk", "blocked", k=10**6)


def test_analytic_model_is_inert_in_resolve():
    shape = dict(N=4096, d=32, Q=32, k=8)
    cm = tprec.CostModel.analytic()
    assert not cm.calibrated
    assert cm.preferred_path("knn", bucket=32) is None
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             **shape).name == "fused"
    assert not tdispatch.active_cost_model().calibrated


def test_explicit_path_env_and_int8_outrank_calibration(monkeypatch):
    shape = dict(N=4096, d=32, Q=32, k=8)
    cm = tprec.CostModel.from_calibration(_flip_model(ref_fast=True))
    assert tdispatch.resolve("knn", "distance_topk", path="fused",
                             cost_model=cm, **shape).name == "fused"
    int8 = tdispatch.get_policy("int8")
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             policy=int8, **shape).name == \
        jdispatch.resolve("knn", "distance_topk", policy=jdispatch.get_policy(
            "int8"), cost_model=jprec.CostModel.from_calibration(
                _flip_model(ref_fast=True)), **shape).name == "fused"
    monkeypatch.setenv(tdispatch.ENV_VAR, "blocked")
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             **shape).name == "blocked"
    # an env arm the op lacks falls through to the calibration
    ann = {"results": [
        {"tier": t, "algorithm": "ann", "op": "adc_topk", "bucket": 8,
         "path": p, "measured_us": us}
        for t, p, us in (("fp32-ref", "ref", 1.0), ("fused", "fused", 2.0))]}
    ann_kw = dict(Q=8, L=64, m=4, n_codes=16, k=4)
    for d, prec in ((tdispatch, tprec), (jdispatch, jprec)):
        assert d.resolve("ann", "adc_topk", cost_model=prec.CostModel
                         .from_calibration(ann), **ann_kw).name == "ref"
    monkeypatch.setenv(tdispatch.ENV_VAR, "quant")
    assert tdispatch.resolve("kmeans", "distance_argmin", N=32, d=4,
                             K=3).name == "quant"


def test_quant_is_never_preferred():
    entry = {"results": [
        {"tier": "fused", "algorithm": "kmeans", "op": "distance_argmin",
         "bucket": 8, "path": "quant", "measured_us": 1.0},
        {"tier": "fused", "algorithm": "kmeans", "op": "distance_argmin",
         "bucket": 8, "path": "fused", "measured_us": 9.0}]}
    cm = tprec.CostModel.from_calibration(entry)
    assert cm.preferred_path("kmeans", bucket=8) == "quant"
    assert tdispatch.resolve("kmeans", "distance_argmin", cost_model=cm,
                             N=8, d=4, K=3).name == "fused"


def test_installed_model_steers_resolve():
    shape = dict(N=4096, d=32, Q=32, k=8)
    tdispatch.set_cost_model(tprec.CostModel.from_calibration(
        _flip_model(ref_fast=True)))
    assert tdispatch.resolve("knn", "distance_topk", **shape).name == "ref"
    tdispatch.set_cost_model(None)
    assert tdispatch.resolve("knn", "distance_topk", **shape).name == \
        "fused"


def test_env_var_loads_calibration(tmp_path, monkeypatch):
    rows = _synthetic_rows(tprec.BACKENDS["fpu"].vector() * 0.01)
    fit = tcal.fit_calibration(rows, iters=200)
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps({"entries": [fit]}))
    monkeypatch.setenv(tdispatch.CALIBRATION_ENV_VAR, str(path))
    tdispatch.set_cost_model(None)      # drop the cache, allow a reload
    tdispatch._ENV_CALIBRATION_LOADED = False
    cm = tdispatch.active_cost_model()
    assert cm.calibrated and cm.source == "calibrated"
    assert tdispatch.active_cost_model() is cm     # loaded once
    same_model(cm, jprec.CostModel.from_calibration(str(path)))


def test_serve_cli_loads_a_calibration(tmp_path, capsys):
    """``serve --calibration PATH`` installs the model before serving,
    and the run serves through the measured-fastest arm."""
    from repro_torch.launch import serve
    path = tmp_path / "calibration.json"
    entry = _flip_model(ref_fast=True, bucket=16)
    path.write_text(json.dumps({"entries": [entry]}))
    serve.main(["--device", "cpu", "--algo", "knn", "--batch", "16",
                "--requests", "32", "--train-size", "120",
                "--calibration", str(path)])
    out = capsys.readouterr().out
    assert f"[calibrate] cost model loaded from {path}" in out
    assert tdispatch.active_cost_model().calibrated
    assert tdispatch.resolve("knn", "distance_topk", N=120, d=21, Q=16,
                             k=4).name == "ref"


def test_ref_preference_is_cpu_only():
    """A calibration whose fastest arm is ``ref`` steers calls on the CPU
    (as in the JAX package) but never calls on a card: there the shape
    selector's kernel serves, and only an explicit ``path="ref"`` reaches
    the plain version.  ``blocked`` preferences steer both."""
    shape = dict(N=4096, d=32, Q=32, k=8)
    cm = tprec.CostModel.from_calibration(_flip_model(ref_fast=True))
    card = torch.device("cuda")
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             device="cpu", **shape).name == "ref"
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             device=card, **shape).name == "fused"
    assert tdispatch.resolve("knn", "distance_topk", cost_model=cm,
                             device=card, path="ref", **shape).name == "ref"
    blocked = tprec.CostModel.from_calibration(
        _flip_model(ref_fast=True, fast_path="blocked"))
    assert tdispatch.resolve("knn", "distance_topk", cost_model=blocked,
                             device=card, **shape).name == "blocked"
    assert not tdispatch.measured_arm_ok("ref", card)
    assert not tdispatch.measured_arm_ok("quant", "cpu")
    assert tdispatch.measured_arm_ok("ref", "cpu")
    assert tdispatch.measured_arm_ok("ref")
    assert tdispatch.measured_arm_ok("blocked", card)
