"""The port's FP-backend cost model and Amdahl analysis
(``repro_torch.core.precision``, ``repro_torch.core.amdahl``) against the
JAX package's and against the paper's own numbers.

Mirrors ``tests/test_precision.py`` on the port, then holds every census,
``predicted_cycles``, ``fit_backend``, ``relative_errors``,
``analyze_parallel``, ``speedup_table``, ``serve_census``, ``merge_elems``,
``tier_for``, ``serve_strategy_costs`` and the policies'
``estimated_cycles`` equal to the JAX package's at ``rtol=1e-12`` (both
are the same numpy arithmetic), and names and strategy picks exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import amdahl as jamdahl
from repro.core import precision as jprec
from repro.kernels import dispatch as jdispatch
from repro_torch.core import amdahl as tamdahl
from repro_torch.core import precision as tprec
from repro_torch.kernels import dispatch as tdispatch

RTOL = 1e-12

# Paper Table 2, single-core cycles
PAPER_T2 = {
    "libgcc": {"svm": 1.01e6, "lr": 1.04e6, "gnb": 22.1e6, "knn": 8.31e6},
    "rvfplib": {"svm": 594e3, "lr": 607e3, "gnb": 15.8e6, "knn": 4.38e6},
    "fpu": {"svm": 39.4e3, "lr": 40.5e3, "gnb": 778e3, "knn": 259e3},
}
FIT_KERNELS = ("svm", "lr", "gnb", "knn")

CENSUS_ARGS = {
    "census_svm": [{}, {"d": 21, "n_class": 3}],
    "census_lr": [{}, {"d": 64, "n_class": 7}],
    "census_gnb": [{}, {"d": 13, "n_class": 2}],
    "census_knn": [{}, {"n": 4096, "d": 32, "k": 8, "n_cores": 8}],
    "census_kmeans_iter": [{}, {"n": 500, "d": 8, "k": 5}],
    "census_rf": [{}, {"n_trees": 16, "depth": 8, "n_class": 3}],
    "census_gmm_iter": [{}, {"n": 300, "d": 16, "k": 4}],
}
SERVE_SHAPES = {
    "knn": [{}, {"N": 1 << 20, "d": 21, "k": 32}],
    "kmeans": [{}, {"K": 256, "d": 21}],
    "gnb": [{}, {"C": 10, "d": 784}],
    "gmm": [{}, {"K": 10, "d": 784}],
    "rf": [{}, {"T": 16, "depth": 8, "C": 3}],
    "ann": [{}, {"C": 64, "d": 21, "m": 4, "n_codes": 256, "L": 65536,
                 "k": 4, "R": 32}],
}


def close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)


def same_census(t, j):
    assert t.name == j.name
    assert t.parallel.keys() == j.parallel.keys()
    assert t.sequential.keys() == j.sequential.keys()
    for sec in ("total", "parallel", "sequential"):
        close(t.vector(sec), j.vector(sec))


# ------------------------------------------- the paper's numbers (mirror)

def test_amdahl_formula():
    assert tamdahl.amdahl_speedup(1.0, 8) == pytest.approx(8.0)
    assert tamdahl.amdahl_speedup(0.0, 8) == pytest.approx(1.0)
    assert tamdahl.amdahl_speedup(0.98, 8) == pytest.approx(7.02, rel=1e-2)


@pytest.mark.parametrize("backend", ["libgcc", "rvfplib", "fpu"])
def test_seed_model_within_3x(backend):
    """Literature-seeded costs land within 3x of every paper
    measurement."""
    for k in FIT_KERNELS:
        pred = tprec.predicted_cycles(tprec.PAPER_CENSUSES[k],
                                      tprec.BACKENDS[backend])
        meas = PAPER_T2[backend][k]
        assert 1 / 3 < pred / meas < 3, (backend, k, pred, meas)


@pytest.mark.parametrize("backend", ["libgcc", "rvfplib", "fpu"])
def test_fit_reduces_error_below_35pct(backend):
    censuses = [tprec.PAPER_CENSUSES[k] for k in FIT_KERNELS]
    measured = [PAPER_T2[backend][k] for k in FIT_KERNELS]
    fitted = tprec.fit_backend(censuses, measured, tprec.BACKENDS[backend])
    _, errs = tprec.relative_errors(censuses, measured, fitted)
    assert np.max(np.abs(errs)) < 0.35, errs


def test_parallel_speedups_in_paper_range():
    """Predicted 8-core speedups fall in the paper's 6.5-7.7x band for the
    compute-heavy kernels."""
    rows = tamdahl.speedup_table(
        {k: tprec.PAPER_CENSUSES[k] for k in FIT_KERNELS},
        {b: tprec.BACKENDS[b] for b in ("libgcc", "rvfplib", "fpu")},
        n_cores=8)
    for r in rows:
        assert r.theoretical_speedup <= 8.0
        if r.backend != "fpu":
            assert r.predicted_speedup > 5.5, r
        assert r.predicted_speedup <= r.theoretical_speedup + 1e-6


def test_fpu_speedup_band():
    """Paper: FPU-native is 25.6-32.1x faster than libgcc on GEMM/MS
    kernels."""
    for k in ("svm", "lr", "knn"):
        ratio = tprec.predicted_cycles(tprec.PAPER_CENSUSES[k],
                                       tprec.BACKENDS["libgcc"]) / \
            tprec.predicted_cycles(tprec.PAPER_CENSUSES[k],
                                   tprec.BACKENDS["fpu"])
        assert 15 < ratio < 60, (k, ratio)


# ---------------------------------------------------- parity with JAX

def test_tables_match_jax():
    assert tprec.OPS == jprec.OPS
    assert tprec.BACKENDS.keys() == jprec.BACKENDS.keys()
    for name, b in tprec.BACKENDS.items():
        assert dataclasses.astuple(b) == dataclasses.astuple(
            jprec.BACKENDS[name])
        close(b.vector(), jprec.BACKENDS[name].vector())
    assert tprec.PAPER_CENSUSES.keys() == jprec.PAPER_CENSUSES.keys()
    for name, c in tprec.PAPER_CENSUSES.items():
        same_census(c, jprec.PAPER_CENSUSES[name])
    assert tprec.CALIBRATION_TIERS == jprec.CALIBRATION_TIERS
    assert tprec.SHARD_STRATEGIES == jprec.SHARD_STRATEGIES
    assert tprec.SERVE_CENSUS_ALGOS == jprec.SERVE_CENSUS_ALGOS
    for const in ("SHARD_LAUNCH_CYCLES", "COLLECTIVE_LAUNCH_CYCLES",
                  "COLLECTIVE_ELEM_CYCLES"):
        assert getattr(tprec, const) == getattr(jprec, const)
    for const in ("BARRIER_CYCLES", "N_BARRIERS", "ICACHE_WARMUP",
                  "FPU_CONTENTION_SLOPE"):
        assert getattr(tamdahl, const) == getattr(jamdahl, const)


@pytest.mark.parametrize("fn", sorted(CENSUS_ARGS))
def test_census_functions_match_jax(fn):
    for kw in CENSUS_ARGS[fn]:
        same_census(getattr(tprec, fn)(**kw), getattr(jprec, fn)(**kw))


@pytest.mark.parametrize("section", ["total", "parallel", "sequential"])
def test_predicted_cycles_match_jax(section):
    for cname, c in tprec.PAPER_CENSUSES.items():
        for bname, b in tprec.BACKENDS.items():
            close(tprec.predicted_cycles(c, b, section),
                  jprec.predicted_cycles(jprec.PAPER_CENSUSES[cname],
                                         jprec.BACKENDS[bname], section))


@pytest.mark.parametrize("backend", ["libgcc", "rvfplib", "fpu"])
def test_fit_backend_and_errors_match_jax(backend):
    measured = [PAPER_T2[backend][k] for k in FIT_KERNELS]
    t = tprec.fit_backend([tprec.PAPER_CENSUSES[k] for k in FIT_KERNELS],
                          measured, tprec.BACKENDS[backend], iters=500)
    j = jprec.fit_backend([jprec.PAPER_CENSUSES[k] for k in FIT_KERNELS],
                          measured, jprec.BACKENDS[backend], iters=500)
    assert t.name == j.name == f"{backend}-fit"
    close(t.vector(), j.vector())
    tp, te = tprec.relative_errors(
        [tprec.PAPER_CENSUSES[k] for k in FIT_KERNELS], measured, t)
    jp, je = jprec.relative_errors(
        [jprec.PAPER_CENSUSES[k] for k in FIT_KERNELS], measured, j)
    close(tp, jp)
    close(te, je)


@pytest.mark.parametrize("n_cores", [1, 4, 8])
def test_analyze_parallel_and_speedup_table_match_jax(n_cores):
    iters = {"kmeans_iter": 7.0, "gmm_iter": 3.0}
    t = tamdahl.speedup_table(tprec.PAPER_CENSUSES, tprec.BACKENDS,
                              n_cores=n_cores, iters=iters)
    j = jamdahl.speedup_table(jprec.PAPER_CENSUSES, jprec.BACKENDS,
                              n_cores=n_cores, iters=iters)
    assert len(t) == len(j) == len(tprec.PAPER_CENSUSES) * len(
        tprec.BACKENDS)
    for a, b in zip(t, j):
        assert (a.kernel, a.backend) == (b.kernel, b.backend)
        close([a.seq_cycles_1, a.par_cycles_1, a.p, a.theoretical_speedup,
               a.predicted_speedup, a.predicted_cycles_n],
              [b.seq_cycles_1, b.par_cycles_1, b.p, b.theoretical_speedup,
               b.predicted_speedup, b.predicted_cycles_n])
    # a refit backend (its "-fit" name) takes the seed's warm-up cost
    fit = tprec.fit_backend([tprec.PAPER_CENSUSES[k] for k in FIT_KERNELS],
                            [PAPER_T2["fpu"][k] for k in FIT_KERNELS],
                            tprec.BACKENDS["fpu"], iters=50)
    jfit = jprec.BackendCosts(*dataclasses.astuple(fit))
    a = tamdahl.analyze_parallel(tprec.PAPER_CENSUSES["gnb"], fit, n_cores)
    b = jamdahl.analyze_parallel(jprec.PAPER_CENSUSES["gnb"], jfit, n_cores)
    close(a.predicted_cycles_n, b.predicted_cycles_n)


@pytest.mark.parametrize("algo", sorted(SERVE_SHAPES))
def test_serve_census_and_merge_elems_match_jax(algo):
    for shape in SERVE_SHAPES[algo]:
        same_census(tprec.serve_census(algo, shape),
                    jprec.serve_census(algo, shape))
        for c in (1, 2, 8, 6):
            close(tprec.merge_elems(algo, shape, c),
                  jprec.merge_elems(algo, shape, c))


def test_tier_for_matches_jax():
    for policy in ("fp32", "bf16", "int8", "fp32@rvfplib"):
        for path in (None, "fused", "blocked", "ref"):
            for quantized in (False, True):
                for grouped in (False, True):
                    kw = dict(quantized=quantized, path=path,
                              grouped=grouped)
                    assert tprec.tier_for(policy, **kw) == \
                        jprec.tier_for(policy, **kw)
    assert tprec.tier_for("fp32", path="ref") == "fp32-ref"
    assert tprec.tier_for("fp32", grouped=True) == "grouped"


@pytest.mark.parametrize("algo", sorted(SERVE_SHAPES))
def test_serve_strategy_costs_match_jax(algo):
    shape = SERVE_SHAPES[algo][1]
    for backend in (None, "libgcc", "int8"):
        for bucket in (1, 7, 1024):
            for n_shards in (1, 8):
                for quantized in (False, True):
                    kw = dict(bucket=bucket, n_shards=n_shards, shape=shape,
                              quantized=quantized)
                    t = tprec.serve_strategy_costs(
                        algo, backend=tprec.BACKENDS.get(backend), **kw)
                    j = jprec.serve_strategy_costs(
                        algo, backend=jprec.BACKENDS.get(backend), **kw)
                    assert t.keys() == j.keys()
                    for s in t:
                        close([t[s].compute, t[s].overhead, t[s].total],
                              [j[s].compute, j[s].overhead, j[s].total])
                    assert tprec.pick_strategy(t) == jprec.pick_strategy(j)


def test_policies_cost_like_jax():
    for name in ("fp32", "bf16", "int8", "fp32@libgcc", "fp32@rvfplib",
                 "bf16@cortex-m4", "int8@fpu"):
        tp, jp = tdispatch.get_policy(name), jdispatch.get_policy(name)
        assert (tp.name, tp.cost_backend, tp.quantized) == \
            (jp.name, jp.cost_backend, jp.quantized)
        for algo in sorted(tdispatch._CENSUS_KEY):
            for section in ("total", "parallel"):
                close(tp.estimated_cycles(algo, section),
                      jp.estimated_cycles(algo, section))
    assert tdispatch.get_policy("fp32@rvfplib").dtype == \
        tdispatch.get_policy("fp32").dtype
    with pytest.raises(KeyError, match="cost backend"):
        tdispatch.get_policy("fp32@nope")
    with pytest.raises(KeyError, match="unknown policy"):
        tdispatch.get_policy("fp16")


def test_unknown_algorithms_name_the_missing_census():
    with pytest.raises(ValueError, match="no serve census for 'dbscan'"):
        tprec.serve_census("dbscan", {})
    with pytest.raises(ValueError, match="no merge model for 'dbscan'"):
        tprec.merge_elems("dbscan", {})
    with pytest.raises(ValueError, match="serve census"):
        tprec.serve_strategy_costs("dbscan", bucket=8, n_shards=8)
    with pytest.raises(ValueError, match="no census for algorithm 'dbscan'"):
        tdispatch.get_policy("fp32").estimated_cycles("dbscan")


def test_serve_cli_takes_a_cost_backend(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--algo", "gnb", "--batch", "8",
                "--requests", "12", "--train-size", "90",
                "--policy", "fp32@rvfplib"])
    assert "policy=fp32@rvfplib" in capsys.readouterr().out
    with pytest.raises(KeyError, match="cost backend"):
        serve.main(["--device", "cpu", "--algo", "gnb",
                    "--policy", "fp32@x87"])
