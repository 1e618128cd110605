"""The port's strategy dispatch (``dispatch.resolve_strategy``) against the
JAX package's: host arithmetic, no mesh and no device.

Mirrors ``tests/test_strategy_dispatch.py``'s eight tests on the port,
each also holding the port's decision to the JAX package's for the same
(algorithm, bucket, n_shards, shape, policy): the cost regimes (a small
bucket takes ``reference``, a large one ``query``, one shard ``single``),
the ``REPRO_SHARD_STRATEGY`` contract (a typo fails, an explicit
``strategy=`` outranks it), the quantized exclusion of ``reference``,
every algorithm's costs and the tie-break.  Then a grid over algorithms,
buckets, shard counts and policies, ``<dtype>@<backend>`` cost backends
included: ``resolve_strategy`` reads ``PrecisionPolicy.cost_backend``, so
a policy's backend moves the decision in both packages alike, and a
calibrated cost model moves it alike too.
"""
import pytest

from repro.core import precision as jprec
from repro.kernels import dispatch as jdispatch
from repro_torch.core import calibrate as tcal
from repro_torch.core import precision as tprec
from repro_torch.kernels import dispatch as tdispatch

KNN_SHAPE = {"N": 1024, "d": 32, "k": 8}
SHAPES = {"knn": KNN_SHAPE,
          "kmeans": {"K": 16, "d": 16},
          "gnb": {"C": 4, "d": 16},
          "gmm": {"K": 4, "d": 16},
          "rf": {"T": 16, "depth": 8, "C": 4},
          "ann": {"C": 64, "d": 21, "m": 4, "n_codes": 256, "L": 512,
                  "k": 4, "R": 0}}


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for d in (tdispatch, jdispatch):
        monkeypatch.delenv(d.STRATEGY_ENV_VAR, raising=False)
        monkeypatch.delenv(d.ENV_VAR, raising=False)
    yield
    for d in (tdispatch, jdispatch):
        d.set_cost_model(None)
        d._ENV_CALIBRATION_LOADED = False


def both(algo, policy=None, **kw):
    """The port's decision, checked equal to the JAX package's."""
    t = tdispatch.resolve_strategy(
        algo, policy=tdispatch.get_policy(policy) if policy else None, **kw)
    j = jdispatch.resolve_strategy(
        algo, policy=jdispatch.get_policy(policy) if policy else None, **kw)
    assert t == j, (algo, policy, kw, t, j)
    return t


def test_cost_regimes_small_bucket_reference_large_bucket_query():
    assert both("knn", bucket=1, n_shards=8, shape=KNN_SHAPE) == "reference"
    assert both("knn", bucket=1024, n_shards=8, shape=KNN_SHAPE) == "query"


def test_one_shard_resolves_single():
    assert both("knn", bucket=64, n_shards=1) == "single"
    costs = tprec.serve_strategy_costs("knn", bucket=64, n_shards=1,
                                       shape=KNN_SHAPE)
    assert set(costs) == {"single"}


def test_explicit_strategy_outranks_cost_model_and_env(monkeypatch):
    for d in (tdispatch, jdispatch):
        monkeypatch.setenv(d.STRATEGY_ENV_VAR, "reference")
    assert both("knn", bucket=1024, n_shards=8, strategy="query",
                shape=KNN_SHAPE) == "query"
    # "auto" defers to the env override, then the cost model
    assert both("knn", bucket=1024, n_shards=8, strategy="auto",
                shape=KNN_SHAPE) == "reference"


def test_env_override_and_typo(monkeypatch):
    monkeypatch.setenv(tdispatch.STRATEGY_ENV_VAR, "query")
    assert tdispatch.strategy_env_override() == "query"
    assert both("knn", bucket=1, n_shards=8, shape=KNN_SHAPE) == "query"
    monkeypatch.setenv(tdispatch.STRATEGY_ENV_VAR, "qeury")
    with pytest.raises(ValueError, match="REPRO_SHARD_STRATEGY"):
        tdispatch.strategy_env_override()
    with pytest.raises(ValueError, match="qeury"):
        tdispatch.resolve_strategy("knn", bucket=1, n_shards=8)
    monkeypatch.setenv(tdispatch.STRATEGY_ENV_VAR, "auto")
    assert tdispatch.strategy_env_override() is None


def test_explicit_strategy_typo_fails():
    with pytest.raises(ValueError, match="qry"):
        tdispatch.resolve_strategy("knn", bucket=4, n_shards=8,
                                   strategy="qry")


def test_quantized_excludes_reference():
    costs = tprec.serve_strategy_costs("knn", bucket=1, n_shards=8,
                                       shape=KNN_SHAPE, quantized=True)
    assert "reference" not in costs
    got = both("knn", bucket=1, n_shards=8, shape=KNN_SHAPE, quantized=True)
    assert got in ("single", "query")
    # the int8 policy implies the same exclusion without quantized=
    got = both("knn", "int8", bucket=1, n_shards=8, shape=KNN_SHAPE)
    assert got in ("single", "query")


def test_costs_cover_all_algorithms():
    for algo in ("knn", "kmeans", "gnb", "gmm", "rf"):
        costs = tprec.serve_strategy_costs(algo, bucket=64, n_shards=8,
                                           shape=SHAPES[algo])
        jcosts = jprec.serve_strategy_costs(algo, bucket=64, n_shards=8,
                                            shape=SHAPES[algo])
        assert set(costs) == set(jcosts) == {"single", "query", "reference"}
        assert tprec.pick_strategy(costs) == jprec.pick_strategy(jcosts)
        for s, c in costs.items():
            assert c.strategy == s
            assert c.total == c.compute + c.overhead > 0.0
            assert c.total == pytest.approx(jcosts[s].total, rel=1e-12)


def test_pick_strategy_tie_breaks_toward_simpler_partition():
    SC = tprec.StrategyCost
    costs = {"reference": SC("reference", 10.0, 0.0),
             "query": SC("query", 5.0, 5.0),
             "single": SC("single", 10.0, 0.0)}
    assert tprec.pick_strategy(costs) == "single"
    del costs["single"]
    assert tprec.pick_strategy(costs) == "query"


POLICIES = (None, "fp32", "bf16", "int8", "fp32@libgcc", "fp32@rvfplib",
            "fp32@cortex-m4", "bf16@libgcc")


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("algo", sorted(SHAPES))
def test_decisions_match_jax_over_a_grid(algo, policy):
    """Every (bucket, shard count) cell of a grid resolves alike; ANN
    never to the partition it does not register."""
    for bucket in (1, 3, 16, 64, 1024):
        for n_shards in (1, 2, 3, 8, 64):
            got = both(algo, policy, bucket=bucket, n_shards=n_shards,
                       shape=SHAPES[algo])
            if algo == "ann":
                assert got != "reference"


def test_cost_backend_moves_the_decision():
    """``PrecisionPolicy.cost_backend`` is read: some cell resolves
    differently under a soft-float backend than under the FPU's, in both
    packages alike."""
    flips = []
    for algo in sorted(SHAPES):
        for bucket in (1, 2, 4, 8, 16, 32, 64, 256, 1024):
            fpu = both(algo, "fp32", bucket=bucket, n_shards=8,
                       shape=SHAPES[algo])
            soft = both(algo, "fp32@libgcc", bucket=bucket, n_shards=8,
                        shape=SHAPES[algo])
            if fpu != soft:
                flips.append((algo, bucket, fpu, soft))
    assert flips


def test_calibrated_model_decides_alike():
    """A calibrated cost model (the same seeded rows fitted by the port)
    installed in both packages: the same strategy a cell."""
    base = tprec.BACKENDS["fpu"].vector() * 0.017
    rows = []
    for i, (algo, shape) in enumerate(
            [("knn", {"N": n, "d": d, "k": 4})
             for n, d in [(200, 8), (400, 16), (800, 24), (1600, 32)]]
            + [("gnb", {"C": c, "d": d}) for c, d in [(3, 8), (5, 16)]]):
        rows.append({"tier": "fused", "algorithm": algo,
                     "op": tdispatch.HOT_OPS[algo], "bucket": 8 * (1 + i % 3),
                     "path": "fused", "shape": shape,
                     "measured_us": float(
                         tprec.serve_census(algo, shape).vector() @ base)})
    entry = tcal.fit_calibration(rows, iters=200)
    tdispatch.set_cost_model(tprec.CostModel.from_calibration(entry))
    jdispatch.set_cost_model(jprec.CostModel.from_calibration(entry))
    for algo in ("knn", "gnb", "kmeans"):
        for bucket in (1, 8, 64, 1024):
            for policy in (None, "int8"):
                both(algo, policy, bucket=bucket, n_shards=8,
                     shape=SHAPES[algo])
