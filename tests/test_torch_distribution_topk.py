"""The PyTorch port's two-phase primitives (paper §4.1-4.4) against the
JAX package's ``core/distribution.py`` and ``core/topk.py``.

Mirrors ``tests/test_core_distribution.py`` and ``tests/test_core_topk.py``
case for case, with fixed parametrised draws in place of Hypothesis.
Inputs come from a seeded numpy rng.  Tolerances:
  * ``two_phase_matvec``: |port − JAX| ≤ 1e-5 + 1e-5·Σ|W·x| per output
    (the partial sums associate in another order), and the same bar
    against the dense ``W @ x + b``;
  * ``chunk_bounds``, ``choose_partition``, pad and split,
    ``sorting_cost_model``: equal;
  * ``two_phase_reduce``: equal on integer-valued floats;
  * the top-k functions: indices exact (ties to the smallest index, the
    ``lax.top_k`` rule), values equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distribution as jdist
from repro.core import topk as jtopk
from repro_torch.core import distribution as tdist
from repro_torch.core import topk as ttopk

RTOL = ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ two-phase matvec

MATVEC = [(c, d, n, s) for s, (c, d) in enumerate(
    [(2, 2), (3, 21), (10, 784), (17, 130), (5, 7), (16, 64)])
    for n in (1, 2, 4, 8)]


@pytest.mark.parametrize("c,d,n_cores,seed", MATVEC)
def test_two_phase_matvec_matches_jax(c, d, n_cores, seed):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(c, d)).astype(np.float32)
    x = rng.normal(size=(d,)).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    want = np.asarray(jdist.two_phase_matvec(W, x, b, n_cores))
    got = tdist.two_phase_matvec(_t(W), _t(x), _t(b), n_cores).numpy()
    scale = np.abs(W * x).sum(1) + np.abs(b)
    assert got.shape == want.shape == (c,)
    assert np.all(np.abs(got - want) <= ATOL + RTOL * scale)
    assert np.all(np.abs(got - (W @ x + b)) <= ATOL + RTOL * scale)


@pytest.mark.parametrize("n_cores", [1, 3, 8])
def test_two_phase_matvec_batched_rows_match_single(n_cores):
    """A (B, d) batch gives each query's single-query result."""
    rng = np.random.default_rng(n_cores)
    W, b = _t(rng.normal(size=(10, 37)).astype(np.float32)), \
        _t(rng.normal(size=(10,)).astype(np.float32))
    X = _t(rng.normal(size=(6, 37)).astype(np.float32))
    Y = tdist.two_phase_matvec(W, X, b, n_cores)
    assert Y.shape == (6, 10)
    for i in range(6):
        torch.testing.assert_close(
            Y[i], tdist.two_phase_matvec(W, X[i], b, n_cores),
            rtol=RTOL, atol=ATOL)


# -------------------------------------------------------- §4.1 partition

@pytest.mark.parametrize("n", [1, 7, 64, 129, 200])
@pytest.mark.parametrize("n_cores", [1, 2, 4, 8, 16])
def test_chunk_bounds_cover_exactly_once(n, n_cores):
    """Every index in [0, chunk*n_cores) is owned by exactly one core,
    with JAX's bounds."""
    chunk = max(n // n_cores, 1)
    total = chunk * n_cores
    owned = np.zeros(total, dtype=int)
    for core in range(n_cores):
        lb, ub = tdist.chunk_bounds(total, n_cores, core)
        assert (lb, ub) == jdist.chunk_bounds(total, n_cores, core)
        owned[lb:ub] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("r,c", [(1000, 10), (10, 1000), (5, 5), (1, 2)])
def test_choose_partition_matches_paper_rule(r, c):
    assert tdist.choose_partition(r, c) == jdist.choose_partition(r, c)
    assert tdist.choose_partition(r, c) == \
        ("horizontal" if r >= c else "vertical")


@pytest.mark.parametrize("n", [1, 5, 8, 63, 100])
@pytest.mark.parametrize("n_cores", [2, 4, 8])
def test_pad_and_split_roundtrip(n, n_cores):
    x = np.arange(n, dtype=np.float32)
    jp, jn = jdist.pad_to_multiple(jnp.asarray(x), n_cores)
    xp, n_orig = tdist.pad_to_multiple(_t(x), n_cores)
    assert n_orig == jn == n and xp.shape[0] % n_cores == 0
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jp))
    chunks = tdist.split_chunks(xp, n_cores)
    assert chunks.shape == (n_cores, xp.shape[0] // n_cores)
    np.testing.assert_array_equal(
        chunks.numpy(), np.asarray(jdist.split_chunks(jp, n_cores)))
    np.testing.assert_array_equal(chunks.reshape(-1)[:n].numpy(), x)


def test_split_refuses_an_unpadded_axis():
    with pytest.raises(ValueError, match="pad_to_multiple"):
        tdist.split_chunks(torch.zeros(7), 2)


@pytest.mark.parametrize("n_cores", [1, 2, 8])
def test_two_phase_reduce_sum(n_cores):
    x = np.arange(64, dtype=np.float32)
    want = jdist.two_phase_reduce(lambda c: jnp.sum(c), lambda p: jnp.sum(p),
                                  jnp.asarray(x), n_cores=n_cores)
    got = tdist.two_phase_reduce(lambda c: c.sum(), lambda p: p.sum(),
                                 _t(x), n_cores=n_cores)
    assert float(got) == float(want) == float(x.sum())


def test_two_phase_reduce_along_axis_1():
    x = np.arange(48, dtype=np.float32).reshape(3, 16)
    want = jdist.two_phase_reduce(lambda c: jnp.max(c, axis=0),
                                  lambda p: jnp.max(p, axis=0),
                                  jnp.asarray(x), n_cores=4, axis=1)
    got = tdist.two_phase_reduce(lambda c: c.amax(dim=0),
                                 lambda p: p.amax(dim=0), _t(x),
                                 n_cores=4, axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ top-k

TOPK = [(n, k, s) for s, (n, k) in enumerate(
    [(5, 1), (5, 5), (37, 3), (128, 4), (300, 5), (299, 2)])]


@pytest.mark.parametrize("n,k,seed", TOPK)
@pytest.mark.parametrize("ties", [False, True])
def test_selection_topk_matches_jax(n, k, seed, ties):
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 4, size=n) if ties else rng.normal(size=n)
         ).astype(np.float32)
    for jfn, tfn in ((jtopk.selection_topk_smallest,
                      ttopk.selection_topk_smallest),
                     (jtopk.selection_topk_largest,
                      ttopk.selection_topk_largest)):
        jv, ji = jfn(jnp.asarray(x), k)
        tv, ti = tfn(_t(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the lax.top_k rule: ties to the smallest index
    want_v, want_i = jax.lax.top_k(-jnp.asarray(x), k)
    tv, ti = ttopk.selection_topk_smallest(_t(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))


LOCAL_GLOBAL = [(n, k, c, s) for s, (n, k, c) in enumerate(
    [(8, 1, 8), (64, 4, 8), (100, 6, 4), (333, 5, 8), (500, 3, 1),
     (37, 2, 2), (257, 6, 8)])]


@pytest.mark.parametrize("n,k,n_cores,seed", LOCAL_GLOBAL)
@pytest.mark.parametrize("ties", [False, True])
def test_local_global_matches_jax_and_global(n, k, n_cores, seed, ties):
    """The paper's c-core local SS + master merge equals one global
    top-k and the JAX package's, ties to the smallest index."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(0, 3, size=n) if ties else rng.normal(size=n)
         ).astype(np.float32)
    for jfn, tfn, sign in ((jtopk.local_global_topk_smallest,
                            ttopk.local_global_topk_smallest, 1.0),
                           (jtopk.local_global_topk_largest,
                            ttopk.local_global_topk_largest, -1.0)):
        jv, ji = jfn(jnp.asarray(x), k, n_cores)
        tv, ti = tfn(_t(x), k, n_cores)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        order = np.argsort(sign * x, kind="stable")[:k]
        np.testing.assert_array_equal(ti.numpy(), order)
        np.testing.assert_array_equal(tv.numpy(), x[order])


@pytest.mark.parametrize("n,k,c", [(1000, 4, 8), (1000, 9, 8), (64, 2, 1),
                                   (7, 3, 16), (1, 1, 1)])
def test_sorting_cost_model_matches_jax(n, k, c):
    """Paper Eq. 14: the JAX package's counts, and SS beats QS iff
    k < log2(n/c)."""
    got = ttopk.sorting_cost_model(n, k, c)
    assert got == jtopk.sorting_cost_model(n, k, c)
    if (n, k, c) == (1000, 4, 8):
        assert got["ss_favorable"]
        assert got["selection_sort"] < got["quick_sort"]
    if (n, k, c) == (1000, 9, 8):
        assert not got["ss_favorable"]
