"""Parity of the PyTorch port's LM kernels B10 (``matmul``) and B11
(``flash_attention``) with the JAX package, on the CPU.

The same numpy inputs go through ``repro.kernels.ops`` (the Pallas kernels,
in interpret mode on the CPU) and ``repro_torch.kernels.ops`` on CPU
tensors, which run the kernels' plain versions.  Tolerances are those of
``tests/test_kernels.py``: rtol = atol = 2e-4 in fp32 and 2e-2 in bf16,
since both packages form the fp32 product of the same operands and round
it once.  The port's plain attention is also held against the reference's
materialised ``full_attention``, the function its prefill computes.  On a
card the wrappers launch the CUDA kernels instead; ``chip_smoke.py`` holds
those against the plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-4, atol=2e-4)


def _pair(x, dtype):
    """One float32 numpy array as (jax array, torch tensor) of ``dtype``:
    both round float32 to bf16 to nearest even."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch,
                                                                 dtype)))


def _np(t):
    return t.to(torch.float32).numpy()


# ------------------------------------------------------------------ B10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 256, 128),
                                   (100, 300, 50), (257, 129, 65)])
def test_matmul_matches_jax(m, k, n, dtype):
    rng = np.random.default_rng(m * 7 + n)
    a_np = (rng.normal(size=(m, k)) * 0.5).astype(np.float32)
    b_np = (rng.normal(size=(k, n)) * 0.5).astype(np.float32)
    ja, ta = _pair(a_np, dtype)
    jb, tb = _pair(b_np, dtype)
    got = tops.matmul(ta, tb)
    assert got.dtype == ta.dtype and got.shape == (m, n)
    want = jops.matmul(ja, jb, bm=64, bn=64, bk=64)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (4, 2560, 3), (3, 65, 257)])
def test_matmul_ragged_shapes_match_the_fp32_product(m, k, n):
    """Any M, N, K >= 1, the decode shape's M = 4 among them: the plain
    version is the fp32 product rounded once to the operands' dtype."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    np.testing.assert_allclose(tops.matmul(a, b).numpy(), (a @ b).numpy(),
                               rtol=1e-5, atol=1e-5)
    got = tops.matmul(a.bfloat16(), b.bfloat16())
    want = (a.bfloat16().float() @ b.bfloat16().float()).bfloat16()
    assert torch.equal(got, want)


def test_small_m_plan_covers_k_and_fills_the_card():
    """The split-K plan of the matrix-vector kernel: the K slices of a
    cluster cover K with none empty, each a whole number of 64-row stages
    and at most 8 of them (a portable cluster), and at the decode shapes
    of stablelm-3b the blocks make at least one wave over 132 SMs."""
    for M, N, K in [(1, 1, 1), (4, 2560, 2560), (4, 6912, 2560),
                    (4, 2560, 6912), (4, 50304, 2560), (16, 3, 6913),
                    (3, 257, 65)]:
        for dtype in (torch.bfloat16, torch.float32):
            splits, per = tgemm.plan_small(M, N, K, dtype, 132)
            assert splits >= 1 and per >= 1
            assert splits * per >= K > (splits - 1) * per
            assert splits == 1 or per >= tgemm.MIN_SPLIT_ROWS
            assert splits <= tgemm.MAX_CLUSTER
            assert per % tgemm.MIN_SPLIT_ROWS == 0
    for N, K in [(2560, 2560), (6912, 2560), (2560, 6912), (50304, 2560)]:
        splits, _ = tgemm.plan_small(4, N, K, torch.bfloat16, 132)
        assert splits * -(-N // tgemm.strip_width(torch.bfloat16)) >= 132


# ------------------------------------------------------------------ B11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,s,d", [(1, 2, 128, 64), (1, 2, 128, 80)])
def test_flash_attention_matches_jax(b, h, s, d, causal, dtype):
    rng = np.random.default_rng(d + causal)
    q, k, v = ((rng.normal(size=(b, h, s, d)) * 0.3).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (b, h, s, d)
    want = jops.flash_attention(jq, jk, jv, causal=causal, bq=64, bk=64)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [144, 192, 256])
def test_flash_attention_past_d128_matches_jax(d, causal):
    """Head dims past the old cap of 128, up to gemma-7b's 256 (ROADMAP
    C2): the port's B11 wrapper against the Pallas kernel in interpret
    mode, bf16 as the LM serves it."""
    rng = np.random.default_rng(d + 7 * causal)
    q, k, v = ((rng.normal(size=(1, 2, 128, d)) * 0.3).astype(np.float32)
               for _ in range(3))
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, "bfloat16") for x in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 2, 128, d)
    want = jops.flash_attention(jq, jk, jv, causal=causal, bq=64, bk=64)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **_tol("bfloat16"))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_full_attention(causal):
    """The function the reference's prefill runs at S <= 4096, at S = 12
    (no 64- or 128-row block divides it) and head_dim 80, in the models'
    (B, S, H, d) layout handed to the port as a permuted view."""
    cfg = jax_config("stablelm-3b")
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(2, 12, 3, 80)).astype(np.float32)
               for _ in range(3))
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), cfg, causal=causal)
    tq, tk, tv = (torch.from_numpy(x).permute(0, 2, 1, 3)
                  for x in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.permute(0, 2, 1, 3).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("written", [1, 6, 9])
def test_decode_full_attention_matches_jax(written):
    """Decode's attention over the cache, with grouped KV heads: the
    reference scores the whole 9-slot cache and masks the unwritten
    slots; the port scores the written ones only.  Same result."""
    from repro_torch.configs.registry import get_config
    jcfg, tcfg = jax_config("stablelm-3b"), get_config("stablelm-3b")
    rng = np.random.default_rng(written)
    q = rng.normal(size=(3, 1, 4, 80)).astype(np.float32)
    k, v = (rng.normal(size=(3, 9, 2, 80)).astype(np.float32)
            for _ in range(2))
    mask = np.broadcast_to(np.arange(9) < written, (3, 9))
    want = jattn.full_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jcfg, causal=False,
                                kv_len_mask=jnp.asarray(mask))
    got = tattn.full_attention(torch.from_numpy(q),
                               torch.from_numpy(k[:, :written]),
                               torch.from_numpy(v[:, :written]), tcfg,
                               causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_wgmma_shape_rule():
    """B10's routes: M <= 16 the small-M kernel in either dtype; bf16 with
    K and N multiples of 8 and aligned bases the wgmma kernel; other bf16
    shapes mma.sync; fp32 the CUDA cores."""
    def ab(m, k, n, dtype=torch.bfloat16):
        return torch.zeros((m, k), dtype=dtype), torch.zeros((k, n),
                                                              dtype=dtype)
    assert tgemm.uses_wgmma(*ab(2048, 2560, 6912))
    assert tgemm.uses_wgmma(*ab(17, 6912, 2560))
    assert not tgemm.uses_wgmma(*ab(16, 2560, 2560))
    assert not tgemm.uses_wgmma(*ab(2048, 2560, 2560, torch.float32))
    assert not tgemm.uses_wgmma(*ab(65, 257, 64))
    assert not tgemm.uses_wgmma(*ab(65, 64, 6913))
    a, b = ab(65, 72, 64)
    assert tgemm.uses_wgmma(a, b)
    assert not tgemm.uses_wgmma(a.view(-1)[4:4 + 64 * 72].view(64, 72), b)
    routes = {shape + (str(dt),): tgemm.route(*ab(*shape, dt))
              for shape in [(4, 2560, 2560), (2048, 2560, 2560),
                            (257, 65, 3)]
              for dt in (torch.bfloat16, torch.float32)}
    assert list(routes.values()) == ["small_m", "small_m", "wgmma", "fp32",
                                     "mma_sync", "fp32"]


@pytest.mark.parametrize("d,dtype,want", [
    (80, torch.bfloat16, "wgmma"), (144, torch.bfloat16, "wgmma"),
    (256, torch.bfloat16, "wgmma"), (24, torch.bfloat16, "cuda_core"),
    (80, torch.float32, "cuda_core"), (256, torch.float32, "cuda_core")])
def test_attention_route_rule(d, dtype, want):
    """B11's routes in the models' (B, S, H, d) layout: wgmma for bf16 at
    d a multiple of 16 up to 256, the CUDA cores otherwise."""
    q = torch.zeros((2, 5, 4, d), dtype=dtype).permute(0, 2, 1, 3)
    assert tfa.route(q, q, q) == want
    assert tfa.D_MAX == 256


def test_tensor_core_layout_rule():
    """B11 takes its tensor-core kernel for the models' layout at head_dim
    80 in bf16, and its CUDA-core kernel for fp32, a head_dim that is not
    a multiple of 16, or a stride that is not a multiple of 8."""
    def qkv(d, dtype=torch.bfloat16, h=32):
        return [torch.zeros((2, 5, h, d), dtype=dtype).permute(0, 2, 1, 3)
                for _ in range(3)]
    assert tfa.uses_tensor_cores(*qkv(80))
    assert tfa.uses_tensor_cores(*qkv(16, h=1))
    assert not tfa.uses_tensor_cores(*qkv(80, torch.float32))
    assert not tfa.uses_tensor_cores(*qkv(24))
    odd = torch.zeros((2, 3, 5, 17), dtype=torch.bfloat16)[..., :16]
    assert not tfa.uses_tensor_cores(odd, odd, odd)


# ------------------------------------------------------------------ wrappers


def test_cpu_tensors_run_plain_and_count_no_launch(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("a CPU tensor reached a kernel launcher")

    monkeypatch.setattr(tgemm, "launch", boom)
    monkeypatch.setattr(tfa, "launch", boom)
    tops.reset_launches()
    a = torch.randn(5, 7, dtype=torch.bfloat16)
    assert tops.matmul(a, torch.randn(7, 3, dtype=torch.bfloat16)).dtype \
        == torch.bfloat16
    q = torch.randn(1, 2, 9, 16)
    tops.flash_attention(q, q, q)
    assert tops.LAUNCHES["matmul"] == tops.LAUNCHES["flash_attention"] == 0


def test_device_tensors_launch_and_never_reach_plain(monkeypatch):
    """The branch a CUDA tensor takes, driven on the CPU by presenting the
    inputs as device tensors: the launcher runs with bf16 kept as bf16
    (no upcast), the count grows by one per call, and the plain versions
    are never called."""
    def boom(*_a, **_k):
        raise AssertionError("a device tensor reached a plain version")

    calls = []

    def launcher(name):
        def fn(*args):
            calls.append((name, [a.dtype for a in args
                                 if isinstance(a, torch.Tensor)], args[-1]))
            return "launched"
        return fn

    monkeypatch.setattr(tref, "matmul", boom)
    monkeypatch.setattr(tref, "attention", boom)
    monkeypatch.setattr(tgemm, "launch", launcher("gemm"))
    monkeypatch.setattr(tfa, "launch", launcher("flash"))
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    tops.reset_launches()
    a = torch.randn(4, 80, dtype=torch.bfloat16)
    assert tops.matmul(a, torch.randn(80, 6, dtype=torch.bfloat16)) \
        == "launched"
    q = torch.randn(1, 5, 2, 80, dtype=torch.bfloat16).permute(0, 2, 1, 3)
    assert tops.flash_attention(q, q, q, causal=False) == "launched"
    assert tops.LAUNCHES == {"distance_topk": 0, "distance_argmin": 0,
                             "gnb_scores_batch": 0, "pairwise_sq_dist": 0,
                             "topk_smallest": 0, "gnb_scores": 0,
                             "distance_topk_q8": 0, "distance_argmin_q8": 0,
                             "adc_topk": 0, "matmul": 1,
                             "flash_attention": 1}
    assert [c[0] for c in calls] == ["gemm", "flash"]
    assert all(dt == torch.bfloat16 for _, dts, _ in calls for dt in dts)
    assert calls[1][2] is False          # causal reaches the launcher


@pytest.mark.parametrize("case,err", [
    ("mixed dtypes", TypeError), ("int operands", TypeError),
    ("inner mismatch", ValueError), ("1-D operand", ValueError),
    ("transposed weight", ValueError), ("attn shapes differ", ValueError),
    ("attn d > 128", ValueError), ("attn strided d", ValueError),
    ("attn mixed dtypes", TypeError)])
def test_wrong_dtype_or_shape_raises(case, err):
    f32 = torch.randn(4, 6)
    q = torch.randn(1, 2, 5, 16)
    calls = {
        "mixed dtypes": lambda: tops.matmul(f32, torch.randn(6, 3).bfloat16()),
        "int operands": lambda: tops.matmul(
            f32.int(), torch.ones(6, 3, dtype=torch.int32)),
        "inner mismatch": lambda: tops.matmul(f32, torch.randn(5, 3)),
        "1-D operand": lambda: tops.matmul(f32, torch.randn(6)),
        "transposed weight": lambda: tops.matmul(f32, torch.randn(3, 6).T),
        "attn shapes differ": lambda: tops.flash_attention(
            q, torch.randn(1, 2, 4, 16), q),
        "attn d > 128": lambda: tops.flash_attention(
            *[torch.randn(1, 1, 3, 264)] * 3),
        "attn strided d": lambda: tops.flash_attention(
            q, q, torch.randn(1, 2, 5, 32)[..., ::2]),
        "attn mixed dtypes": lambda: tops.flash_attention(q, q, q.bfloat16()),
    }
    with pytest.raises(err):
        calls[case]()


def test_plain_route_selection(monkeypatch):
    """``path="ref"`` or ``REPRO_BACKEND=ref`` sends the LM ops to their
    plain versions; the kernels are the default, and the LM ops have no
    other arm."""
    monkeypatch.delenv("REPRO_BACKEND", raising=False)
    assert not tlayers.plain_route() and tlayers.plain_route("ref")
    assert not tlayers.plain_route("fused")
    monkeypatch.setenv("REPRO_BACKEND", "ref")
    assert tlayers.plain_route() and not tlayers.plain_route("fused")
    monkeypatch.setenv("REPRO_BACKEND", "blocked")
    assert not tlayers.plain_route()
    with pytest.raises(ValueError):
        tlayers.plain_route("blocked")


# ------------------------------------------------------------------ build


def _gen_wgmma():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "gen_wgmma", _build.CSRC / "gen_wgmma.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_wgmma_header_matches_its_generator():
    """``csrc/wgmma.cuh`` is the committed output of ``gen_wgmma.py``, and
    it holds every shape B10 and B11 issue: m64n192 for the GEMM tile,
    m64n64 for the scores, m64n{16..128} for P·V."""
    gen = _gen_wgmma()
    assert (_build.CSRC / "wgmma.cuh").read_text() == gen.render()
    assert set(gen.SS_N) == {64, 192}
    assert set(gen.RS_N) == set(range(16, 129, 16))


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """A library's name digests the ``csrc/*.cuh`` headers its source
    includes, so an edited header rebuilds exactly the sources that
    include it."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [h.name for h in _build.headers(csrc / "gemm.cu")] == \
        ["hopper.cuh", "wgmma.cuh"]
    assert _build.headers(csrc / "distance_topk.cu") == []
    before = {s.stem: _build._target(s).name for s in _build.sources()}
    hdr = csrc / "hopper.cuh"
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {s.stem: _build._target(s).name for s in _build.sources()}
    changed = {stem for stem in before if before[stem] != after[stem]}
    assert changed == {"gemm", "flash_attention"}
