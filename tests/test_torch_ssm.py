"""The port's SSD mixer (``models/ssm.py``) and mamba2-780m against the JAX
package.

Inputs are drawn from numpy with a seed.  The module tests run the
reference's ``apply_ssm`` and ``decode_ssm`` (jnp, no Pallas kernel) and
the port's on the same weights (the reference's ``init_ssm`` carried
across) at mamba2's reduced widths (``get_smoke_config``: d_model 64,
d_state 16, head_dim 16, chunk 32, fp32); the model tests carry the
reduced mamba2-780m's params across with ``convert.lm_params_from_numpy``
(one JAX model for the module, built by the ``served`` fixture) and
serve the same prompts in both packages.  The bar is ROADMAP C's fp32
bar: greedy tokens exactly, values to rtol = atol = 1e-5.  The SSD's
``exp`` of segment sums meets it at these widths (its terms are at most
1: the decays are exp of sums of dt·A <= 0), so no leaf needs a looser
bound.  Full width is checked on the ``meta`` device only;
``chip_smoke.py`` serves mamba2-780m at full width on the card.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-780m"
N_NEW = 5
S_TOK = 45          # not a multiple of the reduced chunk (32)
MAX_SEQ = 64


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **tol)


@pytest.fixture(scope="module")
def mixer():
    """One reduced SSD mixer in both packages: the reference's weights,
    with its D and dt_bias moved off their constant init (a mixer that
    skips D or dt_bias would still agree at D = 1, dt_bias = -2) and A_log
    drawn so heads decay at different rates."""
    jcfg, cfg = jax_smoke(ARCH), get_smoke_config(ARCH)
    jp = jssm.init_ssm(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(7)
    H = cfg.ssm_heads
    jp = dict(jp, A_log=jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32),
              D=jnp.asarray(rng.normal(size=H), jnp.float32),
              dt_bias=jnp.asarray(rng.normal(size=H) - 1.0, jnp.float32))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, p=_torch_tree(jp), rng=rng)


@pytest.fixture(scope="module")
def served():
    """The reduced mamba2-780m in both packages on one set of weights,
    and the reference's prefill (logits and cache), forward and greedy
    generation."""
    jcfg = jax_smoke(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(ARCH)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, S_TOK)).astype(np.int32)
    engine = JaxServeEngine(jcfg, jparams, jbase.ServeConfig(max_seq=MAX_SEQ))
    jlogits, jcache = engine.prefill(jnp.asarray(prompts))
    jres = engine.generate(jnp.asarray(prompts), N_NEW)
    jforward, _ = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, jnp.asarray(prompts))
    return dict(cfg=cfg, jcfg=jcfg, jparams=jparams, params=params,
                prompts=prompts, jlogits=np.asarray(jlogits), jcache=jcache,
                jforward=np.asarray(jforward),
                jtokens=np.asarray(jres.tokens),
                jlogprobs=np.asarray(jres.logprobs))


def _engine(s, max_seq=MAX_SEQ):
    return ServeEngine(s["cfg"], s["params"],
                       tbase.ServeConfig(max_seq=max_seq))


# ------------------------------------------------------------------ configs


def test_config_equals_the_reference():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert (port.d_inner, port.ssm_heads) == (ref.d_inner, ref.ssm_heads)
    cfg = get_config(ARCH)
    assert (cfg.d_inner, cfg.ssm_heads, cfg.tie_embeddings) == \
        (3072, 48, True)


def test_full_width_counts_and_shapes_on_meta():
    """The reference's count at full width, and the port's tree on the
    meta device in the reference's leaf shapes and dtypes; the tree holds
    what the count leaves out (``chip_smoke.tree_extra``: the final norm,
    each layer's gated norm of d_inner, less the norm_ffn a layer without
    an FFN has not)."""
    cfg = get_config(ARCH)
    count = 779_913_984
    assert cfg.param_count() == jax_get_config(ARCH).param_count() == count
    params = T.init_params(cfg, device="meta")
    leaves = list(_leaves(params))
    extra = 1536 + 48 * (3072 - 1536)
    assert sum(t.numel() for t in leaves) == count + extra
    assert _chip_smoke().tree_extra(cfg) == extra
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                    jax_get_config(ARCH)))
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jshapes) == _shapes_dtypes(params)
    sub = T.param_shapes(cfg)["layers"]["sub0"]
    assert sorted(sub) == ["norm_mixer", "ssm"]
    assert sub["ssm"]["wdt"] == (48, 1536, 48)
    assert sub["ssm"]["wB"] == (48, 1536, 128)
    assert sub["ssm"]["conv_x"] == (48, 4, 3072)
    assert "unembed" not in T.param_shapes(cfg)["embed"]


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _shapes_dtypes(tree):
    return {k: _shapes_dtypes(v) if isinstance(v, dict)
            else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def test_init_and_logical_axes_match_the_reference(mixer):
    """``init_ssm``'s leaves, shapes and dtypes and ``ssm_logical``'s axes
    are the reference's; the seeded init draws N(0, 1/d_model)
    projections and N(0, 0.1²) conv taps, A_log 0, D 1, dt_bias -2."""
    cfg = dataclasses.replace(mixer["cfg"], dtype="bfloat16")
    jcfg = dataclasses.replace(mixer["jcfg"], dtype="bfloat16")
    p = tssm.init_ssm(torch.Generator().manual_seed(0), cfg,
                      torch.device("cpu"), lead=(3,))
    jp = jax.eval_shape(lambda: jssm.init_ssm(jax.random.PRNGKey(0), jcfg))
    assert sorted(p) == sorted(jp)
    for k, v in p.items():
        assert tuple(v.shape) == (3,) + jp[k].shape, k
        assert str(v.dtype).replace("torch.", "") == str(jp[k].dtype), k
    assert tssm.ssm_logical(cfg) == jssm.ssm_logical(jcfg)
    assert tuple(tssm.ssm_cache_logical(cfg)) == \
        tuple(jssm.ssm_cache_logical(jcfg))
    assert float(p["A_log"].abs().max()) == 0.0
    assert bool((p["D"] == 1).all()) and bool((p["dt_bias"] == -2).all())
    assert abs(float(p["wz"].float().std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["conv_x"].float().std()) - 0.1) < 0.01
    jc = jssm.init_ssm_cache(jcfg, 2)
    c = tssm.init_ssm_cache(cfg, 2, lead=(3, 1))
    for got, want in zip(c, jc):
        assert tuple(got.shape) == (3, 1) + want.shape
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)


# ------------------------------------------------------------------ pieces


def test_segsum_conv_and_conv_step_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(2, 3, 9)).astype(np.float32)
    got = tssm._segsum(torch.from_numpy(a)).numpy()
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(got[np.isfinite(got)], want[np.isfinite(want)])
    x = rng.normal(size=(2, 11, 6)).astype(np.float32)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    _close(tssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w)),
           jssm._causal_conv(jnp.asarray(x), jnp.asarray(w)))
    win, new = x[:, :3], x[:, 3]
    y, nwin = tssm._conv_step(torch.from_numpy(win), torch.from_numpy(new),
                              torch.from_numpy(w))
    jy, jwin = jssm._conv_step(jnp.asarray(win), jnp.asarray(new),
                               jnp.asarray(w))
    _close(y, jy)
    _close(nwin, jwin)


@pytest.mark.parametrize("S", [45, 64, 7])
@pytest.mark.parametrize("with_h0", [False, True])
def test_apply_ssm_matches_jax(mixer, S, with_h0):
    """The chunked SSD at S = 45 (padded to 64: two chunks of 32, the
    carried state exact over the padding), 64 (two whole chunks) and 7
    (one chunk of 7), from a zero state and from a drawn ``h0``: the
    output and the final state; the conv windows it returns are the
    reference prefill's ``_ssm_conv_tail`` of the same input."""
    cfg, jcfg, rng = mixer["cfg"], mixer["jcfg"], mixer["rng"]
    u = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    h0 = rng.normal(size=(2, cfg.ssm_heads, cfg.ssm.head_dim,
                          cfg.ssm.d_state)).astype(np.float32) \
        if with_h0 else None
    jy, jh = jssm.apply_ssm(mixer["jp"], jnp.asarray(u), jcfg,
                            h0=None if h0 is None else jnp.asarray(h0))
    y, state = tssm.apply_ssm(mixer["p"], torch.from_numpy(u), cfg,
                              h0=None if h0 is None else torch.from_numpy(h0))
    assert y.shape == (2, S, cfg.d_model) and state.h.dtype == torch.float32
    _close(y, jy)
    _close(state.h, jh)
    tail = np.asarray(JT._ssm_conv_tail(mixer["jp"], jnp.asarray(u), jcfg))
    d_in, GN = cfg.d_inner, cfg.ssm.d_state
    for got, want in zip(state[:3], (tail[..., :d_in],
                                     tail[..., d_in:d_in + GN],
                                     tail[..., d_in + GN:])):
        _close(got, want)


def test_short_prompt_windows_are_zero_padded(mixer):
    """A sequence shorter than W - 1 leaves its inputs right-aligned in the
    window after W - 1 - S zeros, the causal conv's own padding, so that
    decode continues it exactly (the reference's tail would have S rows)."""
    cfg, rng = mixer["cfg"], mixer["rng"]
    u = torch.from_numpy(rng.normal(size=(2, 2, cfg.d_model))
                         .astype(np.float32))
    _, state = tssm.apply_ssm(mixer["p"], u, cfg)
    assert state.conv_x.shape == (2, cfg.ssm.conv_width - 1, cfg.d_inner)
    assert bool((state.conv_x[:, 0] == 0).all())
    _close(state.conv_x[:, 1:], u @ mixer["p"]["wx"])


def test_decode_ssm_continues_a_prefill_like_jax(mixer):
    """``decode_ssm`` over six steps from the state and windows a 37-token
    ``apply_ssm`` leaves, against the reference's from its own; and the
    whole sequence through ``apply_ssm`` at once agrees with prefill then
    decode."""
    cfg, jcfg, rng = mixer["cfg"], mixer["jcfg"], mixer["rng"]
    S, n = 37, 6
    u = rng.normal(size=(2, S + n, cfg.d_model)).astype(np.float32)
    _, state = tssm.apply_ssm(mixer["p"], torch.from_numpy(u[:, :S]), cfg)
    _, jh = jssm.apply_ssm(mixer["jp"], jnp.asarray(u[:, :S]), jcfg)
    tail = JT._ssm_conv_tail(mixer["jp"], jnp.asarray(u[:, :S]), jcfg)
    d_in, GN = cfg.d_inner, cfg.ssm.d_state
    jstate = jssm.SSMCache(conv_x=tail[..., :d_in],
                           conv_B=tail[..., d_in:d_in + GN],
                           conv_C=tail[..., d_in + GN:], h=jh)
    outs = []
    for t in range(S, S + n):
        y, state = tssm.decode_ssm(mixer["p"],
                                   torch.from_numpy(u[:, t:t + 1]), state,
                                   cfg)
        jy, jstate = jssm.decode_ssm(mixer["jp"], jnp.asarray(u[:, t:t + 1]),
                                     jstate, jcfg)
        assert y.shape == (2, 1, cfg.d_model)
        _close(y, jy)
        for got, want in zip(state, jstate):
            _close(got, want)
        outs.append(y)
    whole, last = tssm.apply_ssm(mixer["p"], torch.from_numpy(u), cfg)
    _close(torch.cat(outs, 1), whole[:, S:])
    _close(state.h, last.h)


def test_projections_run_on_b10(mixer, monkeypatch):
    """The five in-projections and ``w_out`` are B10 launches (a prefill
    and a decode step six each); the scan launches nothing else."""
    cfg, rng = mixer["cfg"], mixer["rng"]
    _kernel_route(monkeypatch)
    u = torch.from_numpy(rng.normal(size=(2, 40, cfg.d_model))
                         .astype(np.float32))
    tops.reset_launches()
    _, state = tssm.apply_ssm(mixer["p"], u, cfg)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {"matmul": 6}
    tssm.decode_ssm(mixer["p"], u[:, :1], state, cfg)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == {"matmul": 12}
    assert tgemm.ROUTE_LAUNCHES["small_m"] == 6


# ------------------------------------------------------------------ serving


def test_prefill_logits_and_state_match_jax(served):
    logits, cache = _engine(served).prefill(served["prompts"])
    _close(logits, served["jlogits"])
    assert cache.kv_k is None and cache.kv_v is None and \
        served["jcache"].kv_k is None
    assert cache.length == S_TOK
    for got, want in zip(cache.ssm, served["jcache"].ssm):
        assert tuple(got.shape) == want.shape
        assert got.dtype == (torch.float32)
        _close(got, want)


def test_forward_logits_match_jax(served):
    got, aux = T.forward(served["params"],
                         torch.from_numpy(served["prompts"]).long(),
                         served["cfg"])
    _close(got, served["jforward"])
    assert float(aux) == 0.0


def test_greedy_generation_matches_jax(served):
    res = _engine(served).generate(served["prompts"], N_NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])
    _close(res.logprobs, served["jlogprobs"])


def test_decode_writes_the_state_in_place(served):
    """A decode step writes each layer's windows and state into the
    cache's own tensors and hands the same tensors on."""
    engine = _engine(served)
    logits, cache = engine.prefill(served["prompts"])
    before = [t.clone() for t in cache.ssm]
    ptrs = [t.data_ptr() for t in cache.ssm]
    _, cache2 = engine.decode(cache, logits.argmax(-1)[:, None])
    assert [t.data_ptr() for t in cache2.ssm] == ptrs
    assert cache2.length == S_TOK + 1
    assert all(not torch.equal(a, b) for a, b in zip(cache2.ssm, before))


def _kernel_route(monkeypatch):
    """The wrappers' card branch on the CPU: ``ops._check`` reports a card
    and B10's launcher runs the plain version, counting its route."""
    def gemm_launch(a, b, tile_n=0):
        tgemm.ROUTE_LAUNCHES[tgemm.route(a, b)] += 1
        return tref.matmul(a, b)
    monkeypatch.setattr(tgemm, "launch", gemm_launch)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])


def test_launch_counts_on_the_kernel_route(served, monkeypatch):
    """mamba2 launches B10 six times a layer a forward pass and once for
    the tied unembedding, and no B11: ``chip_smoke.lm_launch_plan``
    derives the same, (6·2 + 1)·6 here and (6·48 + 1)·33 = 9,537 at the
    chip phase's full width."""
    _kernel_route(monkeypatch)
    tops.reset_launches()
    res = _engine(served).generate(served["prompts"], N_NEW)
    cfg = served["cfg"]
    want = dict(matmul=(6 * cfg.n_layers + 1) * (1 + N_NEW))
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == want
    cs = _chip_smoke()
    plan = cs.lm_launch_plan(torch, cfg, 2, S_TOK, N_NEW)
    assert {k: v for k, v in plan["launches"].items() if v} == want
    assert cs.lm_launch_plan(torch, get_config(ARCH), 4, 512, 32)[
        "launches"] == dict(matmul=9_537, flash_attention=0)
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])


def test_lm_path_shapes():
    """The B10 shapes ``chip_smoke.lm_kernel_edges`` holds for mamba2: z
    and x (N = 3,072), B and C (N = 128), dt (N = 48) at K = 1,536 and the
    output at K = 3,072, each at the prefill's M = 2,048 and decode's M =
    4, then the tied unembedding at N = 50,280; no B11."""
    gemm, attn = _chip_smoke().lm_path_shapes(get_config(ARCH), 4, 512)
    proj = [(3072, 1536), (128, 1536), (48, 1536), (1536, 3072)]
    assert gemm == [(M, N, K) for M in (2048, 4) for N, K in proj] + \
        [(4, 50_280, 1536)]
    assert attn is None


def test_cache_logical_and_shapes_match_jax():
    """The SSM state's specs and meta shapes are the reference's, with its
    (n_units, n_ssm) axes; mamba2 has no k and v."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    lg, jlg = T.cache_logical(cfg), JT.cache_logical(jcfg)
    assert lg.kv_k is None and jlg.kv_k is None
    assert tuple(lg.ssm) == tuple(jlg.ssm)
    c = T.init_cache(cfg, 4, 544, device="meta")
    jc = jax.eval_shape(lambda: JT.init_cache(jcfg, 4, 544))
    assert [tuple(t.shape) for t in c.ssm] == [t.shape for t in jc.ssm]
    assert c.ssm.h.shape == (48, 1, 4, 48, 64, 128)
