"""deepseek-67b and nemotron-4-340b in the port against the JAX package.

Both are dense decoders the port's layers already hold (swiglu and RMSNorm;
squared-ReLU and LayerNorm); neither fits one 80 GB card at full depth,
so ``chip_smoke.py`` serves them at their published widths with the depth
cut (``layer_cut``).  Here each arch's reduced config (``get_smoke_config``:
2 layers, d_model 64, fp32) is initialised by the reference, its params
carried across with ``convert.lm_params_from_numpy``, and both packages
serve the same numpy prompts: greedy tokens compare exactly, logits and
log-probabilities to rtol = atol = 1e-4 (fp32 summation order at widths
<= 128, as in ``tests/test_torch_lm.py``).  Full width is checked without
allocating it: configs, parameter counts, shapes on the ``meta`` device,
the chip phase's depth and kernel shapes.
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
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-67b", "nemotron-4-340b")
N_NEW = 5
MAX_SEQ = 24


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced arch in both packages on one set of weights, and the
    reference's prefill, forward and greedy generation (one jitted
    prefill serves both)."""
    arch = request.param
    jcfg = jax_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(arch)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    engine = JaxServeEngine(jcfg, jparams, jbase.ServeConfig(max_seq=MAX_SEQ))
    jlogits, _ = engine.prefill(jnp.asarray(prompts))
    jres = engine.generate(jnp.asarray(prompts), N_NEW)
    jforward, _ = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, jnp.asarray(prompts))
    return dict(arch=arch, cfg=cfg, params=params, prompts=prompts,
                jlogits=np.asarray(jlogits), jforward=np.asarray(jforward),
                jtokens=np.asarray(jres.tokens),
                jlogprobs=np.asarray(jres.logprobs))


def _engine(s):
    return ServeEngine(s["cfg"], s["params"],
                       tbase.ServeConfig(max_seq=MAX_SEQ))


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.head_dim == ref.head_dim and port.q_dim == ref.q_dim


@pytest.mark.parametrize("arch,count,extra", [
    ("deepseek-67b", 67_424_993_280, 8_192),
    ("nemotron-4-340b", 341_025_619_968, 3_575_808)])
def test_full_width_counts_and_shapes_on_meta(arch, count, extra):
    """The reference's count at full width, and the port's tree on the
    meta device (nothing allocated) in the reference's leaf shapes; the
    tree holds the norms the count leaves out (``chip_smoke.tree_extra``:
    the final norm, and LayerNorm's biases)."""
    cfg = get_config(arch)
    assert cfg.param_count() == jax_get_config(arch).param_count() == count
    params = T.init_params(cfg, device="meta")

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    assert sum(t.numel() for t in leaves(params)) == count + extra
    assert _chip_smoke().tree_extra(cfg) == extra
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in leaves(params))
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                    jax_get_config(arch)))
    assert jax.tree.map(lambda a: tuple(a.shape), jshapes) == \
        T.param_shapes(cfg)


# ------------------------------------------------------------------ serving


def test_prefill_logits_match_jax(served):
    logits, cache = _engine(served).prefill(served["prompts"])
    np.testing.assert_allclose(logits.numpy(), served["jlogits"], **TOL)
    cfg = served["cfg"]
    assert cache.length == 12 and cache.cross_kv is None
    assert cache.kv_k.shape == (cfg.n_layers, 2, MAX_SEQ, cfg.n_kv_heads,
                                cfg.head_dim)


def test_forward_logits_match_jax(served):
    got, aux = T.forward(served["params"],
                         torch.from_numpy(served["prompts"]).long(),
                         served["cfg"])
    np.testing.assert_allclose(got.numpy(), served["jforward"], **TOL)
    assert float(aux) == 0.0


def test_greedy_generation_matches_jax(served):
    res = _engine(served).generate(served["prompts"], N_NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])
    np.testing.assert_allclose(res.logprobs.numpy(), served["jlogprobs"],
                               **TOL)


def _kernel_route(monkeypatch):
    """The wrappers' card branch on the CPU: ``ops._check`` reports a card
    and B10 and B11's launchers run the plain versions, each counting its
    route."""
    def gemm_launch(a, b, tile_n=0):
        tgemm.ROUTE_LAUNCHES[tgemm.route(a, b)] += 1
        return tref.matmul(a, b)

    def attn_launch(q, k, v, causal=True):
        tfa.ROUTE_LAUNCHES[tfa.route(q, k, v)] += 1
        return tref.attention(q, k, v, causal)
    monkeypatch.setattr(tgemm, "launch", gemm_launch)
    monkeypatch.setattr(tfa, "launch", attn_launch)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])


def test_launch_counts_on_the_kernel_route(served, monkeypatch):
    """Each layer launches B10 seven times (deepseek's swiglu: q, k, v, o,
    in, gate, out) or six (nemotron's squared ReLU has no gate), the
    unembedding once, in the prefill and in every decode step; B11 once a
    layer, in the prefill only; ``chip_smoke.lm_launch_plan`` derives the
    same counts."""
    _kernel_route(monkeypatch)
    tops.reset_launches()
    res = _engine(served).generate(served["prompts"], N_NEW)
    cfg = served["cfg"]
    per_layer = 7 if cfg.mlp_type == "swiglu" else 6
    want = dict(matmul=(per_layer * cfg.n_layers + 1) * (1 + N_NEW),
                flash_attention=cfg.n_layers)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == want
    plan = _chip_smoke().lm_launch_plan(torch, cfg, 2, 12, N_NEW)
    assert plan["launches"] == want
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])


# ------------------------------------------------------------------ the chip


def test_layer_cut_depths():
    """The chip phases' depths: the most layers whose estimated peak stays
    within ``CUT_PEAK_BYTES`` (deepseek-67b 41 layers, 60.1 GB of bf16
    weights; nemotron-4-340b 4, 46.5 GB), every width as published."""
    cs = _chip_smoke()
    for spec in cs.LM_ARCHS:
        if not spec["cut"]:
            continue
        cfg = get_config(spec["arch"])
        n = cs.layer_cut(cfg, spec)
        assert n == {"deepseek-67b": 41, "nemotron-4-340b": 4}[spec["arch"]]
        assert cs.cut_peak(cfg, spec, n) <= cs.CUT_PEAK_BYTES < \
            cs.cut_peak(cfg, spec, n + 1)
        assert cs.layer_weights(cfg, n) == 2 * (
            dataclasses.replace(cfg, n_layers=n).param_count() +
            cs.tree_extra(dataclasses.replace(cfg, n_layers=n)))


def test_lm_path_shapes():
    """The B10 and B11 shapes ``chip_smoke.lm_kernel_edges`` holds for the
    two archs: prefill M = 2,048 at deepseek's K = 8,192 (N = 8,192,
    1,024, 22,016) and nemotron's K = 18,432 (N = 18,432, 1,536, 73,728)
    and K = 73,728; decode M = 4; the unembeddings at N = 102,400 and
    256,000; B11 causal at d = 128 (GQA 8) and d = 192 (GQA 12)."""
    cs = _chip_smoke()
    gemm, attn = cs.lm_path_shapes(get_config("deepseek-67b"), 4, 512)
    assert gemm == [(2048, 8192, 8192), (2048, 1024, 8192),
                    (2048, 22016, 8192), (2048, 8192, 22016),
                    (4, 8192, 8192), (4, 1024, 8192), (4, 22016, 8192),
                    (4, 8192, 22016), (4, 102400, 8192)]
    assert attn == (4, 64, 512, 128)
    gemm, attn = cs.lm_path_shapes(get_config("nemotron-4-340b"), 4, 512)
    assert gemm == [(2048, 18432, 18432), (2048, 1536, 18432),
                    (2048, 73728, 18432), (2048, 18432, 73728),
                    (4, 18432, 18432), (4, 1536, 18432), (4, 73728, 18432),
                    (4, 18432, 73728), (4, 256000, 18432)]
    assert cs.lm_attn_shapes(get_config("nemotron-4-340b"), 4, 512) == \
        [((4, 96, 512, 192), True)]


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_phase_rehearsal(arch, monkeypatch, capsys):
    """``chip_smoke.lm_arch_path`` on the CPU at the reduced arch in bf16:
    the card's timing calls stubbed, the launchers the plain versions
    (``_kernel_route``); every check of the phase runs (launches and
    routes as ``lm_launch_plan`` derives them, the logits gate, the
    per-layer check) and the depth is named in the arch id."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    from repro_torch.launch import lm_kernel_times
    monkeypatch.setattr(lm_kernel_times, "device_kernels", lambda fn: {})
    from repro_torch.configs import registry
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    monkeypatch.setattr(registry, "get_config", lambda a: cfg)
    spec = dict(next(s for s in cs.LM_ARCHS if s["arch"] == arch),
                batch=2, prompt=20, new=3)
    launches = cs.lm_arch_path(torch, tops, torch.device("cpu"), spec)
    assert {k: v for k, v in launches.items() if v} == \
        cs.lm_launch_plan(torch, cfg, 2, 20, 3)["launches"]
    out = capsys.readouterr().out
    tag = spec["tag"]
    assert f"[lm/{tag}] {arch}-L2 (2 of 2 layers" in out
    assert f"[lm/{tag}] launches B10={launches['matmul']}" in out
