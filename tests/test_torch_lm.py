"""The PyTorch port's LM serving slice (dense family) against the JAX
package.

The reduced stablelm-3b (``get_smoke_config``: 2 layers, d_model 64, fp32)
is initialised by the reference (``init_params(PRNGKey(0))``), its params
carried across with ``repro_torch.convert.lm_params_from_numpy``, and both
packages serve the same numpy prompts.  Greedy tokens compare exactly;
logits and log-probabilities to rtol = atol = 1e-4, which allows for fp32
summation order at widths <= 128.  The layers are held against the
reference's at reduced widths to 1e-5.  Full width is checked without
allocating it: parameter counts, and shapes on the ``meta`` device.  The
port runs on ``device="cpu"``, where its wrappers run the kernels' plain
versions; ``chip_smoke.py`` serves stablelm-3b at full width on the card.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch import serve as tserve
from repro_torch.models import factory as tfactory
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as T
from repro_torch.serving import GenerationResult, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
ARCH = "stablelm-3b"
N_NEW = 6


@pytest.fixture(scope="module")
def served():
    """The reduced stablelm-3b in both packages on one set of weights, and
    the reference's prefill logits and greedy generation."""
    jcfg = jax_smoke(ARCH)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    cfg = get_smoke_config(ARCH)
    params = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jlogits, _ = JT.prefill(jparams, jnp.asarray(prompts), jcfg, max_seq=32)
    jres = JaxServeEngine(jcfg, jparams, jbase.ServeConfig(max_seq=32)
                          ).generate(jnp.asarray(prompts), N_NEW)
    return dict(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                prompts=prompts, jlogits=np.asarray(jlogits),
                jtokens=np.asarray(jres.tokens),
                jlogprobs=np.asarray(jres.logprobs))


def _engine(s, max_seq=32, **kw):
    return ServeEngine(s["cfg"], s["params"],
                       tbase.ServeConfig(max_seq=max_seq), **kw)


# ------------------------------------------------------------------ configs


def test_configs_equal_the_references():
    for port, ref in ((get_config(ARCH), jax_get_config(ARCH)),
                      (get_smoke_config(ARCH), jax_smoke(ARCH))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.head_dim == ref.head_dim and port.q_dim == ref.q_dim


def test_full_width_counts_and_shapes_on_meta():
    """stablelm-3b at full width: 2,795,274,240 parameters, as the
    reference counts them, and the port's tree on the meta device (nothing
    allocated) in the reference's shapes.  The count takes one d_model
    vector per norm and leaves out the final norm, so the tree of a
    LayerNorm model holds 2·d_model·(n_layers + 1) more: the biases and the
    final norm."""
    cfg = get_config(ARCH)
    assert cfg.param_count() == 2_795_274_240
    params = tfactory.init_params(cfg, device="meta")

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    assert sum(t.numel() for t in leaves(params)) == \
        cfg.param_count() + 2 * cfg.d_model * (cfg.n_layers + 1)
    assert all(t.device.type == "meta" and t.dtype == torch.bfloat16
               for t in leaves(params))
    sub = T.param_shapes(cfg)["layers"]["sub0"]
    assert sub["attn"]["wq"] == (32, 2560, 2560)
    assert sub["mlp"]["w_in"] == sub["mlp"]["w_gate"] == (32, 2560, 6912)
    assert sub["mlp"]["w_out"] == (32, 6912, 2560)
    assert T.param_shapes(cfg)["embed"]["unembed"] == (2560, 50_304)
    # the reference's tree has the same leaves in the same shapes
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                    jax_get_config(ARCH)))
    assert jax.tree.map(lambda a: tuple(a.shape), jshapes) == \
        T.param_shapes(cfg)


def test_registry_resolves_every_reference_arch():
    """All ten of the reference's arch ids resolve, at full width and at
    ``reduced``, to the reference's configs (gemma-7b, mamba2-780m and
    jamba-1.5-large-398b in ``tests/test_torch_ssm.py`` and
    ``tests/test_torch_tied_hybrid.py``; the MoE family in
    ``tests/test_torch_moe.py``; deepseek-67b and nemotron-4-340b in
    ``tests/test_torch_dense_archs.py``; the enc-dec and VLM archs in
    ``tests/test_torch_encdec_vlm.py``)."""
    from repro.configs.registry import ALL_ARCH_IDS as JIDS
    assert len(JIDS) == 10
    for arch in JIDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_get_config(arch))
        assert dataclasses.asdict(get_smoke_config(arch)) == \
            dataclasses.asdict(jax_smoke(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gemma-8b")


@pytest.mark.parametrize("family,extra", [
    ("ssm", dict(ssm=tbase.SSMConfig())),
    ("hybrid", dict(hybrid_block=4, n_layers=4, ssm=tbase.SSMConfig())),
    ("audio", dict(encoder=tbase.EncoderConfig(n_layers=2, n_ctx=16))),
    ("vlm", dict(vision=tbase.VisionConfig(num_patches=4)))])
def test_every_family_builds_carries_and_serves(family, extra, served):
    """Every family builds, carries across from numpy and serves: the SSM
    (an SSD mixer a layer) and hybrid (a unit of SSD mixers with
    attention at position 0) families without frontend inputs, the
    enc-dec ("audio") and VLM families with their stub frontends'
    inputs given."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), family=family, **extra)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert ("encoder" in params) == ("cross" in params) == \
        (family == "audio")
    n_sub = 4 if family == "hybrid" else 1
    assert sorted(params["layers"]) == [f"sub{j}" for j in range(n_sub)]
    assert ("ssm" in params["layers"][f"sub{n_sub - 1}"]) == \
        (family in ("ssm", "hybrid"))
    carried = convert.lm_params_from_numpy(
        cfg, _numpy_tree(params), device="cpu")
    assert carried.keys() == params.keys()
    if family in ("ssm", "hybrid"):
        res = ServeEngine(cfg, carried, tbase.ServeConfig(
            max_seq=24)).generate(served["prompts"], 3)
        assert res.tokens.shape == (2, 3) and bool(torch.isfinite(
            res.logprobs).all())
        return
    rng = np.random.default_rng(3)
    n = 16 if family == "audio" else 4
    key = "encoder_frames" if family == "audio" else "patch_embeds"
    front = {key: rng.normal(size=(2, n, 64)).astype(np.float32)}
    res = ServeEngine(cfg, carried, tbase.ServeConfig(max_seq=24)).generate(
        served["prompts"], 3, **front)
    assert res.tokens.shape == (2, 3) and bool(torch.isfinite(
        res.logprobs).all())
    # an enc-dec arch needs its frames; a VLM takes none
    wrong = {} if family == "audio" else \
        dict(front, encoder_frames=front[key])
    with pytest.raises(ValueError, match="encoder_frames"):
        ServeEngine(cfg, carried, tbase.ServeConfig(max_seq=24)).generate(
            served["prompts"], 3, **wrong)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


# ------------------------------------------------------------------ layers


def _layer_cfgs(norm):
    return (dataclasses.replace(jax_smoke(ARCH), norm=norm),
            dataclasses.replace(get_smoke_config(ARCH), norm=norm))


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms_match_jax(norm):
    jcfg, cfg = _layer_cfgs(norm)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(2, 5, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32),
         "bias": rng.normal(size=64).astype(np.float32)}
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), jcfg)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("hd", [16, 80])
def test_rope_matches_jax(hd):
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, 7, 3, hd)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 500]).astype(np.int32)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             10_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "squared_relu",
                                      "gelu"])
def test_mlp_matches_jax(mlp_type):
    jcfg = dataclasses.replace(jax_smoke(ARCH), mlp_type=mlp_type)
    cfg = dataclasses.replace(get_smoke_config(ARCH), mlp_type=mlp_type)
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), jcfg)
    got = tlayers.apply_mlp({k: torch.from_numpy(np.array(v))
                             for k, v in jp.items()},
                            torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ the slice


def test_prefill_logits_match_jax(served):
    logits, cache = _engine(served).prefill(served["prompts"])
    np.testing.assert_allclose(logits.numpy(), served["jlogits"], **TOL)
    assert cache.length == 12 and cache.kv_k.shape == (2, 2, 32, 4, 16)
    assert cache.pos.tolist() == [12, 12]


def test_forward_logits_match_jax(served):
    toks = torch.from_numpy(served["prompts"]).long()
    got, aux = T.forward(served["params"], toks, served["cfg"])
    want, _ = JT.forward(served["jparams"], jnp.asarray(served["prompts"]),
                         served["jcfg"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


def test_greedy_generation_matches_jax(served):
    res = _engine(served).generate(served["prompts"], N_NEW)
    assert isinstance(res, GenerationResult) and res.steps == N_NEW
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])
    np.testing.assert_allclose(res.logprobs.numpy(), served["jlogprobs"],
                               **TOL)


def test_greedy_equals_repeated_forward_argmax(served):
    """The port's engine (prefill, then decode against the cache) against
    the slow oracle: a full forward over the growing sequence per step."""
    toks = torch.from_numpy(served["prompts"]).long()
    want = []
    for _ in range(N_NEW):
        logits, _ = T.forward(served["params"], toks, served["cfg"])
        nxt = logits[:, -1].argmax(-1)
        want.append(nxt)
        toks = torch.cat([toks, nxt[:, None]], dim=1)
    got = _engine(served).generate(served["prompts"], N_NEW).tokens
    assert torch.equal(got, torch.stack(want, dim=1))


def test_decode_writes_the_cache_in_place(served):
    engine = _engine(served)
    logits, cache = engine.prefill(served["prompts"])
    ptr = cache.kv_k.data_ptr()
    nxt = logits.argmax(-1)[:, None]
    _, cache2 = engine.decode(cache, nxt)
    assert cache2.kv_k.data_ptr() == ptr and cache2.length == 13
    assert cache2.pos.tolist() == [13, 13]
    assert bool(cache2.kv_k[:, :, 12].abs().sum() > 0)
    assert bool((cache2.kv_k[:, :, 13:] == 0).all())


def test_plain_route_equals_the_default_on_cpu(served):
    a = _engine(served).generate(served["prompts"], 3)
    b = _engine(served, path="ref").generate(served["prompts"], 3)
    assert torch.equal(a.tokens, b.tokens)
    with pytest.raises(ValueError):
        _engine(served, path="quant").generate(served["prompts"], 1)


def test_launch_counts_on_the_kernel_route(served, monkeypatch):
    """The CUDA branch of the path, driven on the CPU: the wrappers take
    their launch branch (``ops._check`` reports a card), the launchers run
    the plain versions.  Each layer launches B10 seven times and the
    unembedding once, in the prefill and in every decode step; B11 once a
    layer, in the prefill only."""
    monkeypatch.setattr(tgemm, "launch", tref.matmul)
    monkeypatch.setattr(tfa, "launch", tref.attention)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    tops.reset_launches()
    res = _engine(served).generate(served["prompts"], N_NEW)
    n_layers = served["cfg"].n_layers
    assert tops.LAUNCHES["matmul"] == (7 * n_layers + 1) * (1 + N_NEW)
    assert tops.LAUNCHES["flash_attention"] == n_layers
    assert sum(tops.LAUNCHES.values()) == \
        tops.LAUNCHES["matmul"] + n_layers
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])


# ------------------------------------------------------------------ engine


def test_temperature_without_generator_raises(served):
    engine = _engine(served)
    with pytest.raises(ValueError, match="generator"):
        engine.generate(served["prompts"], 2, temperature=0.7)
    assert engine.generate(served["prompts"], 2).tokens.shape == (2, 2)


def test_sampling_is_reproducible_from_a_seed(served):
    engine = _engine(served)

    def draw(seed):
        return engine.generate(served["prompts"], 4, temperature=0.8,
                               generator=torch.Generator().manual_seed(seed))
    a, b = draw(7), draw(7)
    assert torch.equal(a.tokens, b.tokens)
    assert a.tokens.shape == (2, 4)
    assert bool(((a.tokens >= 0) & (a.tokens < 128)).all())


def test_engine_rejects_overlong_runs(served):
    engine = _engine(served, max_seq=16)
    with pytest.raises(ValueError, match="max_seq"):
        engine.generate(served["prompts"], 5)
    with pytest.raises(ValueError, match="max_seq"):
        _engine(served, max_seq=8).prefill(served["prompts"])


def test_params_from_numpy_names_missing_and_misshapen_leaves(served):
    cfg = served["cfg"]
    tree = jax.tree.map(np.asarray, served["jparams"])
    bad = dict(tree, embed={"tok": tree["embed"]["tok"]})
    with pytest.raises(KeyError, match="unembed"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32),
                                 "bias": np.zeros(64, np.float32)})
    with pytest.raises(ValueError, match="final_norm/scale"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    # bf16 leaves (the reference's dtype at scale) arrive as bf16
    leaf = convert.lm_params_from_numpy(
        cfg, jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          served["jparams"]), device="cpu")["embed"]["tok"]
    assert leaf.dtype == torch.bfloat16
    assert torch.equal(leaf, served["params"]["embed"]["tok"].bfloat16())


def test_lm_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(get_smoke_config(ARCH))
    with pytest.raises(RuntimeError):
        tserve.main(["--algo", "lm", "--smoke", "--new-tokens", "1"])


def test_serve_cli_lm_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--algo", "lm", "--smoke", "--batch", "2", "--prompt-len", "8",
         "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[serve] arch=stablelm-3b device=cpu "
                           "params=98560 batch=2 prompt=8 generated 8 tokens")
    assert "tok/s" in line
