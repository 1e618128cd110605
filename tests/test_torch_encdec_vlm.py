"""whisper-large-v3 (enc-dec) and phi-3-vision-4.2b (VLM) in the port against
the JAX package.

The stub frontends' inputs (encoder frames, patch embeddings) and the
prompts are drawn from numpy with a seed; each arch's reduced config
(``get_smoke_config``: 2 layers, d_model 64, fp32; whisper 2 encoder layers
over 16 frames, phi-3-vision 4 patches) is initialised by the reference,
its params carried across with ``convert.lm_params_from_numpy``.  The new
modules (``sinusoidal_positions``, ``encode_cross_kv``,
``apply_cross_attention``, ``apply_encoder``) match the reference's to
1e-5; served, logits, log-probabilities and the cache's ``cross_kv`` to
rtol = atol = 1e-4 and greedy tokens exactly, as in
``tests/test_torch_lm.py``.  Full width is checked on the ``meta`` device
only; ``chip_smoke.py`` serves both archs at full width on the card.
"""
import dataclasses
import functools
import importlib.util
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
from repro.models import attention as jattn
from repro.models import factory as jfactory
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.models import whisper as jwhisper
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import factory as tfactory
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as T
from repro_torch.models import whisper as twhisper
from repro_torch.serving import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
MOD_TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
WHISPER, VLM = "whisper-large-v3", "phi-3-vision-4.2b"
ARCHS = (WHISPER, VLM)
N_NEW = 5
S_TOK = 12
MAX_SEQ = 24


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _frontend(cfg, rng, batch=2):
    """The stub frontends' inputs of ``cfg`` as numpy arrays."""
    out = {}
    if cfg.encoder is not None:
        out["encoder_frames"] = rng.normal(
            size=(batch, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    if cfg.vision is not None:
        out["patch_embeds"] = rng.normal(
            size=(batch, cfg.vision.num_patches,
                  cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced arch in both packages on one set of weights and one set
    of frontend inputs, and the reference's prefill (logits and cache),
    forward and greedy generation (one jitted prefill serves both)."""
    arch = request.param
    jcfg = jax_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(arch)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(2, S_TOK)).astype(np.int32)
    front = _frontend(cfg, rng)
    jfront = {k: jnp.asarray(v) for k, v in front.items()}
    engine = JaxServeEngine(jcfg, jparams, jbase.ServeConfig(max_seq=MAX_SEQ))
    jlogits, jcache = engine.prefill(jnp.asarray(prompts), **jfront)
    jres = engine.generate(jnp.asarray(prompts), N_NEW, **jfront)
    jforward, _ = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, jnp.asarray(prompts), **jfront)
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, jparams=jparams,
                params=params, prompts=prompts, front=front,
                jlogits=np.asarray(jlogits), jcache=jcache,
                jforward=np.asarray(jforward),
                jtokens=np.asarray(jres.tokens),
                jlogprobs=np.asarray(jres.logprobs))


def _engine(s, max_seq=MAX_SEQ, **kw):
    return ServeEngine(s["cfg"], s["params"],
                       tbase.ServeConfig(max_seq=max_seq), **kw)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.head_dim == ref.head_dim and port.q_dim == ref.q_dim
    cfg = get_config(arch)
    assert (cfg.encoder, cfg.vision) == (
        (tbase.EncoderConfig(n_layers=32, n_ctx=1500), None) if arch == WHISPER
        else (None, tbase.VisionConfig(num_patches=576)))


@pytest.mark.parametrize("arch,count,extra", [
    (WHISPER, 1_600_988_160, 209_920), (VLM, 3_821_076_480, 3_072)])
def test_full_width_counts_and_shapes_on_meta(arch, count, extra):
    """The reference's count at full width, and the port's tree on the
    meta device (nothing allocated) in the reference's leaf shapes, the
    encoder and the cross-attention blocks included; the tree holds the
    norms the count leaves out (``chip_smoke.tree_extra``: for whisper
    the two final norms, every LayerNorm's bias, and the cross blocks'
    norms past the one d_model counted for each)."""
    cfg = get_config(arch)
    assert cfg.param_count() == jax_get_config(arch).param_count() == count
    params = T.init_params(cfg, device="meta")

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    assert sum(t.numel() for t in leaves(params)) == count + extra
    assert _chip_smoke().tree_extra(cfg) == extra
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                    jax_get_config(arch)))
    shapes = T.param_shapes(cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), jshapes) == shapes
    if arch == WHISPER:
        assert shapes["encoder"]["layers"]["attn"]["wq"] == (32, 1280, 1280)
        assert shapes["cross"]["attn"]["wk"] == (32, 1280, 1280)
        assert shapes["cross"]["norm"]["bias"] == (32, 1280)


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize("n_ctx,d", [(16, 64), (5, 6), (64, 1280)])
def test_sinusoidal_positions_match_jax(n_ctx, d):
    got = tlayers.sinusoidal_positions(n_ctx, d)
    assert got.dtype == torch.float32 and got.shape == (n_ctx, d)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jlayers.sinusoidal_positions(n_ctx, d)),
        **MOD_TOL)


def test_sinusoidal_table_at_full_width():
    """whisper's (1500, 1280) table: the frequencies exp(-ln(1e4)·i/639)
    of the two packages differ in the last bit where XLA's fp32 ``exp`` is
    not correctly rounded (torch's is, but for a few), and position 1,499
    multiplies that bit into the angle; every column whose frequency the
    two compute alike agrees to 1e-5."""
    n_ctx, d = 1500, 1280
    half = d // 2
    c = -np.log(10_000.0).item()
    same = np.asarray(jnp.exp(c * jnp.arange(half, dtype=jnp.float32) /
                              (half - 1))) == \
        torch.exp(c * torch.arange(half, dtype=torch.float32) /
                  (half - 1)).numpy()
    assert same.sum() > 0.9 * half
    got = tlayers.sinusoidal_positions(n_ctx, d).numpy()
    want = np.asarray(jlayers.sinusoidal_positions(n_ctx, d))
    cols = np.concatenate([same, same])
    np.testing.assert_allclose(got[:, cols], want[:, cols], **MOD_TOL)


def _cross_case():
    jcfg, cfg = jax_smoke(WHISPER), get_smoke_config(WHISPER)
    jp = jattn.init_attention(jax.random.PRNGKey(5), jcfg, cross=True)
    assert "q_norm" not in jp
    rng = np.random.default_rng(4)
    memory = rng.normal(size=(2, 16, 64)).astype(np.float32)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    return jcfg, cfg, jp, _torch_tree(jp), memory, x


def test_encode_cross_kv_matches_jax():
    jcfg, cfg, jp, p, memory, _ = _cross_case()
    want = jattn.encode_cross_kv(jp, jnp.asarray(memory), jcfg)
    got = tattn.encode_cross_kv(p, torch.from_numpy(memory), cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 16, cfg.n_kv_heads,
                                             cfg.head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MOD_TOL)


def test_apply_cross_attention_matches_jax():
    jcfg, cfg, jp, p, memory, x = _cross_case()
    jkv = jattn.encode_cross_kv(jp, jnp.asarray(memory), jcfg)
    want = jattn.apply_cross_attention(jp, jnp.asarray(x), jkv, jcfg)
    kv = tuple(torch.from_numpy(np.array(t)) for t in jkv)
    got = tattn.apply_cross_attention(p, torch.from_numpy(x), kv, cfg)
    assert got.shape == (2, 7, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)
    # no RoPE: the keys' order does not matter, as in the reference
    perm = torch.randperm(16, generator=torch.Generator().manual_seed(0))
    shuffled = tattn.apply_cross_attention(
        p, torch.from_numpy(x), tuple(t[:, perm] for t in kv), cfg)
    np.testing.assert_allclose(shuffled.numpy(), got.numpy(), **MOD_TOL)


def test_apply_encoder_matches_jax():
    jcfg, cfg = jax_smoke(WHISPER), get_smoke_config(WHISPER)
    jp = jwhisper.init_encoder(jax.random.PRNGKey(6), jcfg)
    frames = np.random.default_rng(5).normal(
        size=(2, 16, 64)).astype(np.float32)
    want = jwhisper.apply_encoder(jp, jnp.asarray(frames), jcfg)
    got = twhisper.apply_encoder(_torch_tree(jp), torch.from_numpy(frames),
                                 cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOD_TOL)


# ------------------------------------------------------------------ serving


def test_prefill_logits_and_cross_kv_match_jax(served):
    logits, cache = _engine(served).prefill(served["prompts"],
                                            **served["front"])
    np.testing.assert_allclose(logits.numpy(), served["jlogits"], **TOL)
    cfg, jc = served["cfg"], served["jcache"]
    P = cfg.vision.num_patches if cfg.vision is not None else 0
    assert cache.length == P + S_TOK and cache.pos.tolist() == [P + S_TOK] * 2
    # the reference's k and v carry one more axis (its layers a unit, 1)
    np.testing.assert_allclose(cache.kv_k.numpy(),
                               np.asarray(jc.kv_k)[:, 0], **TOL)
    if cfg.encoder is None:
        assert cache.cross_kv is None and jc.cross_kv is None
        return
    for got, want in zip(cache.cross_kv, jc.cross_kv):
        assert tuple(got.shape) == want.shape == (
            cfg.n_layers, 2, cfg.encoder.n_ctx, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_logits_match_jax(served):
    got, aux = T.forward(served["params"],
                         torch.from_numpy(served["prompts"]).long(),
                         served["cfg"], **{k: torch.from_numpy(v) for k, v
                                           in served["front"].items()})
    np.testing.assert_allclose(got.numpy(), served["jforward"], **TOL)
    assert float(aux) == 0.0


def test_greedy_generation_matches_jax(served):
    res = _engine(served).generate(served["prompts"], N_NEW,
                                   **served["front"])
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])
    np.testing.assert_allclose(res.logprobs.numpy(), served["jlogprobs"],
                               **TOL)


def test_decode_reads_cross_kv_and_never_writes_it(served):
    """A decode step hands whisper's memory (k, v) on untouched (the same
    tensors, the same values); a VLM's cache has none."""
    engine = _engine(served)
    logits, cache = engine.prefill(served["prompts"], **served["front"])
    if served["cfg"].encoder is None:
        _, cache2 = engine.decode(cache, logits.argmax(-1)[:, None])
        assert cache.cross_kv is None and cache2.cross_kv is None
        return
    before = [t.clone() for t in cache.cross_kv]
    _, cache2 = engine.decode(cache, logits.argmax(-1)[:, None])
    assert all(a is b for a, b in zip(cache2.cross_kv, cache.cross_kv))
    assert all(torch.equal(a, b) for a, b in zip(cache2.cross_kv, before))


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
    """whisper's prefill launches B10 six times an encoder layer (q, k, v,
    o, the gelu MLP's in and out) and ten a decoder layer (four for
    self-attention, two for its MLP, cross-attention's k and v of the
    memory and its q and o), its decode steps eight a layer (the memory's
    k and v come from the cache), each pass one unembedding more; B11
    once an encoder layer (bidirectional) and once a decoder layer
    (causal), in the prefill only.  phi-3-vision launches as stablelm:
    seven a layer and the unembedding.  ``chip_smoke.lm_launch_plan``
    derives the same counts."""
    _kernel_route(monkeypatch)
    tops.reset_launches()
    res = _engine(served).generate(served["prompts"], N_NEW,
                                   **served["front"])
    cfg = served["cfg"]
    L = cfg.n_layers
    if cfg.encoder is not None:
        Le = cfg.encoder.n_layers
        want = dict(matmul=6 * Le + 10 * L + 1 + N_NEW * (8 * L + 1),
                    flash_attention=Le + L)
    else:
        want = dict(matmul=(7 * L + 1) * (1 + N_NEW), flash_attention=L)
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == want
    plan = _chip_smoke().lm_launch_plan(torch, cfg, 2, S_TOK, N_NEW)
    assert plan["launches"] == want
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])


def test_layer_states_cover_the_encoder(served):
    """``layer_states`` (the per-layer check's input) returns the encoder's
    layers first, then the decoder's, and its last state is the forward
    pass's before the final norm."""
    cfg, params = served["cfg"], served["params"]
    front = {k: torch.from_numpy(v) for k, v in served["front"].items()}
    toks = torch.from_numpy(served["prompts"]).long()
    states = T.layer_states(params, toks, cfg, **front)
    n_enc = cfg.encoder.n_layers if cfg.encoder is not None else 0
    assert len(states) == n_enc + cfg.n_layers
    S = S_TOK + (cfg.vision.num_patches if cfg.vision is not None else 0)
    assert states[-1].shape == (2, S, cfg.d_model)
    logits = tlayers.apply_unembed(
        params["embed"], tlayers.apply_norm(params["final_norm"], states[-1],
                                            cfg), cfg)
    np.testing.assert_allclose(logits.numpy(), served["jforward"], **TOL)
    # the per-layer check's fp32 route: on these fp32 weights the casts are
    # copies, so the states are the default route's
    exact = T.layer_states(params, toks, cfg, path="ref",
                           dtype=torch.float32, **front)
    for a, b in zip(exact, states):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


# ------------------------------------------------------------------ the VLM's
# cache length (ROADMAP C: the reference's fault)


def test_vlm_cache_shorter_than_its_positions_raises():
    """The JAX serve CLI sizes a VLM's cache at prompt + new tokens, not
    patches + prompt + new: its prefill then leaves the cache at the P + S
    positions it filled (``pad`` is negative, so nothing is padded) and
    its decode clamps every write to the last position.  The port raises
    instead, in ``generate`` and in ``prefill``."""
    jcfg, cfg = jax_smoke(VLM), get_smoke_config(VLM)
    P, new = cfg.vision.num_patches, 3
    shape = jax.eval_shape(
        lambda p, t, e: JT.prefill(p, t, jcfg, max_seq=S_TOK + new,
                                   patch_embeds=e)[1],
        jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg)),
        jax.ShapeDtypeStruct((2, S_TOK), jnp.int32),
        jax.ShapeDtypeStruct((2, P, cfg.d_model), jnp.float32))
    assert shape.kv_k.shape[3] == P + S_TOK > S_TOK + new
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    front = _frontend(cfg, np.random.default_rng(1))
    prompts = np.zeros((2, S_TOK), np.int64)
    engine = ServeEngine(cfg, params, tbase.ServeConfig(max_seq=S_TOK + new))
    with pytest.raises(ValueError, match=f"{P} patch \\+ {S_TOK} prompt"):
        engine.generate(prompts, new, **front)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        ServeEngine(cfg, params, tbase.ServeConfig(max_seq=S_TOK)).prefill(
            prompts, **front)
    ok = ServeEngine(cfg, params, tbase.ServeConfig(
        max_seq=P + S_TOK + new)).generate(prompts, new, **front)
    assert ok.tokens.shape == (2, new)


# ------------------------------------------------------------------ specs


@pytest.mark.parametrize("mesh", [(1, 16, 16), (2, 16, 16), (1, 4, 2)])
def test_cross_kv_cache_specs_match_jax(mesh):
    """whisper's decode cache specs at every decode shape: the port's
    ``cross_kv`` pair takes the reference's spec (which has no "layers"
    axis), and its meta tensors the reference's shapes."""
    pods, data, model = mesh
    m = tbase.MeshConfig(data=data, model=model, pods=pods)
    jm = jbase.MeshConfig(data=data, model=model, pods=pods)
    from repro.configs.shapes import SHAPES as JSHAPES
    cfg, jcfg = get_config(WHISPER), jax_get_config(WHISPER)
    for name, shape in SHAPES.items():
        if not shape.is_decode:
            continue
        got = tfactory.cache_pspecs(cfg, shape, m).cross_kv
        want = jfactory.cache_pspecs(jcfg, JSHAPES[name], jm).cross_kv
        assert [tuple(s) for s in got] == [tuple(s) for s in want], name
        cs = tfactory.cache_shapes(cfg, shape).cross_kv
        jcs = jfactory.cache_shapes(jcfg, JSHAPES[name]).cross_kv
        assert [tuple(t.shape) for t in cs] == [t.shape for t in jcs]
        assert all(t.device.type == "meta" for t in cs)
    assert T.cache_logical(get_config(VLM)).cross_kv is None


# ------------------------------------------------------------------ the CLI
# and the chip


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--algo", "lm", "--arch", arch, "--smoke", "--batch", "2",
         "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith(f"[serve] arch={arch} device=cpu params="
                           f"{get_smoke_config(arch).param_count()} batch=2 "
                           "prompt=8 generated 8 tokens")


def test_lm_path_shapes():
    """The B10 and B11 shapes ``chip_smoke.lm_kernel_edges`` holds for the
    two archs: whisper's decoder at M = 256, its encoder and memory
    projections at M = 6,000, its unembedding at N = 51,866 (not a
    multiple of 16), B11 causal over the decoder's 64 tokens and
    bidirectional at S = 1,500 (a ragged last tile); phi-3-vision's
    prefill at M = 4 x (576 + 512), B11 causal at S = 1,088, d = 96."""
    cs = _chip_smoke()
    cfg = get_config(WHISPER)
    gemm, _ = cs.lm_path_shapes(cfg, 4, 64)
    assert gemm == [(256, 1280, 1280), (256, 5120, 1280), (256, 1280, 5120),
                    (4, 1280, 1280), (4, 5120, 1280), (4, 1280, 5120),
                    (4, 51866, 1280), (6000, 1280, 1280), (6000, 5120, 1280),
                    (6000, 1280, 5120)]
    assert cs.lm_attn_shapes(cfg, 4, 64) == [((4, 20, 64, 64), True),
                                             ((4, 20, 1500, 64), False)]
    gemm, attn = cs.lm_path_shapes(get_config(VLM), 4, 512)
    assert gemm[0] == (4352, 3072, 3072) and gemm[-1] == (4, 32064, 3072)
    assert attn == (4, 32, 1088, 96)


@pytest.mark.parametrize("arch", ARCHS)
def test_chip_phase_rehearsal(arch, monkeypatch, capsys):
    """``chip_smoke.lm_arch_path`` on the CPU at the reduced arch in bf16:
    the card's timing calls stubbed, the launchers the plain versions;
    every check of the phase runs (launches and routes as
    ``lm_launch_plan`` derives them, the logits gate, the per-layer check
    over the encoder's layers too)."""
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
    n = cfg.n_layers + (cfg.encoder.n_layers if cfg.encoder else 0)
    assert f"at all {n} layers" in out
