"""gemma-7b (the tied unembedding) and jamba-1.5-large-398b (the hybrid
layer plan) in the port against the JAX package, and the chip phases of
the three archs of ``models/ssm.py``'s slice (gemma-7b, mamba2-780m,
jamba).

Each arch's reduced config (``get_smoke_config``: d_model 64, fp32; gemma
2 layers of head_dim 16; jamba one unit of 4 sublayers, SSD mixers and
attention at position 3, an MoE of 8 experts top-2 at positions 1 and 3)
is initialised by the reference, its params carried across with
``convert.lm_params_from_numpy`` (one JAX model an arch, built by the
``served`` fixture), and both packages serve the same numpy prompts.  The
bar is ROADMAP C's fp32 bar: greedy tokens exactly, values to rtol = atol
= 1e-5, the tied table's loss gradient too.  Full width is checked on the
``meta`` device only; ``chip_smoke.py`` serves gemma-7b at full width
and jamba at ``reduced`` widths on the card.
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
from repro.models import layers as jlayers
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro.training import trainer as jtr
from repro_torch import convert
from repro_torch import tree as TR
from repro_torch.configs import base as tbase
from repro_torch.configs.registry import (ALL_ARCH_IDS, get_config,
                                          get_smoke_config)
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_select as tts
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine
from repro_torch.training import trainer

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]
GEMMA, JAMBA, MAMBA = "gemma-7b", "jamba-1.5-large-398b", "mamba2-780m"
ARCHS = (GEMMA, JAMBA)
N_NEW = 5
S_TOK = 12
MAX_SEQ = 24


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), **tol)


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced arch in both packages on one set of weights, and the
    reference's prefill (logits and cache), forward and greedy
    generation."""
    arch = request.param
    jcfg = jax_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(arch)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, S_TOK)).astype(np.int32)
    engine = JaxServeEngine(jcfg, jparams, jbase.ServeConfig(max_seq=MAX_SEQ))
    jlogits, jcache = engine.prefill(jnp.asarray(prompts))
    jres = engine.generate(jnp.asarray(prompts), N_NEW)
    jforward, _ = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, jnp.asarray(prompts))
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, jparams=jparams,
                params=params, prompts=prompts, jlogits=np.asarray(jlogits),
                jcache=jcache, jforward=np.asarray(jforward),
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
        assert port.active_param_count() == ref.active_param_count()
        assert T.layer_plan(port) == JT.layer_plan(ref)


def test_layer_plans():
    """gemma one attention layer a unit, its MLP GeGLU; jamba a unit of 8
    (4 reduced) sublayers, attention at 4 (3), MoE at every odd one."""
    assert T.layer_plan(get_config(GEMMA)) == (["attn"], ["mlp"], 1, 28)
    assert T.layer_plan(get_config(JAMBA)) == (
        ["ssm"] * 4 + ["attn"] + ["ssm"] * 3, ["mlp", "moe"] * 4, 8, 9)
    assert T.layer_plan(get_smoke_config(JAMBA)) == (
        ["ssm"] * 3 + ["attn"], ["mlp", "moe"] * 2, 4, 1)
    assert T.ssm_slots(get_config(JAMBA)) == [0, 1, 2, 3, None, 4, 5, 6]


@pytest.mark.parametrize("arch,count,extra", [
    (GEMMA, 8_537_677_824, 3_072), (JAMBA, 397_709_850_880, 1_040_384)])
def test_full_width_counts_and_shapes_on_meta(arch, count, extra):
    """The reference's count at full width, and the port's tree on the
    meta device (nothing allocated) in the reference's leaf shapes and
    dtypes; no ``unembed`` for gemma's tied table; jamba's units under
    ``sub0`` .. ``sub7``, each stacked over its 9 units.  The tree holds
    what the count leaves out (``chip_smoke.tree_extra``: the final norm
    and, for jamba, its 63 SSD mixers' gated norms of 16,384)."""
    cfg = get_config(arch)
    assert cfg.param_count() == jax_get_config(arch).param_count() == count
    params = T.init_params(cfg, device="meta")
    assert sum(t.numel() for t in TR.leaves(params)) == count + extra
    assert _chip_smoke().tree_extra(cfg) == extra
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                    jax_get_config(arch)))
    assert jax.tree.map(lambda a: tuple(a.shape), jshapes) == \
        T.param_shapes(cfg)
    assert [str(t.dtype).replace("torch.", "") for t in TR.leaves(params)] \
        == [str(a.dtype) for a in jax.tree.leaves(jshapes)]
    shapes = T.param_shapes(cfg)
    if arch == GEMMA:
        assert shapes["embed"] == {"tok": (256_000, 3072)}
        assert shapes["layers"]["sub0"]["attn"]["wq"] == (28, 3072, 4096)
    else:
        assert sorted(shapes["layers"]) == [f"sub{j}" for j in range(8)]
        assert "attn" in shapes["layers"]["sub4"]
        assert shapes["layers"]["sub1"]["moe"]["w_in"] == \
            (9, 16, 8192, 24_576)
        assert shapes["layers"]["sub0"]["ssm"]["wz"] == (9, 8192, 16_384)


def test_registry_resolves_all_ten_archs():
    """The port's registry holds the reference's ten archs, in its
    order."""
    from repro.configs.registry import ALL_ARCH_IDS as JIDS
    assert ALL_ARCH_IDS == JIDS and len(ALL_ARCH_IDS) == 10


# ------------------------------------------------------------------ the tied
# unembedding


def test_tied_unembed_matches_jax():
    """``apply_unembed`` of a tied arch is the reference's ``x @ tok.T``;
    an untied arch keeps its own ``unembed``."""
    jcfg, cfg = jax_smoke(GEMMA), get_smoke_config(GEMMA)
    rng = np.random.default_rng(2)
    tok = rng.normal(size=(cfg.vocab_size, cfg.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = jlayers.apply_unembed({"tok": jnp.asarray(tok)}, jnp.asarray(x),
                                 jcfg)
    got = tlayers.apply_unembed({"tok": torch.from_numpy(tok)},
                                torch.from_numpy(x), cfg)
    assert got.shape == (2, 5, cfg.vocab_size)
    _close(got, want)
    with pytest.raises(KeyError):
        tlayers.apply_unembed({"tok": torch.from_numpy(tok)},
                              torch.from_numpy(x), get_smoke_config(JAMBA))


@pytest.mark.parametrize("arch", [GEMMA, MAMBA])
def test_tied_table_gradient_matches_jax_grad(arch):
    """The loss gradient of every leaf, the tied table's included: its
    embedding and unembedding parts summed, as ``jax.grad`` sums them
    through ``tok.T``; a table the unembedding did not feed would miss
    the second part."""
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(2, 10))
             .astype(np.int32) for k in ("tokens", "targets")}
    (jloss, _), jgrads = jax.value_and_grad(jtr.loss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        jbase.TrainConfig(remat="none"))
    loss, _, grads = trainer.loss_and_grads(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        cfg, tbase.TrainConfig(remat="none"))
    _close(loss, jloss)
    flat = TR.flatten(grads)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [p for p, _ in flat] == \
        ["/".join(k.key for k in path) for path, _ in jflat]
    for (path, g), (_, jg) in zip(flat, jflat):
        _close(g, jg)
    # the unembedding's part of the table's gradient is most of it: the
    # embedding's part alone touches only the 20 rows the tokens take
    tok = grads["embed"]["tok"]
    untouched = np.setdiff1d(np.arange(cfg.vocab_size), batch["tokens"])
    assert float(tok[untouched].abs().sum()) > 0


# ------------------------------------------------------------------ serving


def test_prefill_logits_and_cache_match_jax(served):
    """The last position's logits; the cache's k and v (the reference's
    carry one more axis, its attention sublayers a unit: 1) and, for
    jamba, its SSD mixers' windows and states with the reference's
    (n_units, n_ssm) axes."""
    logits, cache = _engine(served).prefill(served["prompts"])
    _close(logits, served["jlogits"])
    jc = served["jcache"]
    assert jc.kv_k.shape[1] == 1
    _close(cache.kv_k, np.asarray(jc.kv_k)[:, 0])
    _close(cache.kv_v, np.asarray(jc.kv_v)[:, 0])
    if served["arch"] == GEMMA:
        assert cache.ssm is None and jc.ssm is None
        return
    assert cache.ssm.h.shape[:2] == (1, 3)
    for got, want in zip(cache.ssm, jc.ssm):
        assert tuple(got.shape) == want.shape
        _close(got, want)


def test_forward_logits_match_jax(served):
    got, aux = T.forward(served["params"],
                         torch.from_numpy(served["prompts"]).long(),
                         served["cfg"])
    _close(got, served["jforward"])


def test_greedy_generation_matches_jax(served):
    res = _engine(served).generate(served["prompts"], N_NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])
    _close(res.logprobs, served["jlogprobs"])


def test_layer_states_walk_every_sublayer(served):
    """``layer_states`` (the per-layer check's input) gives one state a
    sublayer (jamba's unit of 4 counts 4), and its last is the forward
    pass's before the final norm."""
    cfg, params = served["cfg"], served["params"]
    toks = torch.from_numpy(served["prompts"]).long()
    states = T.layer_states(params, toks, cfg)
    assert len(states) == cfg.n_layers
    logits = tlayers.apply_unembed(
        params["embed"], tlayers.apply_norm(params["final_norm"], states[-1],
                                            cfg), cfg)
    _close(logits, served["jforward"])


def _kernel_route(monkeypatch):
    """The wrappers' card branch on the CPU: ``ops._check`` reports a card
    and B10, B11 and B5's launchers run the plain versions, each counting
    its route."""
    def gemm_launch(a, b, tile_n=0):
        tgemm.ROUTE_LAUNCHES[tgemm.route(a, b)] += 1
        return tref.matmul(a, b)

    def attn_launch(q, k, v, causal=True):
        tfa.ROUTE_LAUNCHES[tfa.route(q, k, v)] += 1
        return tref.attention(q, k, v, causal)

    def select_launch(x, k):
        tts.ROUTE_LAUNCHES[tts.route(k)] += 1
        return tref.topk_smallest(x, k)
    monkeypatch.setattr(tgemm, "launch", gemm_launch)
    monkeypatch.setattr(tfa, "launch", attn_launch)
    monkeypatch.setattr(tts, "launch", select_launch)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])


def test_launch_counts_on_the_kernel_route(served, monkeypatch):
    """gemma launches B10 seven times a layer (q, k, v, o, GeGLU's in,
    gate and out) and once for the tied unembedding a pass, B11 once a
    layer in the prefill; jamba's unit six times an SSD mixer, four for
    its attention, three a dense MLP, B5 once an MoE (its router), B11
    once for its attention.  ``chip_smoke.lm_launch_plan`` derives the
    same, and at the chip phases' shapes gemma B10 (7·28 + 1)·33 = 6,501
    and B11 28."""
    _kernel_route(monkeypatch)
    tops.reset_launches()
    res = _engine(served).generate(served["prompts"], N_NEW)
    cfg = served["cfg"]
    if served["arch"] == GEMMA:
        want = dict(matmul=(7 * cfg.n_layers + 1) * (1 + N_NEW),
                    flash_attention=cfg.n_layers)
    else:
        want = dict(matmul=(3 * 6 + 4 + 2 * 3 + 1) * (1 + N_NEW),
                    flash_attention=1, topk_smallest=2 * (1 + N_NEW))
        assert tts.ROUTE_LAUNCHES == {"filter": 2 * (1 + N_NEW), "radix": 0}
    assert {k: v for k, v in tops.LAUNCHES.items() if v} == want
    cs = _chip_smoke()
    plan = cs.lm_launch_plan(torch, cfg, 2, S_TOK, N_NEW)
    assert {k: v for k, v in plan["launches"].items() if v} == want
    assert cs.lm_launch_plan(torch, get_config(GEMMA), 4, 512, 32)[
        "launches"] == dict(matmul=6_501, flash_attention=28)
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])


def test_jamba_cache_specs_and_shapes_match_jax():
    """jamba's decode cache at full width: k and v for its one attention
    sublayer a unit, (9, B, S, 8, 128) (the reference's carry its
    attention axis of 1), and the SSM state with the reference's (9, 7)
    axes and logical spec ("blocks", "layers", ...)."""
    cfg, jcfg = get_config(JAMBA), jax_get_config(JAMBA)
    lg, jlg = T.cache_logical(cfg), JT.cache_logical(jcfg)
    assert lg.kv_k == jlg.kv_k[:1] + jlg.kv_k[2:]
    assert tuple(lg.ssm) == tuple(jlg.ssm)
    c = T.init_cache(cfg, 2, 64, device="meta")
    jc = jax.eval_shape(lambda: JT.init_cache(jcfg, 2, 64))
    assert tuple(c.kv_k.shape) == (9, 2, 64, 8, 128) == \
        jc.kv_k.shape[:1] + jc.kv_k.shape[2:]
    assert [tuple(t.shape) for t in c.ssm] == [t.shape for t in jc.ssm]
    assert c.ssm.h.shape == (9, 7, 2, 256, 64, 128)


# ------------------------------------------------------------------ the CLI
# and the dry run


@pytest.mark.parametrize("arch", [GEMMA, MAMBA, JAMBA])
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


def test_dry_run_cells_of_the_three_archs():
    """The dry run builds the three archs' cells at full width on the
    meta device: ``long_500k`` for the sub-quadratic mamba2 and jamba
    (skipped for gemma, as the reference skips it), and ``--ssm-chunk``
    recorded and honoured (the trees do not depend on the chunk)."""
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(GEMMA, "long_500k", False)
    assert rec["status"] == "skipped"
    for arch in (MAMBA, JAMBA):
        rec = dryrun.run_cell(arch, "long_500k", False)
        assert rec["status"] == "ok" and rec["global_batch"] == 1
        assert rec["params"] == get_config(arch).param_count()
        assert rec["specs"]["cache"]["ssm/h"][:2] == [None, None]
        chunk = dryrun.run_cell(arch, "long_500k", False,
                                variant={"ssm_chunk": 128})
        assert chunk["variant"] == {"ssm_chunk": 128}
        assert chunk["ssm_chunk"] == 128 and rec["ssm_chunk"] == 256
        assert chunk["bytes"] == rec["bytes"]
    rec = dryrun.run_cell(JAMBA, "decode_32k", True)
    assert rec["bytes"]["cache"]["per_device"] > 0


# ------------------------------------------------------------------ the chip


def test_lm_path_shapes():
    """gemma's B10 shapes (K = 3,072, N = 4,096 and 24,576 and K =
    24,576; the tied unembedding at N = 256,000) and its B11 shape (4,
    16, 512, 256), the first path shape at head_dim 256; jamba's reduced
    phase its SSD and attention projections at d_model 64."""
    cs = _chip_smoke()
    gemm, attn = cs.lm_path_shapes(get_config(GEMMA), 4, 512)
    assert gemm == [(2048, 4096, 3072), (2048, 3072, 4096),
                    (2048, 24_576, 3072), (2048, 3072, 24_576),
                    (4, 4096, 3072), (4, 3072, 4096), (4, 24_576, 3072),
                    (4, 3072, 24_576), (4, 256_000, 3072)]
    assert attn == (4, 16, 512, 256)
    cfg = cs.phase_config(next(s for s in cs.LM_ARCHS if s["tag"] == "jamba"))
    assert cfg.arch_id == f"{JAMBA}-reduced" and cfg.dtype == "bfloat16"
    gemm, attn = cs.lm_path_shapes(cfg, 4, 512)
    # q and o, k and v (one KV head of 16), z and x (and the MLP's in),
    # dt (8 heads), the SSD's and the MLP's out; B and C (16) are k's
    assert gemm[:5] == [(2048, 64, 64), (2048, 16, 64), (2048, 128, 64),
                        (2048, 8, 64), (2048, 64, 128)]
    assert attn == (4, 4, 512, 16)


def test_tied_routes_take_the_kernel_routes_experts(monkeypatch):
    """``chip_smoke.tied_routes``: the plain route's router returns the
    kernel route's expert ids, and a choice the two differ on away from a
    near-tie is counted: a B5 that returns the wrong experts (the kernel
    route's logits agree with the plain route's, so no gap is a near-tie)
    is caught."""
    cs = _chip_smoke()
    cfg = get_smoke_config(JAMBA)
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg,
                      torch.device("cpu"))
    x = torch.randn((16, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    tie = cs.tied_routes(torch)
    w_k, ids_k, _ = tmoe.route(p, x, cfg)
    w_p, ids_p, _ = tmoe.route(p, x, cfg, "ref")
    assert torch.equal(ids_p, ids_k)
    _close(w_p, w_k)
    assert tie.close() == dict(decisions=16, flips=0, far=0)
    assert tmoe.route is tie.real
    # a faulty B5 on the kernel route: the last expert chosen is the
    # worst one instead
    real_topk = tops.topk_smallest

    def wrong(v, k):
        vals, idx = real_topk(v, k)
        worst = torch.argmax(v, dim=-1, keepdim=True).to(idx.dtype)
        return vals, torch.cat([idx[:, :-1], worst], dim=1)
    monkeypatch.setattr(tops, "topk_smallest", wrong)
    tie = cs.tied_routes(torch)
    _, ids_k, _ = tmoe.route(p, x, cfg)
    _, ids_p, _ = tmoe.route(p, x, cfg, "ref")
    assert torch.equal(ids_p, ids_k)
    counts = tie.close()
    assert counts["flips"] == counts["far"] == 16


def _phase(tag, monkeypatch):
    """``chip_smoke`` with the card's timing calls stubbed and the
    launchers the plain versions (``_kernel_route``), the ``LM_ARCHS``
    spec of ``tag`` at 2 prompts of 40 tokens and 3 new ones, and its
    config: the reduced arch in bf16."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    from repro_torch.launch import lm_kernel_times
    monkeypatch.setattr(lm_kernel_times, "device_kernels", lambda fn: {})
    spec = dict(next(s for s in cs.LM_ARCHS if s["tag"] == tag),
                batch=2, prompt=40, new=3)
    if tag == "jamba":
        cfg = cs.phase_config(spec)
    else:
        cfg = dataclasses.replace(get_smoke_config(spec["arch"]),
                                  dtype="bfloat16")
        monkeypatch.setattr(cs, "phase_config", lambda s: cfg)
    return cs, spec, cfg


@pytest.mark.parametrize("tag", ["gemma", "mamba2", "jamba"])
def test_chip_phase_rehearsal(tag, monkeypatch, capsys):
    """``chip_smoke.lm_arch_path`` on the CPU at the reduced arch in bf16:
    the card's timing calls stubbed, the launchers the plain versions;
    every check of the phase runs (launches and routes as
    ``lm_launch_plan`` derives them, B5's for jamba, the logits gate with
    jamba's routers tied, gemma's and mamba2's the fp32 gate, the
    per-layer check, jamba's made for routing)."""
    cs, spec, cfg = _phase(tag, monkeypatch)
    launches = cs.lm_arch_path(torch, tops, torch.device("cpu"), spec)
    plan = cs.lm_launch_plan(torch, cfg, 2, 40, 3)["launches"]
    assert {k: v for k, v in launches.items() if v} == \
        {k: v for k, v in plan.items() if v}
    out = capsys.readouterr().out
    assert f"[lm/{tag}] {cfg.arch_id} batch=2" in out
    assert f"at all {cfg.n_layers} layers" in out
    assert ("logits from an fp32 route at most" in out) == (tag != "jamba")
    if tag == "jamba":
        assert cfg.arch_id == f"{JAMBA}-reduced"
        assert "B5=8, routes B5 {'filter': 8, 'radix': 0}" in out
        # the prefill's 2 x 40 tokens and 3 decode steps' 2, at 2 routers
        assert f"0 of {2 * (2 * 40 + 3 * 2)} decisions differed" in out


@pytest.mark.parametrize("where", ["unembedding", "every launch"])
@pytest.mark.parametrize("tag", ["gemma", "mamba2"])
def test_fp32_gate_fails_a_wrong_b10_tile(tag, where, monkeypatch,
                                          capsys):
    """The fp32 logits gate of ``[lm/gemma]`` and ``[lm/mamba2]`` fails a
    B10 whose first 16 output columns leave out the last 16 rows of K: in
    the tied unembedding alone (which no per-layer check sees), or in
    every launch.  The logits gate is the first check to fail."""
    cs, spec, cfg = _phase(tag, monkeypatch)
    plain = tgemm.launch

    def wrong(a, b, tile_n=0):
        out = plain(a, b)
        if where == "every launch" or b.shape[1] == cfg.vocab_size:
            out[:, :16] -= (a[:, -16:].float() @ b[-16:, :16].float()
                            ).to(out.dtype)
        return out
    monkeypatch.setattr(tgemm, "launch", wrong)
    with pytest.raises(SystemExit):
        cs.lm_arch_path(torch, tops, torch.device("cpu"), spec)
    out = capsys.readouterr().out
    assert f"FAIL: lm/{tag} step 0: the kernel route's logits stand" in out
