"""The PyTorch port's MoE LM family against the JAX package.

The reduced qwen3-moe-30b-a3b and phi3.5-moe-42b-a6.6b (``get_smoke_config``:
2 layers, d_model 64, 8 experts, top 2, fp32) are initialised by the
reference (``init_params(PRNGKey(0))``), their params carried across with
``repro_torch.convert.lm_params_from_numpy``, and both packages run the
same numpy inputs.  Two token counts cover both branches of the
dispatch: 2 x 12 tokens run dropless, 2 x 528 (> 1024) take the capacity
branch, where prompts drawn from four token ids crowd the experts so that
assignments really are dropped.  Router ids, ranks and the slot map
compare exactly; router weights, the aux loss and the MoE layer to 1e-5;
logits and log-probabilities to rtol = atol = 1e-4, as for the dense
family; greedy tokens exactly.  Full width is checked without allocating
it (counts, and shapes on the ``meta`` device).  On the CPU the wrappers
run their plain versions; the kernel route's branch is driven by
presenting the inputs as device tensors with the launchers replaced by
the plain versions.  ``chip_smoke.py`` serves qwen3-moe-30b-a3b at full
width on the card; its near-tie rule, per-layer check and ``[lm/moe]``
phase are rehearsed here.
"""
import dataclasses
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

from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.serving import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs.base import ServeConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_select as tts
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.serving import ServeEngine

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
N_NEW = 6
# (batch, prompt, token ids drawn from [0, n_ids)): 24 tokens dropless;
# 1056 tokens on the capacity branch, four ids crowding the experts
BRANCHES = {"dropless": (2, 12, 128), "capacity": (2, 528, 4)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One reduced MoE arch in both packages on the reference's weights."""
    arch = request.param
    jcfg = jax_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = get_smoke_config(arch)
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return dict(arch=arch, jcfg=jcfg, jparams=jparams, cfg=cfg,
                params=params)


def _layer0(s):
    """Layer 0's MoE params in both packages."""
    jp = jax.tree.map(lambda a: a[0], s["jparams"]["layers"]["sub0"]["moe"])
    return jp, T.layer_params(s["params"], 0)["moe"]


def _tokens_in(T_, seed, skew):
    """(T_, 64) fp32 router inputs; with ``skew`` every row leans towards
    one direction, so most tokens pick the same experts and a capacity
    branch drops assignments."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T_, 64)).astype(np.float32)
    if skew:
        x = 0.3 * x + 4.0 * rng.normal(size=(1, 64)).astype(np.float32)
    return x


def _jax_slot_map(weights, ids, C, num_experts):
    """The reference's slot-space dispatch (``_dispatch_compute_combine``,
    ``src/repro/models/moe.py:140-157``) over every expert (its e_base 0,
    e_local ``num_experts``) on given routing."""
    T_, k = ids.shape
    e_flat = ids.reshape(-1)
    ranks = JM._ranks_static(e_flat, num_experts)
    n_slots = num_experts * C
    slot = jnp.where(ranks < C, e_flat * C + ranks, n_slots)
    tok_idx = jnp.repeat(jnp.arange(T_), k)
    inv_tok = jnp.full((n_slots + 1,), T_, jnp.int32).at[slot].set(
        tok_idx, mode="drop")[:n_slots]
    w_slot = jnp.zeros((n_slots + 1,), jnp.float32).at[slot].set(
        weights.reshape(-1), mode="drop")[:n_slots]
    return (np.asarray(slot).reshape(T_, k), np.asarray(inv_tok),
            np.asarray(w_slot))


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_references(arch):
    for port, want in ((get_config(arch), jax_get_config(arch)),
                       (get_smoke_config(arch), jax_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(want)
        assert port.param_count() == want.param_count()
        assert port.active_param_count() == want.active_param_count()
        assert port.moe_layer_indices() == want.moe_layer_indices()


@pytest.mark.parametrize("arch,count,n_bytes", [
    ("qwen3-moe-30b-a3b", 30_532_108_288, 61_089_411_072),
    ("phi3.5-moe-42b-a6.6b", 41_872_523_264, 83_749_249_024)])
def test_full_width_counts_and_shapes_on_meta(arch, count, n_bytes):
    """The reference's count at full width, and the port's tree on the
    meta device (nothing allocated) in the reference's shapes: bf16 but
    for the fp32 router.  The count leaves out the final norm and the
    q/k norms, which the tree holds.  qwen3's 61.1 GB fit one 80 GB card;
    phi3.5-moe's 83.7 GB do not."""
    cfg = get_config(arch)
    assert cfg.param_count() == count
    params = T.init_params(cfg, device="meta")

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else [v])
    qk = 2 * cfg.head_dim * cfg.n_layers if cfg.attn.qk_norm else 0
    assert sum(t.numel() for t in leaves(params)) == \
        count + cfg.d_model + qk
    assert sum(t.numel() * t.element_size() for t in leaves(params)) == \
        n_bytes
    moe = params["layers"]["sub0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert all(t.device.type == "meta" for t in leaves(params))
    assert all(t.dtype == torch.bfloat16 for t in leaves(params)
               if t is not moe["router"])
    L_, E, d, f = (cfg.n_layers, cfg.moe.num_experts, cfg.d_model,
                   cfg.moe.d_ff_expert)
    sub = T.param_shapes(cfg)["layers"]["sub0"]
    assert "mlp" not in sub
    assert sub["moe"] == {"router": (L_, d, E), "w_in": (L_, E, d, f),
                          "w_gate": (L_, E, d, f), "w_out": (L_, E, f, d)}
    jshapes = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                    jax_get_config(arch)))
    assert jax.tree.map(lambda a: tuple(a.shape), jshapes) == \
        T.param_shapes(cfg)


def test_layer_plan_follows_the_reference():
    for arch in ARCHS + ("stablelm-3b",):
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (get_smoke_config(arch), jax_smoke(arch))):
            assert T.layer_plan(cfg) == JT.layer_plan(jcfg)
    # an MoE config with every > 1 takes the dense MLP in every layer, as
    # the reference's layer_plan does
    cfg = get_smoke_config(ARCHS[0])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            every=2))
    jcfg = dataclasses.replace(jax_smoke(ARCHS[0]), moe=cfg.moe)
    assert T.layer_plan(cfg) == JT.layer_plan(jcfg) == \
        (["attn"], ["mlp"], 1, 2)


# ------------------------------------------------------------------ the layer


@pytest.mark.parametrize("tokens", [1, 4, 12, 127, 1024, 1025, 1056, 2048,
                                    4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch, tokens):
    for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch))):
        assert M.capacity(tokens, cfg) == JM.capacity(tokens, jcfg)
    assert M.CAPACITY_FACTOR == JM.CAPACITY_FACTOR
    assert M.DROPLESS_THRESHOLD == JM.DROPLESS_THRESHOLD
    if tokens <= M.DROPLESS_THRESHOLD:      # dropless: every assignment
        cfg = get_config(arch)
        assert M.capacity(tokens, cfg) >= tokens * cfg.moe.top_k


@pytest.mark.parametrize("tokens,skew", [(12, False), (1056, False),
                                         (1056, True)])
def test_route_matches_jax(model, tokens, skew):
    jp, tp = _layer0(model)
    x = _tokens_in(tokens, 3, skew)
    w, ids, aux = JM.route(jp, jnp.asarray(x), model["jcfg"])
    tw, tids, taux = M.route(tp, torch.from_numpy(x), model["cfg"])
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(w), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(aux), **LAYER_TOL)
    # the router's fp32 logits: x read in its dtype, products in fp32
    want = jnp.einsum("td,de->te", jnp.asarray(x), jp["router"],
                      preferred_element_type=jnp.float32)
    np.testing.assert_allclose(M.router_logits(tp, torch.from_numpy(x))
                               .numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("A,E", [(1, 8), (24, 8), (2112, 8), (4096, 128),
                                 (333, 16)])
def test_ranks_static_matches_jax(A, E):
    e = np.random.default_rng(A).integers(0, E, size=A).astype(np.int32)
    if A > 1000:
        e[: A // 2] = 3                         # one crowded expert
    want = JM._ranks_static(jnp.asarray(e), E)
    got = M._ranks_static(torch.from_numpy(e), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("branch", ["dropless", "capacity"])
def test_slot_map_matches_jax(model, branch):
    """inv_tok and w_slot equal the reference's on the same routing (the
    reference's route, fed to both); on the capacity branch assignments
    are dropped."""
    jp, _ = _layer0(model)
    jcfg = model["jcfg"]
    m = jcfg.moe
    tokens = 12 if branch == "dropless" else 1056
    x = _tokens_in(tokens, 5, branch == "capacity")
    w, ids, _ = JM.route(jp, jnp.asarray(x), jcfg)
    C = JM.capacity(tokens, jcfg)
    want = _jax_slot_map(w, ids, C, m.num_experts)
    got = M.slot_map(torch.from_numpy(np.array(w)),
                     torch.from_numpy(np.array(ids)), C, m.num_experts)
    for g, ww in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), ww)
    dropped = int((got[0] == m.num_experts * C).sum())
    if branch == "capacity":
        assert C < tokens * m.top_k and dropped > 0
    else:
        assert dropped == 0


@pytest.mark.parametrize("branch", ["dropless", "capacity"])
def test_apply_moe_matches_jax(model, branch):
    jp, tp = _layer0(model)
    tokens = 12 if branch == "dropless" else 1056
    x = _tokens_in(tokens, 7, branch == "capacity")
    y, aux = JM.apply_moe(jp, jnp.asarray(x), model["jcfg"])
    ty, taux = M.apply_moe(tp, torch.from_numpy(x), model["cfg"])
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **LAYER_TOL)
    np.testing.assert_allclose(float(taux), float(aux), **LAYER_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_is_a_sequential_scatter_add(dtype):
    """The combine sums each token's weighted expert rows in ascending
    slot order, so it equals a scatter-add applied slot by slot (the CPU's
    ``index_add_``) bit for bit, in either dtype."""
    cfg = dataclasses.replace(get_smoke_config(ARCHS[0]),
                              dtype=str(dtype).split(".")[1])
    p = T.layer_params(T.init_params(cfg, torch.Generator().manual_seed(1),
                                     device="cpu"), 0)["moe"]
    x = torch.from_numpy(_tokens_in(1056, 11, True)).to(dtype)
    C = M.capacity(1056, cfg)
    E = cfg.moe.num_experts
    y, _ = M._dispatch_compute_combine(p, x, cfg, C)
    w, ids, _ = M.route(p, x, cfg)
    _, inv_tok, w_slot = M.slot_map(w, ids, C, E)
    buf = torch.cat([x, x.new_zeros((1, 64))])[inv_tok.long()]
    ye = M._expert_ffn(p, buf.view(E, C, 64), cfg).reshape(-1, 64)
    contrib = ye * w_slot[:, None].to(dtype)
    want = torch.zeros((1057, 64), dtype=dtype).index_add_(
        0, inv_tok.long(), contrib)[:1056]
    assert torch.equal(y.view(torch.int16 if dtype == torch.bfloat16
                              else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_init_moe_draws_seeded_slabs():
    """Expert slabs one layer at a time, fp32 draws cast to the config's
    dtype: N(0, 1/in) weights, the fp32 router at N(0, 0.02²), the same
    tree again from the same seed."""
    cfg = dataclasses.replace(get_smoke_config(ARCHS[0]), dtype="bfloat16")
    a = T.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    pa, pb = a["layers"]["sub0"]["moe"], b["layers"]["sub0"]["moe"]
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    assert pa["router"].dtype == torch.float32
    assert pa["w_in"].dtype == torch.bfloat16
    assert abs(float(pa["router"].std()) - 0.02) < 0.002
    for name, fan_in in (("w_in", 64), ("w_gate", 64), ("w_out", 64)):
        std = float(pa[name].float().std())
        assert abs(std * fan_in ** 0.5 - 1.0) < 0.05, name
    # layers and weights are distinct draws
    assert not torch.equal(pa["w_in"][0], pa["w_in"][1])
    assert not torch.equal(pa["w_in"], pa["w_gate"])


def test_params_from_numpy_names_missing_and_misshapen_moe_leaves(model):
    cfg = model["cfg"]
    tree = jax.tree.map(np.asarray, model["jparams"])
    sub = tree["layers"]["sub0"]
    bad = dict(tree, layers={"sub0": dict(sub, moe={
        k: v for k, v in sub["moe"].items() if k != "w_gate"})})
    with pytest.raises(KeyError, match="w_gate"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    bad = dict(tree, layers={"sub0": dict(sub, moe=dict(
        sub["moe"], router=sub["moe"]["router"][:, :, :4]))})
    with pytest.raises(ValueError, match="moe/router"):
        convert.lm_params_from_numpy(cfg, bad, device="cpu")
    moe = model["params"]["layers"]["sub0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_out"].shape == (2, 8, 64, 64)


# ------------------------------------------------------------------ the model


@pytest.fixture(scope="module", params=list(BRANCHES))
def served(request, model):
    """The reference's prefill logits, forward logits and aux, and greedy
    generation on one branch's prompts."""
    B, S, n_ids = BRANCHES[request.param]
    prompts = np.random.default_rng(S).integers(
        0, n_ids, size=(B, S)).astype(np.int32)
    jcfg, jparams = model["jcfg"], model["jparams"]
    max_seq = S + N_NEW
    jlogits, _ = JT.prefill(jparams, jnp.asarray(prompts), jcfg,
                            max_seq=max_seq)
    jfwd, jaux = JT.forward(jparams, jnp.asarray(prompts), jcfg)
    jres = JaxServeEngine(jcfg, jparams, JaxServeConfig(max_seq=max_seq)
                          ).generate(jnp.asarray(prompts), N_NEW)
    return dict(model, branch=request.param, prompts=prompts,
                max_seq=max_seq, jlogits=np.asarray(jlogits),
                jfwd=np.asarray(jfwd), jaux=float(jaux),
                jtokens=np.asarray(jres.tokens),
                jlogprobs=np.asarray(jres.logprobs))


def _engine(s, **kw):
    return ServeEngine(s["cfg"], s["params"],
                       ServeConfig(max_seq=s["max_seq"]), **kw)


def test_capacity_prompts_drop_assignments(served):
    """The capacity branch's prompts do drop assignments in layer 0 (and
    the dropless ones cannot)."""
    s = served
    p = T.layer_params(s["params"], 0)
    x = tlayers.apply_embed(s["params"]["embed"],
                            torch.from_numpy(s["prompts"]).long(), s["cfg"])
    B, S, d = x.shape
    xa, _ = T.mixer(p, x, s["cfg"], torch.arange(S).expand(B, S))
    h = tlayers.apply_norm(p["norm_ffn"], xa, s["cfg"]).reshape(B * S, d)
    w, ids, _ = M.route(p["moe"], h, s["cfg"])
    E = s["cfg"].moe.num_experts
    C = M.capacity(B * S, s["cfg"])
    slot, _, _ = M.slot_map(w, ids, C, E)
    dropped = int((slot == E * C).sum())
    assert (dropped > 0) == (s["branch"] == "capacity")


def test_prefill_logits_match_jax(served):
    logits, cache = _engine(served).prefill(served["prompts"])
    np.testing.assert_allclose(_np(logits), served["jlogits"], **TOL)
    S = served["prompts"].shape[1]
    assert cache.length == S and cache.kv_k.shape[:3] == (2, 2,
                                                          served["max_seq"])


def test_forward_logits_and_aux_match_jax(served):
    toks = torch.from_numpy(served["prompts"]).long()
    got, aux = T.forward(served["params"], toks, served["cfg"])
    np.testing.assert_allclose(_np(got), served["jfwd"], **TOL)
    np.testing.assert_allclose(float(aux), served["jaux"], **LAYER_TOL)
    assert float(aux) > 0


def test_greedy_generation_matches_jax(served):
    res = _engine(served).generate(served["prompts"], N_NEW)
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])
    np.testing.assert_allclose(res.logprobs.numpy(), served["jlogprobs"],
                               **TOL)


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
    """Each layer launches B10 four times (q, k, v, o) and B5 once (the
    router), in the prefill and in every decode step, B11 once in the
    prefill; the unembedding is one more B10 launch a pass."""
    _kernel_route(monkeypatch)
    tops.reset_launches()
    res = _engine(served).generate(served["prompts"], N_NEW)
    n = served["cfg"].n_layers
    want = {name: 0 for name in tops.LAUNCHES}
    want.update(matmul=(4 * n + 1) * (1 + N_NEW), flash_attention=n,
                topk_smallest=n * (1 + N_NEW))
    assert tops.LAUNCHES == want
    assert tts.ROUTE_LAUNCHES == {"filter": n * (1 + N_NEW), "radix": 0}
    np.testing.assert_array_equal(res.tokens.numpy(), served["jtokens"])


def test_kernel_route_equals_the_plain_route_bitwise(model, monkeypatch):
    """B5 returns what its plain version does, so an MoE layer on the
    kernel route equals the plain route's bit for bit, in bf16, on both
    branches."""
    _kernel_route(monkeypatch)
    cfg = dataclasses.replace(model["cfg"], dtype="bfloat16")
    p = T.layer_params(T.init_params(cfg, torch.Generator().manual_seed(4),
                                     device="cpu"), 1)["moe"]
    for tokens in (4, 1056):
        x = torch.from_numpy(_tokens_in(tokens, 13, True)).bfloat16()
        tops.reset_launches()
        y, aux = M.apply_moe(p, x, cfg)
        assert tops.LAUNCHES["topk_smallest"] == 1
        yp, auxp = M.apply_moe(p, x, cfg, path="ref")
        assert tops.LAUNCHES["topk_smallest"] == 1
        assert torch.equal(y.view(torch.int16), yp.view(torch.int16))
        assert torch.equal(aux, auxp)


def test_plain_route_equals_the_default_on_cpu(served):
    a = _engine(served).generate(served["prompts"], 3)
    b = _engine(served, path="ref").generate(served["prompts"], 3)
    assert torch.equal(a.tokens, b.tokens)


def test_serve_cli_moe_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--algo", "lm", "--arch", "qwen3-moe-30b-a3b", "--smoke",
         "--batch", "2", "--prompt-len", "8", "--new-tokens", "4"],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("[serve] arch=qwen3-moe-30b-a3b device=cpu "
                           "params=234752 batch=2 prompt=8 generated 8 "
                           "tokens")


# ------------------------------------------------------------------ the chip phase


def _logits(rows):
    return torch.tensor(rows, dtype=torch.float32)


def test_flip_rule_passes_near_ties_and_fails_far_flips():
    """``chip_smoke.moe_flip_check``: a token whose top-2 sets differ
    passes when the plain route's gap between the dropped and the taken
    expert is at most twice the largest logit difference, and fails
    otherwise; a token without a flip always passes."""
    cs = _chip_smoke()
    plain = _logits([[3.0, 2.0, 1.0, 0.0],      # near tie of 1 and 2
                     [3.0, 2.0, 1.0, 0.0],      # far: gap 2
                     [3.0, 2.0, 1.0, 0.0]])     # no flip
    kern = plain.clone()
    kern[0, 1] -= 0.6                           # δ = 0.6, gap 1.0 ≤ 1.2
    kern[1, 0] -= 0.1                           # δ = 0.1, gap 2.0 > 0.2
    kern[2, 3] += 0.5
    ids_p = torch.tensor([[0, 1], [0, 1], [0, 1]], dtype=torch.int32)
    ids_k = torch.tensor([[0, 2], [1, 3], [1, 0]], dtype=torch.int32)
    flip, ok = cs.moe_flip_check(torch, ids_k, ids_p, kern, plain)
    assert flip.tolist() == [True, True, False]
    assert ok.tolist() == [True, False, True]
    # the bound is inclusive: a gap of exactly twice δ is a near-tie
    kern = plain.clone()
    kern[0, 1] -= 0.5
    flip, ok = cs.moe_flip_check(torch, ids_k[:1], ids_p[:1], kern[:1],
                                 plain[:1])
    assert flip.tolist() == [True] and ok.tolist() == [True]


def _bf16_moe():
    cfg = dataclasses.replace(get_smoke_config(ARCHS[0]), dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    return cfg, params, tokens


def test_moe_layer_check_passes_the_plain_route_against_itself():
    cs = _chip_smoke()
    cfg, params, tokens = _bf16_moe()
    rows = cs.moe_layers(torch, cfg, params, tokens)
    assert [r["layer"] for r in rows] == list(range(cfg.n_layers))
    assert all(r["ok"] and r["flips"] == 0 and r["dist"] == 0 and
               r["noise"] > 0 and r["same"] > 0 for r in rows)


def test_moe_layer_check_fails_a_router_that_swaps_experts(monkeypatch):
    """A kernel route whose selection takes the third expert in place of
    the second (a wrong pick, not a near-tie) fails at the first layer."""
    cs = _chip_smoke()
    cfg, params, tokens = _bf16_moe()
    real = tops.topk_smallest

    def wrong(x, k):
        v, i = real(x, k + 1)
        keep = [0] + list(range(2, k + 1))
        return v[:, keep].contiguous(), i[:, keep].contiguous()
    monkeypatch.setattr(tops, "topk_smallest", wrong)
    rows = cs.moe_layers(torch, cfg, params, tokens)
    assert rows[0]["flips"] == 32 and rows[0]["far"] > 0
    assert not rows[0]["ok"]


def _unused_pair(cfg, params, tokens, layer):
    """Two experts that no token takes together at ``layer`` on the plain
    route, in bf16 or fp32, fed the kernel route's residual stream."""
    x = T.layer_states(params, tokens, cfg)[layer - 1]
    B, S, d = x.shape
    used = set()
    for dtype in (None, torch.float32):
        p = T.layer_params(params, layer, dtype)
        xa, _ = T.mixer(p, x if dtype is None else x.to(dtype), cfg,
                        torch.arange(S).expand(B, S), "ref")
        h = tlayers.apply_norm(p["norm_ffn"], xa, cfg).reshape(B * S, d)
        used |= {tuple(sorted(r)) for r in
                 M.route(p["moe"], h, cfg, "ref")[1].tolist()}
    E = cfg.moe.num_experts
    return next((a, b) for a in range(E) for b in range(a + 1, E)
                if (a, b) not in used)


@pytest.mark.parametrize("error", ["small", "every_router"])
def test_moe_layer_check_fails_a_wrong_projection(monkeypatch, error):
    """A B10 fault in layer 1's output projection on the kernel route fails
    that layer.  A small error (5% of each output) leaves the routing
    alike and moves the layer past twice the fp32 noise.  A large one (a
    row along two experts' router columns that no token takes together,
    added to every output) sends every token to those two: every token
    flips, each flip within its own near-tie bound, and no token is left
    routed alike for the norm, so only the share gate can fail it."""
    cs = _chip_smoke()
    cfg, params, tokens = _bf16_moe()
    wo = params["layers"]["sub0"]["attn"]["wo"][1]
    router = params["layers"]["sub0"]["moe"]["router"][1]
    a, b = _unused_pair(cfg, params, tokens, 1)
    row = router[:, a] + router[:, b]
    row = (1e3 * row / row.norm()).to(torch.bfloat16)
    real = tops.matmul

    def wrong(x, w):
        out = real(x, w)
        if w.data_ptr() != wo.data_ptr():
            return out
        return out * 1.05 if error == "small" else out + row
    monkeypatch.setattr(tops, "matmul", wrong)
    rows = cs.moe_layers(torch, cfg, params, tokens)
    T_ = tokens.numel()
    assert rows[0]["ok"] and not rows[1]["ok"]
    assert rows[1]["far"] == 0
    if error == "small":
        assert rows[1]["same"] >= cs.MOE_SAME * T_
        assert rows[1]["dist"] > cs.LAYER_FACTOR * rows[1]["noise"]
    else:
        assert rows[1]["flips"] == T_ and rows[1]["same"] == 0
        assert rows[1]["dist"] == rows[1]["noise"] == 0


def test_lm_path_shapes():
    """The B10 and B11 shapes ``chip_smoke.lm_kernel_edges`` holds at full
    width: stablelm-3b's projections, MLP and unembedding (one (M, d, d)
    for q, k, v and o), qwen3-moe-30b-a3b's q, k/v (4 KV heads) and o
    projections at the prefill's and decode's M and its unembedding, and
    each prefill's attention after the GQA repeat."""
    cs = _chip_smoke()
    gemm, attn = cs.lm_path_shapes(get_config("stablelm-3b"), 4, 512)
    assert gemm == [(2048, 2560, 2560), (2048, 6912, 2560),
                    (2048, 2560, 6912), (4, 2560, 2560), (4, 6912, 2560),
                    (4, 2560, 6912), (4, 50304, 2560)]
    assert attn == (4, 32, 512, 80)
    gemm, attn = cs.lm_path_shapes(get_config(ARCHS[0]), 4, 512)
    assert gemm == [(2048, 4096, 2048), (2048, 512, 2048),
                    (2048, 2048, 4096), (4, 4096, 2048), (4, 512, 2048),
                    (4, 2048, 4096), (4, 151936, 2048)]
    assert attn == (4, 32, 512, 128)


def test_lm_kernel_edges_rehearsal(monkeypatch, capsys):
    """``chip_smoke.lm_kernel_edges`` on the CPU with the launchers the
    plain versions (``_kernel_route``), shrunk edge lists and both reduced
    models in bf16: every path case takes the route the shape rule gives,
    the B11 cases include each model's prefill in its GQA layout, and B5
    is held at the MoE model's two router shapes."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(cs, "GEMM_EDGES", (1, 17))
    monkeypatch.setattr(cs, "ATTN_EDGES_S", (1, 12))
    monkeypatch.setattr(cs, "ATTN_EDGES_D", (16, 80))
    models = [(dataclasses.replace(get_smoke_config(a), dtype="bfloat16"),
               2, 8) for a in ("stablelm-3b", ARCHS[0])]
    n = cs.lm_kernel_edges(torch, tops, tref, "cpu",
                           torch.Generator().manual_seed(0), models)
    shapes = {s for cfg, b, p in models for s in
              cs.lm_path_shapes(cfg, b, p)[0]}
    assert n == 2 * (8 + len(shapes) + 2) + 2 * (8 + 2) + 2 * 2 + 2
    out = capsys.readouterr().out
    qwen = models[1][0]
    assert (f"B11 {qwen.arch_id} torch.bfloat16 B=2 H={qwen.n_heads} S=8 "
            f"d={qwen.head_dim} causal, KV heads {qwen.n_kv_heads}") in out
    E, k = qwen.moe.num_experts, qwen.moe.top_k
    for T in (16, 2):
        assert (f"B5 {qwen.arch_id} router T={T} E={E} k={k} (filter): "
                "values and indices equal") in out


def test_chip_phase_rehearsal(monkeypatch, capsys):
    """``chip_smoke.moe_path`` on the CPU at the reduced qwen3 in bf16 on
    the capacity branch (2 x 528 prompts): the card's timing calls
    stubbed, the launchers the plain versions (``_kernel_route``); every
    check of the phase runs and the launch counts come back."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "cuda_ms", lambda torch_, fn, reps: 1.0)
    from repro_torch.launch import lm_kernel_times
    monkeypatch.setattr(lm_kernel_times, "device_ms", lambda fn, reps=0: 1.0)
    monkeypatch.setattr(lm_kernel_times, "device_kernels", lambda fn: {})
    monkeypatch.setattr(cs, "MOE", dict(cs.MOE, batch=2, prompt=528, new=3))
    cfg = dataclasses.replace(get_smoke_config(ARCHS[0]), dtype="bfloat16")
    launches = cs.moe_path(torch, tops, tref, torch.device("cpu"), cfg,
                           cs.PEAKS["SXM"])
    assert launches["topk_smallest"] == cfg.n_layers * 4
    assert launches["matmul"] == (4 * cfg.n_layers + 1) * 4
    out = capsys.readouterr().out
    assert "[lm/moe] per layer" in out and "free-running" in out
    assert "C=336" in out and "T=2 E=8 k=2" in out
