"""The port's two-phase expert-parallel MoE against the JAX package's.

The JAX side runs once for the file, in one subprocess with eight forced
host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``):
``apply_moe_two_phase`` of the reduced qwen3-moe-30b-a3b (8 experts, top
2, fp32) on the meshes (4, 2) and (1, 8) of ``("data", "model")``, its
output, aux and the gradients of sum(y²); the token-replicated branch (T
= 1, which the data axes cannot split); a capacity-branch batch whose
skewed tokens crowd the experts, at (1, 8), (2, 4) and (4, 2); the planned
``forward``, ``make_prefill_step`` and ``make_decode_step`` of the
reduced model.  The port runs the same params (``convert``) and inputs
on ``make_local_mesh(shape, "cpu", axes=("data", "model"))``: the layer
at rtol = atol = 1e-5, its gradients at rtol 2e-4 / atol 2e-5 (the
reference's own bars, ``tests/test_moe_two_phase.py``), the model's
logits at the MoE family's 1e-4 (``tests/test_torch_moe.py``).  With
``plan=None`` every route is the one-device layer bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.registry import get_smoke_config
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_select as tts
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.sharding import ParallelPlan
from repro_torch.training import trainer

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-moe-30b-a3b"
MESHES = ((4, 2), (1, 8))
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
N_NEW = 4
B, S = 2, 12          # 24 tokens: split 4 ways at (4, 2); decode's 2 not

PAYLOAD = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs.registry import get_smoke_config
    from repro.launch.mesh import _mk
    from repro.models import moe as MOE
    from repro.models import transformer as TR
    from repro.sharding.partitioning import ParallelPlan
    from repro.training import trainer

    B, S, N_NEW = %d, %d, %d
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    out = {}
    params = MOE.init_moe(jax.random.PRNGKey(0), cfg)
    for k, v in params.items():
        out["moe/" + k] = np.asarray(v)
    x = jax.random.normal(jax.random.PRNGKey(1), (64, cfg.d_model)) * 0.5
    out["x"] = np.asarray(x)
    rng = np.random.default_rng(2)
    xc = (0.3 * rng.normal(size=(4224, cfg.d_model))
          + 4.0 * rng.normal(size=(1, cfg.d_model))).astype(np.float32)
    out["xc"] = xc

    def plan_of(shape):
        mesh = _mk(shape, ("data", "model"))
        return mesh, ParallelPlan(mesh=mesh, dp_axes=("data",),
                                  model_axis="model")

    def two_phase(mesh, plan, p, x):
        with mesh:
            return jax.jit(
                lambda p, x: MOE.apply_moe_two_phase(p, x, cfg, plan))(p, x)

    for shape in ((4, 2), (1, 8), (2, 4)):
        mesh, plan = plan_of(shape)
        tag = "%%dx%%d" %% shape
        y, aux = two_phase(mesh, plan, params, jnp.asarray(xc))
        out[tag + "/yc"] = np.asarray(y)
        out[tag + "/auxc"] = np.asarray(aux)
        if shape == (2, 4):
            continue
        y, aux = two_phase(mesh, plan, params, x)
        out[tag + "/y"] = np.asarray(y)
        out[tag + "/aux"] = np.asarray(aux)
        y1, aux1 = two_phase(mesh, plan, params, x[:1])
        out[tag + "/y1"] = np.asarray(y1)
        out[tag + "/aux1"] = np.asarray(aux1)

        def loss(p):
            return jnp.sum(MOE.apply_moe_two_phase(p, x, cfg, plan)[0] ** 2)
        with mesh:
            g = jax.jit(jax.grad(loss))(params)
        for k, v in g.items():
            out[tag + "/g/" + k] = np.asarray(v)

    # the model, planned
    mparams = TR.init_params(jax.random.PRNGKey(3), cfg)
    for path, leaf in jax.tree_util.tree_flatten_with_path(mparams)[0]:
        out["model/" + "/".join(k.key for k in path)] = np.asarray(leaf)
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    out["prompts"] = prompts
    for shape in ((4, 2), (1, 8)):
        mesh, plan = plan_of(shape)
        tag = "model/%%dx%%d" %% shape
        with mesh:
            fwd, aux = jax.jit(lambda p, t: TR.forward(
                p, t, cfg, plan=plan))(mparams, jnp.asarray(prompts))
            out[tag + "/fwd"] = np.asarray(fwd)
            out[tag + "/faux"] = np.asarray(aux)
            pre = jax.jit(trainer.make_prefill_step(cfg, S + N_NEW,
                                                    plan=plan))
            dec = jax.jit(trainer.make_decode_step(cfg, plan=plan))
            logits, cache = pre(mparams, {"tokens": jnp.asarray(prompts)})
            toks, lgs = [], []
            for _ in range(N_NEW):
                lgs.append(np.asarray(logits))
                nxt = jnp.argmax(logits, -1).astype(jnp.int32)
                toks.append(np.asarray(nxt))
                logits, cache = dec(mparams, cache, nxt[:, None])
        out[tag + "/logits"] = np.stack(lgs, 1)
        out[tag + "/tokens"] = np.stack(toks, 1)
    np.savez(sys.argv[1], **out)
""" % (B, S, N_NEW))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX package's two-phase outputs (one subprocess a file)."""
    path = tmp_path_factory.mktemp("two_phase") / "ref.npz"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_")}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", PAYLOAD, str(path)],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=ROOT)
    assert res.returncode == 0, (res.stdout[-800:], res.stderr[-3000:])
    with np.load(path) as f:
        out = dict(f)
    cfg = get_smoke_config(ARCH)
    moe = {k[4:]: torch.from_numpy(v) for k, v in out.items()
           if k.startswith("moe/")}
    tree: dict = {}
    for key, v in out.items():
        if key.startswith("model/") and key.count("/") >= 2 and \
                not key.startswith(("model/4x2", "model/1x8")):
            *head, leaf = key[len("model/"):].split("/")
            node = tree
            for h in head:
                node = node.setdefault(h, {})
            node[leaf] = v
    params = convert.lm_params_from_numpy(cfg, tree, device="cpu")
    return dict(out=out, cfg=cfg, moe=moe, params=params)


def plan_of(shape):
    return ParallelPlan(mesh=make_local_mesh(shape, "cpu",
                                             axes=("data", "model")))


def _np(t):
    return t.detach().float().numpy()


def tag(shape):
    return "%dx%d" % shape


@pytest.mark.parametrize("shape", MESHES)
def test_two_phase_layer_matches_jax(ref, shape):
    out, cfg = ref["out"], ref["cfg"]
    x = torch.from_numpy(out["x"])
    y, aux = M.apply_moe_two_phase(ref["moe"], x, cfg, plan_of(shape))
    np.testing.assert_allclose(_np(y), out[tag(shape) + "/y"], **TOL)
    np.testing.assert_allclose(float(aux), out[tag(shape) + "/aux"], **TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_two_phase_gradients_match_jax(ref, shape):
    out, cfg = ref["out"], ref["cfg"]
    x = torch.from_numpy(out["x"])
    params = {k: v.clone().requires_grad_() for k, v in ref["moe"].items()}
    y, _ = M.apply_moe_two_phase(params, x, cfg, plan_of(shape))
    grads = torch.autograd.grad((y ** 2).sum(), list(params.values()))
    for (name, _), g in zip(params.items(), grads):
        np.testing.assert_allclose(_np(g), out[f"{tag(shape)}/g/{name}"],
                                   err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_token_replicated_branch_matches_jax(ref, shape):
    """T = 1 does not split over 4 data shards: every data shard holds the
    token, the experts stay split (at one data shard, T = 1 splits)."""
    out, cfg = ref["out"], ref["cfg"]
    plan = plan_of(shape)
    assert M.shard_grid(plan, 1) == (1, 1, shape[0] == 1)
    y, aux = M.apply_moe_two_phase(ref["moe"], torch.from_numpy(out["x"][:1]),
                                   cfg, plan)
    np.testing.assert_allclose(_np(y), out[tag(shape) + "/y1"], **TOL)
    np.testing.assert_allclose(float(aux), out[tag(shape) + "/aux1"], **TOL)


@pytest.mark.parametrize("shape", ((1, 8), (2, 4), (4, 2)))
def test_capacity_branch_matches_jax(ref, shape):
    """4,224 skewed tokens: T_loc past 1,024 takes the capacity branch, and
    assignments are dropped on every mesh."""
    out, cfg = ref["out"], ref["cfg"]
    x = torch.from_numpy(out["xc"])
    plan = plan_of(shape)
    n_data, T_loc, split = M.shard_grid(plan, x.shape[0])
    assert split and T_loc > M.DROPLESS_THRESHOLD
    C = M.capacity(T_loc, cfg)
    w, ids, _ = M.route(ref["moe"], x[:T_loc], cfg)
    slot, _, _ = M.slot_map(w, ids, C, cfg.moe.num_experts)
    assert int((slot == cfg.moe.num_experts * C).sum()) > 0
    y, aux = M.apply_moe_two_phase(ref["moe"], x, cfg, plan)
    np.testing.assert_allclose(_np(y), out[tag(shape) + "/yc"], **TOL)
    np.testing.assert_allclose(float(aux), out[tag(shape) + "/auxc"], **TOL)


def test_expert_ranges_partition_the_one_device_slots(ref):
    """At one data shard each model shard keeps exactly the one-device
    layer's assignments to its experts, in slots offset by e_base·C: the
    kept sets of the shards are the one-device kept set."""
    cfg = ref["cfg"]
    x = torch.from_numpy(ref["out"]["xc"][:2112])
    E, C = cfg.moe.num_experts, M.capacity(2112, cfg)
    w, ids, _ = M.route(ref["moe"], x, cfg)
    slot1, _, _ = M.slot_map(w, ids, C, E)
    for model_n in (2, 8):
        e_local = E // model_n
        union = torch.full_like(slot1, E * C)
        for j in range(model_n):
            s, inv, ws = M.slot_map(w, ids, C, E, j * e_local, e_local)
            mine = s < e_local * C
            assert inv.shape == (e_local * C,) and ws.shape == inv.shape
            assert bool(((ids.long() // e_local == j) |
                         ~mine).all())
            union = torch.where(mine, s + j * e_local * C, union)
        assert torch.equal(union, slot1)


def test_uneven_expert_split_raises(ref):
    with pytest.raises(ValueError, match="do not divide"):
        M.apply_moe_two_phase(ref["moe"], torch.from_numpy(ref["out"]["x"]),
                              ref["cfg"], plan_of((1, 3)))


def test_one_shard_plan_is_the_one_device_layer(ref):
    """A (1, 1) plan sums one partial: bit-equal to ``apply_moe``."""
    x = torch.from_numpy(ref["out"]["xc"][:2112])
    y1, a1 = M.apply_moe(ref["moe"], x, ref["cfg"])
    yp, ap = M.apply_moe_two_phase(ref["moe"], x, ref["cfg"],
                                   plan_of((1, 1)))
    assert torch.equal(y1, yp) and torch.equal(a1, ap)


def _old_apply_moe(params, x, cfg):
    """The one-device layer as it stood before the expert range came in
    (every expert, slot e·C + rank where rank < C), for ``plan=None``'s
    bit-for-bit check."""
    T_, d = x.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    C = M.capacity(T_, cfg)
    weights, ids, aux = M.route(params, x, cfg)
    e_flat = ids.reshape(-1).long()
    ranks = M._ranks_static(e_flat, E).long()
    slot = torch.where(ranks < C, e_flat * C + ranks,
                       torch.full_like(e_flat, E * C))
    inv_tok = torch.full((E * C + 1,), T_, dtype=torch.int32)
    inv_tok[slot] = torch.arange(T_, dtype=torch.int32).repeat_interleave(k)
    w_slot = torch.zeros((E * C + 1,))
    w_slot[slot] = weights.reshape(-1).float()
    buf = torch.cat([x, x.new_zeros((1, d))])[inv_tok[:E * C].long()]
    ye = M._expert_ffn(params, buf.view(E, C, d), cfg).reshape(-1, d)
    contrib = torch.cat([ye * w_slot[:E * C, None].to(ye.dtype),
                         ye.new_zeros((1, d))])
    rows = contrib[torch.sort(slot.reshape(T_, k), dim=1).values]
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y.to(x.dtype), aux


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("tokens", (64, 2112))
def test_plan_none_is_the_one_device_layer_bitwise(ref, dtype, tokens):
    p = {k: (v if k == "router" else v.to(dtype))
         for k, v in ref["moe"].items()}
    x = torch.from_numpy(ref["out"]["xc"][:tokens]).to(dtype)
    cfg = dataclasses.replace(ref["cfg"], dtype=str(dtype)[6:])
    y, aux = M.apply_moe(p, x, cfg)
    yo, auxo = _old_apply_moe(p, x, cfg)
    assert torch.equal(y, yo) and torch.equal(aux, auxo)


# ------------------------------------------------------------------ model


@pytest.mark.parametrize("shape", MESHES)
def test_planned_forward_matches_jax(ref, shape):
    out, cfg = ref["out"], ref["cfg"]
    toks = torch.from_numpy(out["prompts"]).long()
    logits, aux = T.forward(ref["params"], toks, cfg, plan=plan_of(shape))
    np.testing.assert_allclose(_np(logits), out[f"model/{tag(shape)}/fwd"],
                               **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), out[f"model/{tag(shape)}/faux"],
                               **TOL)


@pytest.mark.parametrize("shape", MESHES)
def test_planned_prefill_and_decode_match_jax(ref, shape):
    """``make_prefill_step`` then ``make_decode_step`` with the plan, fed
    the reference's greedy tokens: every step's logits at 1e-4 and the
    port's own argmax the reference's token.  At (4, 2) the decode's two
    tokens take the token-replicated branch."""
    out, cfg = ref["out"], ref["cfg"]
    plan = plan_of(shape)
    want = out[f"model/{tag(shape)}/logits"]
    toks = out[f"model/{tag(shape)}/tokens"]
    pre = trainer.make_prefill_step(cfg, S + N_NEW, plan=plan)
    dec = trainer.make_decode_step(cfg, plan=plan)
    logits, cache = pre(ref["params"],
                        {"tokens": torch.from_numpy(out["prompts"]).long()})
    for i in range(N_NEW):
        np.testing.assert_allclose(_np(logits), want[:, i], **LOGIT_TOL)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), toks[:, i])
        logits, cache = dec(ref["params"], cache,
                            torch.from_numpy(toks[:, i:i + 1]).long())


@pytest.mark.parametrize("entry", ("forward", "prefill", "decode"))
def test_plan_none_routes_are_unchanged(ref, entry):
    """``plan=None`` is the default route, bit for bit, at every entry."""
    cfg, params = ref["cfg"], ref["params"]
    toks = torch.from_numpy(ref["out"]["prompts"]).long()
    if entry == "forward":
        a, b = T.forward(params, toks, cfg), \
            T.forward(params, toks, cfg, plan=None)
    elif entry == "prefill":
        a = trainer.make_prefill_step(cfg, S + 1)(params, {"tokens": toks})
        b = trainer.make_prefill_step(cfg, S + 1, plan=None)(
            params, {"tokens": toks})
        a, b = (a[0], a[1].kv_k), (b[0], b[1].kv_k)
    else:
        _, c1 = T.prefill(params, toks, cfg, max_seq=S + 1)
        _, c2 = T.prefill(params, toks, cfg, max_seq=S + 1)
        a = trainer.make_decode_step(cfg)(params, c1, toks[:, :1])[0]
        b = trainer.make_decode_step(cfg, plan=None)(params, c2,
                                                     toks[:, :1])[0]
        a, b = (a,), (b,)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_two_phase_kernel_route_equals_plain_route_bitwise(ref, monkeypatch):
    """B5 is exact, so the two-phase layer on the kernel route (the
    wrappers' card branch, B5's launcher its plain version) equals its
    plain route bit for bit in bf16, launching B5 once a shard."""
    def select_launch(x, k):
        tts.ROUTE_LAUNCHES[tts.route(k)] += 1
        return tref.topk_smallest(x, k)
    monkeypatch.setattr(tts, "launch", select_launch)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    cfg = dataclasses.replace(ref["cfg"], dtype="bfloat16")
    p = {k: (v if k == "router" else v.bfloat16())
         for k, v in ref["moe"].items()}
    for shape, tokens in (((1, 8), 2112), ((2, 4), 4224), ((1, 8), 4)):
        x = torch.from_numpy(ref["out"]["xc"][:tokens]).bfloat16()
        plan = plan_of(shape)
        tops.reset_launches()
        y, aux = M.apply_moe_two_phase(p, x, cfg, plan)
        assert tops.LAUNCHES["topk_smallest"] == 8
        assert tts.ROUTE_LAUNCHES == {"filter": 8, "radix": 0}
        yp, auxp = M.apply_moe_two_phase(p, x, cfg, plan, path="ref")
        assert tops.LAUNCHES["topk_smallest"] == 8
        assert torch.equal(y.view(torch.int16), yp.view(torch.int16))
        assert torch.equal(aux, auxp)


# ------------------------------------------------------------------ chip


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_stubs(monkeypatch):
    """The wrappers' card branch on the CPU: ``ops._check`` reports a card,
    B10, B11 and B5's launchers run the plain versions counting their
    routes, and the card's timing and memory calls are stubbed."""
    from repro_torch.kernels import flash_attention as tfa
    from repro_torch.kernels import gemm as tgemm
    from repro_torch.launch import lm_kernel_times

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
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(lm_kernel_times, "device_kernels", lambda fn: {})


def test_chip_phase_rehearsal(monkeypatch, capsys):
    """``chip_smoke.moe_two_phase_path`` on the CPU at the reduced qwen3
    (fp32; 8 experts, top 2: one expert a shard at (1, 8)), on the
    capacity branch (2 x 528 prompts), the params, prompts and greedy
    tokens handed on as ``[lm/moe]`` hands them: every check of the phase
    runs and the launch counts come back."""
    from repro_torch.configs.base import ServeConfig
    from repro_torch.serving import ServeEngine
    cs = _chip_smoke()
    _card_stubs(monkeypatch)
    monkeypatch.setattr(cs, "TWO_PHASE", dict(cs.TWO_PHASE, new=2))
    cfg = get_smoke_config(ARCH)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 528),
                            generator=torch.Generator().manual_seed(1))
    res = ServeEngine(cfg, params, ServeConfig(max_seq=530)).generate(
        prompts, 2)
    hand = dict(params=params, prompts=prompts, tokens=res.tokens,
                prefill_ms=1.0, step_ms=1.0, prefill_dev=None, step_dev=None)
    launches = cs.moe_two_phase_path(torch, tops, torch.device("cpu"), cfg,
                                     hand)
    n = cfg.n_layers
    assert launches["topk_smallest"] == n * 8 * 3
    assert launches["matmul"] == (4 * n + 1) * 3
    assert launches["flash_attention"] == n
    out = capsys.readouterr().out
    assert "[lm/moe/two_phase] per layer" in out and "greedy tokens" in out
    assert "mesh (data, model) = (2, 4), T=1056 (2 data shards of 528" in out


def test_two_phase_check_fails_a_lost_partial(monkeypatch):
    """At top 4 over two model shards the two-phase grouping of a token's
    bf16 additions differs from one device's: within the derived bound,
    which is tight enough to catch an OP2 that drops a shard's
    partial."""
    cs = _chip_smoke()
    base = get_smoke_config(ARCH)
    cfg = dataclasses.replace(base, dtype="bfloat16", moe=dataclasses.replace(
        base.moe, top_k=4))
    p = T.layer_params(T.init_params(cfg, torch.Generator().manual_seed(5),
                                     device="cpu"), 0)["moe"]
    h = torch.randn((256, cfg.d_model),
                    generator=torch.Generator().manual_seed(6)).bfloat16()
    plan = plan_of((1, 2))
    r = cs.two_phase_check(torch, cfg, p, h, plan)
    assert r["ok"] and r["kept"] and r["rows_equal"] == 2
    assert 0 < r["ratio"] <= 1.0
    real = M.collectives.psum      # OP2 that loses the last shard's rows
    monkeypatch.setattr(M.collectives, "psum", lambda parts, device: real(
        parts[:-1] if parts[0].ndim else parts, device))
    r = cs.two_phase_check(torch, cfg, p, h, plan)
    assert not r["ok"] and r["ratio"] > 1.0
