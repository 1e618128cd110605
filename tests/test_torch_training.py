"""The PyTorch port's training path against the JAX package.

The reduced stablelm-3b and qwen3-moe-30b-a3b (``get_smoke_config``: 2
layers, d_model 64, fp32) are initialised by the reference, their params
and optimizer state carried across with ``convert.lm_params_from_numpy``
and ``convert.opt_state_from_numpy``, and both packages take the same
train step on the same numpy batch.  The port runs on ``device="cpu"``,
where B10, B11 and B12's wrappers run their plain versions under the same
autograd operators the card uses (``kernels/autograd.py``).

Tolerances, each with its reason:
  * losses, ``ce``, ``aux``, the gradient norm: rtol 1e-5 (fp32 sums in
    another order; measured ~1e-7);
  * every gradient leaf: 2e-5 x the leaf's largest |gradient| (the same
    sums, and B12's explicit formula against XLA's autodiff of jnp
    attention; measured at most 1.5e-6 x);
  * the port's optimizer and int8 round trip on the reference's
    gradients against the reference's own (``adamw_update``,
    ``compress_tree``) on the same gradients: 1e-6 absolute (the params,
    moments and residual are O(1) or less);
  * the params, moments and residual after the two train steps: 1e-6
    plus the change that the gradients' difference itself makes through
    each step.  AdamW normalises each element (on a first step an element
    moves by ±lr whatever its gradient's size) and int8 compression
    rounds each element to a step of amax/127, so an element whose
    gradient sits near zero, or near a rounding boundary, in both
    packages may move up to lr (or one quantisation step) apart.  The
    allowance is |port step on its gradients − port optimizer on the
    reference's| plus |the reference's jitted step − its optimizer on its
    eager gradients| (XLA's jit sums the gradients in another order than
    its eager ops), each package's response to the gradient differences
    that the gradient check bounds.
  * remat ``none``, ``full`` and ``dots``: bit-equal on the CPU.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.data import datasets as jdata
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.models import transformer as JT
from repro.training import grad_compression as jgc
from repro.training import optimizer as jopt
from repro.training import trainer as jtr
from repro_torch import convert
from repro_torch import tree as T
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data import datasets as tdata
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import autograd as grad_ops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_attention_bwd as tfab
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_select as tts
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.training import grad_compression as tgc
from repro_torch.training import optimizer as topt
from repro_torch.training import trainer

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("stablelm-3b", "qwen3-moe-30b-a3b")
B, S = 4, 16
SCALAR_RTOL = 1e-5
GRAD_RTOL = 2e-5
STATE_ATOL = 1e-6
JTC = dict(learning_rate=1e-3, warmup_steps=5, total_steps=20)


def _np(t):
    return t.detach().float().numpy()


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One reduced arch in both packages on the reference's weights, a
    batch, and the reference's optimizer state after one step (so that
    the compared step starts from nonzero moments)."""
    arch = request.param
    jcfg = jax_smoke(arch)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S)
                                    ).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab_size, (B, S)
                                     ).astype(np.int32)}
    return dict(arch=arch, jcfg=jcfg, jparams=jparams, cfg=get_smoke_config(
        arch), batch=batch)


def _port_state(s, tree, opt):
    params = convert.lm_params_from_numpy(
        s["cfg"], jax.tree.map(np.asarray, tree), device="cpu")
    state = convert.opt_state_from_numpy(
        s["cfg"], jax.tree.map(np.asarray, opt), device="cpu")
    return params, state


# the reference's value_and_grad of loss_fn, jitted once (the config and
# TrainConfig static); its loss reads only remat and label smoothing
_VG = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True),
              static_argnums=(2, 3))
_VG_CFG = JTrainConfig(remat="none")


def _jax_grads(s, jparams, jtc):
    """The reference's gradients of one step as its train step forms them:
    ``value_and_grad`` of ``loss_fn``, accumulated over the microbatches
    as ``acc + g / n`` in fp32."""
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    n = jtc.microbatches
    if n == 1:
        return _VG(jparams, jb, s["jcfg"], _VG_CFG)[1]
    acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jparams)
    for i in range(n):
        mb = {k: v.reshape((n, B // n) + v.shape[1:])[i] for k, v in
              jb.items()}
        g = _VG(jparams, mb, s["jcfg"], _VG_CFG)[1]
        acc = jax.tree.map(lambda a, x: a + x.astype(jnp.float32) / n, acc, g)
    return acc


def _capture_grads(monkeypatch):
    """Record the gradients of the port's step after the microbatch
    accumulation, before the int8 round trip where there is one."""
    seen = {}
    real, real_compress = topt.adamw_update, trainer.compress_tree

    def spy(params, grads, state, cfg):
        seen.setdefault("grads", T.map(lambda g: g.clone(), grads))
        return real(params, grads, state, cfg)

    def spy_compress(grads, resid=None):
        seen["grads"] = T.map(lambda g: g.clone(), grads)
        return real_compress(grads, resid)
    monkeypatch.setattr(topt, "adamw_update", spy)
    monkeypatch.setattr(trainer, "compress_tree", spy_compress)
    return seen


def _state_leaves(params, opt):
    return T.leaves({"params": params, "opt_state": opt})


@pytest.mark.parametrize("compression", ["none", "int8"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_jax(model, microbatches, compression,
                                monkeypatch):
    """One train step from the same params, moments (after a reference
    step) and batch: loss, ce, aux, grad norm, lr, every gradient leaf,
    and the params, moments (and the int8 residual) after the step; the
    port's remat policies bit-equal to each other."""
    s = model
    jtc = JTrainConfig(microbatches=microbatches,
                       grad_compression=compression, remat="none", **JTC)
    jb = {k: jnp.asarray(v) for k, v in s["batch"].items()}
    jstep = jax.jit(jtr.make_train_step(s["jcfg"], jtc))
    jp1, jo1, _ = jstep(s["jparams"], jtr.init_opt_state(s["jparams"], jtc),
                        jb)
    jp2, jo2, jm = jstep(jp1, jo1, jb)
    # the reference's step composed eagerly from its own functions on its
    # gradients: what its optimizer makes of them, outside the jit
    jraw = _jax_grads(s, jp1, jtc)
    if compression == "int8":
        qtree, jresid = jgc.compress_tree(jraw, jo1.resid)
        jgrads = jgc.decompress_tree(qtree)
        ja2, jadam, _ = jopt.adamw_update(jp1, jgrads, jo1.adam, jtc)
        jeager = {"params": ja2, "opt_state": jtr.CompressedOptState(
            adam=jadam, resid=jresid)}
    else:
        jgrads = jraw
        ja2, jadam, _ = jopt.adamw_update(jp1, jgrads, jo1, jtc)
        jeager = {"params": ja2, "opt_state": jadam}

    seen = _capture_grads(monkeypatch)
    results = {}
    for remat in ("none", "full", "dots"):
        tc = TrainConfig(microbatches=microbatches,
                         grad_compression=compression, remat=remat, **JTC)
        params, opt = _port_state(s, jp1, jo1)
        params, opt, m = trainer.make_train_step(s["cfg"], tc)(
            params, opt, _tensors(s["batch"]))
        results[remat] = (params, opt, m, seen.pop("grads"))
    params, opt, m, grads = results["none"]
    for remat in ("full", "dots"):
        p2, o2, m2, g2 = results[remat]
        for a, b in zip(_state_leaves(params, opt) + T.leaves(grads),
                        _state_leaves(p2, o2) + T.leaves(g2)):
            assert torch.equal(a, b), remat
        assert all(torch.equal(m[k], m2[k]) for k in m)

    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=SCALAR_RTOL, atol=1e-7, err_msg=key)
    for (path, g), jg in zip(T.flatten(grads), jax.tree.leaves(jraw)):
        jg = np.asarray(jg, np.float32)
        np.testing.assert_allclose(_np(g), jg, rtol=0,
                                   atol=GRAD_RTOL * np.abs(jg).max() + 1e-12,
                                   err_msg=path)

    # the port's optimizer (and int8 round trip) on the reference's raw
    # gradients, from the same state, against the reference's own
    tc = TrainConfig(microbatches=microbatches, grad_compression=compression,
                     **JTC)
    pj, oj = _port_state(s, jp1, jo1)
    raw = T.unflatten(pj, (torch.from_numpy(np.array(g, np.float32))
                           for g in jax.tree.leaves(jraw)))
    if compression == "int8":
        qt, resid = tgc.compress_tree(raw, oj.resid)
        pj, adam, _ = topt.adamw_update(pj, tgc.decompress_tree(qt), oj.adam,
                                        tc)
        oj = trainer.CompressedOptState(adam=adam, resid=resid)
    else:
        pj, oj, _ = topt.adamw_update(pj, raw, oj, tc)
    for (path, got), w in zip(T.flatten({"params": pj, "opt_state": oj}),
                              jax.tree.leaves(jeager)):
        np.testing.assert_allclose(_np(got), np.asarray(w, np.float32),
                                   rtol=0, atol=STATE_ATOL,
                                   err_msg=f"{path} (both optimizers on the "
                                   "reference's gradients)")
    # the two steps: within the change each package's own step makes of
    # the gradients' difference (the port's: its gradients against the
    # reference's; the reference's: its jitted step's against its eager
    # gradients)
    for (path, got), on_ref, jstep_v, jeager_v in zip(
            T.flatten({"params": params, "opt_state": opt}),
            _state_leaves(pj, oj),
            jax.tree.leaves({"params": jp2, "opt_state": jo2}),
            jax.tree.leaves(jeager)):
        want = np.asarray(jstep_v, np.float32)
        allow = np.abs(_np(got) - _np(on_ref)) + np.abs(
            want - np.asarray(jeager_v, np.float32))
        assert np.all(np.abs(_np(got) - want) <= allow + STATE_ATOL), path


def test_router_gradient_matches_jax(monkeypatch):
    """The MoE router's gradient on the kernel route, with B5's launcher
    returning values that carry no autograd graph (as the card's ctypes
    launch does): the weights are gathered from the probabilities at B5's
    indices, so the router gets the reference's gradient, not only the
    aux term's."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = JT.init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 8)
                                    ).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, 8)
                                     ).astype(np.int32)}
    jg = _VG(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
             _VG_CFG)[1]
    want = np.asarray(jg["layers"]["sub0"]["moe"]["router"])

    def select_launch(x, k):
        tts.ROUTE_LAUNCHES[tts.route(k)] += 1
        vals, ids = tref.topk_smallest(x.detach(), k)
        return vals.detach(), ids
    monkeypatch.setattr(tts, "launch", select_launch)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1] if op ==
        "topk_smallest" else real_check(op, **kw))
    params = convert.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    tops.reset_launches()
    for path in (None, "ref"):
        _, _, grads = trainer.loss_and_grads(params, _tensors(batch), cfg,
                                             TrainConfig(remat="none"), path)
        got = _np(grads["layers"]["sub0"]["moe"]["router"])
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_RTOL * np.abs(want).max())
    assert tops.LAUNCHES["topk_smallest"] == cfg.n_layers


def test_route_weights_equal_b5_values():
    """The gathered weights are B5's values bit for bit before the
    renormalisation (serving is unchanged)."""
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    gen = torch.Generator().manual_seed(0)
    params = tmoe.init_moe(gen, cfg, torch.device("cpu"))
    x = torch.randn(37, cfg.d_model, generator=gen)
    probs = torch.softmax(tmoe.router_logits(params, x), dim=-1)
    neg, ids = tref.topk_smallest(-probs, cfg.moe.top_k)
    w, ids2, _ = tmoe.route(params, x, cfg)
    assert torch.equal(ids2, ids)
    assert torch.equal(w, -neg / (-neg).sum(-1, keepdim=True))


# ------------------------------------------------------------------- B12


def _attn_inputs(seed, shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(dtype) for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,d", [(1, 16), (7, 33), (33, 80), (40, 16)])
def test_attention_bwd_plain_matches_autograd_and_jax(S, d, causal):
    """``ref.attention_bwd`` (B12's plain version) against torch.autograd
    of ``ref.attention`` and jax.grad of the reference's
    ``kernels/ref.py::attention``, fp32, to 1e-5 of the gradients' size
    (fp32 sums in another order)."""
    q, k, v, do = _attn_inputs(S * d + causal, (2, 3, S, d))
    o = tref.attention(q, k, v, causal)
    dq, dk, dv = tref.attention_bwd(q, k, v, o, do, causal=causal)
    qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
    want_t = torch.autograd.grad(tref.attention(qs, ks, vs, causal),
                                 (qs, ks, vs), do)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want_j = vjp(jnp.asarray(do.numpy()))
    for got, wt, wj in zip((dq, dk, dv), want_t, want_j):
        tol = 1e-5 * max(float(wt.abs().max()), 1.0)
        np.testing.assert_allclose(got.numpy(), wt.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(wj), rtol=0,
                                   atol=tol)


def test_attention_bwd_wrapper_checks_and_card_branch(monkeypatch):
    """``ops.flash_attention_bwd`` on the CPU is the plain version; on a
    card it hands the tensors to B12's launcher and counts one launch; it
    refuses mixed dtypes, mismatched shapes and d > 256."""
    q, k, v, do = _attn_inputs(0, (1, 2, 5, 16))
    o = tref.attention(q, k, v, True)
    tops.reset_launches()
    for a, b in zip(tops.flash_attention_bwd(q, k, v, o, do),
                    tref.attention_bwd(q, k, v, o, do)):
        assert torch.equal(a, b)
    assert tops.LAUNCHES["flash_attention_bwd"] == 0
    with pytest.raises(TypeError):
        tops.flash_attention_bwd(q, k, v.double(), o, do)
    with pytest.raises(ValueError):
        tops.flash_attention_bwd(q, k[:, :, :4], v, o, do)
    big = torch.zeros(1, 1, 2, 264)
    with pytest.raises(ValueError):
        tops.flash_attention_bwd(big, big, big, big, big)
    calls = []
    monkeypatch.setattr(tfab, "launch", lambda *a: calls.append(a) or "bwd")
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    qp = q.bfloat16().permute(0, 2, 1, 3)
    assert tops.flash_attention_bwd(qp, qp, qp, qp, qp, causal=False) == "bwd"
    assert tops.LAUNCHES["flash_attention_bwd"] == 1
    assert calls[0][-1] is False and calls[0][0] is qp


def test_b12_source_is_built_and_self_contained():
    """B12 is a csrc source of its own that ``_build`` compiles with the
    rest, exports its C entry (with the wgmma flag) and the error string,
    uses no atomics, and includes exactly the Hopper headers B11 uses
    (``hopper.cuh``, ``wgmma.cuh``), which it does not change."""
    from repro_torch.kernels import _build
    src = _build.CSRC / "flash_attention_bwd.cu"
    assert src in _build.sources()
    text = src.read_text()
    assert "int flash_attention_bwd(int dtype, int use_wgmma," in text and \
        "cuda_error_string" in text and "atomicAdd" not in text
    assert _build.headers(src) == [_build.CSRC / "hopper.cuh",
                                   _build.CSRC / "wgmma.cuh"]


# ------------------------------------------------- autograd forms (B10/B11)


def _kernel_route(monkeypatch):
    """The wrappers' card branch on the CPU: B10, B11 and B12's launchers
    run the plain versions, each counting its route (B12's the one it is
    named, else the one its rule gives)."""
    def gemm_launch(a, b, tile_n=0):
        tgemm.ROUTE_LAUNCHES[tgemm.route(a, b)] += 1
        return tref.matmul(a, b)

    def attn_launch(q, k, v, causal=True):
        tfa.ROUTE_LAUNCHES[tfa.route(q, k, v)] += 1
        return tref.attention(q, k, v, causal)
    monkeypatch.setattr(tgemm, "launch", gemm_launch)
    monkeypatch.setattr(tfa, "launch", attn_launch)
    def attn_bwd_launch(q, k, v, o, do, causal, way=None):
        tfab.ROUTE_LAUNCHES[way or tfab.route(q, k, v, o, do)] += 1
        return tref.attention_bwd(q, k, v, o, do, causal)
    monkeypatch.setattr(tfab, "launch", attn_bwd_launch)
    real_check = tops._check
    monkeypatch.setattr(tops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])


def test_autograd_forms_launch_the_kernels(monkeypatch):
    """B10's autograd form launches B10 once forward and twice backward,
    B11's launches B11 forward and B12 backward; both gradients equal
    autograd of the plain versions (fp32, to 1e-6)."""
    _kernel_route(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(9, 24, generator=gen, requires_grad=True)
    w = torch.randn(24, 16, generator=gen, requires_grad=True)
    g = torch.randn(9, 16, generator=gen)
    tops.reset_launches()
    got = torch.autograd.grad(grad_ops.matmul(a, w), (a, w), g)
    assert tops.LAUNCHES["matmul"] == 3
    want = torch.autograd.grad(a @ w, (a, w), g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6)
    q, k, v = (torch.randn(1, 2, 6, 16, generator=gen, requires_grad=True)
               for _ in range(3))
    tops.reset_launches()
    out = grad_ops.flash_attention(q, k, v, True)
    got = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert tops.LAUNCHES["flash_attention"] == 1
    assert tops.LAUNCHES["flash_attention_bwd"] == 1
    want = torch.autograd.grad(tref.attention(q, k, v, True), (q, k, v),
                               torch.ones_like(out))
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)


def test_serving_keeps_the_direct_calls(monkeypatch):
    """Without autograd recording (no_grad, or no input requiring a
    gradient) ``linear`` and ``apply_attention`` call B10 and B11
    directly; a training forward pass takes the autograd forms."""
    cfg = get_smoke_config("stablelm-3b")
    params = TT.init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    used = []
    for name in ("matmul", "flash_attention"):
        real = getattr(grad_ops, name)
        monkeypatch.setattr(grad_ops, name, lambda *a, _r=real, _n=name: (
            used.append(_n), _r(*a))[1])
    TT.forward(params, tokens, cfg)
    with torch.no_grad():
        TT.forward(T.map(lambda t: t.requires_grad_(), params), tokens, cfg)
    assert used == []
    with torch.enable_grad():
        TT.forward(params, tokens, cfg)
    assert used.count("matmul") == 7 * cfg.n_layers + 1
    assert used.count("flash_attention") == cfg.n_layers


def test_train_launches_per_remat_policy(monkeypatch):
    """One step's launches under each remat policy equal
    ``chip_smoke.train_launches`` (the counts PERF.md predicts at full
    width), on the reduced stablelm-3b in bf16."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype="bfloat16")
    params = TT.init_params(cfg, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8)),
             "targets": torch.randint(0, cfg.vocab_size, (2, 8))}
    for remat in ("none", "full", "dots"):
        tops.reset_launches()
        trainer.loss_and_grads(params, batch, cfg, TrainConfig(remat=remat))
        assert tops.LAUNCHES == cs.train_launches(cfg, remat), remat
    full = dataclasses.replace(cfg, n_layers=32)
    assert cs.train_launches(full, "none")["matmul"] == 675
    assert cs.train_launches(full, "full")["matmul"] == 899
    assert cs.train_launches(full, "dots")["flash_attention"] == 64


def test_unstacked_layers_are_views_taken_once():
    """``unstack_layers`` unbinds each stacked leaf once: every layer's
    weight is a view of the stacked tensor, and the stacked leaf's
    gradient is one stack of the layers' gradients."""
    cfg = get_smoke_config("stablelm-3b")
    params = TT.init_params(cfg, device="cpu")
    layers = TT.unstack_layers(params)
    assert len(layers) == cfg.n_layers
    w = params["layers"]["sub0"]["attn"]["wq"]
    for i, p in enumerate(layers):
        assert p["attn"]["wq"].data_ptr() == w[i].data_ptr()
    with pytest.raises(ValueError, match="remat"):
        TT.forward(params, torch.zeros((1, 2), dtype=torch.long), cfg,
                   remat="some")


# --------------------------------------------- optimizer and compression


def _tree(seed, shapes=((3, 5), (7,), (2, 3, 4))):
    rng = np.random.default_rng(seed)
    return {f"w{i}": rng.standard_normal(s).astype(np.float32)
            for i, s in enumerate(shapes)}


def test_lr_schedule_matches_jax():
    """The schedule at every step of a run, to 3e-7 relative: a few fp32
    ulps, since the two frameworks' cos differ in the last bit."""
    tc = TrainConfig(**JTC)
    jtc = JTrainConfig(**JTC)
    for step in range(0, 25):
        np.testing.assert_allclose(
            float(topt.lr_schedule(torch.tensor(step, dtype=torch.int32),
                                   tc)),
            float(jopt.lr_schedule(jnp.asarray(step, jnp.int32), jtc)),
            rtol=3e-7, atol=0)


@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_steps_match_jax(clip, monkeypatch):
    """Three AdamW steps on the same trees, with the clip on and off; the
    port slices a leaf past ``CHUNK`` elements, so a small CHUNK takes
    that branch too."""
    monkeypatch.setattr(topt, "CHUNK", 20)
    kw = dict(JTC, grad_clip=clip, weight_decay=0.1)
    tc, jtc = TrainConfig(**kw), JTrainConfig(**kw)
    p0 = _tree(0)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init_opt_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    ts = topt.init_opt_state(tp)
    for i in range(3):
        g = _tree(10 + i)
        jp, js, jst = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g), js,
                                        jtc)
        tp, ts, tst = topt.adamw_update(
            tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tc)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tst[key]), float(jst[key]),
                                       rtol=1e-6)
        for a, b in zip(T.leaves((tp, ts.mu, ts.nu)),
                        jax.tree.leaves((jp, js.mu, js.nu))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        assert int(ts.step) == int(js.step)


def test_global_norm_and_cross_entropy_match_jax():
    tree = _tree(4)
    np.testing.assert_allclose(
        float(topt.global_norm({k: torch.from_numpy(v) for k, v in
                                tree.items()})),
        float(jopt.global_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 13)).astype(np.float32)
    targets = rng.integers(0, 13, (3, 7)).astype(np.int32)
    for ls in (0.0, 0.1):
        np.testing.assert_allclose(
            float(trainer.cross_entropy(torch.from_numpy(logits),
                                        torch.from_numpy(targets), ls)),
            float(jtr.cross_entropy(jnp.asarray(logits),
                                    jnp.asarray(targets), ls)), rtol=1e-6)


def test_int8_compression_matches_jax():
    """quantize_int8 bit-equal (q and scale; rounding half to even), and
    three error-feedback steps of compress/decompress with the residual
    carried, bit-equal to the reference's."""
    g = np.array([0.5, -1.5, 2.5, 127.0, -127.0, 0.0, 63.5, 1e-3],
                 np.float32)
    q, s = tgc.quantize_int8(torch.from_numpy(g))
    jq, js = jgc.quantize_int8(jnp.asarray(g))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    resid, jresid = None, None
    for i in range(3):
        grads = _tree(20 + i)
        tq, resid = tgc.compress_tree({k: torch.from_numpy(v) for k, v in
                                       grads.items()}, resid)
        jqt, jresid = jgc.compress_tree(jax.tree.map(jnp.asarray, grads),
                                        jresid)
        for a, b in zip(T.leaves(tgc.decompress_tree(tq)),
                        jax.tree.leaves(jgc.decompress_tree(jqt))):
            assert np.array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(T.leaves(resid), jax.tree.leaves(jresid)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    x = torch.from_numpy(_tree(30)["w0"])
    np.testing.assert_allclose(float(tgc.roundtrip_error(x)),
                               float(jgc.roundtrip_error(jnp.asarray(
                                   x.numpy()))), rtol=1e-6)


def test_opt_state_from_numpy_carries_both_forms():
    cfg = get_smoke_config("stablelm-3b")
    jcfg = jax_smoke("stablelm-3b")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    for comp in ("none", "int8"):
        jo = jtr.init_opt_state(jp, JTrainConfig(grad_compression=comp))
        jo = jax.tree.map(lambda x: x + 1, jo)
        got = convert.opt_state_from_numpy(cfg, jax.tree.map(np.asarray, jo),
                                           device="cpu")
        want = jax.tree.leaves(jo)
        assert type(got).__name__ == type(jo).__name__
        assert len(T.leaves(got)) == len(want)
        for a, b in zip(T.leaves(got), want):
            assert a.dtype == getattr(torch, str(b.dtype))
            assert np.array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------------- data


def test_token_stream_and_batches_match_jax():
    """The same stream bytes for the same seed, and ``batch_at`` a pure
    function of the step, equal to the reference's; the prefetcher keeps
    the iterator's order."""
    a = tdata.token_stream(5000, 97, seed=4)
    assert np.array_equal(a, jdata.token_stream(5000, 97, seed=4))
    tb, jb = tpipe.TokenBatcher(a, 4, 9), jpipe.TokenBatcher(a, 4, 9)
    for step in (0, 3, 1000):
        for key in ("tokens", "targets"):
            assert np.array_equal(tb.batch_at(step)[key],
                                  jb.batch_at(step)[key])
    pre = tpipe.Prefetcher(iter(tb), size=2, device="cpu")
    try:
        for step in range(5):
            got = next(pre)
            assert got["tokens"].dtype == torch.int32
            assert np.array_equal(got["tokens"].numpy(),
                                  tb.batch_at(step)["tokens"])
    finally:
        pre.close()


# ------------------------------------------------- chip phase rehearsal


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_card(monkeypatch):
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)


def test_train_kernel_edges_rehearsal(monkeypatch):
    """``chip_smoke.train_kernel_edges``, ``train_path_edges`` and
    ``train_kernel_times`` on the CPU at small sizes, the launchers their
    plain versions (the checks then compare the plain versions with
    themselves: they exercise the cases, the tolerances, the routes and
    the launch counts)."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    _stub_card(monkeypatch)
    monkeypatch.setattr(cs, "cuda_ms", lambda torch_, fn, reps: 1.0)
    from repro_torch.launch import lm_kernel_times
    monkeypatch.setattr(lm_kernel_times, "device_ms", lambda fn, reps=0: 1.0)
    monkeypatch.setattr(cs, "BWD_EDGES_S", (1, 33))
    monkeypatch.setattr(cs, "BWD_EDGES_D", (16, 33))
    monkeypatch.setattr(cs, "TRAIN", dict(cs.TRAIN, batch=1, seq=9))
    cfg = get_smoke_config("stablelm-3b")
    gen = torch.Generator().manual_seed(0)
    n = cs.train_kernel_edges(torch, tops, tref, torch.device("cpu"), gen,
                              cfg)
    # 16 edge cases (wgmma: bf16 at d = 16; CUDA cores: d = 33, fp32), two
    # calls each, then the path's bf16 case on each route and its fp32 one
    assert n == 2 * 2 * 2 * 2 + 3
    assert tfab.ROUTE_LAUNCHES == {"wgmma": 2 * (2 * 2 + 1),
                                   "cuda_core": 2 * (3 * 2 * 2 + 2)}
    shapes, _ = cs.train_path_shapes(cfg, 1, 9)
    tops.reset_launches()
    n = cs.train_path_edges(torch, tops, tref, torch.device("cpu"), gen, cfg)
    assert n == 3 * len(shapes) + 2 and tops.LAUNCHES["matmul"] == n - 2
    row = cs.train_kernel_times(torch, tops, tref, torch.device("cpu"), gen,
                                cfg, cs.PEAKS["SXM"])
    assert row["name"] == "flash_attention_bwd" and row["bound_by"] == \
        "bytes" and row["max_abs_err"] == 0


def test_attn_bwd_case_fails_a_wrong_kernel(monkeypatch):
    """The B12 check refuses a kernel whose dK misses one key tile's
    contribution."""
    cs = _chip_smoke()
    _stub_card(monkeypatch)

    def wrong(q, k, v, o, do, causal=True):
        dq, dk, dv = tref.attention_bwd(q, k, v, o, do, causal=causal)
        dk = dk.clone()
        dk[..., :1, :] *= 0.9
        return dq, dk, dv
    monkeypatch.setattr(tops, "flash_attention_bwd", wrong)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 40, 16, generator=gen) for _ in range(3))
    with pytest.raises(SystemExit):
        cs.attn_bwd_case(torch, tops, tref, gen, q, k, v, True, "wrong")


def test_train_phase_rehearsal(monkeypatch, capsys, tmp_path):
    """``chip_smoke.train_step_checks`` and ``train_path`` on the CPU at
    the reduced stablelm-3b in bf16: every check of the phase runs (the
    gradient rule, remat bit-equality, the launch counts, the CLI loop,
    the resume bit-equality) and the CLI's launches come back."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    _stub_card(monkeypatch)
    from repro_torch.launch import lm_kernel_times
    from repro_torch.launch import train as tl
    monkeypatch.setattr(lm_kernel_times, "device_kernels",
                        lambda fn: (fn(), {"kernel": 1.0})[1])
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype="bfloat16")
    monkeypatch.setattr(tl, "get_config", lambda arch: cfg)
    monkeypatch.setattr(cs, "TRAIN", dict(cs.TRAIN, steps=6, log_every=2,
                                          batch=4, seq=16))
    monkeypatch.setattr(cs, "ROOT", tmp_path)
    rows = cs.train_step_checks(torch, tops, torch.device("cpu"), cfg)
    assert len(rows) == len(T.leaves(TT.init_params(cfg, device="meta")))
    launches = cs.train_path(torch, tops, torch.device("cpu"), cfg,
                             cs.PEAKS["SXM"])
    step = cs.train_launches(cfg, "dots")
    assert launches["matmul"] == 6 * step["matmul"] + 3 * (
        7 * cfg.n_layers + 1)
    assert launches["flash_attention_bwd"] == 6 * cfg.n_layers
    out = capsys.readouterr().out
    assert "bit-equal to remat none" in out and "resume: step 6" in out
    assert not (tmp_path / ".train_ckpt").exists()


def test_train_step_check_fails_a_wrong_backward(monkeypatch, capsys):
    """The gradient rule refuses a B10 backward whose dB is 2% off."""
    cs = _chip_smoke()
    _kernel_route(monkeypatch)
    _stub_card(monkeypatch)
    real = grad_ops._matmul_backward

    def skewed(ctx, grad):
        da, db = real(ctx, grad)
        return da, None if db is None else db * 1.02
    torch.library.register_autograd("repro_torch::matmul", skewed,
                                    setup_context=grad_ops._matmul_setup)
    try:
        cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                                  dtype="bfloat16")
        monkeypatch.setattr(cs, "TRAIN", dict(cs.TRAIN, batch=4, seq=16))
        with pytest.raises(SystemExit):
            cs.train_step_checks(torch, tops, torch.device("cpu"), cfg)
        assert "FAIL: train gradients:" in capsys.readouterr().out
    finally:
        torch.library.register_autograd(
            "repro_torch::matmul", grad_ops._matmul_backward,
            setup_context=grad_ops._matmul_setup)


def test_finite_losses_stay_finite():
    """A step's loss is finite on the reduced model (a guard for the
    rehearsals above)."""
    cfg = get_smoke_config("stablelm-3b")
    params = TT.init_params(cfg, device="cpu")
    loss, parts, _ = trainer.loss_and_grads(
        params, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                 "targets": torch.ones((1, 4), dtype=torch.long)}, cfg,
        TrainConfig(remat="dots"))
    assert math.isfinite(float(loss)) and float(parts["aux"]) == 0.0
