"""B12's two routes on the CPU (``kernels/flash_attention_bwd.py``).

The rule that picks ``wgmma`` or ``cuda_core`` (``route``), the launch
counts per route and their reset, and the wrapper's card branch with the
C entry scripted: the flags it passes for each route, and a refused wgmma
launch raising with no retry on the other route.  Then a plain-torch model
of the wgmma route's arithmetic, P and dS each fed to the products that
take them as two bf16 terms (hi = bf16(x), lo = bf16(x - hi)), held
against the fp32 formula (``ref.attention_bwd``) at a tenth of
``chip_smoke.BWD_RTOL`` of the summed terms, beside the same model with P
and dS rounded once to bf16, which misses that bar.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds both
routes against the plain version.
"""
import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
B, H = 2, 3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tensors(dtype, S, d, layout):
    """Five (B, H, S, d) tensors of zeros: views of the models' (B, S, 3,
    H, d) memory, contiguous, or contiguous from one element past an
    aligned base."""
    if layout == "model":
        x = torch.zeros((B, S, 3, H, d), dtype=dtype)
        views = [x[:, :, i % 3].permute(0, 2, 1, 3) for i in range(5)]
        return views
    if layout == "offset":
        return [torch.zeros(B * H * S * d + 1, dtype=dtype)[1:]
                .view(B, H, S, d) for _ in range(5)]
    return [torch.zeros((B, H, S, d), dtype=dtype) for _ in range(5)]


@pytest.mark.parametrize("layout", ["model", "contiguous", "offset"])
@pytest.mark.parametrize("d", [16, 33, 80, 128, 144, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_rule(dtype, d, layout):
    """``wgmma`` exactly for bf16 with d a multiple of 16 up to 128, every
    stride a multiple of 8 elements and every base 16-byte aligned;
    ``cuda_core`` for everything else."""
    ts = _tensors(dtype, 5, d, layout)
    want = ("wgmma" if dtype == torch.bfloat16 and d % 16 == 0 and d <= 128
            and layout != "offset" else "cuda_core")
    assert fab.route(*ts) == want
    assert fab.uses_tensor_cores(*ts) == (want == "wgmma")
    if want == "wgmma":       # one unaligned tensor of eight is enough
        odd = torch.zeros(ts[0].numel() + 1, dtype=dtype)[1:].view(ts[0].shape)
        assert fab.route(*ts, odd) == "cuda_core"


def test_reset_launches_clears_route_counts(monkeypatch):
    monkeypatch.setitem(fab.ROUTE_LAUNCHES, "wgmma", 3)
    monkeypatch.setitem(fab.ROUTE_LAUNCHES, "cuda_core", 2)
    ops.reset_launches()
    assert fab.ROUTE_LAUNCHES == {"wgmma": 0, "cuda_core": 0}


def _scripted_entry(monkeypatch, err=0):
    """The card branch on the CPU: ``ops._check`` reports a card, the C
    entry records its arguments and returns ``err``."""
    calls = []

    def entry(*args):
        calls.append(args)
        return err

    def error_string(code):
        return b"invalid argument"
    monkeypatch.setattr(fab, "_fns", {})
    monkeypatch.setattr(_build, "bind", lambda stem, name, argtypes: entry)
    monkeypatch.setattr(_build, "library", lambda stem: SimpleNamespace(
        cuda_error_string=error_string))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    real_check = ops._check
    monkeypatch.setattr(ops, "_check", lambda op, **kw: (
        real_check(op, **kw), torch.device("cuda"))[1])
    ops.reset_launches()
    return calls


@pytest.mark.parametrize("dtype,d,layout,want", [
    (torch.bfloat16, 80, "model", "wgmma"),
    (torch.bfloat16, 16, "contiguous", "wgmma"),
    (torch.bfloat16, 128, "model", "wgmma"),
    (torch.bfloat16, 33, "model", "cuda_core"),
    (torch.bfloat16, 256, "contiguous", "cuda_core"),
    (torch.bfloat16, 80, "offset", "cuda_core"),
    (torch.float32, 80, "model", "cuda_core")])
def test_card_branch_counts_the_rule_route(monkeypatch, dtype, d, layout,
                                           want):
    """``ops.flash_attention_bwd`` on a (scripted) card launches once, on
    the route the rule gives: the C entry gets the dtype, the wgmma flag
    and the 24 strides of q, k, v, o, dO and the outputs; both counts
    move by one."""
    calls = _scripted_entry(monkeypatch)
    q, k, v, o, do = _tensors(dtype, 7, d, layout)
    dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, do, causal=False)
    assert ops.LAUNCHES["flash_attention_bwd"] == 1
    assert fab.ROUTE_LAUNCHES == {"wgmma": int(want == "wgmma"),
                                  "cuda_core": int(want == "cuda_core")}
    (args,) = calls
    assert args[:2] == (int(dtype == torch.bfloat16), int(want == "wgmma"))
    assert args[12:17] == (B, H, 7, d, 0)
    assert math.isclose(args[17], 1.0 / math.sqrt(d))
    assert list(args[18]) == [s for t in (q, k, v, o, do, dq, dk, dv)
                              for s in t.stride()[:3]]
    for x, g in zip((q, k, v), (dq, dk, dv)):
        assert g.shape == x.shape and g.dtype == x.dtype


def test_named_route(monkeypatch):
    """The launcher's ``way`` names the route: the CUDA-core route on
    inputs the rule sends to wgmma; each launch counts on the route it
    took."""
    calls = _scripted_entry(monkeypatch)
    ts = _tensors(torch.bfloat16, 9, 80, "model")
    fab.launch(*ts, True, way="cuda_core")
    fab.launch(*ts, True)
    assert [c[1] for c in calls] == [0, 1]
    assert [c[16] for c in calls] == [1, 1]
    assert fab.ROUTE_LAUNCHES == {"wgmma": 1, "cuda_core": 1}
    assert ops.LAUNCHES["flash_attention_bwd"] == 0   # the launcher alone


def test_wgmma_failure_raises_without_retry(monkeypatch):
    """A wgmma launch the C entry refuses raises with the CUDA error and
    the route; nothing retries it on the CUDA-core route, and no count
    moves."""
    calls = _scripted_entry(monkeypatch, err=1)
    ts = _tensors(torch.bfloat16, 9, 80, "model")
    with pytest.raises(RuntimeError, match=r"wgmma: CUDA error 1 \(invalid"):
        ops.flash_attention_bwd(*ts)
    assert len(calls) == 1 and calls[0][1] == 1
    assert fab.ROUTE_LAUNCHES == {"wgmma": 0, "cuda_core": 0}
    assert ops.LAUNCHES["flash_attention_bwd"] == 0


# ------------------------------------------- the wgmma route's arithmetic


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _two_terms(x):
    """What the two issues of a product sum: hi + lo, hi = bf16(x), lo =
    bf16(x - hi)."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _model(q, k, v, o, do, causal, feed):
    """The backward formula in fp32 with P and dS passed through ``feed``
    before the three products that take them (dV = P^T dO, dQ = dS K, dK
    = dS^T Q); the score products take the bf16 inputs exactly."""
    S, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d)
    s = q @ k.transpose(-1, -2) * scale
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, -1)
    ds = p * (do @ v.transpose(-1, -2) - (do * o).sum(-1, keepdim=True))
    pf, dsf = feed(p), feed(ds)
    return (dsf @ k * scale, dsf.transpose(-1, -2) @ q * scale,
            pf.transpose(-1, -2) @ do)


@pytest.mark.parametrize("S,d,causal", [
    (128, 80, True), (45, 16, True), (129, 128, True), (64, 80, False),
    (45, 16, False), (129, 128, False)])
def test_two_term_split_meets_the_bar(S, d, causal):
    """At the training path's (S, d) and the edge sizes, bf16-valued N(0,
    1) inputs (o the attention output in bf16): the two-term model stays
    within a tenth of BWD_RTOL of the summed terms of the fp32 formula,
    while P and dS rounded once to bf16 miss BWD_RTOL itself."""
    cs = _chip_smoke()
    rng = np.random.default_rng(S * d + causal)
    q, k, v, do = (_bf16(torch.from_numpy(
        rng.standard_normal((B, H, S, d)).astype(np.float32)))
        for _ in range(4))
    o = _bf16(ref.attention(q, k, v, causal))
    want = ref.attention_bwd(q, k, v, o, do, causal=causal)
    terms = cs.attn_bwd_terms(torch, q, k, v, o, do, causal)

    def worst(feed):
        got = _model(q, k, v, o, do, causal, feed)
        return max(float(((g - w).abs() / (cs.BWD_RTOL * t)).max())
                   for g, w, t in zip(got, want, terms))
    assert worst(_two_terms) <= 0.1
    assert worst(_bf16) > 2.0
