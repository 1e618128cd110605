"""The per-layer LM check of ``chip_smoke.py`` (ROADMAP C3), on the CPU at
the reduced stablelm-3b config in bf16.

``chip_smoke.lm_layer_check`` holds a route's residual stream after every
layer to the plain route's, within ``LAYER_FACTOR`` times the plain
route's distance from an fp32 plain route on the same weights.  Here the
plain route held against itself passes at every layer, and a route whose
second layer writes a wrong tile (16 of the MLP's 64 output columns with
their sign flipped, as a faulty GEMM tile would) fails at that layer and
not before.
"""
import dataclasses
import importlib.util
from pathlib import Path

import torch

from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _upcast(tree):
    return {k: _upcast(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def _case():
    cfg = dataclasses.replace(get_smoke_config("stablelm-3b"),
                              dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    plain = T.layer_states(params, tokens, cfg, path="ref")
    exact = T.layer_states(_upcast(params), tokens, cfg, path="ref")
    return cfg, params, tokens, plain, exact


def test_layer_states_end_where_the_forward_pass_does():
    cfg, params, tokens, plain, exact = _case()
    assert len(plain) == cfg.n_layers >= 2
    assert all(s.dtype == torch.bfloat16 and s.shape == (2, 16, cfg.d_model)
               for s in plain)
    assert all(s.dtype == torch.float32 for s in exact)
    from repro_torch.models import layers as L
    x = L.apply_norm(params["final_norm"], plain[-1], cfg)
    logits = L.apply_unembed(params["embed"], x, cfg, "ref")
    want, _ = T.forward(params, tokens, cfg, path="ref")
    assert torch.equal(logits, want)


def test_layer_check_passes_the_plain_route_against_itself():
    cs = _chip_smoke()
    cfg, _, _, plain, exact = _case()
    rows = cs.lm_layer_check(torch, plain, plain, exact)
    assert [r[0] for r in rows] == list(range(cfg.n_layers))
    assert all(ok and dist == 0 and noise > 0
               for _, dist, noise, ok in rows)


def test_layer_check_fails_at_a_perturbed_layer():
    cs = _chip_smoke()
    cfg, params, tokens, plain, exact = _case()
    w_out = params["layers"]["sub0"]["mlp"]["w_out"]
    bad = {**params, "layers": {"sub0": {
        **params["layers"]["sub0"],
        "mlp": {**params["layers"]["sub0"]["mlp"], "w_out": w_out.clone()}}}}
    bad["layers"]["sub0"]["mlp"]["w_out"][1, :, :16] *= -1
    got = T.layer_states(bad, tokens, cfg, path="ref")
    rows = cs.lm_layer_check(torch, got, plain, exact)
    assert rows[0][3] and rows[0][1] == 0
    assert not rows[1][3]
    assert rows[1][1] > cs.LAYER_FACTOR * rows[1][2]
