"""nemotron-4-340b — dense GQA, squared-ReLU MLP [arXiv:2402.16819].

96L, d_model=18432, 96H (GQA kv=8, head_dim=192), d_ff=73728, vocab=256000.
About 682 GB of bf16 weights at full depth: one 80 GB card serves a few
of its layers at full width (``chip_smoke.py``).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    mlp_type="squared_relu",
    norm="layernorm",
    attn=AttnConfig(rope_theta=10_000.0, head_dim=192),
)
