"""deepseek-67b — dense llama-arch GQA [arXiv:2401.02954].

95L, d_model=8192, 64H (GQA kv=8, head_dim=128), d_ff=22016, vocab=102400.
About 135 GB of bf16 weights at full depth: one 80 GB card serves it only
with its depth cut (``chip_smoke.py`` keeps every width).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=102_400,
    mlp_type="swiglu",
    attn=AttnConfig(rope_theta=10_000.0, head_dim=128),
)
