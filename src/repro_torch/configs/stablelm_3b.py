"""stablelm-3b — dense decoder [hf:stabilityai/stablelm-2-1_6b family].

32L, d_model=2560, 32H (GQA kv=32 -> MHA), d_ff=6912, vocab=50304.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50_304,
    mlp_type="swiglu",
    norm="layernorm",
    attn=AttnConfig(rope_theta=10_000.0),
)
