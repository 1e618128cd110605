"""phi3.5-moe-42b-a6.6b — MoE 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct].

32L, d_model=4096, 32H (GQA kv=8, head_dim=128), expert d_ff=6400, vocab=32064.
83.7 GB of bf16 weights do not fit one 80 GB card: the port serves it at
``reduced`` width only, until the LM stack's sharding.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32_064,
    mlp_type="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400, every=1),
    attn=AttnConfig(rope_theta=10_000.0, head_dim=128),
)
