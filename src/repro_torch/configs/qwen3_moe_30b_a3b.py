"""qwen3-moe-30b-a3b — fine-grained MoE, 128 experts top-8
[hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32H (GQA kv=4, head_dim=128, qk-norm), expert d_ff=768,
vocab=151936. The top-8-of-128 router is the flagship application of the
paper's local-selection + global-merge distributed top-k (DESIGN.md §2/§3);
in the port the router's top-8 runs on B5 (``models/moe.py``).  61.1 GB of
bf16 weights: one 80 GB card holds the full width.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    mlp_type="swiglu",
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768, every=1),
    attn=AttnConfig(rope_theta=1_000_000.0, head_dim=128, qk_norm=True),
)
