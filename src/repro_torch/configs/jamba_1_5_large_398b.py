"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE 16e top-2
[arXiv:2403.19887].

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576 (expert FF), vocab=65536.
Block of 8 layers: 7 mamba + 1 attention (position 4); MoE every 2 layers.
Sub-quadratic enough for long_500k: the mamba layers carry constant state and
only 1/8 of layers keep a KV cache (sharded over the data axis at 500k).
One unit of 8 layers holds four 19.3 GB MoE layers in bf16, so no whole
unit fits one 80 GB card: ``chip_smoke.py`` serves ``reduced`` on the
card, and the full width runs in the meta-device dry run.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    mlp_type="swiglu",
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24_576, every=2),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    attn=AttnConfig(rope_theta=10_000.0, head_dim=128),
    hybrid_block=8,
    hybrid_attn_pos=4,
    sub_quadratic=True,
)
