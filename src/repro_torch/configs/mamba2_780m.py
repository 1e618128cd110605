"""mamba2-780m — SSD (state-space duality), attention-free [arXiv:2405.21060].

48L, d_model=1536, d_ff=0 (no separate MLP; the Mamba block is the mixer),
vocab=50280, ssm_state=128. d_inner = 2*1536 = 3072, head_dim P=64 -> 48 heads.
Sub-quadratic: runs long_500k (constant-size recurrent state per layer).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=24,          # unused for attention (attn-free); kept for API shape
    n_kv_heads=24,
    d_ff=0,              # no MLP sublayer in mamba2 blocks
    vocab_size=50_280,
    mlp_type="swiglu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256, conv_width=4),
    sub_quadratic=True,
)
