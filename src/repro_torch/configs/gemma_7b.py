"""gemma-7b — dense, GeGLU, head_dim=256 [arXiv:2403.08295].

28L, d_model=3072, 16H (kv=16), d_ff=24576 (GeGLU), vocab=256000.
The unembedding is the embedding table's transpose (``tie_embeddings``).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24_576,
    vocab_size=256_000,
    mlp_type="geglu",
    tie_embeddings=True,
    attn=AttnConfig(rope_theta=10_000.0, head_dim=256),
)
