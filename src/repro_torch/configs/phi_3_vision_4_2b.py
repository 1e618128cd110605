"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stubbed)
[hf:microsoft/Phi-3-vision-128k-instruct].

32L, d_model=3072, 32H (kv=32 -> MHA), d_ff=8192, vocab=32064. The vision
frontend is a STUB, as in the JAX package: the caller passes precomputed
patch embeddings (batch, num_patches, d_model) as ``patch_embeds``, which
``models/transformer.py`` prepends to the tokens' embeddings.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    mlp_type="swiglu",
    attn=AttnConfig(rope_theta=10_000.0),
    vision=VisionConfig(num_patches=576),
)
