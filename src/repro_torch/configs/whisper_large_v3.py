"""whisper-large-v3 — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].

32 encoder + 32 decoder layers, d_model=1280, 20H (kv=20), d_ff=5120,
vocab=51866. The conv frontend is a STUB, as in the JAX package: the
caller passes precomputed frame embeddings (batch, 1500, d_model) as
``encoder_frames``.  The decoder runs self-attention with a KV cache plus
cross-attention into the fixed 1500-frame encoder memory
(``models/whisper.py``, ``models/transformer.py``).
"""
from repro_torch.configs.base import AttnConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    mlp_type="gelu",
    norm="layernorm",
    attn=AttnConfig(rope_theta=10_000.0),
    encoder=EncoderConfig(n_layers=32, n_ctx=1500),
)
