"""Configuration dataclasses of the port's LM stack.

The port's own copy of the JAX package's ``configs/base.py``: the model
configs (``ModelConfig`` and its sub-configs, with the derived properties
and the parameter count), ``ServeConfig``, ``TrainConfig``, ``MeshConfig``
(the production mesh that ``launch/mesh.py`` builds) and ``reduced``.  The
values and the arithmetic are the same, so a config prints, compares and
counts parameters as it does there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts settings."""

    num_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1            # MoE where layer_idx % every == every - 1
    router_dtype: str = "float32"
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings (arXiv:2405.21060)."""

    d_state: int = 128        # N
    head_dim: int = 64        # P
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 256          # SSD chunk length
    conv_width: int = 4
    n_groups: int = 1         # B/C groups (GQA-analogue for SSM)


@dataclass(frozen=True)
class AttnConfig:
    rope_theta: float = 10_000.0
    head_dim: Optional[int] = None      # explicit override (gemma: 256)
    causal: bool = True
    logits_softcap: Optional[float] = None
    qk_norm: bool = False               # qwen3-style per-head RMSNorm on q/k


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack of enc-dec (whisper) archs."""

    n_layers: int
    n_ctx: int = 1500


@dataclass(frozen=True)
class VisionConfig:
    """VLM stub frontend: patch embeddings prepended to the tokens'."""

    num_patches: int = 576
    patch_dim: Optional[int] = None   # None -> d_model


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    mlp_type: str = "swiglu"       # swiglu | geglu | squared_relu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn: AttnConfig = field(default_factory=AttnConfig)
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionConfig] = None
    # hybrid (jamba): within each block of ``hybrid_block`` layers, layer
    # ``hybrid_attn_pos`` is attention, the rest are mamba
    hybrid_block: int = 0
    hybrid_attn_pos: int = 0
    dtype: str = "bfloat16"        # param and activation dtype at scale
    use_pallas: bool = False       # the reference's kernel switch; the port
    #                                always takes its CUDA kernels on a card
    sub_quadratic: bool = False

    # ---- derived ----
    @property
    def head_dim(self) -> int:
        return self.attn.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        return True

    def attn_layer_indices(self) -> Tuple[int, ...]:
        """Which layer indices run attention (vs mamba)."""
        if self.family == "ssm":
            return ()
        if self.hybrid_block:
            return tuple(i for i in range(self.n_layers)
                         if i % self.hybrid_block == self.hybrid_attn_pos)
        return tuple(range(self.n_layers))

    def moe_layer_indices(self) -> Tuple[int, ...]:
        if self.moe is None:
            return ()
        e = self.moe.every
        return tuple(i for i in range(self.n_layers) if i % e == e - 1)

    def param_count(self) -> int:
        """Total parameters (embedding included)."""
        return _count_params(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        return _count_params(self, active_only=True)


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mult = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    return mult * cfg.d_model * d_ff


def _attn_params(cfg: ModelConfig) -> int:
    return cfg.d_model * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * cfg.d_model


def _ssm_params(cfg: ModelConfig) -> int:
    c = cfg.ssm
    d_in = cfg.d_inner
    nheads = cfg.ssm_heads
    in_proj = cfg.d_model * (2 * d_in + 2 * c.n_groups * c.d_state + nheads)
    out_proj = d_in * cfg.d_model
    conv = c.conv_width * (d_in + 2 * c.n_groups * c.d_state)
    return in_proj + out_proj + conv + 3 * nheads   # A_log, D, dt_bias


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model                 # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model            # unembed
    attn_layers = set(cfg.attn_layer_indices())
    moe_layers = set(cfg.moe_layer_indices())
    for i in range(cfg.n_layers):
        total += 2 * cfg.d_model                         # norms
        if cfg.family == "ssm" or (cfg.hybrid_block and i not in attn_layers):
            total += _ssm_params(cfg)
        else:
            total += _attn_params(cfg)
        if i in moe_layers:
            m = cfg.moe
            n_used = m.top_k if active_only else m.num_experts
            total += n_used * _mlp_params(cfg, m.d_ff_expert)
            total += cfg.d_model * m.num_experts         # router
        elif cfg.d_ff:
            total += _mlp_params(cfg, cfg.d_ff)
    if cfg.encoder is not None:
        for _ in range(cfg.encoder.n_layers):
            total += 2 * cfg.d_model + _attn_params(cfg) + \
                _mlp_params(cfg, cfg.d_ff)
        total += cfg.n_layers * (_attn_params(cfg) + cfg.d_model)
    return total


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh description. ``multi_pod`` adds the leading pod
    axis."""

    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def multi_pod(self) -> bool:
        return self.pods > 1

    @property
    def n_devices(self) -> int:
        return self.pods * self.data * self.model

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod \
            else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.multi_pod \
            else (self.data, self.model)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        """Axes carrying data parallelism (batch sharding)."""
        return ("pod", "data") if self.multi_pod else ("data",)


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1            # gradient accumulation
    remat: str = "dots"              # none | dots | full
    zero1: bool = True               # shard optimizer moments over data axis
    grad_compression: str = "none"   # none | int8
    label_smoothing: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 32_768            # KV cache length: prompt + new tokens
    decode_microbatch: int = 0       # 0 = whole batch at once
    kv_dtype: str = "bfloat16"


# ---------------------------------------------------------------------------
# Reduced ("smoke") configs
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig) -> ModelConfig:
    """A tiny config of the same family for CPU tests: the structural
    features kept (GQA ratio, gating, norm), every width shrunk."""
    kw = dict(
        n_layers=min(cfg.n_layers, cfg.hybrid_block or 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(4, 4 * cfg.n_kv_heads // max(cfg.n_heads, 1))
                       or 1),
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=128,
        dtype="float32",
        use_pallas=False,
    )
    if cfg.attn.head_dim is not None:
        kw["attn"] = replace(cfg.attn, head_dim=16)
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
                            top_k=min(cfg.moe.top_k, 2), d_ff_expert=64)
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.encoder is not None:
        kw["encoder"] = replace(cfg.encoder, n_layers=2, n_ctx=16)
    if cfg.vision is not None:
        kw["vision"] = replace(cfg.vision, num_patches=4)
    if cfg.hybrid_block:
        kw["hybrid_block"] = 4
        kw["hybrid_attn_pos"] = min(cfg.hybrid_attn_pos, 3)
        kw["n_layers"] = 4
    return replace(cfg, **kw)


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)
