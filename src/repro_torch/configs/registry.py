"""Architecture registry of the port: ``--arch <id>`` resolution.

All ten of the reference's archs: the dense family (stablelm-3b,
gemma-7b with its tied unembedding; deepseek-67b and nemotron-4-340b,
whose full depth does not fit one card), the MoE family
(qwen3-moe-30b-a3b at full width on one card, phi3.5-moe-42b-a6.6b at
``reduced`` width), the SSM mamba2-780m, the hybrid
jamba-1.5-large-398b (``reduced`` on one card, full width in the
meta-device dry run), the enc-dec whisper-large-v3 and the VLM
phi-3-vision-4.2b.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_67b, gemma_7b,
                                 jamba_1_5_large_398b, mamba2_780m,
                                 nemotron_4_340b, phi3_5_moe_42b,
                                 phi_3_vision_4_2b, qwen3_moe_30b_a3b,
                                 stablelm_3b, whisper_large_v3)
from repro_torch.configs.base import ModelConfig, reduced

# the reference's order
ARCHS: Dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in (
    mamba2_780m, stablelm_3b, nemotron_4_340b, gemma_7b, deepseek_67b,
    jamba_1_5_large_398b, phi3_5_moe_42b, qwen3_moe_30b_a3b,
    phi_3_vision_4_2b, whisper_large_v3)}
ALL_ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(ALL_ARCH_IDS)}"
        ) from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
