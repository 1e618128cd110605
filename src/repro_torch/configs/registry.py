"""Architecture registry of the port: ``--arch <id>`` resolution.

The port serves the dense family (stablelm-3b; deepseek-67b and
nemotron-4-340b, whose full depth does not fit one card), the MoE family
(qwen3-moe-30b-a3b at full width on one card, phi3.5-moe-42b-a6.6b at
``reduced`` width), the enc-dec whisper-large-v3 and the VLM
phi-3-vision-4.2b.  The reference's other archs wait for ROADMAP A17.5:
the SSM and hybrid archs (mamba2-780m, jamba-1.5-large-398b) and the tied
unembedding of gemma-7b.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_67b, nemotron_4_340b,
                                 phi3_5_moe_42b, phi_3_vision_4_2b,
                                 qwen3_moe_30b_a3b, stablelm_3b,
                                 whisper_large_v3)
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in (
    stablelm_3b, nemotron_4_340b, deepseek_67b, phi3_5_moe_42b,
    qwen3_moe_30b_a3b, phi_3_vision_4_2b, whisper_large_v3)}
ALL_ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"arch {arch_id!r} is not ported: the port serves "
            f"{', '.join(ALL_ARCH_IDS)}; the SSM and hybrid archs "
            "(mamba2-780m, jamba-1.5-large-398b) and the tied unembedding "
            "(gemma-7b) wait for ROADMAP A17.5") from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
