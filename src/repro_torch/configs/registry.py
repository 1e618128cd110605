"""Architecture registry of the port: ``--arch <id>`` resolution.

The port serves the dense family (stablelm-3b) and the MoE family
(qwen3-moe-30b-a3b at full width on one card, phi3.5-moe-42b-a6.6b at
``reduced`` width); the reference's other archs (gemma-7b and the large
dense ones, SSM, hybrid, enc-dec, VLM) wait for their model modules
(ROADMAP A17).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import phi3_5_moe_42b, qwen3_moe_30b_a3b, stablelm_3b
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.arch_id: m.CONFIG for m in (
    stablelm_3b, phi3_5_moe_42b, qwen3_moe_30b_a3b)}
ALL_ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"arch {arch_id!r} is not ported: the port serves "
            f"{', '.join(ALL_ARCH_IDS)}; the other dense archs and the SSM, "
            "hybrid, enc-dec and VLM archs wait for ROADMAP A17") from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
