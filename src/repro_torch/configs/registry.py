"""Architecture registry of the port: ``--arch <id>`` resolution.

The port serves the dense family, so it holds stablelm-3b only; the
reference's other archs (MoE, SSM, hybrid, enc-dec, VLM) wait for their
model modules (ROADMAP A17).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import stablelm_3b
from repro_torch.configs.base import ModelConfig, reduced

ARCHS: Dict[str, ModelConfig] = {stablelm_3b.CONFIG.arch_id:
                                 stablelm_3b.CONFIG}
ALL_ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return ARCHS[arch_id]
    except KeyError:
        raise KeyError(
            f"arch {arch_id!r} is not ported: the port serves "
            f"{', '.join(ALL_ARCH_IDS)}; the MoE, SSM, hybrid, enc-dec and "
            "VLM archs wait for ROADMAP A17") from None


def get_smoke_config(arch_id: str) -> ModelConfig:
    return reduced(get_config(arch_id))
