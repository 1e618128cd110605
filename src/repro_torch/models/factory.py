"""Model factory of the port: config -> parameters.

Counterpart of the JAX package's ``models/factory.py`` for the dense and
MoE families; its sharding specs (the MoE's ``moe_logical`` among them)
and per-shape input trees wait for the LM stack's sharding (ROADMAP
A17).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import transformer


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, device: DeviceLike = None) -> Dict[str, Any]:
    return transformer.init_params(cfg, generator, device=device)
