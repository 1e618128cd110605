"""Model factory of the port: config -> parameters.

Counterpart of the JAX package's ``models/factory.py``; its sharding specs
and per-shape input trees wait for the sharded layer (ROADMAP A17).
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
