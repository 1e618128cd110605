"""Device choice for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Without a card the caller must name
    ``"cpu"`` explicitly: the port never falls back to the CPU on its own,
    so a run that meant to measure the card cannot end up timing the
    CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested but no CUDA "
                               "device is visible")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_name(device: Optional[torch.device]) -> str:
    """Human-readable name of the device a result ran on."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
