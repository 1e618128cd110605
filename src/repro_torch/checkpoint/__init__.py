"""Checkpoints of the port's training state."""
from repro_torch.checkpoint.checkpointer import Checkpointer

__all__ = ["Checkpointer"]
