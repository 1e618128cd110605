"""Assigned input shapes for the LM-family architectures.

The port's own copy of the JAX package's ``configs/shapes.py`` (plain
Python): the same four shapes, names and applicability rule.

Each shape defines the step kind whose trees the dry run builds:
  - train   -> train_step (forward + backward + optimizer)
  - prefill -> serve_step prefill (full-sequence forward, KV-cache write)
  - decode  -> serve_step decode (one new token against a seq_len KV cache)

``long_500k`` is decode with a 524288-token context; it only runs for
sub-quadratic archs (SSM / hybrid) -- see DESIGN.md §3.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"

    @property
    def tokens(self) -> int:
        """Tokens processed per step (decode: one per sequence)."""
        if self.kind == "decode":
            return self.global_batch
        return self.global_batch * self.seq_len


TRAIN_4K = ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES: dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}

ALL_SHAPE_NAMES: Tuple[str, ...] = tuple(SHAPES)


def shape_applicable(cfg, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable, reason). long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (see DESIGN.md §3)"
    return True, ""
