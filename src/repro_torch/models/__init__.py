"""The port's models: the dense decoder LM and its config types."""

from repro_torch.models.base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    build_model,
    decode_head_logits,
)

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "build_model",
           "decode_head_logits"]
