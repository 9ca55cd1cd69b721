"""The port's models: the decoder LM (dense or MoE), RWKV6, the hybrid
(Mamba2 + a shared attention block) and their config types."""

from repro_torch.models.base import (
    SHAPES,
    ArchConfig,
    ShapeSpec,
    build_model,
    decode_head_logits,
)

__all__ = ["SHAPES", "ArchConfig", "ShapeSpec", "build_model",
           "decode_head_logits"]
