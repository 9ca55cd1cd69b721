"""The port's optimizers and gradient compression (``repro.optim``)."""

from repro_torch.optim.compression import (
    compress_int8,
    decompress_int8,
    error_feedback_reduce,
)
from repro_torch.optim.optimizers import (
    Optimizer,
    adafactor,
    adamw,
    make_optimizer,
)

__all__ = [
    "adamw",
    "adafactor",
    "make_optimizer",
    "Optimizer",
    "compress_int8",
    "decompress_int8",
    "error_feedback_reduce",
]
