"""Integer quantization substrate: SRS (shift-round-saturate) semantics and
quantized tensor containers, matching the AIE-ML VST.SRS behaviour that
AIE4ML fuses into the kernel store."""

from repro_torch.quant.srs import (
    INT_RANGE,
    srs,
    saturate,
    requant_shift,
)
from repro_torch.quant.qtensor import QTensor, quantize, dequantize, choose_shift

__all__ = [
    "INT_RANGE",
    "srs",
    "saturate",
    "requant_shift",
    "QTensor",
    "quantize",
    "dequantize",
    "choose_shift",
]
