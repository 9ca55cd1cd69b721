"""Peaks of one NVIDIA H100 SXM5 80 GB.

Copied from ``src/repro_torch/core/device.py`` ``H100Target`` at commit
e17a6c6d57bb276822ede68220dea8818d071c25: NVIDIA's H100 data sheet, SXM
part at its 700 W limit, dense tensor-core rates without sparsity.
"""

PEAK = {
    "bf16": 989e12,       # FLOP/s, also fp16
    "fp8": 1979e12,       # FLOP/s
    "int8": 1979e12,      # OP/s
    "tf32": 495e12,       # FLOP/s
    "fp32": 67e12,        # FLOP/s, outside the tensor cores
}
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, dtype: str) -> float:
    """The least time for ``ops`` operations of class ``dtype`` that move
    ``nbytes``: the larger of the compute and the memory term."""
    return max(ops / PEAK[dtype], nbytes / HBM_BYTES_PER_S)
