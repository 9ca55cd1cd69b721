"""Plain torch version of the quantized fused linear ("x86 simulation" role).

Implements Algorithm 1 of the paper exactly:

    acc = A @ W (+ bias broadcast into the accumulators)   # int32, wrapping
    y   = SRS(acc, shift)          # shift-round-saturate to out_dtype
    y   = max(y, 0) if USERELU     # epilogue activation
    store y

Torch has no integer matmul on CUDA, and ``torch.matmul`` on int8 CPU
tensors returns int8 (wrapping at 8 bits). So the product runs in float64,
which is exact while every partial sum stays below 2^53, and is then reduced
modulo 2^32 into int32. Addition modulo 2^32 is associative, so this equals
the reference's wrapping int32 accumulator bit for bit, whatever the order
of summation.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.quant.srs import srs

_FLOAT64_EXACT = 2**53


def _bits(dtype: torch.dtype) -> int:
    if dtype.is_floating_point or dtype == torch.bool:
        raise TypeError(f"qlinear takes integer operands, got {dtype}")
    return torch.iinfo(dtype).bits


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Reduce int64 values modulo 2^32 into two's-complement int32."""
    v = v & 0xFFFFFFFF
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def qlinear_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    shift: int,
    relu: bool = False,
    out_dtype: str = "int8",
    rounding: str = "half_up",
) -> torch.Tensor:
    """y[M,N] = SRS(x[M,K] @ w[K,N] + bias[N]) with optional fused ReLU."""
    K = x.shape[-1]
    # every |partial sum| <= K * max|x| * max|w| must be exact in float64
    bound = K * 2 ** (_bits(x.dtype) - 1) * 2 ** (_bits(w.dtype) - 1)
    if bound >= _FLOAT64_EXACT:
        raise ValueError(
            f"K={K} with {x.dtype} x {w.dtype} operands can exceed 2^53; "
            "the float64 product would not be exact"
        )
    acc = (x.to(torch.float64) @ w.to(torch.float64)).to(torch.int64)
    if bias is not None:
        acc = acc + bias.to(torch.int64)[None, :]
    y = srs(_wrap_int32(acc), shift, out_dtype, rounding)
    if relu:
        y = torch.clamp(y, min=0)
    return y
