"""Dense layers: the float linear and the paper's integer path.

``linear`` is a plain product with fp32 accumulation (the reference left
it to XLA; here it is cuBLAS or the CPU's BLAS). ``quantized_linear``
quantizes, runs the qmatmul kernel (the CUDA kernel for tensors on the
card, its plain version on the CPU) and dequantizes.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.kernels.qmatmul.ops import qlinear
from repro_torch.quant.srs import INT_RANGE, TORCH_DTYPES


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last dim of x, products summed in fp32, fp32 out.

    On the card a bf16 product runs as one cuBLAS GEMM with an fp32 output
    (fp32 accumulation, no rounding to bf16); elsewhere both operands are
    upcast first. A bf16 product is exact in fp32, so the two are the same
    arithmetic up to the order of summation.
    """
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``x @ w`` ([E, M, K] x [E, K, N]), products summed in fp32,
    fp32 out: :func:`matmul_f32` per batch entry (one cuBLAS batched GEMM
    with an fp32 output on the card)."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def linear(params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """y = x @ w (+ b): fp32 accumulation, output in x's dtype."""
    y = matmul_f32(x, params["w"])
    if "b" in params:
        y = y + params["b"].float()
    return y.to(x.dtype)


def quantize_weight(w: torch.Tensor, w_shift: int) -> torch.Tensor:
    """int8 weights: round-half-even(w * 2**w_shift), saturated."""
    lo, hi = INT_RANGE["int8"]
    return torch.clamp(torch.round(w.float() * (2.0 ** w_shift)),
                       lo, hi).to(torch.int8)


def quantized_linear(
    params: Mapping[str, torch.Tensor],
    x: torch.Tensor,
    *,
    x_shift: int = 7,
    w_shift: int = 7,
    out_shift: int = 7,
    relu: bool = False,
    x_dtype: str = "int8",
    out_dtype: str = "int8",
    out_float_dtype: Optional[torch.dtype] = None,
    wq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paper-faithful integer path: quantize, run the fused qmatmul,
    dequantize.

    ``x_dtype`` picks the activation operand width ("int8"/"int16": the
    a16w8 MLP path keeps sub-1e-3 activation resolution); ``out_dtype``
    the SRS output width ("int16" keeps logit-grade resolution for the LM
    head); ``out_float_dtype`` the dequantized dtype (default x's).
    Dequantization runs in fp32 before the final cast, so an int16 result
    is not truncated through bf16. ``torch.round`` rounds half to even,
    like the reference's ``jnp.round``. ``wq`` is ``quantize_weight(w,
    w_shift)`` made once by the caller; the bits are the same as
    quantizing here.
    """
    lo_x, hi_x = INT_RANGE[x_dtype]
    xq = torch.clamp(torch.round(x.float() * (2.0 ** x_shift)), lo_x, hi_x)
    xq = xq.to(TORCH_DTYPES[x_dtype])
    if wq is None:
        wq = quantize_weight(params["w"], w_shift)
    bq = None
    if "b" in params:
        bq = torch.round(
            params["b"].float() * (2.0 ** (x_shift + w_shift))).to(torch.int32)
    lead = xq.shape[:-1]
    y = qlinear(
        xq.reshape(-1, xq.shape[-1]).contiguous(), wq, bq,
        shift=x_shift + w_shift - out_shift, relu=relu, out_dtype=out_dtype,
    )
    y = y.reshape(*lead, y.shape[-1])
    y = y.float() * (2.0 ** -out_shift)
    return y.to(out_float_dtype or x.dtype)
