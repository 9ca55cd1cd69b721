"""Dense layers: the float linear and the paper's integer path.

``linear`` is a plain product with fp32 accumulation (the reference left
it to XLA; here it is cuBLAS or the CPU's BLAS). ``quantized_linear``
quantizes, runs the qmatmul kernel (the CUDA kernel for tensors on the
card, its plain version on the CPU) and dequantizes.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from repro_torch.dist.sharding import is_dtensor, local_product, reshape
from repro_torch.kernels import require_no_grad
from repro_torch.kernels.qmatmul.ops import qlinear
from repro_torch.quant.srs import INT_RANGE, TORCH_DTYPES


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One cuBLAS GEMM (``[M, K] x [K, N]``) or batched GEMM (``[E, M, K]
    x [E, K, N]``) of bf16 operands with an fp32 output."""
    fn = torch.mm if a.dim() == 2 else torch.bmm
    return fn(a, b, out_dtype=torch.float32)


class _MatmulF32(torch.autograd.Function):
    """:func:`_mm_f32` with a backward. torch has no derivative for a
    product with ``out_dtype``; this one is two GEMMs at the forward's
    precision: bf16 operands (the incoming fp32 gradient rounded to bf16)
    and fp32 accumulation, each rounded once to the operand's dtype."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = (torch.matmul(g, b.transpose(-1, -2))
              if ctx.needs_input_grad[0] else None)
        gb = (torch.matmul(a.transpose(-1, -2), g)
              if ctx.needs_input_grad[1] else None)
        return ga, gb


def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`_mm_f32`, through :class:`_MatmulF32` only while autograd
    records (serving calls the GEMM directly). DTensor has no sharding
    rule for a product with ``out_dtype``: DTensor operands run it on
    their local tensors (``dist.sharding.local_product``)."""
    if is_dtensor(a) or is_dtensor(b):
        return local_product(_product_f32, a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _mm_f32(a, b)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` over the last dim of x, products summed in fp32, fp32 out.

    On the card a bf16 product runs as one cuBLAS GEMM with an fp32 output
    (fp32 accumulation, no rounding to bf16); elsewhere both operands are
    upcast first. A bf16 product is exact in fp32, so the two are the same
    arithmetic up to the order of summation. Its gradient on the card is
    :class:`_MatmulF32`'s (bf16 GEMMs), on the CPU the upcast product's.
    """
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        y = _product_f32(reshape(x, -1, x.shape[-1]), w)
        return reshape(y, *x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Batched ``x @ w`` ([E, M, K] x [E, K, N]), products summed in fp32,
    fp32 out: :func:`matmul_f32` per batch entry (one cuBLAS batched GEMM
    with an fp32 output on the card)."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return _product_f32(x, w)
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
    quantizing here. Raises if an input requires grad while grad is
    enabled: rounding and the kernel would drop its gradient.
    """
    require_no_grad("qmatmul", x, params["w"], params.get("b"))
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
        reshape(xq, -1, xq.shape[-1]).contiguous(), wq, bq,
        shift=x_shift + w_shift - out_shift, relu=relu, out_dtype=out_dtype,
    )
    y = reshape(y, *lead, y.shape[-1])
    y = y.float() * (2.0 ** -out_shift)
    return y.to(out_float_dtype or x.dtype)
