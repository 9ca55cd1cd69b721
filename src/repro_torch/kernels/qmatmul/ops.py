"""Public wrapper of the qmatmul kernel: dispatch on the tensors' device.

A CPU tensor goes to the plain version (:func:`qlinear_ref`). A CUDA tensor
goes to the hand-written Hopper kernel in ``csrc/qmatmul.cu``, or the call
raises: nothing falls back. The kernel masks ragged M, N and K edges itself,
so no padding happens here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.qmatmul.ref import qlinear_ref
from repro_torch.quant.srs import TORCH_DTYPES, VALID_ROUNDING

# Kernel launches since import (or since a caller reset it to 0). Only a
# launch of the CUDA kernel counts; the plain version on the CPU does not.
launches = 0

# (x dtype, w dtype) pairs and output dtypes the kernel is instantiated for
_OPERANDS = {
    (torch.int8, torch.int8),
    (torch.int16, torch.int8),
    (torch.int16, torch.int16),
}
_OUT_DTYPES = ("int8", "int16")
_BITS = {torch.int8: 8, torch.int16: 16}
_MAX_SHIFT = 31  # int32 accumulator: a larger shift is undefined

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def _library() -> ctypes.CDLL:
    lib = build.load("qmatmul")
    fn = lib.qmatmul_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check(x, w, bias, shift, out_dtype, rounding) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"qmatmul kernel needs CUDA tensors, got {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"qlinear needs x (M,K) and w (K,N), got {tuple(x.shape)} and "
            f"{tuple(w.shape)}"
        )
    if (x.dtype, w.dtype) not in _OPERANDS:
        raise TypeError(f"qmatmul kernel has no {x.dtype} x {w.dtype} variant")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"qmatmul kernel has no {out_dtype!r} output")
    if rounding not in VALID_ROUNDING:
        raise ValueError(f"unknown rounding mode {rounding!r}")
    if not 0 <= shift <= _MAX_SHIFT:
        raise ValueError(f"SRS shift {shift} outside [0, {_MAX_SHIFT}]")
    tensors = [("x", x), ("w", w)]
    if bias is not None:
        if bias.dtype != torch.int32 or bias.shape != (w.shape[1],):
            raise ValueError(
                f"bias must be int32 of shape ({w.shape[1]},), got "
                f"{bias.dtype} {tuple(bias.shape)}"
            )
        tensors.append(("bias", bias))
    for name, t in tensors:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max(x.shape[0], x.shape[1], w.shape[1]) >= 2**31:
        raise ValueError("qmatmul kernel takes dimensions below 2^31")


def qlinear(
    x: torch.Tensor,                     # (M, K) int8/int16
    w: torch.Tensor,                     # (K, N) int8/int16
    bias: Optional[torch.Tensor] = None,  # (N,) int32
    *,
    shift: int,
    relu: bool = False,
    out_dtype: str = "int8",
    rounding: str = "half_up",
    block: Optional[tuple] = None,
    acc_blocks: Optional[tuple] = None,
) -> torch.Tensor:
    """Fused quantized linear: y = SRS(x @ w + bias), optional ReLU.

    Bit-exact against :func:`qlinear_ref`. ``block`` and ``acc_blocks``
    are accepted for compatibility with the reference's signature and
    ignored: the CUDA kernel picks its own tiling.
    """
    global launches
    if x.device.type == "cpu":
        return qlinear_ref(x, w, bias, shift=shift, relu=relu,
                           out_dtype=out_dtype, rounding=rounding)
    _check(x, w, bias, shift, out_dtype, rounding)
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=TORCH_DTYPES[out_dtype], device=x.device)
    if M == 0 or N == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        err = lib.qmatmul_launch(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            M, K, N,
            _BITS[x.dtype], _BITS[w.dtype], _BITS[y.dtype],
            shift, VALID_ROUNDING.index(rounding), int(relu),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"qmatmul kernel launch failed: CUDA error {err}")
    launches += 1
    return y
