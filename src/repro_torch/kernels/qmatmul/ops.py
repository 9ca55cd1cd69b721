"""Public wrapper of the qmatmul kernel: dispatch on the tensors' device.

A CPU tensor goes to the plain version (:func:`qlinear_ref`). A CUDA tensor
goes to the hand-written Hopper kernel in ``csrc/qmatmul.cu``, or the call
raises: nothing falls back. The kernel masks ragged M, N and K edges itself,
so no padding happens here. :func:`plan` picks the kernel's output tile and
its split of K from the shape and the card's SM count.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import (
    Work,
    build,
    dtensor_mesh,
    gathered,
    replicated_out,
    reported,
    require_no_grad,
)
from repro_torch.kernels.qmatmul.ref import qlinear_ref
from repro_torch.quant.srs import TORCH_DTYPES, VALID_ROUNDING

# Kernel launches since import (or since a caller reset it to 0). Only a
# launch of the CUDA kernel counts; the plain version on the CPU does not.
# One call counts once, also when split-K runs it as two device functions
# (qmatmul_kernel, then qmatmul_kernel_reduce).
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
_MAX_GRID_YZ = 65535  # grid y (row tiles) and z (splits)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]

BLOCK_N = 128          # output columns per block
BLOCK_K = 64           # K per pipeline stage; split boundaries fall on it
SMALL_M = 16           # M up to this takes the 16-row tile, else 64 rows
MIN_K_PER_SPLIT = 512  # a split walks at least this much of K
WAVES = 2              # split K while the tiles fill fewer waves of SMs


class Plan(NamedTuple):
    """How the kernel tiles one call: ``block_m`` output rows per block and
    ``splits`` ranges of K, each ``k_per_split`` long (the last one may be
    shorter)."""
    block_m: int
    splits: int
    k_per_split: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def work(M: int, K: int, N: int, x_dtype: torch.dtype,
         w_dtype: torch.dtype, out_dtype: str, bias: bool) -> Work:
    """The analytic work of one (M, K) x (K, N) call: 2 M K N int8
    tensor-core operations (int16 operands are split into bytes on the
    same units), x, w and the int32 bias read once and y written once, each
    at its own width."""
    nbytes = (M * K * x_dtype.itemsize + K * N * w_dtype.itemsize
              + (4 * N if bias else 0)
              + M * N * TORCH_DTYPES[out_dtype].itemsize)
    return Work(2.0 * M * K * N, float(nbytes), "int8")


def _work_of(x: torch.Tensor, w: torch.Tensor, bias, out_dtype: str) -> Work:
    return work(x.shape[0], x.shape[1], w.shape[1], x.dtype, w.dtype,
                out_dtype, bias is not None)


def plan(M: int, K: int, N: int, sms: int) -> Plan:
    """The tile and split-K plan for an (M, K) x (K, N) call on a card with
    ``sms`` SMs.

    Split K only when the (M, N) tiles give fewer than ``WAVES`` waves of
    blocks, and never below ``MIN_K_PER_SPLIT`` of K per split. Split
    boundaries are multiples of ``BLOCK_K``.
    """
    block_m = SMALL_M if M <= SMALL_M else 64
    tiles = _cdiv(M, block_m) * _cdiv(N, BLOCK_N)
    splits = 1
    if 0 < tiles < WAVES * sms:
        splits = max(1, min(_cdiv(WAVES * sms, tiles), K // MIN_K_PER_SPLIT))
    if splits == 1:
        return Plan(block_m, 1, K)
    k_per_split = _cdiv(_cdiv(K, splits), BLOCK_K) * BLOCK_K
    return Plan(block_m, _cdiv(K, k_per_split), k_per_split)


def split_ranges(p: Plan, K: int) -> List[Tuple[int, int]]:
    """The [lo, hi) range of K that each split of ``p`` sums."""
    return [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split))
            for s in range(p.splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    ignored: the CUDA kernel's tiling comes from :func:`plan`. Raises if
    an input requires grad while grad is enabled (the kernel has no
    backward). DTensor operands are gathered and the kernel (its plain
    version on the CPU) runs once on the whole operands (see
    ``repro_torch.kernels``).
    """
    require_no_grad("qmatmul", x, w, bias)
    mesh = dtensor_mesh("qmatmul", x, w, bias)
    if mesh is not None:
        x, w, bias = gathered(mesh, x, w, bias)
        return replicated_out(
            qlinear(x, w, bias, shift=shift, relu=relu, out_dtype=out_dtype,
                    rounding=rounding), mesh)
    if x.device.type == "cpu":
        with reported("qmatmul", _work_of(x, w, bias, out_dtype)):
            return qlinear_ref(x, w, bias, shift=shift, relu=relu,
                               out_dtype=out_dtype, rounding=rounding)
    return qlinear_planned(x, w, bias, None, shift=shift, relu=relu,
                           out_dtype=out_dtype, rounding=rounding)


def qlinear_planned(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor], p: Optional[Plan], *,
                    shift: int, relu: bool = False, out_dtype: str = "int8",
                    rounding: str = "half_up") -> torch.Tensor:
    """The CUDA kernel under plan ``p``, or under :func:`plan`'s for the
    shape and card if ``p`` is None (what :func:`qlinear` does). Tests pass
    a plan to run one shape with and without split-K."""
    global launches
    _check(x, w, bias, shift, out_dtype, rounding)
    M, K = x.shape
    N = w.shape[1]
    if p is None:
        p = plan(M, K, N, _sm_count(x.device.index
                                    if x.device.index is not None
                                    else torch.cuda.current_device()))
    y = torch.empty((M, N), dtype=TORCH_DTYPES[out_dtype], device=x.device)
    if M == 0 or N == 0:
        return y
    if _cdiv(M, p.block_m) > _MAX_GRID_YZ or p.splits > _MAX_GRID_YZ:
        raise ValueError(f"qmatmul kernel grid too large for M={M} under "
                         f"{p}")
    with reported("qmatmul", _work_of(x, w, bias, out_dtype)):
        ws = (torch.empty((p.splits, M, N), dtype=torch.int32,
                          device=x.device) if p.splits > 1 else None)
        lib = _library()
        with torch.cuda.device(x.device):
            err = lib.qmatmul_launch(
                x.data_ptr(), w.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                None if ws is None else ws.data_ptr(),
                M, K, N,
                _BITS[x.dtype], _BITS[w.dtype], _BITS[y.dtype],
                shift, VALID_ROUNDING.index(rounding), int(relu),
                p.block_m, p.splits, p.k_per_split,
                torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(
                f"qmatmul kernel launch failed: CUDA error {err}")
        launches += 1
    return y
