"""Public wrapper of the flash-attention kernel: dispatch on the tensors'
device.

A CPU tensor goes to the plain version (:func:`attention_ref`). A CUDA
tensor goes to the hand-written Hopper kernel in
``csrc/flash_attention.cu``, or the call raises: nothing falls back. bf16
runs on the tensor cores (``flash_kernel_mma``), fp32 on the CUDA cores
(``flash_kernel``). The kernel masks ragged edges itself, so nothing is
padded here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_ref

# Kernel launches since import (or since a caller reset it to 0). Only a
# launch of the CUDA kernel counts; the plain version on the CPU does not.
launches = 0

HEAD_DIMS = (8, 16, 32, 64, 128)   # head dims the kernel is instantiated for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_Q_TILES = 65535               # grid y: one block per 64 query rows
_ALIGN = 16                        # bf16 tiles are copied 16 bytes at a time

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _check_blocks(Sq: int, Sk: int, causal: bool,
                  block_q: Optional[int], block_k: Optional[int]) -> None:
    """The reference wrapper's argument checks, with its block sizes.

    The reference padded q and k to its blocks and could not mask padded
    keys in a non-causal call, nor in a causal call with Sq != Sk; it
    raised there. The port raises on the same calls so that callers behave
    the same. Its defaults are the reference's off the TPU
    (``min(ceil8(S), 32)``); the kernel's own tiling does not depend on
    them.
    """
    bq = block_q or min(_ceil_to(Sq, 8), 32)
    bk = block_k or min(_ceil_to(Sk, 8), 32)
    if _ceil_to(Sk, bk) > Sk:
        if not causal:
            raise ValueError("non-causal flash requires Sk % block_k == 0")
        if _ceil_to(Sq, bq) != _ceil_to(Sk, bk):
            raise ValueError("causal flash padding requires Sq == Sk")


def _check_kernel_args(q, k, v, q_start: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash attention takes q, k, v of shape [BH, S, hd]")
    BH, Sq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != BH or k.shape[2] != hd:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
            "need k == v shape [BH, Sk, hd] matching q")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash kernel has no head dim {hd} (built for "
                         f"{HEAD_DIMS})")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if q.dtype == torch.bfloat16 and t.data_ptr() % _ALIGN:
            raise ValueError(f"bf16 {name} must be {_ALIGN}-byte aligned")
    if k.shape[1] < 1:
        raise ValueError("flash kernel needs at least one key")
    if not 0 <= q_start < 2**30:
        raise ValueError(f"flash kernel needs 0 <= q_start < 2**30, got "
                         f"{q_start}")
    if _ceil_to(Sq, 64) // 64 > _MAX_Q_TILES or BH >= 2**31 \
            or max(Sq, k.shape[1]) >= 2**30:
        raise ValueError(f"flash kernel grid too large for q {tuple(q.shape)}")


def flash_attention(
    q: torch.Tensor,   # [BH, Sq, hd]
    k: torch.Tensor,   # [BH, Sk, hd]
    v: torch.Tensor,   # [BH, Sk, hd]
    *,
    causal: bool = True,
    q_start: int = 0,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Forward attention with an online softmax; output in q's dtype.

    Within 2e-5 (fp32) and 2e-2 (bf16) of :func:`attention_ref`; the bf16
    kernel feeds the probabilities to the PV product as two bf16 parts
    (hi + lo). ``block_q``/``block_k``
    only feed the reference wrapper's argument checks
    (:func:`_check_blocks`); the CUDA kernel picks its own tiling.
    """
    global launches
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    _check_blocks(Sq, Sk, causal, block_q, block_k)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, q_start=q_start)
    _check_kernel_args(q, k, v, q_start)
    o = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return o
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            BH, Sq, Sk, hd, _DTYPES[q.dtype], int(causal), int(q_start),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed: CUDA error {err}")
    launches += 1
    return o
