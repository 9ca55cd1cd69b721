"""Public wrapper of the flash-attention kernel: dispatch on the tensors'
device.

A CPU tensor goes to the plain version (:func:`attention_ref`). A CUDA
tensor goes to the hand-written Hopper kernel in
``csrc/flash_attention.cu``, or the call raises: nothing falls back. bf16
runs on the tensor cores in ``flash_kernel_wgmma`` (wgmma fed by TMA, a
producer warpgroup and two consumer warpgroups, 128 query rows a block),
fp32 on the CUDA cores in ``flash_kernel`` (64 rows a block). The kernel
masks ragged edges itself, so nothing is padded here.
"""

from __future__ import annotations

import ctypes
from typing import Optional

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
from repro_torch.kernels.flash_attention.ref import attention_ref

# Kernel launches since import (or since a caller reset it to 0). Only a
# launch of the CUDA kernel counts; the plain version on the CPU does not.
launches = 0

HEAD_DIMS = (8, 16, 32, 64, 80, 128)   # head dims the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_Q_TILES = 65535               # grid y of the fp32 body
_MAX_BLOCKS = 2**31 - 1            # the 1-D grid of the bf16 body
_ALIGN = 16                        # TMA and cp.async need 16-byte bases

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def rows_per_block(dtype: torch.dtype) -> int:
    """Query rows one block of the kernel owns: 128 in the bf16 body, 64
    in the fp32 one."""
    return 128 if dtype == torch.bfloat16 else 64


def work(BH: int, Sq: int, Sk: int, hd: int, dtype: torch.dtype,
         causal: bool) -> Work:
    """The analytic work of one call: the two products, 4 BH Sq Sk hd
    operations (half of them under a causal mask) in q's dtype, and q, k,
    v read once and o written once."""
    ops = 4.0 * BH * Sq * Sk * hd / (2 if causal else 1)
    nbytes = dtype.itemsize * BH * hd * (2 * Sq + 2 * Sk)
    return Work(ops, float(nbytes),
                "bf16" if dtype == torch.bfloat16 else "fp32")


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


def accepts(Sq: int, Sk: int, hd: int, causal: bool) -> bool:
    """Whether :func:`flash_attention` is the route for this call at its
    default blocks: the reference's own rule (``hd % 8 == 0``) and the
    reference wrapper's checks (:func:`_check_blocks`). Callers route every
    other call to their plain attention, where the reference (whose flash
    switch is off) runs it. A head dim that passes here but that the kernel
    is not built for still goes to the wrapper, which raises on the card."""
    if hd % 8:
        return False
    try:
        _check_blocks(Sq, Sk, causal, None, None)
    except ValueError:
        return False
    return True


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
    rows = rows_per_block(q.dtype)
    q_tiles = _ceil_to(Sq, rows) // rows
    too_many = (BH * q_tiles > _MAX_BLOCKS if rows == 128
                else q_tiles > _MAX_Q_TILES)
    if too_many or BH >= 2**31 or max(Sq, k.shape[1]) >= 2**30:
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
    (:func:`_check_blocks`); the CUDA kernel picks its own tiling. Raises
    if an input requires grad while grad is enabled: the kernel has no
    backward (nor had the reference's). DTensor operands are gathered and
    the kernel (its plain version on the CPU) runs once on the whole
    operands (see ``repro_torch.kernels``). On the ``meta`` device (the
    dry run) it reports its work and returns an empty output of q's shape
    and dtype; any other device but the CPU and the card raises.
    """
    global launches
    require_no_grad("flash_attention", q, k, v)
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    _check_blocks(Sq, Sk, causal, block_q, block_k)
    mesh = dtensor_mesh("flash_attention", q, k, v)
    if mesh is not None:
        q, k, v = gathered(mesh, q, k, v)
        return replicated_out(
            flash_attention(q, k, v, causal=causal, q_start=q_start), mesh)
    if q.device.type == "cpu":
        with reported("flash_attention",
                      work(BH, Sq, Sk, hd, q.dtype, causal)):
            return attention_ref(q, k, v, causal=causal, q_start=q_start)
    if q.device.type == "meta":          # a dry run: the work, no launch
        with reported("flash_attention",
                      work(BH, Sq, Sk, hd, q.dtype, causal)):
            return torch.empty_like(q)
    _check_kernel_args(q, k, v, q_start)
    if BH == 0 or Sq == 0:
        return torch.empty_like(q)
    with reported("flash_attention", work(BH, Sq, Sk, hd, q.dtype, causal)):
        o = torch.empty_like(q)
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
