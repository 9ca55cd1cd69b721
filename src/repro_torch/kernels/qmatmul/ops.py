"""Public wrapper of the qmatmul kernel: dispatch on the tensors' device.

A CPU tensor goes to the plain version (:func:`qlinear_ref`). A CUDA tensor
goes to one of the two hand-written Hopper bodies in ``csrc/qmatmul.cu``, or
the call raises: nothing falls back. :func:`route` picks the body: the
``wgmma`` body (TMA; persistent blocks that take whole tiles round robin
and share the rest stream-K, the split tiles reduced in the same launch)
for an int8 w, M from 17 to 64 and aligned rows, the rows the ``mma``
body would pad to its 64-row tile (the speculative verify step); the
``mma`` body (``mma.sync``, split-K) for the rest, the decode steps at M
up to 16 among them, where its 16-row tile pads nothing and it ran as fast
or faster on the card (PERF.md). :func:`wgmma_plan` sizes the first,
:func:`plan` the second. Both bodies mask ragged M, N and K edges
themselves, so no padding happens here.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple, Union

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
# One call counts once, also when the mma body's split-K runs it as two
# device functions (qmatmul_kernel, then qmatmul_kernel_reduce).
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
_WG_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]

# the mma body
BLOCK_N = 128          # output columns per block
BLOCK_K = 64           # K per pipeline stage; split boundaries fall on it
SMALL_M = 16           # M up to this takes the 16-row tile, else 64 rows
MIN_K_PER_SPLIT = 512  # a split walks at least this much of K
WAVES = 2              # split K while the tiles fill fewer waves of SMs

# the wgmma body
WG_BLOCK_N = 128       # w columns per unit (two m64 products)
WG_BLOCK_K = 128       # K per unit (one 128-byte swizzle row of int8 x)
WG_MAX_M = 64          # the body takes M up to this
# the router sends it M from this up (below, the mma body's 16-row tile
# pads nothing); chip_smoke.py sets it to 1 or 65 to time either body alone
WG_MIN_M = SMALL_M + 1
WG_WIDTHS = (8, 16, 24, 32, 48, 64)  # the token widths integer wgmma takes
WG_SLOT = WG_MAX_M * WG_BLOCK_N      # uint32 partials of one split tile


class Plan(NamedTuple):
    """How the mma body tiles one call: ``block_m`` output rows per block
    and ``splits`` ranges of K, each ``k_per_split`` long (the last one may
    be shorter)."""
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
    """The mma body's tile and split-K plan for an (M, K) x (K, N) call on
    a card with ``sms`` SMs.

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


class WgPlan(NamedTuple):
    """How the wgmma body walks one call: products ``nt`` tokens wide, the
    work cut into ``units`` (``tiles`` column tiles of ``WG_BLOCK_N`` x
    ``k_blocks`` blocks of ``WG_BLOCK_K``), and ``grid`` persistent blocks
    that share them as :func:`wgmma_walk` says."""
    nt: int
    k_blocks: int
    tiles: int
    units: int
    grid: int


def wgmma_takes(M: int, K: int, N: int, x_dtype: torch.dtype,
                w_dtype: torch.dtype, aligned: bool = True) -> bool:
    """Whether the wgmma body can serve an (M, K) x (K, N) call: an int8 w,
    an int8 or int16 x, 1 <= M <= ``WG_MAX_M``, K >= 1 and TMA's 16-byte
    rule (``aligned``: both base addresses 16-byte aligned; rows of x and
    of w a multiple of 16 bytes)."""
    return (w_dtype == torch.int8 and x_dtype in (torch.int8, torch.int16)
            and 1 <= M <= WG_MAX_M and K >= 1 and aligned
            and K * x_dtype.itemsize % 16 == 0 and N % 16 == 0)


def route(M: int, K: int, N: int, x_dtype: torch.dtype,
          w_dtype: torch.dtype, aligned: bool = True) -> str:
    """The body that serves an (M, K) x (K, N) call: ``"wgmma"`` where
    :func:`wgmma_takes` holds and M >= ``WG_MIN_M``; ``"mma"`` for every
    other call."""
    if M >= WG_MIN_M and wgmma_takes(M, K, N, x_dtype, w_dtype, aligned):
        return "wgmma"
    return "mma"


def wgmma_plan(M: int, K: int, N: int, sms: int) -> WgPlan:
    """The wgmma body's plan for an (M, K) x (K, N) call on ``sms`` SMs:
    the narrowest product that holds M tokens, and one persistent block per
    SM or per unit, whichever is fewer."""
    if not 1 <= M <= WG_MAX_M:
        raise ValueError(f"the wgmma body takes 1 <= M <= {WG_MAX_M}, got "
                         f"{M}")
    nt = next(n for n in WG_WIDTHS if n >= M)
    k_blocks, tiles = _cdiv(K, WG_BLOCK_K), _cdiv(N, WG_BLOCK_N)
    units = k_blocks * tiles
    return WgPlan(nt, k_blocks, tiles, units, max(1, min(sms, units)))


def wgmma_walk(p: WgPlan, block: int) -> List[Tuple[int, int]]:
    """The (tile, k block) units that block ``block`` of ``p`` walks, in
    its order, as the kernel's ``Walk`` computes them.

    The first ``tiles // grid * grid`` tiles are whole tiles dealt round
    robin (block b takes b, b + grid, ...). The remaining tiles (fewer
    than ``grid``) are shared stream-K: their units in tile-major order,
    block b taking [u0, u1) with u0 = floor(b * units_left / grid), so a
    share is shorter than a tile and touches at most two. A block walks
    its stream-K share first, then its whole tiles.
    """
    k = p.k_blocks
    rounds = p.tiles // p.grid
    sk_base = rounds * p.grid * k
    sk_units = p.units - sk_base
    u0 = sk_base + block * sk_units // p.grid
    u1 = sk_base + (block + 1) * sk_units // p.grid
    whole = [(block + p.grid * r) * k + kb for r in range(rounds)
             for kb in range(k)]
    return [divmod(u, k) for u in list(range(u0, u1)) + whole]


def split_ranges(p: Plan, K: int) -> List[Tuple[int, int]]:
    """The [lo, hi) range of K that each split of ``p`` sums."""
    return [(s * p.k_per_split, min(K, (s + 1) * p.k_per_split))
            for s in range(p.splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _library() -> ctypes.CDLL:
    lib = build.load("qmatmul")
    for fn, argtypes in ((lib.qmatmul_launch, _ARGTYPES),
                         (lib.qmatmul_wgmma_launch, _WG_ARGTYPES)):
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


# (device index, stream handle) -> the wgmma body's workspace: per SM one
# slot of WG_SLOT uint32 partials, then one counter per slot (4.3 MB on an
# H100). Zeroed once when made; every launch leaves it zero, so no call
# clears it. The most recently used _MAX_WORKSPACES are kept. One that is
# dropped goes back to the caching allocator on the stream it was made on,
# so a launch still in flight there keeps its memory. PyTorch's own streams
# come from a pool and are never destroyed, so their handles name one
# stream for the process's life; a caller that destroys a stream of its
# own must let its launches finish first.
_workspaces: "OrderedDict[Tuple[int, int], torch.Tensor]" = OrderedDict()
_MAX_WORKSPACES = 8


def _workspace(device: torch.device, stream: int, slots: int) -> torch.Tensor:
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = torch.zeros(slots * (WG_SLOT + 1), dtype=torch.int32,
                         device=device)
        _workspaces[key] = ws
        while len(_workspaces) > _MAX_WORKSPACES:
            _workspaces.popitem(last=False)
    _workspaces.move_to_end(key)
    return ws


def _aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    return x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0


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
    ignored: the CUDA kernel's body and tiling come from :func:`route`,
    :func:`wgmma_plan` and :func:`plan`. Raises if
    an input requires grad while grad is enabled (the kernel has no
    backward). DTensor operands are gathered and the kernel (its plain
    version on the CPU) runs once on the whole operands (see
    ``repro_torch.kernels``). On the ``meta`` device (the dry run) it
    reports its work and returns an empty output of the right shape and
    dtype; any other device but the CPU and the card raises.
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
    if x.device.type == "meta":          # a dry run: the work, no launch
        with reported("qmatmul", _work_of(x, w, bias, out_dtype)):
            return torch.empty((x.shape[0], w.shape[1]),
                               dtype=TORCH_DTYPES[out_dtype], device="meta")
    return qlinear_planned(x, w, bias, None, shift=shift, relu=relu,
                           out_dtype=out_dtype, rounding=rounding)


def qlinear_planned(x: torch.Tensor, w: torch.Tensor,
                    bias: Optional[torch.Tensor],
                    p: Union[Plan, WgPlan, None], *,
                    shift: int, relu: bool = False, out_dtype: str = "int8",
                    rounding: str = "half_up") -> torch.Tensor:
    """The CUDA kernel: with ``p`` None the body :func:`route` picks for
    the call, under its own plan (what :func:`qlinear` does); with a
    :class:`Plan` the ``mma`` body under ``p``, and with a :class:`WgPlan`
    the ``wgmma`` body under ``p``, whatever the route (tests hold each
    body at every shape it takes this way). A WgPlan for a call the wgmma
    body cannot serve (:func:`wgmma_takes`) raises."""
    global launches
    _check(x, w, bias, shift, out_dtype, rounding)
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=TORCH_DTYPES[out_dtype], device=x.device)
    if M == 0 or N == 0:
        return y
    index = (x.device.index if x.device.index is not None
             else torch.cuda.current_device())
    if isinstance(p, WgPlan):
        if not wgmma_takes(M, K, N, x.dtype, w.dtype, _aligned(x, w)):
            raise ValueError(f"the wgmma body cannot serve {M}x{K}x{N} "
                             f"{x.dtype} x {w.dtype} (or unaligned rows)")
        wgmma = True
    else:
        wgmma = p is None and route(M, K, N, x.dtype, w.dtype,
                                    _aligned(x, w)) == "wgmma"
    if p is None and not wgmma:
        p = plan(M, K, N, _sm_count(index))
    if not wgmma and (_cdiv(M, p.block_m) > _MAX_GRID_YZ
                      or p.splits > _MAX_GRID_YZ):
        raise ValueError(f"qmatmul kernel grid too large for M={M} under "
                         f"{p}")
    with reported("qmatmul", _work_of(x, w, bias, out_dtype)):
        lib = _library()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        bias_ptr = None if bias is None else bias.data_ptr()
        with torch.cuda.device(x.device):
            if wgmma:
                sms = _sm_count(index)
                wp = p if p is not None else wgmma_plan(M, K, N, sms)
                ws = _workspace(x.device, stream, sms)
                err = lib.qmatmul_wgmma_launch(
                    x.data_ptr(), w.data_ptr(), bias_ptr, y.data_ptr(),
                    ws.data_ptr(), ws.data_ptr() + 4 * sms * WG_SLOT, sms,
                    M, K, N, _BITS[x.dtype], _BITS[y.dtype],
                    shift, VALID_ROUNDING.index(rounding), int(relu),
                    wp.nt, wp.grid, stream)
            else:
                ws = (torch.empty((p.splits, M, N), dtype=torch.int32,
                                  device=x.device) if p.splits > 1 else None)
                err = lib.qmatmul_launch(
                    x.data_ptr(), w.data_ptr(), bias_ptr, y.data_ptr(),
                    None if ws is None else ws.data_ptr(),
                    M, K, N,
                    _BITS[x.dtype], _BITS[w.dtype], _BITS[y.dtype],
                    shift, VALID_ROUNDING.index(rounding), int(relu),
                    p.block_m, p.splits, p.k_per_split, stream)
        if err != 0:
            raise RuntimeError(
                f"qmatmul kernel launch failed: CUDA error {err}")
        launches += 1
    return y
