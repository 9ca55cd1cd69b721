"""Shift-Round-Saturate (SRS) primitives in int32 torch ops.

On AIE-ML, quantization is fused into the vector store: ``VST.SRS`` applies a
right shift (power-of-two rescale), rounding, and saturation in a single
instruction. These are the integer semantics of ``repro.quant.srs``, written
in torch so they run on the CPU and on the card.

All arithmetic is performed in the accumulator dtype (int32 by default).
Torch's integer ``+`` wraps in two's complement and its ``>>`` on signed
integers is arithmetic, on the CPU and on CUDA alike, so the rounding addend
wraps exactly as the reference's does.
"""

from __future__ import annotations

import torch

# (min, max) representable values per integer dtype.
INT_RANGE = {
    "int8": (-128, 127),
    "int16": (-32768, 32767),
    "int32": (-(2**31), 2**31 - 1),
}

TORCH_DTYPES = {
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
}

VALID_ROUNDING = ("floor", "half_up", "half_even")


def saturate(x: torch.Tensor, out_dtype: str) -> torch.Tensor:
    """Clamp ``x`` to the representable range of ``out_dtype`` and cast."""
    lo, hi = INT_RANGE[out_dtype]
    return torch.clamp(x, lo, hi).to(TORCH_DTYPES[out_dtype])


def _round_shift(acc: torch.Tensor, shift: int, rounding: str) -> torch.Tensor:
    """Arithmetic right shift by ``shift`` with the requested rounding mode.

    ``shift`` is a Python int >= 0. Overflow of the rounding addend wraps
    in the accumulator dtype, matching hardware behaviour.
    """
    if shift == 0:
        return acc
    if rounding == "floor":
        return acc >> shift
    # Python-int operands are cast to acc's dtype (no host->device copy)
    half = 1 << (shift - 1)
    if rounding == "half_up":
        # Round half towards +inf: floor((acc + half) >> shift).
        return (acc + half) >> shift
    if rounding == "half_even":
        floor = acc >> shift
        rem = acc & ((1 << shift) - 1)
        bump = (rem > half) | ((rem == half) & ((floor & 1) == 1))
        return floor + bump.to(acc.dtype)
    raise ValueError(f"unknown rounding mode {rounding!r}")


def srs(
    acc: torch.Tensor,
    shift: int,
    out_dtype: str = "int8",
    rounding: str = "half_up",
) -> torch.Tensor:
    """Shift-round-saturate: the AIE ``VST.SRS`` store path.

    Args:
      acc: integer accumulator values (int32/int64).
      shift: right-shift amount (power-of-two rescale), >= 0.
      out_dtype: output integer dtype name ("int8"/"int16"/"int32").
      rounding: "half_up" (AIE default we adopt), "half_even", or "floor".

    Returns:
      Requantized values in ``out_dtype``.
    """
    if shift < 0:
        raise ValueError("SRS shift must be non-negative")
    if rounding not in VALID_ROUNDING:
        raise ValueError(f"unknown rounding mode {rounding!r}")
    return saturate(_round_shift(acc, shift, rounding), out_dtype)


def requant_shift(in_shift: int, w_shift: int, out_shift: int) -> int:
    """SRS shift for y = x @ w: accumulator lives at scale 2^-(sx+sw); to emit
    outputs at scale 2^-sy we shift right by (sx + sw - sy)."""
    s = in_shift + w_shift - out_shift
    if s < 0:
        raise ValueError(
            f"requantization would need a LEFT shift ({s}); "
            "choose a smaller output shift"
        )
    return s
