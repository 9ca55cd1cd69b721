"""Quantized tensor container with power-of-two scales.

AIE4ML inherits hls4ml's fixed-point world: a quantized tensor is an integer
array ``data`` plus a binary-point position ``shift`` such that
``real = data * 2**-shift``. Power-of-two scales are what make SRS a pure
shift (no integer multiplier needed), which is the paper's requantization
model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.quant.srs import INT_RANGE, saturate


@dataclasses.dataclass
class QTensor:
    """Integer data + binary-point shift: real value = data * 2**-shift."""

    data: torch.Tensor
    shift: int

    @property
    def dtype(self) -> str:
        return str(self.data.dtype).removeprefix("torch.")

    @property
    def shape(self):
        return tuple(self.data.shape)

    def dequantize(self) -> torch.Tensor:
        return self.data.to(torch.float32) * (2.0 ** (-self.shift))


MAX_SHIFT = 46  # beyond this the scale exceeds fp32 dynamic range usefully


def choose_shift(x: np.ndarray, dtype: str = "int8", margin_bits: int = 0) -> int:
    """Largest shift s such that max|x| * 2**s still fits in ``dtype``.

    margin_bits reserves headroom (e.g. for bias tensors that will be added to
    accumulators). Capped at MAX_SHIFT so near-zero tensors can't explode
    the scale.
    """
    lo, hi = INT_RANGE[dtype]
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    if amax == 0.0:
        return 0
    # hi * 2**-s >= amax  =>  s <= log2(hi / amax)
    s = int(math.floor(math.log2(hi / amax)))
    return min(MAX_SHIFT, max(0, s - margin_bits))


def quantize(
    x,
    dtype: str = "int8",
    shift: Optional[int] = None,
    rounding: str = "half_up",
) -> QTensor:
    """Quantize a float array to ``QTensor`` with a power-of-two scale.

    The arithmetic is numpy float64, as in the reference; the result is a
    CPU tensor.
    """
    x = np.asarray(x, dtype=np.float64)
    if shift is None:
        shift = choose_shift(x, dtype)
    scaled = x * (2.0**shift)
    if rounding == "half_up":
        q = np.floor(scaled + 0.5)
    elif rounding == "half_even":
        q = np.rint(scaled)
    elif rounding == "floor":
        q = np.floor(scaled)
    else:
        raise ValueError(f"unknown rounding mode {rounding!r}")
    lo, hi = INT_RANGE[dtype]
    q = np.clip(q, lo, hi)
    # the values are clipped to the range of ``dtype``, so the cast is exact
    return QTensor(data=torch.from_numpy(q.astype(dtype)), shift=shift)


def dequantize(q: QTensor) -> torch.Tensor:
    return q.dequantize()


def requantize(q: QTensor, new_shift: int, out_dtype: str = "int8") -> QTensor:
    """Change the binary point of an existing QTensor (shift right only)."""
    delta = q.shift - new_shift
    if delta < 0:
        raise ValueError("requantize only supports reducing precision")
    data = q.data.to(torch.int32)
    if delta > 0:
        data = (data + (1 << (delta - 1))) >> delta
    return QTensor(data=saturate(data, out_dtype), shift=new_shift)
