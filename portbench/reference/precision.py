"""Rounding of the reference's tensors: none (the reference, fp32), or a
lower precision than the program's (the control).

A control rounds every float activation where the program stores one and
every weight to ``float_format``. Rounding is per tensor: the tensor is
scaled so that its largest magnitude maps to the format's largest value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

FP8_MAX = 448.0          # float8_e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    y = (x.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return y.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``float_format`` None (fp32) or "fp8"."""

    float_format: Optional[str] = None

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A float activation as the program would store it."""
        return x if self.float_format is None else round_fp8(x)

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return self.act(w)


FP32 = Precision()
