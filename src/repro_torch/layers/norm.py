"""RMS normalisation (fp32 inside, output in the input dtype)."""

from __future__ import annotations

from typing import Mapping

import torch


def rmsnorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)
