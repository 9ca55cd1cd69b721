"""Normalisation layers: RMS norm, layer norm and RWKV's per-head group
norm (fp32 inside, output in the input dtype)."""

from __future__ import annotations

from typing import Mapping

import torch


def rmsnorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def _normalize(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * scale + bias`` over the last dim,
    with the population variance, in fp32."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def layernorm(params: Mapping[str, torch.Tensor], x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    return _normalize(x, params["scale"], params["bias"], eps)


def groupnorm_heads(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 64e-5) -> torch.Tensor:
    """Per-head group norm over the last dim (RWKV's wkv output norm):
    x [..., H, P]; scale and bias [H, P]."""
    return _normalize(x, scale, bias, eps)
