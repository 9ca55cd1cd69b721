"""Rotary position embeddings (rotate-half convention)."""

from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim // 2], fp32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(
    x: torch.Tensor,            # [B, S, H, hd]
    positions: torch.Tensor,    # [B, S] int
    inv_freq: torch.Tensor,     # [hd // 2]
) -> torch.Tensor:
    angles = positions[..., None].float() * inv_freq       # [B, S, hd/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
