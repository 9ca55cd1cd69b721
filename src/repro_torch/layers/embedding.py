"""Token embedding."""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.dist.sharding import shard_act


def embed(params: Mapping[str, torch.Tensor],
          tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the [vocab, d] table for int tokens [B, S]."""
    return shard_act(params["table"][tokens], "batch", "seq", "act_embed")
