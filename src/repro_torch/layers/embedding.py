"""Token embedding."""

from __future__ import annotations

from typing import Mapping

import torch


def embed(params: Mapping[str, torch.Tensor],
          tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the [vocab, d] table for int tokens of any shape."""
    return params["table"][tokens]
