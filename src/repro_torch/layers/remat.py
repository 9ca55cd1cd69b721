"""Activation checkpointing (the reference's ``jax.checkpoint``).

:func:`remat` runs a function under ``torch.utils.checkpoint`` while
autograd records: its intermediate activations are dropped after the
forward pass and recomputed in the backward pass. Without a graph to
record (serving runs under ``torch.inference_mode``) it is a plain call.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint


def remat(fn: Callable[..., Any], *args: Any, enabled: bool = True) -> Any:
    """``fn(*args)``, checkpointed when ``enabled`` and grad is enabled.

    Non-reentrant checkpointing (``use_reentrant=False``), so checkpoints
    nest (a block around its attention chunks) and non-tensor arguments
    pass through. Nothing on the port's paths draws random numbers, so the
    RNG state is not stashed."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)
