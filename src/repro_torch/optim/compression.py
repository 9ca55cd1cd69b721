"""Int8 gradient compression with error feedback (the reference's
``repro.optim.compression``).

Each gradient is quantized to int8 with one max-scale per tensor and
dequantized; the quantization residual is kept and added back into the
next step's gradient (error feedback, unbiased in the long run;
Karimireddy et al. 2019). ``torch.round`` rounds half to even, like the
reference's ``jnp.round``, so ``q`` is the reference's bit for bit.

Only the local form is ported: the trainer's accumulation boundary on one
card. The collective form (one scale agreed across workers, an int32 sum
of the payload) belongs to the multi-GPU port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

MULTI_GPU_ITEM = ("ROADMAP Queue 1 item 2, multi-GPU part 2 (sharded "
                  "execution)")


def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns ``(q, scale)``, the
    scale an fp32 scalar tensor."""
    gf = g.float()
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_reduce(
    g: torch.Tensor,
    residual: torch.Tensor,
    axis_name: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress ``g + residual`` and decode it: ``(fp32 grad, new
    residual)``. The reduction over workers (``axis_name``) is not ported
    and raises."""
    if axis_name is not None:
        raise NotImplementedError(
            f"error_feedback_reduce over {axis_name!r} reduces across "
            f"workers; that is {MULTI_GPU_ITEM}")
    corrected = g.float() + residual
    q, scale = compress_int8(corrected)
    reduced = decompress_int8(q, scale)
    return reduced, corrected - reduced
