"""Feed-forward blocks: SwiGLU (with the quantized down-projection) and
the classic GELU/ReLU MLP."""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard_act
from repro_torch.layers.linear import linear, quantized_linear

_CAL = threading.local()


@contextmanager
def swiglu_calibration(record: Dict[str, float]):
    """Observe down-projection ranges for quantization calibration.

    While active (in this thread), every float ``swiglu`` call folds the
    absmax of its down-projection input ("act") and output ("out") into
    ``record``.
    """
    prev = getattr(_CAL, "record", None)
    _CAL.record = record
    try:
        yield record
    finally:
        _CAL.record = prev


def _observe(record: Dict[str, float], key: str, x: torch.Tensor) -> None:
    record[key] = max(record.get(key, 0.0), float(x.abs().max()))


def swiglu(params: Mapping[str, Mapping[str, torch.Tensor]], x: torch.Tensor,
           quant: Optional[Tuple[int, int, int]] = None,
           down_wq: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SwiGLU FFN. ``quant=(x_shift, w_shift, out_shift)`` routes the
    down-projection through the qmatmul kernel as a16w8 (int16
    activations, int8 weights, int16 SRS output); the gate and up
    projections stay float. ``down_wq`` is the down weight already
    quantized at ``w_shift``."""
    g = linear(params["gate"], x)
    u = linear(params["up"], x)
    h = F.silu(g.float()).to(x.dtype) * u
    h = shard_act(h, "batch", "seq", "act_mlp")
    if quant is not None:
        x_shift, w_shift, out_shift = quant
        return quantized_linear(
            params["down"], h,
            x_shift=x_shift, w_shift=w_shift, out_shift=out_shift,
            x_dtype="int16", out_dtype="int16", wq=down_wq,
        )
    y = linear(params["down"], h)
    record = getattr(_CAL, "record", None)
    if record is not None:
        _observe(record, "act", h)
        _observe(record, "out", y)
    return y


def mlp(params: Mapping[str, Mapping[str, torch.Tensor]], x: torch.Tensor,
        act: str = "gelu") -> torch.Tensor:
    """The classic two-layer MLP (with the biases its ``up`` and ``down``
    carry): ``down(act(up(x)))``, the activation in fp32. ``"gelu"`` is
    the tanh form, the reference's ``jax.nn.gelu`` default (torch's own
    default is the exact erf form); anything else is ReLU."""
    hf = linear(params["up"], x).float()
    hf = F.gelu(hf, approximate="tanh") if act == "gelu" else F.relu(hf)
    h = shard_act(hf.to(x.dtype), "batch", "seq", "act_mlp")
    return linear(params["down"], h)
