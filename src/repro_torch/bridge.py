"""Carry a compiled model's quantized arrays into the port.

``emitted_model_from_arrays`` turns per-layer numpy arrays (the state of a
reference ``EmittedModel``: padded quantized weights, int32 biases, SRS
shifts, ...) into a port :class:`EmittedModel` on a given device, without
running the passes. The port's execution can then be held against the
reference's on identical weights, independently of the port's passes.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.emit import DeviceLike, EmittedModel, LayerExec, resolve_device
from repro_torch.quant.srs import INT_RANGE, VALID_ROUNDING

LAYER_KEYS = ("name", "weight", "bias", "srs_shift", "relu", "out_dtype",
              "rounding", "f_in", "f_out")


def _layer(spec: Mapping, device: torch.device) -> LayerExec:
    missing = [k for k in LAYER_KEYS if k not in spec]
    if missing:
        raise KeyError(f"layer {spec.get('name', '?')} lacks {missing}")
    weight = np.asarray(spec["weight"])
    if weight.ndim != 2 or weight.dtype.name not in ("int8", "int16"):
        raise ValueError(
            f"{spec['name']}: weight must be a 2-D int8/int16 array, got "
            f"{weight.dtype} {weight.shape}"
        )
    bias: Optional[torch.Tensor] = None
    if spec["bias"] is not None:
        b = np.asarray(spec["bias"])
        if b.shape != (weight.shape[1],):
            raise ValueError(f"{spec['name']}: bias shape {b.shape} != "
                             f"({weight.shape[1]},)")
        bias = torch.from_numpy(b.astype(np.int32)).to(device)
    if spec["out_dtype"] not in INT_RANGE or spec["rounding"] not in VALID_ROUNDING:
        raise ValueError(f"{spec['name']}: bad out_dtype/rounding")
    return LayerExec(
        name=str(spec["name"]),
        weight=torch.from_numpy(np.array(weight, order="C")).to(device),
        bias=bias,
        srs_shift=int(spec["srs_shift"]),
        relu=bool(spec["relu"]),
        out_dtype=str(spec["out_dtype"]),
        rounding=str(spec["rounding"]),
        f_in=int(spec["f_in"]),
        f_out=int(spec["f_out"]),
    )


def emitted_model_from_arrays(
    layers: Sequence[Mapping],
    *,
    in_shift: int,
    in_dtype: str,
    out_shift: int,
    device: DeviceLike = None,
) -> EmittedModel:
    """Build a port model from numpy arrays, one mapping per layer with the
    keys of ``LAYER_KEYS`` (``bias`` may be None). The model has no graph,
    so its introspection properties are unavailable."""
    if not layers:
        raise ValueError("a model needs at least one layer")
    if in_dtype not in INT_RANGE:
        raise ValueError(f"unknown input dtype {in_dtype!r}")
    dev = resolve_device(device)
    return EmittedModel.from_layers(
        [_layer(spec, dev) for spec in layers], dev,
        in_shift=int(in_shift), in_dtype=in_dtype, out_shift=int(out_shift),
    )
