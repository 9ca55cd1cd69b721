"""Carry a reference model's arrays into the port.

``emitted_model_from_arrays`` turns per-layer numpy arrays (the state of a
reference ``EmittedModel``: padded quantized weights, int32 biases, SRS
shifts, ...) into a port :class:`EmittedModel` on a given device, without
running the passes. ``decoder_lm_from_arrays`` turns the reference's
decoder-LM parameter tree, as numpy arrays, into a port ``DecoderLM``. The
port's execution can then be held against the reference's on identical
weights; ``hybrid_from_arrays`` does the same for the hybrid's tree, and
``model_from_arrays`` picks by the config's family.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

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


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _to_tensor(arr, device: torch.device) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; bfloat16 arrays (numpy
    has no such type of its own) are carried bit for bit."""
    arr = np.array(arr, order="C")      # a private, writable copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _install(model: nn.Module, got: Mapping[str, Any],
             device: torch.device) -> nn.Module:
    """Give ``model`` (built on the meta device) the arrays of ``got``, one
    per parameter name; raises on a missing, extra or misshapen leaf."""
    want = dict(model.named_parameters())
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise KeyError(f"parameter tree mismatch: missing {missing}, "
                       f"unexpected {extra}")
    for name, arr in got.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != "
                             f"{tuple(want[name].shape)}")
        parent, leaf = name.rsplit(".", 1)
        setattr(model.get_submodule(parent), leaf, nn.Parameter(
            _to_tensor(arr, device), requires_grad=False))
    return model


def _unstack(path: str, arr, dims: Sequence[int],
             what: str) -> Dict[str, Any]:
    """Split a leaf stacked over ``dims`` (``what`` names them: ``[L]`` or
    ``[G, E]``) into one array per index, named ``path`` with the indices
    spliced in after its first component."""
    arr = np.asarray(arr)
    if tuple(arr.shape[:len(dims)]) != tuple(dims):
        raise ValueError(f"{path}: stacked dims {arr.shape[:len(dims)]} != "
                         f"{what} {tuple(dims)}")
    head, rest = path.split(".", 1)
    return {".".join([head, *map(str, idx), rest]): arr[idx]
            for idx in np.ndindex(*dims)}


def decoder_lm_from_arrays(cfg, params: Mapping[str, Any],
                           device: DeviceLike = None):
    """A port ``DecoderLM`` holding the reference's parameters.

    ``params`` is the reference's tree as numpy arrays:
    ``{"embed": {"table"}, "blocks": {...}, "ln_f": {"scale"},
    "head": {"w"}}`` with every ``blocks`` leaf stacked ``[L, ...]``.
    Block ``l`` takes slice ``l`` of every stacked leaf; every parameter
    keeps its leaf's dtype. Raises on a missing, extra or misshapen leaf.
    """
    from repro_torch.models.lm import DecoderLM

    dev = resolve_device(device)
    got: Dict[str, Any] = {}
    for path, arr in _flatten(params).items():
        if path.startswith("blocks."):
            got.update(_unstack(path, arr, (cfg.n_layers,), "n_layers"))
        else:
            got[path] = np.asarray(arr)
    return _install(DecoderLM(cfg, device="meta"), got, dev)


def hybrid_from_arrays(cfg, params: Mapping[str, Any],
                       device: DeviceLike = None):
    """A port ``HybridModel`` holding the reference's parameters.

    ``params`` is the reference's tree as numpy arrays: ``{"embed":
    {"table"}, "mamba_blocks": {"ln", "mamba"}, "shared_attn": {...},
    "ln_f": {"scale"}, "head": {"w"}}`` with every ``mamba_blocks`` leaf
    stacked ``[G, E, ...]`` (groups, layers per group) and the one shared
    block unstacked. Layer ``(g, e)`` takes slice ``[g, e]``; every
    parameter keeps its leaf's dtype. Raises on a missing, extra or
    misshapen leaf.
    """
    from repro_torch.models.hybrid import HybridModel

    dev = resolve_device(device)
    model = HybridModel(cfg, device="meta")
    dims = (model.n_groups, cfg.attn_every)
    got: Dict[str, Any] = {}
    for path, arr in _flatten(params).items():
        if path.startswith("mamba_blocks."):
            got.update(_unstack(path, arr, dims, "(groups, attn_every)"))
        else:
            got[path] = np.asarray(arr)
    return _install(model, got, dev)


def model_from_arrays(cfg, params: Mapping[str, Any],
                      device: DeviceLike = None):
    """The port's model of ``cfg.family`` holding the reference's
    parameter tree (numpy arrays); a family the port does not carry
    raises ``NotImplementedError`` (from ``DecoderLM``)."""
    if cfg.family == "hybrid":
        return hybrid_from_arrays(cfg, params, device)
    return decoder_lm_from_arrays(cfg, params, device)
