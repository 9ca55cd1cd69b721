"""Carry a reference model's arrays into the port.

``emitted_model_from_arrays`` turns per-layer numpy arrays (the state of a
reference ``EmittedModel``: padded quantized weights, int32 biases, SRS
shifts, ...) into a port :class:`EmittedModel` on a given device, without
running the passes. ``decoder_lm_from_arrays`` turns the reference's
decoder-LM parameter tree (dense or MoE), as numpy arrays, into a port
``DecoderLM``. The port's execution can then be held against the
reference's on identical weights; ``rwkv_from_arrays``,
``hybrid_from_arrays``, ``encdec_from_arrays`` and ``vlm_from_arrays`` do
the same for the RWKV, hybrid, encoder-decoder and vision-LM trees, and
``model_from_arrays`` picks by the config's family.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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


def _install_stacked(model: nn.Module, params: Mapping[str, Any],
                     stacks: Mapping[str, Tuple[Sequence[int], str]],
                     device: DeviceLike) -> nn.Module:
    """Install a tree into ``model`` (built on the meta device). Every leaf
    under a top-level key of ``stacks`` is stacked over that key's dims
    (``(dims, what)``, ``what`` naming them in errors): index ``idx`` of
    the stack goes to ``key.<idx>...``; other leaves go as they are."""
    got: Dict[str, Any] = {}
    for path, arr in _flatten(params).items():
        top = path.split(".", 1)[0]
        if top in stacks:
            got.update(_unstack(path, arr, *stacks[top]))
        else:
            got[path] = np.asarray(arr)
    return _install(model, got, resolve_device(device))


def _layer_stacked(model: nn.Module, cfg, params: Mapping[str, Any],
                   device: DeviceLike) -> nn.Module:
    """Install a tree whose ``blocks`` leaves are stacked ``[L, ...]`` into
    ``model`` (built on the meta device): block ``l`` takes slice ``l``."""
    return _install_stacked(
        model, params, {"blocks": ((cfg.n_layers,), "n_layers")}, device)


def decoder_lm_from_arrays(cfg, params: Mapping[str, Any],
                           device: DeviceLike = None):
    """A port ``DecoderLM`` (dense or MoE) holding the reference's
    parameters.

    ``params`` is the reference's tree as numpy arrays:
    ``{"embed": {"table"}, "blocks": {...}, "ln_f": {"scale"},
    "head": {"w"}}`` with every ``blocks`` leaf stacked ``[L, ...]`` (an
    MoE block's expert weights ``[L, E, ...]``). Block ``l`` takes slice
    ``l`` of every stacked leaf; every parameter keeps its leaf's dtype.
    Raises on a missing, extra or misshapen leaf.
    """
    from repro_torch.models.lm import DecoderLM

    return _layer_stacked(DecoderLM(cfg, device="meta"), cfg, params, device)


def rwkv_from_arrays(cfg, params: Mapping[str, Any],
                     device: DeviceLike = None):
    """A port ``RWKVModel`` holding the reference's parameters: ``{"embed":
    {"table"}, "ln0", "blocks": {"ln1", "ln2", "mix"}, "ln_f", "head":
    {"w"}}`` with every ``blocks`` leaf stacked ``[L, ...]``, as
    :func:`decoder_lm_from_arrays` takes them."""
    from repro_torch.models.rwkv_model import RWKVModel

    return _layer_stacked(RWKVModel(cfg, device="meta"), cfg, params, device)


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

    model = HybridModel(cfg, device="meta")
    return _install_stacked(
        model, params, {"mamba_blocks": ((model.n_groups, cfg.attn_every),
                                         "(groups, attn_every)")}, device)


def encdec_from_arrays(cfg, params: Mapping[str, Any],
                       device: DeviceLike = None):
    """A port ``EncDecLM`` holding the reference's parameters: ``{"embed":
    {"table"}, "enc_blocks": {...}, "dec_blocks": {...}, "ln_enc",
    "ln_f", "head": {"w"}}`` with every ``enc_blocks`` leaf stacked
    ``[n_enc, ...]`` and every ``dec_blocks`` leaf ``[L, ...]``. Raises on
    a missing, extra or misshapen leaf."""
    from repro_torch.models.encdec import EncDecLM

    model = EncDecLM(cfg, device="meta")
    return _install_stacked(
        model, params, {"enc_blocks": ((model.n_enc,), "n_enc_layers"),
                        "dec_blocks": ((cfg.n_layers,), "n_layers")}, device)


def vlm_from_arrays(cfg, params: Mapping[str, Any],
                    device: DeviceLike = None):
    """A port ``VisionLM`` holding the reference's parameters: ``{"embed":
    {"table"}, "self_blocks": {...}, "cross_blocks": {...}, "ln_f",
    "head": {"w"}}`` with every ``self_blocks`` leaf stacked twice,
    ``[n_super, self_per_block, ...]``, and every ``cross_blocks`` leaf
    (the ``gate`` [n_super, 1] among them) once, ``[n_super, ...]``.
    Raises on a missing, extra or misshapen leaf."""
    from repro_torch.models.vision_lm import VisionLM

    model = VisionLM(cfg, device="meta")
    n = model.n_super
    return _install_stacked(
        model, params,
        {"self_blocks": ((n, model.self_per_block),
                         "(n_super, self_per_block)"),
         "cross_blocks": ((n,), "n_super")}, device)


def model_from_arrays(cfg, params: Mapping[str, Any],
                      device: DeviceLike = None):
    """The port's model of ``cfg.family`` holding the reference's
    parameter tree (numpy arrays); an unknown family raises
    ``NotImplementedError`` (from ``DecoderLM``)."""
    by_family = {"hybrid": hybrid_from_arrays, "ssm": rwkv_from_arrays,
                 "encdec": encdec_from_arrays, "vlm": vlm_from_arrays}
    return by_family.get(cfg.family, decoder_lm_from_arrays)(cfg, params,
                                                             device)
