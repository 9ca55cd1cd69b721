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

The reverse map serves training: :func:`leaf_groups` lists each leaf of
the reference's tree with the port parameters that hold it (the optimizer
runs over these groups, as the reference's optimizer runs over its
stacked leaves), :func:`params_to_arrays` gives the reference's stacked
tree back as numpy arrays, and :func:`load_arrays` copies such a tree into
a model in place.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

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


def _from_arrays(model: nn.Module, params: Mapping[str, Any],
                 device: DeviceLike) -> nn.Module:
    """Install a tree into ``model`` (built on the meta device). Every leaf
    under a top-level key of :func:`param_stacks` is stacked over that
    key's dims: index ``idx`` of the stack goes to ``key.<idx>...``; other
    leaves go as they are."""
    stacks = param_stacks(model)
    got: Dict[str, Any] = {}
    for path, arr in _flatten(params).items():
        top = path.split(".", 1)[0]
        if top in stacks:
            got.update(_unstack(path, arr, *stacks[top]))
        else:
            got[path] = np.asarray(arr)
    return _install(model, got, resolve_device(device))


def param_stacks(model: nn.Module) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """The reference's stacked top-level keys of ``model``'s family: for
    each, the stacked dims and their name (for errors). Index ``idx`` of a
    stacked leaf ``key.rest`` is the port parameter ``key.<idx>.rest``."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        return {"mamba_blocks": ((model.n_groups, cfg.attn_every),
                                 "(groups, attn_every)")}
    if cfg.family == "encdec":
        return {"enc_blocks": ((model.n_enc,), "n_enc_layers"),
                "dec_blocks": ((cfg.n_layers,), "n_layers")}
    if cfg.family == "vlm":
        return {"self_blocks": ((model.n_super, model.self_per_block),
                                "(n_super, self_per_block)"),
                "cross_blocks": ((model.n_super,), "n_super")}
    return {"blocks": ((cfg.n_layers,), "n_layers")}


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

    return _from_arrays(DecoderLM(cfg, device="meta"), params, device)


def rwkv_from_arrays(cfg, params: Mapping[str, Any],
                     device: DeviceLike = None):
    """A port ``RWKVModel`` holding the reference's parameters: ``{"embed":
    {"table"}, "ln0", "blocks": {"ln1", "ln2", "mix"}, "ln_f", "head":
    {"w"}}`` with every ``blocks`` leaf stacked ``[L, ...]``, as
    :func:`decoder_lm_from_arrays` takes them."""
    from repro_torch.models.rwkv_model import RWKVModel

    return _from_arrays(RWKVModel(cfg, device="meta"), params, device)


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

    return _from_arrays(HybridModel(cfg, device="meta"), params, device)


def encdec_from_arrays(cfg, params: Mapping[str, Any],
                       device: DeviceLike = None):
    """A port ``EncDecLM`` holding the reference's parameters: ``{"embed":
    {"table"}, "enc_blocks": {...}, "dec_blocks": {...}, "ln_enc",
    "ln_f", "head": {"w"}}`` with every ``enc_blocks`` leaf stacked
    ``[n_enc, ...]`` and every ``dec_blocks`` leaf ``[L, ...]``. Raises on
    a missing, extra or misshapen leaf."""
    from repro_torch.models.encdec import EncDecLM

    return _from_arrays(EncDecLM(cfg, device="meta"), params, device)


def vlm_from_arrays(cfg, params: Mapping[str, Any],
                    device: DeviceLike = None):
    """A port ``VisionLM`` holding the reference's parameters: ``{"embed":
    {"table"}, "self_blocks": {...}, "cross_blocks": {...}, "ln_f",
    "head": {"w"}}`` with every ``self_blocks`` leaf stacked twice,
    ``[n_super, self_per_block, ...]``, and every ``cross_blocks`` leaf
    (the ``gate`` [n_super, 1] among them) once, ``[n_super, ...]``.
    Raises on a missing, extra or misshapen leaf."""
    from repro_torch.models.vision_lm import VisionLM

    return _from_arrays(VisionLM(cfg, device="meta"), params, device)


def model_from_arrays(cfg, params: Mapping[str, Any],
                      device: DeviceLike = None):
    """The port's model of ``cfg.family`` holding the reference's
    parameter tree (numpy arrays); an unknown family raises
    ``NotImplementedError`` (from ``DecoderLM``)."""
    by_family = {"hybrid": hybrid_from_arrays, "ssm": rwkv_from_arrays,
                 "encdec": encdec_from_arrays, "vlm": vlm_from_arrays}
    return by_family.get(cfg.family, decoder_lm_from_arrays)(cfg, params,
                                                             device)


# ---------------------------------------------------------------------------
# The reverse map: port parameters -> the reference's stacked leaves
# ---------------------------------------------------------------------------


class LeafGroup(NamedTuple):
    """One leaf of the reference's parameter tree and the port parameters
    that hold it: ``name`` is the leaf's path ("." joined, as
    :func:`model_from_arrays` reads it), ``members`` the port parameter
    names in stack order (``np.ndindex(*stack)``), ``stack`` the stacked
    dims (``()`` for a leaf that is not stacked, with one member)."""

    name: str
    members: Tuple[str, ...]
    stack: Tuple[int, ...]


def leaf_groups(model: nn.Module) -> List[LeafGroup]:
    """Every leaf of the reference's tree for ``model``, in the order the
    model first names its parameters (the inverse of the split that
    :func:`model_from_arrays` makes)."""
    stacks = param_stacks(model)
    found: Dict[str, Dict[Tuple[int, ...], str]] = {}
    for name, _ in model.named_parameters():
        top, rest = name.split(".", 1)
        if top in stacks:
            n = len(stacks[top][0])
            parts = rest.split(".")
            idx = tuple(int(i) for i in parts[:n])
            leaf = ".".join([top, *parts[n:]])
        else:
            idx, leaf = (), name
        found.setdefault(leaf, {})[idx] = name
    groups = []
    for leaf, by_idx in found.items():
        top = leaf.split(".", 1)[0]
        dims = tuple(stacks[top][0]) if top in stacks else ()
        groups.append(LeafGroup(leaf, tuple(by_idx[idx]
                                            for idx in np.ndindex(*dims)),
                                dims))
    return groups


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}`` (the inverse of
    :func:`_flatten`)."""
    out: Dict[str, Any] = {}
    for path, val in flat.items():
        *heads, leaf = path.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = val
    return out


def params_to_arrays(model: nn.Module) -> Dict[str, Any]:
    """The reference's parameter tree of ``model`` as numpy arrays, each
    block leaf stacked as the reference stacks it: the inverse of
    :func:`model_from_arrays` up to dtype. numpy has no bfloat16 of its
    own, so a bf16 leaf comes out as fp32 (exactly; as the checkpoint
    stores it)."""
    from repro_torch.dist.sharding import local_value

    params = dict(model.named_parameters())
    flat = {}
    for grp in leaf_groups(model):
        first = params[grp.members[0]]
        dtype = (np.float32 if first.dtype == torch.bfloat16
                 else torch.empty((), dtype=first.dtype).numpy().dtype)
        arr = np.empty(grp.stack + tuple(first.shape), dtype)
        rows = arr.reshape(-1, *first.shape)
        for i, name in enumerate(grp.members):
            # a DTensor is gathered whole: a collective every rank joins
            t = local_value(params[name].detach())
            rows[i] = (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
        flat[grp.name] = arr
    return _nest(flat)


def params_template(model: nn.Module) -> Dict[str, Any]:
    """The shapes and dtypes of :func:`params_to_arrays`'s tree as tensors
    on the meta device (a restore template; nothing is allocated)."""
    params = dict(model.named_parameters())
    flat = {}
    for grp in leaf_groups(model):
        first = params[grp.members[0]]
        flat[grp.name] = torch.empty(grp.stack + tuple(first.shape),
                                     dtype=first.dtype, device="meta")
    return _nest(flat)


@torch.no_grad()
def load_arrays(model: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy the reference-layout tree ``tree`` (numpy arrays or tensors,
    stacked as :func:`params_to_arrays` gives them) into ``model``'s
    parameters in place, each cast to its parameter's dtype. A DTensor
    parameter takes its own shard of the whole value (each rank holds the
    tree; no data moves). Raises on a missing, extra or misshapen leaf."""
    from repro_torch.dist.sharding import is_dtensor, place

    params = dict(model.named_parameters())
    groups = leaf_groups(model)
    flat = _flatten(tree)
    want = {grp.name for grp in groups}
    if set(flat) != want:
        raise KeyError(f"parameter tree mismatch: missing "
                       f"{sorted(want - set(flat))}, unexpected "
                       f"{sorted(set(flat) - want)}")
    for grp in groups:
        first = params[grp.members[0]]
        arr = flat[grp.name]
        shape = grp.stack + tuple(first.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{grp.name}: shape {tuple(arr.shape)} != "
                             f"{shape}")
        src = arr if torch.is_tensor(arr) else _to_tensor(
            arr, torch.device("cpu"))
        rows = src.reshape(-1, *first.shape)
        for i, name in enumerate(grp.members):
            p = params[name]
            if is_dtensor(p):
                p.to_local().copy_(place(
                    rows[i].to(device=p.device, dtype=p.dtype),
                    p.device_mesh, p.placements).to_local())
            else:
                p.copy_(rows[i])
    if hasattr(model, "reset_quantized"):
        model.reset_quantized()
    return model
