"""Logical-axis sharding: which mesh axes each tensor dim lives on.

A jax-free copy of ``repro.dist.sharding``'s resolution half. Layers name
each parameter dim with a LOGICAL axis ("fsdp", "col_out", "experts",
...); a per-mode rule table maps those names to physical mesh axes
("pod", "data", "model"):

* ``cascade``     -- paper-faithful: every weight's contraction dim on the
                     model axis, the other dim FSDP over (pod, data);
* ``megatron``    -- tensor parallelism: "col" weights split their output
                     dim on model, "row" weights their input dim;
* ``megatron_sp`` -- megatron plus sequence parallelism ("seq" on model).

Resolution is two-stage and total: ``logical_to_pspec`` maps names to mesh
axes, dropping axes the mesh does not have; ``fit_pspec`` then drops any
axis whose size does not divide its dim and any mesh axis an earlier dim
already uses. A tensor that cannot be sharded is replicated.

The resolved :class:`PartitionSpec` prints exactly as JAX's does, so a
plan's recorded specs compare string for string with the reference's.
:func:`pspec_to_placements` turns one into DTensor placements over a
``torch.distributed.device_mesh.DeviceMesh``: ``Shard(d)`` on each mesh
dim that shards tensor dim ``d``, ``Replicate()`` on the others. A
composite entry such as ``("pod", "data")`` shards one dim over two mesh
dims, the first named outermost, as JAX lays it out.

The reference's ``sharding_ctx``/``shard_act`` (activation constraints)
act only when ops run over several ranks; they are not ported yet
(ROADMAP Queue 1 item 2, part 2).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

# A rule-table entry: replicate (None), one mesh axis ("model"), or a
# composite of mesh axes (("pod", "data")) applied to a single tensor dim.
MeshAxes = Union[None, str, Tuple[str, ...]]


def _canonical(entry) -> MeshAxes:
    """A PartitionSpec entry as JAX canonicalizes it: an empty tuple is
    None, a one-axis tuple is the axis name."""
    if entry is None or isinstance(entry, str):
        return entry
    entry = tuple(entry)
    if not all(isinstance(ax, str) for ax in entry):
        raise TypeError(f"PartitionSpec entry {entry!r}: axes must be str")
    if not entry:
        return None
    return entry[0] if len(entry) == 1 else entry


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), a mesh axis, or a tuple of mesh
    axes. ``str()`` prints as ``jax.sharding.PartitionSpec`` does, e.g.
    ``PartitionSpec(('pod', 'data'), None, 'model')``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec({tuple.__repr__(self)[1:-1]})"

    __str__ = __repr__

    @classmethod
    def from_str(cls, text: str) -> "PartitionSpec":
        """The inverse of ``str()`` (plans record their specs as text)."""
        head = "PartitionSpec("
        if not (text.startswith(head) and text.endswith(")")):
            raise ValueError(f"not a PartitionSpec: {text!r}")
        return cls(*ast.literal_eval(f"[{text[len(head):-1]}]"))



# ---------------------------------------------------------------------------
# ParamSpec: shape + logical axes + init recipe for one parameter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative spec for one parameter tensor.

    ``logical`` names each dim with a logical axis (or None = replicated);
    ``init`` names the initializer ("normal" | "zeros" | "ones" | "embed" |
    "small"); ``scale`` overrides its stddev.
    """

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"
    scale: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(self.shape))
        object.__setattr__(self, "logical", tuple(self.logical))
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"ParamSpec rank mismatch: shape {self.shape} vs "
                f"logical axes {self.logical}"
            )


# ---------------------------------------------------------------------------
# Rule tables: logical axis name -> mesh axes, per sharding mode
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Immutable logical-axis -> mesh-axes table for one sharding mode."""

    mode: str
    table: Tuple[Tuple[str, MeshAxes], ...]

    def __post_init__(self):
        object.__setattr__(self, "_map", dict(self.table))

    def get(self, name: str, default: MeshAxes = None) -> MeshAxes:
        return self._map.get(name, default)

    def __getitem__(self, name: str) -> MeshAxes:
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def items(self):
        return self.table

    def replace(self, **updates: MeshAxes) -> "ShardingRules":
        merged = dict(self.table)
        merged.update(updates)
        return ShardingRules(self.mode, tuple(merged.items()))


# Axes shared by every mode. "batch"/"fsdp" use the composite
# ("pod", "data") so the same table serves the 16x16 single-pod and the
# 2x16x16 multi-pod mesh: logical_to_pspec drops "pod" when absent.
_COMMON: Mapping[str, MeshAxes] = {
    # data-parallel / FSDP dims
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    # scan-over-layers dim: never sharded
    "layers": None,
    "seq": None,
    # embedding / LM head
    "vocab": "model",
    "embed": None,
    # tensor-parallel weight dims (megatron roles)
    "col_out": "model",
    "row_in": "model",
    # MoE: experts on model (EP), capacity slots on data
    "experts": "model",
    "expert_cap": "data",
    # SSM / RWKV inner dims
    "mlp": "model",
    "q_heads": "model",
    "conv_k": None,
    # KV-cache dims
    "cache_heads": "model",
    "cache_hd": None,
    # activation dims
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
}

_MODE_OVERRIDES: Mapping[str, Mapping[str, MeshAxes]] = {
    # contraction dim on model (the cascade psum), output dim FSDP over
    # (pod, data); activations keep their feature dim on model
    "cascade": {
        "cascade_in": "model",
        "cascade_out": ("pod", "data"),
        "act_embed": "model",
    },
    # megatron TP: the roles of _COMMON
    "megatron": {},
    # megatron + sequence parallelism: activations shard "seq" on model
    "megatron_sp": {"seq": "model"},
}

MODES = tuple(_MODE_OVERRIDES)


def rules_for_mode(mode: str) -> ShardingRules:
    """The logical->mesh rule table for "cascade" | "megatron" | "megatron_sp"."""
    if mode not in _MODE_OVERRIDES:
        raise ValueError(f"unknown sharding mode {mode!r}; expected {MODES}")
    table = dict(_COMMON)
    table.update(_MODE_OVERRIDES[mode])
    return ShardingRules(mode, tuple(table.items()))


# ---------------------------------------------------------------------------
# Resolution: logical names -> PartitionSpec -> mesh-fitted PartitionSpec
# ---------------------------------------------------------------------------


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh-dim order of a ``DeviceMesh`` (its
    ``mesh_dim_names`` and ``shape``), of any object with ``axis_names``
    and a ``devices`` array (so duck-typed meshes work in tests), or of
    such a mapping itself."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if hasattr(mesh, "mesh_dim_names"):
        if mesh.mesh_dim_names is None:
            raise ValueError(f"{mesh} has no mesh_dim_names")
        return {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}
    return {n: int(s) for n, s in zip(mesh.axis_names, mesh.devices.shape)}


def logical_to_pspec(axes: Sequence[Optional[str]], mesh,
                     rules: ShardingRules) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec of mesh axes.

    Names missing from the rule table resolve to None (replicated), and
    mesh axes the mesh does not have (e.g. "pod" on a 2D mesh) are
    dropped. The result may still name an axis more than once or not
    divide the tensor: ``fit_pspec`` repairs both.
    """
    present = set(mesh_axis_sizes(mesh))
    out = []
    for name in axes:
        entry = rules.get(name) if name is not None else None
        if entry is None:
            out.append(None)
        elif isinstance(entry, str):
            out.append(entry if entry in present else None)
        else:
            kept = tuple(ax for ax in entry if ax in present)
            out.append(kept if kept else None)
    return PartitionSpec(*out)


def fit_pspec(shape: Sequence[int], pspec: Sequence[MeshAxes],
              mesh) -> PartitionSpec:
    """Repair ``pspec`` so it is legal for ``shape`` on ``mesh``.

    Per dim: an axis whose size does not divide the dim is dropped; a
    composite entry keeps its longest divisible prefix; a mesh axis
    already used by an earlier dim is dropped (first dim wins). The result
    always partitions validly, at worst fully replicated.
    """
    sizes = mesh_axis_sizes(mesh)
    entries = tuple(pspec)
    used = set()
    out = []
    for i, dim in enumerate(shape):
        entry = entries[i] if i < len(entries) else None
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        kept = []
        prod = 1
        for ax in axes:
            if ax in used or ax not in sizes or dim % (prod * sizes[ax]):
                break
            prod *= sizes[ax]
            kept.append(ax)
        if not kept:
            out.append(None)
        else:
            out.append(kept[0] if isinstance(entry, str) else tuple(kept))
            used.update(kept)
    return PartitionSpec(*out)


def spec_to_pspec(spec: ParamSpec, mesh, rules: ShardingRules) -> PartitionSpec:
    """Fully resolved PartitionSpec for one ParamSpec."""
    return fit_pspec(spec.shape, logical_to_pspec(spec.logical, mesh, rules),
                     mesh)


# ---------------------------------------------------------------------------
# Placement: PartitionSpec -> DTensor placements on a DeviceMesh
# ---------------------------------------------------------------------------


def pspec_to_placements(pspec: Sequence[MeshAxes], mesh) -> List[Any]:
    """One DTensor placement per mesh dim: ``Shard(d)`` where the mesh axis
    shards tensor dim ``d``, else ``Replicate()``. A composite entry shards
    its dim over several mesh dims, which DTensor splits in mesh-dim
    order, so its axes must come in that order (as ``("pod", "data")``
    does on every mesh of ``launch.mesh``); raises ``ValueError`` when
    they do not, or name an axis the mesh lacks or twice."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axis_sizes(mesh))
    placements: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(PartitionSpec(*pspec)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        missing = [ax for ax in axes if ax not in names]
        if missing:
            raise ValueError(f"{pspec}: mesh axes {names} lack {missing}")
        dims = [names.index(ax) for ax in axes]
        if dims != sorted(dims):
            raise ValueError(f"{pspec}: entry {entry} is not in mesh-dim "
                             f"order {names}")
        for i in dims:
            if placements[i] != Replicate():
                raise ValueError(f"{pspec}: mesh axis {names[i]} used twice")
            placements[i] = Shard(d)
    return placements


def specs_to_placements(specs: Mapping[str, ParamSpec], mesh,
                        rules: ShardingRules) -> Dict[str, List[Any]]:
    """``{path: ParamSpec}`` -> ``{path: placements}`` (the counterpart of
    the reference's ``specs_to_shardings``)."""
    return {k: pspec_to_placements(spec_to_pspec(s, mesh, rules), mesh)
            for k, s in specs.items()}
