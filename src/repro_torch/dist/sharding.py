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

Activations are constrained as in the reference: :func:`sharding_ctx`
installs a ``(mesh, rules)`` pair for the calling thread, and
:func:`shard_act` then returns its tensor as a DTensor laid out by the
logical axes it names (a plain tensor is taken as replicated on every
rank first). Outside a context ``shard_act`` returns its argument itself,
so the one-device path never sees a DTensor. :func:`serving_grad_mode`
picks the serve path's autograd mode: ``torch.inference_mode()`` outside
a context, ``torch.no_grad()`` inside (DTensor's views cannot be made
under inference mode). :func:`implicit_replication` lets the plain
tensors the layers make (``arange``, masks, RoPE tables) meet DTensors as
replicated ones, re-entrantly.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import threading
from contextlib import contextmanager
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


# ---------------------------------------------------------------------------
# Context: install (mesh, rules) for activation constraints
# ---------------------------------------------------------------------------

_CTX = threading.local()


@contextmanager
def sharding_ctx(mesh, rules: ShardingRules):
    """Install ``(mesh, rules)`` so that :func:`shard_act` lays activations
    out on ``mesh``; outside it every ``shard_act`` is the identity.
    Re-entrant and thread-local, as the reference's."""
    prev = getattr(_CTX, "active", None)
    _CTX.active = (mesh, rules)
    try:
        yield (mesh, rules)
    finally:
        _CTX.active = prev


def current_ctx() -> Optional[Tuple[Any, ShardingRules]]:
    """The innermost active ``(mesh, rules)`` of this thread, or None."""
    return getattr(_CTX, "active", None)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor's sake)."""
    if type(x) is torch.Tensor or not torch.is_tensor(x):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicated(x: torch.Tensor, mesh):
    """``x`` as a DTensor on ``mesh``: a DTensor as it is, a plain tensor
    as the same value replicated on every rank."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard_act(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Lay an activation out by logical axis names.

    Under an active :func:`sharding_ctx` the names resolve through the
    rule table (``logical_to_pspec``, then ``fit_pspec`` for ``x``'s
    shape) to DTensor placements, and ``x`` comes back as a DTensor with
    them: a DTensor is redistributed, a plain tensor is first taken as
    replicated. Trailing unnamed dims replicate, and so does a dim whose
    mesh axis has one device (:func:`whole_on_one_device`). With no
    context it returns ``x`` itself."""
    ctx = current_ctx()
    if ctx is None:
        return x
    mesh, rules = ctx
    pspec = fit_pspec(x.shape, logical_to_pspec(logical_axes, mesh, rules),
                      mesh)
    return replicated(x, mesh).redistribute(
        mesh, whole_on_one_device(pspec_to_placements(pspec, mesh), mesh))


def whole_on_one_device(placements: List[Any], mesh) -> List[Any]:
    """``placements`` with every shard over a mesh dim of size 1 written as
    ``Replicate()``: the same layout (one shard is the whole tensor), but
    DTensor's view rules refuse to flatten or drop a dim sharded even over
    one device (a decode step's [B, 1, d] activation, its sequence dim on
    the model axis of a 1x1 mesh)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if mesh.size(i) == 1 else p
            for i, p in enumerate(placements)]


def on_replicated(fn, *args):
    """``fn(*args)`` on whole values: with no DTensor among ``args`` a plain
    call; else each tensor is gathered to ``Replicate`` on the DTensors'
    mesh (a plain one taken as replicated), ``fn`` runs on the local
    tensors, and every tensor it returns comes back as a replicated
    DTensor. For ops DTensor has no sharding rule for (the MoE's sort,
    ``searchsorted`` and scatter-add); autograd records through it."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    rep = [Replicate()] * mesh.ndim
    local = [replicated(a, mesh).redistribute(mesh, rep).to_local()
             if torch.is_tensor(a) else a for a in args]
    out = fn(*local)

    def wrap(o):
        return DTensor.from_local(o, mesh, rep, run_check=False)

    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``. A DTensor sharded on a dim that the reshape
    splits or merges is first replicated on that mesh dim: DTensor cannot
    split a sharded dim that its mesh dim does not divide evenly, nor
    merge it with its neighbours (XLA pads instead). Dims the reshape
    keeps, a common prefix and suffix, keep their sharding."""
    if not is_dtensor(x):
        return x.reshape(*shape)
    from torch.distributed.tensor import Replicate

    old = tuple(x.shape)
    new = tuple(torch.empty(old, device="meta").reshape(*shape).shape)
    lo = 0
    while lo < min(len(old), len(new)) and old[lo] == new[lo]:
        lo += 1
    hi = 0
    while (hi < min(len(old), len(new)) - lo
           and old[len(old) - 1 - hi] == new[len(new) - 1 - hi]):
        hi += 1
    placements = [Replicate() if p.is_shard() and lo <= p.dim < len(old) - hi
                  else p for p in x.placements]
    if placements != list(x.placements):
        x = x.redistribute(x.device_mesh, placements)
    return x.reshape(*new)


def whole(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with the tensor dims ``dims`` replicated: a DTensor sharded on
    one of them is gathered on that mesh dim; a plain tensor is returned
    as it is. A product whose contraction dim is whole on every rank sums
    in the unsharded product's order."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    want = {d % x.ndim for d in dims}
    placements = [Replicate() if p.is_shard() and p.dim in want else p
                  for p in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def local_product(fn, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fn(a, b)`` for a product ``[M, K] x [K, N]`` (or batched ``[E, M,
    K] x [E, K, N]``) of DTensors, run by ``fn`` on each rank's local
    operands: for ops DTensor has no sharding rule for (``torch.mm`` with
    ``out_dtype``, the card's fp32-output GEMM). Per mesh dim the output
    keeps ``a``'s rows or ``b``'s columns sharded (or, batched, the shared
    batch dim), and every other operand dim, the contraction among them,
    is gathered, so each rank sums whole products."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = next(t.device_mesh for t in (a, b) if is_dtensor(t))
    a, b = replicated(a, mesh), replicated(b, mesh)
    rows, cols = a.ndim - 2, b.ndim - 1
    pa, pb, out = [], [], []
    for i in range(mesh.ndim):
        sa, sb = a.placements[i], b.placements[i]
        if sa.is_shard(rows):
            pick = (Shard(rows), Replicate(), Shard(rows))
        elif sb.is_shard(cols):
            pick = (Replicate(), Shard(cols), Shard(cols))
        elif a.ndim == 3 and (sa.is_shard(0) or sb.is_shard(0)):
            pick = (Shard(0), Shard(0), Shard(0))
        else:
            pick = (Replicate(), Replicate(), Replicate())
        pa.append(pick[0])
        pb.append(pick[1])
        out.append(pick[2])
    y = fn(a.redistribute(mesh, pa).to_local(),
           b.redistribute(mesh, pb).to_local())
    return DTensor.from_local(y, mesh, out, run_check=False)


def local_value(x: torch.Tensor) -> torch.Tensor:
    """The whole value of ``x`` as a plain tensor on this rank (a DTensor
    is gathered; a plain tensor is returned as it is): what the host reads
    back, tokens and logits."""
    return x.full_tensor() if is_dtensor(x) else x


def leaf_placements(member: Sequence[Any], nstack: int) -> List[Any]:
    """A stacked leaf's placements from one member's: each ``Shard(d)``
    moves past the ``nstack`` stacked dims, which replicate (a one-stage
    plan never shards its ``layers`` dims)."""
    from torch.distributed.tensor import Shard

    return [Shard(p.dim + nstack) if p.is_shard() else p for p in member]


def place(x: torch.Tensor, mesh, placements: Sequence[Any]):
    """``x``, the whole value and the same on every rank, as a DTensor at
    ``placements``: each rank keeps its own shard of its own copy, so no
    data moves between ranks (``distribute_tensor`` with no source
    rank)."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mesh, list(placements), src_data_rank=None)


def at_placements(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` redistributed to ``like``'s placements when both are DTensors
    and they differ (a ``Partial`` gradient is reduced onto its
    parameter's layout); otherwise ``x`` itself."""
    if not is_dtensor(x) or not is_dtensor(like) \
            or tuple(x.placements) == tuple(like.placements):
        return x
    return x.redistribute(like.device_mesh, like.placements)


def mesh_all_reduce(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum the plain tensor ``t`` in place over every rank of ``mesh``,
    one mesh dim after another (a dim of one device is skipped). Returns
    ``t``."""
    import torch.distributed as dist

    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(t, group=mesh.get_group(i))
    return t


def serving_grad_mode():
    """The autograd mode of the serve path: ``torch.inference_mode()``
    outside a sharding context (the one-device path), ``torch.no_grad()``
    inside one, where DTensor views cannot be made under inference mode
    ("Cannot set version_counter for inference tensor")."""
    if current_ctx() is None:
        return torch.inference_mode()
    return torch.no_grad()


def serving(fn):
    """Decorate a serve-path function to run under
    :func:`serving_grad_mode`, decided at each call."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with serving_grad_mode():
            return fn(*args, **kwargs)

    return wrapper


_IMPLICIT = threading.Lock()
_implicit_depth = 0
_implicit_cm = None


@contextmanager
def implicit_replication():
    """DTensor's ``implicit_replication`` (plain tensors that meet DTensors
    in an op are taken as replicated), re-entrant across threads: DTensor
    keeps the switch process-wide and its own context turns it off on any
    exit, so the first entry turns it on and the last exit off."""
    global _implicit_depth, _implicit_cm
    from torch.distributed.tensor.experimental import (
        implicit_replication as dtensor_implicit_replication,
    )

    with _IMPLICIT:
        if _implicit_depth == 0:
            _implicit_cm = dtensor_implicit_replication()
            _implicit_cm.__enter__()
        _implicit_depth += 1
    try:
        yield
    finally:
        with _IMPLICIT:
            _implicit_depth -= 1
            if _implicit_depth == 0:
                _implicit_cm.__exit__(None, None, None)
                _implicit_cm = None


@contextmanager
def sharded(mesh, rules: ShardingRules):
    """Run sharded on ``mesh``: :func:`sharding_ctx` for this thread and
    :func:`implicit_replication`, so the plain tensors the layers make
    meet DTensors as replicated ones. The replication switch is
    process-wide, so a backward must run inside too."""
    with sharding_ctx(mesh, rules), implicit_replication():
        yield
