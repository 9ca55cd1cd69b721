"""The staged placement: each rank holds only its band of a layer stack.

After PlaceStages (``layers -> data``) the reference's stacked leaves
``[L, ...]`` shard their stacked dim over the ``data`` axis in row order:
data row ``r`` holds members ``[r * L / D, (r + 1) * L / D)``, and within
them the blocks the other mesh axes give each rank. GSPMD then gathers one
layer per scan iteration. The port keeps a stacked leaf as separate member
parameters (``bridge.leaf_groups``), so it places each member on its
**band**: the sub-mesh of the data row that owns it (the mesh without the
``data`` dim, at that row). A member is a DTensor on its band's
``DeviceMesh``; on a rank outside the band its local tensor is empty (0
bytes), as DTensor keeps it for a rank that is not in a mesh.

Running a block (:func:`materialized`) swaps each of its staged members
for :func:`gather_member`'s copy on the whole mesh, replicated over
``data``: one all-reduce per member, the owner band contributing its
shard and every other rank zeros (a ``Partial`` placement). Its backward
all-reduces the gradient over ``data`` and keeps it on the owner band, at
the member's placements. The copy is freed with the block. Indexing the
stack as one DTensor would all-gather all L layers on every access, so no
staged path indexes a ``Shard(0)``-over-``data`` DTensor.

A staged decode-state leaf ``[L, ...]`` (layer dim over ``data``) is read
one layer at a time by :func:`layer_of`: one collective per leaf, of one
layer, from the owner band's rows into the layout a one-stage plan gives
the layer (a per-slot leaf's batch over ``data``, as the activations'
batch). The block's writes go back into the owner band's own rows by
:func:`put_layer` (the layer gathered over ``data``, then a local copy on
the owner). The stored leaf is never gathered whole and never replaced.

The stacked optimizer state and checkpoints keep the reference's layout:
DTensors ``[L, ...]`` on the whole mesh whose local shard holds the rows
of the members this rank owns (:func:`owned`, :func:`stacked_placements`).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch


class Band(NamedTuple):
    """Where a band's members live: ``mesh`` the whole mesh, ``axis`` the
    stage mesh dim (``data``), ``row`` the owner row on it, ``sub`` the
    band's sub-mesh (``mesh`` without ``axis``, at ``row``)."""

    mesh: Any
    axis: int
    row: int
    sub: Any

    def owner(self) -> bool:
        """Whether this rank is in the band."""
        return self.sub._is_current_rank_part_of_mesh()

    def full_placements(self, member: Sequence[Any]) -> List[Any]:
        """A member's placements on the whole mesh, replicated over the
        stage axis (the layout :func:`gather_member` gives)."""
        from torch.distributed.tensor import Replicate

        out = list(member)
        out.insert(self.axis, Replicate())
        return out


_BANDS: Dict[Tuple[int, int, int], Band] = {}


def band(mesh, axis: int, row: int) -> Band:
    """The band of data row ``row`` on mesh dim ``axis`` of ``mesh``, made
    once per mesh. Its sub-mesh reuses the whole mesh's process groups on
    the band's ranks and starts none: no rank outside it ever runs a
    collective on it."""
    key = (id(mesh), axis, row)
    hit = _BANDS.get(key)
    if hit is not None and hit.mesh is mesh:
        return hit
    from torch.distributed.device_mesh import DeviceMesh

    ranks = mesh.mesh.select(axis, row)
    names = tuple(n for i, n in enumerate(mesh.mesh_dim_names) if i != axis)
    sub = DeviceMesh(mesh.device_type, ranks, mesh_dim_names=names,
                     _init_backend=False)
    coord = mesh.get_coordinate()
    if coord is not None and coord[axis] == row:
        groups = [mesh.get_group(i) for i in range(mesh.ndim) if i != axis]
        sub._dim_group_names = [g.group_name for g in groups]
        for g in groups:             # as DeviceMesh.from_group does
            sub._pg_registry[g.group_name] = g
    sub.stage_band = Band(mesh, axis, row, sub)
    _BANDS[key] = sub.stage_band
    return sub.stage_band


def stage_band(t) -> Optional[Band]:
    """The band a staged member lives on, or None for any other tensor."""
    from repro_torch.dist.sharding import is_dtensor

    if not is_dtensor(t):
        return None
    return getattr(t.device_mesh, "stage_band", None)


def staged_dim(placements: Sequence[Any], nstack: int
               ) -> Optional[Tuple[int, int]]:
    """``(stacked dim, mesh dim)`` of a stacked leaf's placements whose
    stacked dim is sharded, or None (a one-stage leaf)."""
    for i, p in enumerate(placements):
        if p.is_shard() and p.dim < nstack:
            return p.dim, i
    return None


def place_member(x: torch.Tensor, mesh, leaf: Sequence[Any],
                 stack: Tuple[int, ...], index: int):
    """Member ``index`` (in ``np.ndindex(*stack)`` order) of a stacked leaf
    at placements ``leaf`` on ``mesh``, its whole value ``x`` on every
    rank: a DTensor on the member's band when the stacked dim is sharded
    (each band rank keeps its own block, the others nothing), else on
    ``mesh`` with the stacked dims dropped. No data moves."""
    from torch.distributed.tensor import Shard

    from repro_torch.dist.sharding import place

    nstack = len(stack)
    member = [Shard(p.dim - nstack) if p.is_shard() else p for p in leaf]
    found = staged_dim(leaf, nstack)
    if found is None:
        return place(x, mesh, member)
    k, axis = found
    idx = _unravel(index, stack)
    row = idx[k] // (stack[k] // mesh.size(axis))
    b = band(mesh, axis, row)
    # where a rank outside the band makes its zeros for a gather (DTensor
    # keeps a non-member's empty shard on the mesh's device type, which a
    # meta placement does not use)
    b.sub.member_device = x.device
    del member[axis]
    return place(x, b.sub, member)


def _unravel(index: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for n in reversed(shape):
        out.append(index % n)
        index //= n
    return tuple(reversed(out))


def _local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    return tuple(compute_local_shape_and_global_offset(
        shape, mesh, placements)[0])


class _Gather(torch.autograd.Function):
    """A staged member onto the whole mesh, replicated over the stage
    axis (see :func:`gather_member`)."""

    @staticmethod
    def forward(ctx, p, b: Band):
        from torch.distributed.tensor import DTensor, Partial

        full = b.full_placements(p.placements)
        partial = list(full)
        partial[b.axis] = Partial()
        if b.owner():
            local = p.to_local()
        else:
            local = torch.zeros(_local_shape(p.shape, b.mesh, full),
                                dtype=p.dtype, device=b.sub.member_device)
        ctx.band, ctx.like = b, (p.placements, p.shape, p.stride())
        return DTensor.from_local(
            local, b.mesh, partial, run_check=False, shape=p.shape,
            stride=p.stride()).redistribute(b.mesh, full)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        b = ctx.band
        placements, shape, stride = ctx.like
        g = g.redistribute(b.mesh, b.full_placements(placements))
        local = g.to_local() if b.owner() else g.to_local().new_empty(0)
        return DTensor.from_local(local, b.sub, placements, run_check=False,
                                  shape=shape, stride=stride), None


def gather_member(p):
    """A staged member as a DTensor on the whole mesh, replicated over the
    stage axis and at its own placements on the other mesh dims: one
    all-reduce over ``data`` (the owner band's shard plus zeros). Its
    gradient all-reduces over ``data`` and comes back on the owner band.
    Any other tensor is returned as it is."""
    b = stage_band(p)
    return p if b is None else _Gather.apply(p, b)


def owned(members: Sequence[str], params) -> List[str]:
    """The members of a stacked leaf whose rows this rank's shard of the
    stacked leaf holds, in stack order: all of them unless they are
    staged, else those of this rank's band."""
    out = []
    for name in members:
        b = stage_band(params[name])
        if b is None or b.owner():
            out.append(name)
    return out


def stacked_placements(first, stack: Tuple[int, ...]) -> Tuple[Any, list]:
    """``(mesh, placements)`` of a stacked leaf ``[*stack, ...]`` from its
    first member: a one-stage member's placements with each ``Shard(d)``
    moved past the stacked dims, on its mesh; a staged member's on the
    whole mesh, its stacked dim sharded over the stage axis (the first
    stacked dim the axis divides, as ``fit_pspec`` picks it)."""
    from torch.distributed.tensor import Shard

    nstack = len(stack)
    out = [Shard(p.dim + nstack) if p.is_shard() else p
           for p in first.placements]
    b = stage_band(first)
    if b is None:
        return first.device_mesh, out
    n = b.mesh.size(b.axis)
    k = next(i for i, s in enumerate(stack) if s % n == 0)
    out.insert(b.axis, Shard(k))
    return b.mesh, out


def param_bytes(t) -> int:
    """The bytes of ``t`` this rank holds (a DTensor's local shard)."""
    from repro_torch.dist.sharding import is_dtensor

    local = t.to_local() if is_dtensor(t) else t
    return local.numel() * local.element_size()


# ---------------------------------------------------------------------------
# running a staged block
# ---------------------------------------------------------------------------


def mark_staged(model) -> None:
    """Record on every module of ``model`` the staged members of its
    subtree (``(owner module, name)``), for :func:`materialized`; a model
    with none records nothing."""
    for mod in model.modules():
        found = [(sub, name) for sub in mod.modules()
                 for name, p in sub._parameters.items()
                 if p is not None and stage_band(p) is not None]
        if found:
            mod._staged_members = found
        elif "_staged_members" in mod.__dict__:
            del mod._staged_members


@contextmanager
def materialized(module):
    """Run ``module`` with each staged member of it swapped for its copy on
    the whole mesh (:func:`gather_member`); the stored members come back on
    exit and the copies are freed. A module with no staged members (any
    one-stage or unsharded model) runs as it is."""
    found = getattr(module, "_staged_members", None)
    if not found:
        yield module
        return
    stored = [sub._parameters[name] for sub, name in found]
    try:
        for (sub, name), p in zip(found, stored):
            sub._parameters[name] = gather_member(p)
        yield module
    finally:
        for (sub, name), p in zip(found, stored):
            sub._parameters[name] = p


def run_block(module, *args):
    """``module(*args)`` under :func:`materialized` (the form ``remat``
    checkpoints, so a recomputation gathers again)."""
    with materialized(module):
        return module(*args)


# ---------------------------------------------------------------------------
# a staged decode state: one layer at a time
# ---------------------------------------------------------------------------


def _staged_leaf(leaf) -> Optional[int]:
    """The mesh dim that shards a state leaf's layer dim (dim 0), or
    None."""
    from repro_torch.dist.sharding import is_dtensor

    if not is_dtensor(leaf):
        return None
    for i, p in enumerate(leaf.placements):
        if p.is_shard(0):
            return i
    return None


def _layer_layout(leaf, axis: int) -> Tuple[list, int, int]:
    """``(placements of one layer replicated over axis, layers per row,
    this rank's row)`` of a staged state leaf."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for i, p in enumerate(leaf.placements):
        if i == axis:
            out.append(Replicate())
        elif p.is_shard():
            out.append(Shard(p.dim - 1))
        else:
            out.append(p)
    mesh = leaf.device_mesh
    per = leaf.shape[0] // mesh.size(axis)
    return out, per, mesh.get_coordinate()[axis]


def layer_of(leaf: torch.Tensor, i: int, batch: bool = True
             ) -> torch.Tensor:
    """Layer ``i`` of a decode-state leaf ``[L, ...]``: a view of it,
    unless its layer dim is staged; then a copy on the whole mesh made by
    one collective from the owner band's row (the other rows add zeros),
    laid out as a one-stage plan lays the layer out: with ``batch`` (a
    per-slot leaf ``[L, B, ...]``) its batch dim over the stage axis, as
    the activations' batch is (a reduce-scatter), else (the page pool)
    replicated over it (an all-reduce). Write it back with
    :func:`put_layer`."""
    axis = _staged_leaf(leaf)
    if axis is None:
        return leaf[i]
    from torch.distributed.tensor import DTensor, Partial, Shard

    placements, per, row = _layer_layout(leaf, axis)
    shape = leaf.shape[1:]
    mesh = leaf.device_mesh
    partial = list(placements)
    partial[axis] = Partial()
    if i // per == row:
        local = leaf.to_local()[i - row * per]
    else:
        local = torch.zeros(_local_shape(shape, mesh, placements),
                            dtype=leaf.dtype, device=leaf.to_local().device)
    if batch and _local_shape(shape, mesh, placements)[0] \
            % mesh.size(axis) == 0:
        placements[axis] = Shard(0)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, partial, run_check=False,
                              shape=shape, stride=stride
                              ).redistribute(mesh, placements)


def put_layer(leaf: torch.Tensor, i: int, value: torch.Tensor) -> None:
    """Store ``value``, layer ``i`` as :func:`layer_of` gave it (and a
    block wrote it), into a staged leaf: gathered over the stage axis
    where :func:`layer_of` split its batch (every rank joins), then copied
    by the owner band into its own row; every other rank keeps nothing. A
    leaf whose layer dim is not staged was written through its view
    already."""
    axis = _staged_leaf(leaf)
    if axis is None:
        return
    placements, per, row = _layer_layout(leaf, axis)
    if tuple(value.placements) != tuple(placements):
        value = value.redistribute(value.device_mesh, placements)
    if i // per == row:
        leaf.to_local()[i - row * per].copy_(value.to_local())


@contextmanager
def layers(i: int, *leaves: torch.Tensor, batch: bool = True):
    """Layer ``i`` of each decode-state leaf (:func:`layer_of`, ``batch``
    as there), written back into the staged ones on exit
    (:func:`put_layer`)."""
    views = [layer_of(leaf, i, batch) for leaf in leaves]
    yield views
    for leaf, view in zip(leaves, views):
        put_layer(leaf, i, view)
