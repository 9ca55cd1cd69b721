"""Optimizers of the port: the reference's ``adamw`` and ``adafactor``
(``repro.optim.optimizers``), updating parameters in place.

The reference's optimizers run over its parameter tree, whose block
leaves are stacked ``[L, ...]``; the port's blocks are an ``nn.ModuleList``
of per-layer tensors. Both optimizers here run over the reference's
leaves: ``groups`` (``repro_torch.bridge.leaf_groups``) names, for each
leaf, the port parameters that hold it in stack order, and the optimizer
state is kept per leaf at the reference's shapes. That matters for
``adafactor``, which factors by the stacked shape (a per-layer norm scale
``[d]`` is factored as ``[L, d]``) and clips each update by the RMS of the
whole stacked leaf: it stacks each group's gradient into one fp32 tensor.
``adamw`` is elementwise apart from the global norm, so it runs member by
member on views of its stacked moments.

Memory: the reference's clip makes an fp32 copy of every gradient; here
the global norm is a sum of per-parameter fp32 sums of squares, and the
scale, the moments and the update are applied group by group (adamw:
parameter by parameter) under ``torch.no_grad``, in place. The bias
corrections are computed in fp32 tensors, as the reference computes them.

``state_specs(param_specs)`` gives the state's ``ParamSpec``s, as the
reference's does: fp32 moments with each leaf's logical axes (adafactor's
``vr`` drops the last axis, ``vc`` the second-to-last) and an int32
scalar ``step``. On a mesh (a sharded model) every parameter, its
gradient (at the parameter's placements) and the state are DTensors;
``ExecutionPlan.init_train_state`` places the stacked state by these
specs, its stacked dims replicated (a one-stage plan never shards
``layers``). ``adamw`` then runs on the local shards: a member's moments,
gradient and parameter lie at the same placements, so the elementwise
update is the unsharded one, shard by shard. ``global_norm`` sums each
local shard's squares over its replica count and all-reduces the total,
so every rank holds the same plain scalar. ``adafactor`` runs its
stacked leaf as a DTensor, whose means and RMS reduce over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import torch

from repro_torch.dist.sharding import (
    ParamSpec,
    is_dtensor,
    leaf_placements,
    mesh_all_reduce,
)

Params = Mapping[str, torch.Tensor]
STEP_SPEC = ParamSpec((), (), torch.int32, "zeros")


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params, groups) -> state``; ``update(grads, state, params,
    groups) -> grad norm`` writes the new parameters and state in place.
    ``params`` and ``grads`` map port parameter names to tensors.
    ``state_specs(param_specs) -> {state key: ParamSpecs}``, the specs
    keyed as ``param_specs`` is (leaf keys or leaf names)."""

    init: Callable[[Params, Sequence[Any]], Dict[str, Any]]
    update: Callable[[Params, Dict[str, Any], Params, Sequence[Any]],
                     torch.Tensor]
    state_specs: Callable[[Mapping[str, Any]], Dict[str, Any]]


def local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (shares its storage); a plain tensor
    as it is."""
    return t.to_local() if is_dtensor(t) else t


def group_shape(group, params: Params) -> Tuple[int, ...]:
    """The reference leaf's shape: the stacked dims, then a member's."""
    return tuple(group.stack) + tuple(params[group.members[0]].shape)


def stacked(tensors: Params, group) -> torch.Tensor:
    """The group's members as one new fp32 tensor of the leaf's shape. Of
    DTensor members (all at one placement) a DTensor: their local shards
    stacked, at the leaf's placements (:func:`leaf_placements`)."""
    first = tensors[group.members[0]]
    if is_dtensor(first):
        from torch.distributed.tensor import DTensor

        if any(tuple(tensors[n].placements) != tuple(first.placements)
               for n in group.members):
            raise ValueError(f"{group.name}: members at mixed placements")
        shape = torch.Size(tuple(group.stack) + tuple(first.shape))
        return DTensor.from_local(
            stacked({n: tensors[n].to_local() for n in group.members},
                    group),
            first.device_mesh, leaf_placements(first.placements,
                                               len(group.stack)),
            run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    out = torch.empty(tuple(group.stack) + tuple(first.shape),
                      dtype=torch.float32, device=first.device)
    rows = out.view(-1, *first.shape)
    for i, name in enumerate(group.members):
        rows[i].copy_(tensors[name])
    return out


def member_rows(t: torch.Tensor, group) -> torch.Tensor:
    """A view of a leaf-shaped tensor with one row per member (of a
    DTensor leaf: of its local shard, each row a member's shard)."""
    t = local(t)
    return t.view(-1, *t.shape[len(group.stack):])


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of every gradient's fp32 sum of squares.

    DTensor gradients (at Shard/Replicate placements) add their local
    shards' sums, each divided by the number of ranks that hold the same
    shard, and the total is all-reduced over the mesh: one full
    reduction, the same plain scalar on every rank. On a mesh of one
    device that is the unsharded sum, bit for bit."""
    mesh = next((g.device_mesh for g in grads.values() if is_dtensor(g)),
                None)
    sums = []
    for g in grads.values():
        s = torch.sum(torch.square(local(g).float()))
        if mesh is not None:
            if not is_dtensor(g):
                holders = mesh.size()
            elif any(p.is_partial() for p in g.placements):
                raise ValueError("global_norm of a Partial gradient: "
                                 "redistribute it to its parameter first")
            else:
                holders = math.prod(mesh.size(i) for i, p in
                                    enumerate(g.placements)
                                    if not p.is_shard())
            if holders > 1:
                s = s / holders
        sums.append(s)
    total = torch.sum(torch.stack(sums))
    if mesh is not None:
        mesh_all_reduce(total, mesh)
    return torch.sqrt(total)


def clip_scale(grads: Params, max_norm: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scale, norm)``: the factor that clips the gradients to global
    norm ``max_norm`` (1 when they are within it), and their norm."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _step(state: Dict[str, Any]) -> torch.Tensor:
    """Advance the int32 step counter in place; the step as a plain fp32
    scalar (of a placed counter, its local copy: it is replicated)."""
    state["step"].add_(1)
    return local(state["step"]).float()


def _map_specs(fn, specs: Mapping[str, Any]) -> Dict[str, Any]:
    """``fn`` over every ``ParamSpec`` of a (nested) dict of them."""
    return {k: fn(v) if isinstance(v, ParamSpec) else _map_specs(fn, v)
            for k, v in specs.items()}


def _f32(s: ParamSpec) -> ParamSpec:
    return ParamSpec(s.shape, s.logical, torch.float32, "zeros")


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    def init(params, groups):
        dev = next(iter(params.values())).device
        return {
            "m": {g.name: _zeros(group_shape(g, params), dev)
                  for g in groups},
            "v": {g.name: _zeros(group_shape(g, params), dev)
                  for g in groups},
            "step": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def update(grads, state, params, groups):
        scale, gnorm = clip_scale(grads, max_grad_norm)
        t = _step(state)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t
        for grp in groups:
            ms = member_rows(state["m"][grp.name], grp)
            vs = member_rows(state["v"][grp.name], grp)
            for i, name in enumerate(grp.members):
                g = local(grads[name]).float() * scale
                m, v, p = ms[i], vs[i], local(params[name])
                if not m.shape == g.shape == p.shape:
                    raise ValueError(f"{name}: shards {tuple(m.shape)}, "
                                     f"{tuple(g.shape)}, {tuple(p.shape)} "
                                     f"differ: state, gradient and "
                                     f"parameter lie at other placements")
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                u = u + weight_decay * p.float()
                p.copy_(p.float() + (-lr * u))
        return gnorm

    def state_specs(param_specs):
        return {"m": _map_specs(_f32, param_specs),
                "v": _map_specs(_f32, param_specs),
                "step": STEP_SPEC}

    return Optimizer(init, update, state_specs)


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor(
    lr: float = 1e-3,
    decay: float = 0.8,       # running-average exponent for v
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    max_grad_norm: float = 1.0,
) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern 2018), beta1=0."""

    def init(params, groups):
        dev = next(iter(params.values())).device
        f = {}
        for g in groups:
            shape = group_shape(g, params)
            f[g.name] = ({"vr": _zeros(shape[:-1], dev),
                          "vc": _zeros(shape[:-2] + shape[-1:], dev)}
                         if _factored(shape) else {"v": _zeros(shape, dev)})
        return {"f": f, "step": torch.zeros((), dtype=torch.int32,
                                             device=dev)}

    @torch.no_grad()
    def update(grads, state, params, groups):
        scale, gnorm = clip_scale(grads, max_grad_norm)
        t = _step(state)
        beta = 1.0 - t ** (-decay)
        for grp in groups:
            g = stacked(grads, grp).mul_(scale)
            f = state["f"][grp.name]
            g2 = g * g
            g2.add_(eps)
            if "vr" in f:
                vr, vc = f["vr"], f["vc"]
                vr.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-1))
                vc.mul_(beta).add_((1 - beta) * torch.mean(g2, dim=-2))
                del g2
                denom = torch.mean(vr, dim=-1, keepdim=True)
                u = vr[..., :, None] * vc[..., None, :]
                u.div_(denom[..., None] + eps)
            else:
                f["v"].mul_(beta).add_((1 - beta) * g2)
                del g2
                u = f["v"].clone()
            u.add_(eps).rsqrt_().mul_(g)
            del g
            # update clipping (RMS over the whole stacked leaf)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u.div_(torch.clamp(rms / clip_threshold, min=1.0))
            if weight_decay:
                u.add_(weight_decay * stacked(params, grp))
            u.mul_(-lr)
            first = params[grp.members[0]]
            if is_dtensor(u):
                u = u.redistribute(u.device_mesh, leaf_placements(
                    first.placements, len(grp.stack)))
            rows = member_rows(u, grp)
            for i, name in enumerate(grp.members):
                p = local(params[name])
                p.copy_(p.float() + rows[i])
        return gnorm

    def state_specs(param_specs):
        def one(s: ParamSpec):
            if _factored(s.shape):
                return {"vr": ParamSpec(s.shape[:-1], s.logical[:-1],
                                        torch.float32, "zeros"),
                        "vc": ParamSpec(s.shape[:-2] + s.shape[-1:],
                                        s.logical[:-2] + s.logical[-1:],
                                        torch.float32, "zeros")}
            return {"v": _f32(s)}

        return {"f": _map_specs(one, param_specs), "step": STEP_SPEC}

    return Optimizer(init, update, state_specs)


def make_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(f"unknown optimizer {name}")
