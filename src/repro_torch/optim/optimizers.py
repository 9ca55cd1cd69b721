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

``state_specs`` (the reference's sharding dry-run input) belongs to the
multi-GPU port (ROADMAP Queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import torch

Params = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``init(params, groups) -> state``; ``update(grads, state, params,
    groups) -> grad norm`` writes the new parameters and state in place.
    ``params`` and ``grads`` map port parameter names to tensors."""

    init: Callable[[Params, Sequence[Any]], Dict[str, Any]]
    update: Callable[[Params, Dict[str, Any], Params, Sequence[Any]],
                     torch.Tensor]


def group_shape(group, params: Params) -> Tuple[int, ...]:
    """The reference leaf's shape: the stacked dims, then a member's."""
    return tuple(group.stack) + tuple(params[group.members[0]].shape)


def stacked(tensors: Params, group) -> torch.Tensor:
    """The group's members as one new fp32 tensor of the leaf's shape."""
    first = tensors[group.members[0]]
    out = torch.empty(tuple(group.stack) + tuple(first.shape),
                      dtype=torch.float32, device=first.device)
    rows = out.view(-1, *first.shape)
    for i, name in enumerate(group.members):
        rows[i].copy_(tensors[name])
    return out


def member_rows(t: torch.Tensor, group) -> torch.Tensor:
    """A view of a leaf-shaped tensor with one row per member."""
    return t.view(-1, *t.shape[len(group.stack):])


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum of every gradient's fp32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(g.float())) for g in grads.values()])))


def clip_scale(grads: Params, max_norm: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scale, norm)``: the factor that clips the gradients to global
    norm ``max_norm`` (1 when they are within it), and their norm."""
    norm = global_norm(grads)
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0), norm


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _step(state: Dict[str, Any]) -> torch.Tensor:
    """Advance the int32 step counter in place; the step as fp32."""
    state["step"].add_(1)
    return state["step"].float()


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
                g = grads[name].float() * scale
                m, v, p = ms[i], vs[i], params[name]
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * g * g)
                u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                u = u + weight_decay * p.float()
                p.copy_(p.float() + (-lr * u))
        return gnorm

    return Optimizer(init, update)


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
            rows = member_rows(u, grp)
            for i, name in enumerate(grp.members):
                p = params[name]
                p.copy_(p.float() + rows[i])
        return gnorm

    return Optimizer(init, update)


def make_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise ValueError(f"unknown optimizer {name}")
