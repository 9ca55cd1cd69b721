"""Token embedding."""

from __future__ import annotations

from typing import Mapping

import torch

from repro_torch.dist.sharding import is_dtensor, replicated, shard_act


def embed(params: Mapping[str, torch.Tensor],
          tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the [vocab, d] table for int tokens [B, S]. A table placed
    on a mesh of more than one device is read through :class:`_Lookup`."""
    table = params["table"]
    if is_dtensor(table) and table.device_mesh.size() > 1:
        rows = _Lookup.apply(table, tokens)
    else:
        rows = table[tokens]
    return shard_act(rows, "batch", "seq", "act_embed")


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` on a mesh, run on each rank's local tensors: the
    table gathered whole, the rows of this rank's tokens picked, the
    output laid out as the tokens are (its feature dim replicated). The
    backward accumulates the rows' gradients into a zero table per rank
    (``index_put_``, as the plain lookup's backward does), a ``Partial``
    sum over the mesh dims that split the tokens. DTensor's own index op
    and its backward cannot be relied on at a production mesh's
    placements (torch 2.11's ``index_put`` rule fails on tokens split
    over ``data``)."""

    @staticmethod
    def forward(ctx, table, tokens):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = table.device_mesh
        tokens = replicated(tokens, mesh)
        whole = table.redistribute(mesh, [Replicate()] * mesh.ndim)
        local = tokens.to_local()
        rows = whole.to_local()[local]
        shape = torch.Size((*tokens.shape, table.shape[1]))
        ctx.save_for_backward(local)
        ctx.like = (mesh, table.shape, table.stride(), tuple(tokens.placements))
        return DTensor.from_local(
            rows, mesh, tokens.placements, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor, Partial, Replicate

        (local,) = ctx.saved_tensors
        mesh, shape, stride, placements = ctx.like
        rows = grad.redistribute(mesh, placements).to_local()
        acc = torch.zeros(shape, dtype=rows.dtype, device=rows.device)
        acc.index_put_((local,), rows, accumulate=True)
        out = [Partial() if p.is_shard() else Replicate()
               for p in placements]
        return DTensor.from_local(acc, mesh, out, run_check=False,
                                  shape=shape, stride=stride), None
