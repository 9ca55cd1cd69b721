"""Int8 gradient compression with error feedback (the reference's
``repro.optim.compression``).

Each gradient is quantized to int8 with one max-scale per tensor and
dequantized; the quantization residual is kept and added back into the
next step's gradient (error feedback, unbiased in the long run;
Karimireddy et al. 2019). ``torch.round`` rounds half to even, like the
reference's ``jnp.round``, so ``q`` is the reference's bit for bit.

The local form serves the trainer's accumulation boundary (on a mesh
too: its per-leaf max is then a DTensor reduction, the global one). The
collective form, ``axis_name`` given, is the reference's ``shard_map``
reduction: ``g`` and ``residual`` are this rank's blocks, one scale is
agreed by a MAX all-reduce of ``amax`` over the named mesh dim's process
group, the int8 payload is summed as int32 (int8 sums would overflow;
gloo has no int16 sum either) and divided by the group's size, and the
residual stays local.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

def compress_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns ``(q, scale)``, the
    scale an fp32 scalar tensor."""
    gf = g.float()
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp(amax / 127.0, min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def axis_group(axis_name: str):
    """The process group of mesh dim ``axis_name`` of the active
    ``sharding_ctx``'s mesh (the counterpart of a ``shard_map`` axis
    name). Raises outside a context, or when the mesh lacks the axis."""
    from repro_torch.dist.sharding import current_ctx

    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError(f"axis {axis_name!r} names a mesh dim: run "
                           f"under sharding_ctx")
    mesh, _ = ctx
    names = tuple(mesh.mesh_dim_names or ())
    if axis_name not in names:
        raise ValueError(f"mesh axes {names} lack {axis_name!r}")
    return mesh.get_group(axis_name)


def error_feedback_reduce(
    g: torch.Tensor,
    residual: torch.Tensor,
    axis_name: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compress ``g + residual``, all-reduce the int8 payload over
    ``axis_name`` (mean), return ``(reduced fp32 grad, new residual)``.

    With ``axis_name`` the mesh dim of that name of the active
    ``sharding_ctx`` reduces: ``g`` and ``residual`` are this rank's
    plain blocks. Without it the call degrades to a local
    quantize/dequantize (the accumulation loop, tests)."""
    corrected = g.float() + residual
    if axis_name is not None:
        import torch.distributed as dist

        group = axis_group(axis_name)
        # agree on one scale across workers (MAX), then quantize, then
        # reduce the int32 payload
        amax = torch.max(torch.abs(corrected))
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = torch.clamp(amax / 127.0, min=1e-30)
        q = torch.clamp(torch.round(corrected / scale), -127,
                        127).to(torch.int8)
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)
        n = float(dist.get_world_size(group))
        reduced = qsum.float() * scale / n
        local_decoded = q.float() * scale
    else:
        q, scale = compress_int8(corrected)
        reduced = decompress_int8(q, scale)
        local_decoded = reduced
    return reduced, corrected - local_decoded
