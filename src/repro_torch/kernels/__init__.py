"""Hand-written Hopper kernels of the port, each beside its plain version.

Each wrapper reports the analytic work of every call (:class:`Work`) to
the step analysis that is active, if any (``launch.step_analysis``): a
``ctypes`` launch is invisible to a dispatch mode, so the analysis counts
a kernel by what its wrapper reports, on the card and on the CPU alike.

A kernel has no partitioning rule, so a wrapper given DTensor operands
gathers each to ``Replicate``, launches its kernel once on the local
tensors and returns the output as a replicated DTensor, as XLA all-gathers
a ``pallas_call``'s operands under GSPMD (:func:`dtensor_mesh`,
:func:`gathered`, :func:`replicated_out`). On a CPU mesh the plain version
takes the kernel's place on the same gathered operands (DTensor's own
integer ops do not reproduce the int32 wraparound path).
"""

import contextlib
from typing import NamedTuple, Optional

import torch


class Work(NamedTuple):
    """What one kernel call must do: ``ops`` operations on operands of the
    class ``dtype`` ("int8", "bf16", "fp32", ...: the peak that bounds
    them) and ``bytes`` moved, each input read once and each output
    written once."""

    ops: float
    bytes: float
    dtype: str


# The step analysis that wrappers report to; None (the hot path) outside
# ``launch.step_analysis.analyze_step``.
active_analysis = None


@contextlib.contextmanager
def reported(kernel: str, work: Work):
    """Report one call of ``kernel`` doing ``work`` to the active analysis
    when the body returns, and hide the body's own ops from it (the plain
    version's, or the wrapper's allocations), so that a call counts the
    same on the CPU as on the card. Costs one check with no analysis."""
    analysis = active_analysis
    if analysis is None:
        yield
        return
    with analysis.hidden():
        yield
    analysis.kernel(kernel, work)


def require_no_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would record through ``kernel``: a kernel launched
    through ``ctypes`` returns a tensor detached from its inputs, so the
    gradients of inputs that require grad would silently be lost. Training
    runs the plain paths instead (``layers.attention.mha`` never routes a
    grad-requiring call to flash)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: an input requires grad (train "
            f"through the plain path, or call under torch.no_grad())")


def dtensor_mesh(kernel: str, *tensors: Optional[torch.Tensor]):
    """The mesh of a call's DTensor operands, or None for a plain call.

    Raises ``TypeError`` for a call that mixes plain tensors and DTensors
    or DTensors of two meshes, and ``ValueError`` for a DTensor on the
    card whose mesh is not a CUDA mesh: the kernel launches on one
    layout or not at all."""
    from repro_torch.dist.sharding import is_dtensor

    given = [t for t in tensors if t is not None]
    dts = [t for t in given if is_dtensor(t)]
    if not dts:
        return None
    if len(dts) != len(given):
        raise TypeError(f"{kernel}: a call mixes DTensors and plain tensors")
    mesh = dts[0].device_mesh
    if any(t.device_mesh != mesh for t in dts):
        raise TypeError(f"{kernel}: DTensor operands on different meshes")
    if dts[0].device.type == "cuda" and mesh.device_type != "cuda":
        raise ValueError(f"{kernel}: a DTensor on the card over a "
                         f"{mesh.device_type} mesh")
    return mesh


def gathered(mesh, *tensors: Optional[torch.Tensor]):
    """Each DTensor gathered to ``Replicate`` on ``mesh`` as its local
    (whole, plain, contiguous) tensor; None stays None. A tensor whole on
    every rank already (replicated, or split over mesh dims of size 1)
    moves nothing; int16 travels as int32 (exactly), which neither NCCL
    nor gloo carries."""
    from torch.distributed.tensor import Replicate

    rep = [Replicate()] * mesh.ndim
    out = []
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        if all(p.is_replicate() or mesh.size(i) == 1
               for i, p in enumerate(t.placements)):
            local = t.to_local()
        else:
            wide = t.to(torch.int32) if t.dtype == torch.int16 else t
            local = wide.redistribute(mesh, rep).to_local().to(t.dtype)
        out.append(local.contiguous())
    return tuple(out)


def replicated_out(y: torch.Tensor, mesh):
    """A kernel's local output as a DTensor replicated on ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(y, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
