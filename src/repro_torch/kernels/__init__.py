"""Hand-written Hopper kernels of the port, each beside its plain version.

Each wrapper reports the analytic work of every call (:class:`Work`) to
the step analysis that is active, if any (``launch.step_analysis``): a
``ctypes`` launch is invisible to a dispatch mode, so the analysis counts
a kernel by what its wrapper reports, on the card and on the CPU alike.
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
