"""Hand-written Hopper kernels of the port, each beside its plain version."""

import torch


def require_no_grad(kernel: str, *tensors) -> None:
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
