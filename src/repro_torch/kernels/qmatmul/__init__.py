from repro_torch.kernels.qmatmul.ops import qlinear
from repro_torch.kernels.qmatmul.ref import qlinear_ref

__all__ = ["qlinear", "qlinear_ref"]
