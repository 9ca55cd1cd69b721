"""The algorithm's work of one kernel call: operations and bytes.

Copied from ``src/repro_torch/kernels/flash_attention/ops.py`` ``work``
at commit e17a6c6d57bb276822ede68220dea8818d071c25. Each input byte is
read once and each output byte written once, whatever the kernel reads
again. The count differs from its original in one place: K and V are counted at
their own (key-value) head count, since grouped-query attention needs
only those; the original counted them at the query heads, as the port
repeats them before the call.
"""

from typing import NamedTuple

ITEMSIZE = {"bf16": 2, "fp32": 4}


class Work(NamedTuple):
    ops: float
    bytes: float
    dtype: str        # the operand class whose peak bounds ``ops``


def flash_work(B: int, H: int, KV: int, Sq: int, Sk: int, hd: int,
               dtype: str = "bf16", causal: bool = True) -> Work:
    """One attention call over B sequences of H query heads and KV
    key-value heads: Q K^T and P V, 4 B H Sq Sk hd operations, half of
    them under a causal mask (P V counts once, though the bf16 kernel
    issues it for P's hi and lo parts); q and o at H heads and k and v at
    KV heads, each moved once."""
    ops = 4.0 * B * H * Sq * Sk * hd / (2 if causal else 1)
    nbytes = ITEMSIZE[dtype] * B * hd * (2 * H * Sq + 2 * KV * Sk)
    return Work(ops, float(nbytes), dtype)
