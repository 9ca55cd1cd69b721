"""Cascade parallelism resolution (paper Sec. III-B).

A layer with (f_in, f_out) features is spread over a CAS_LEN x CAS_NUM
rectangle of tiles:

    f_in  = CAS_LEN * f_in_slice     (contraction split; partial sums flow
                                      west->east over the cascade ports)
    f_out = CAS_NUM * f_out_slice    (output-feature split; rows replicate
                                      north-south)

A copy of ``repro.core.cascade``, kept identical (including the known
fault where ``f_out_slice`` is sized by the weight budget alone and the
I/O check below then rejects small-f_in / wide-f_out layers), so the
port's Resolve pass takes the reference's decisions.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.device import AIEMLDevice, MmulTiling
from repro_torch.core.ir import CascadeSpec
from repro_torch.core.packing import ceil_to


def resolve_cascade(
    f_in: int,
    f_out: int,
    tiling: MmulTiling,
    device: AIEMLDevice,
    batch: int,
    a_bytes: int,
    w_bytes: int,
    overrides: Optional[Dict] = None,
    weight_budget_bytes: Optional[int] = None,
) -> CascadeSpec:
    """Choose CAS_LEN/CAS_NUM and per-tile slices for one dense layer.

    Constraints honored:
      * slices are multiples of the mmul tile dims (K, N);
      * the per-tile weight slice (resident, RTP-loaded) plus double-buffered
        I/O slices fit in local memory;
      * user overrides (cas_len / cas_num / f_in_slice / f_out_slice) are
        hard constraints.
    """
    overrides = overrides or {}
    budget = weight_budget_bytes or (device.local_mem_bytes // 2)

    # default slice caps: keep the contraction slice near 128 features (a
    # sweet spot for K-tile streaming), then size the output slice so the
    # weight slice fits the budget.
    f_in_slice = overrides.get("f_in_slice")
    cas_len = overrides.get("cas_len")
    if cas_len is not None and f_in_slice is None:
        f_in_slice = ceil_to(-(-f_in // cas_len), tiling.K)
    if f_in_slice is None:
        f_in_slice = min(ceil_to(f_in, tiling.K), 128)
    f_in_slice = ceil_to(f_in_slice, tiling.K)
    if cas_len is None:
        cas_len = -(-f_in // f_in_slice)

    f_out_slice = overrides.get("f_out_slice")
    cas_num = overrides.get("cas_num")
    if cas_num is not None and f_out_slice is None:
        f_out_slice = ceil_to(-(-f_out // cas_num), tiling.N)
    if f_out_slice is None:
        cap = max(tiling.N, budget // max(1, f_in_slice * w_bytes))
        # round the cap DOWN to a tile multiple (never below one tile), and
        # never exceed the padded layer width.
        f_out_slice = max(tiling.N, (cap // tiling.N) * tiling.N)
        f_out_slice = min(f_out_slice, ceil_to(f_out, tiling.N))
    f_out_slice = ceil_to(f_out_slice, tiling.N)
    if cas_num is None:
        cas_num = -(-f_out // f_out_slice)

    spec = CascadeSpec(
        cas_len=cas_len, cas_num=cas_num,
        f_in_slice=f_in_slice, f_out_slice=f_out_slice,
    )

    # local-memory feasibility: resident weights + double-buffered io slices
    w_slice = f_in_slice * f_out_slice * w_bytes
    io_slice = 2 * batch * (f_in_slice * a_bytes + f_out_slice * a_bytes)
    if w_slice > device.local_mem_bytes:
        raise ValueError(
            f"weight slice {w_slice}B exceeds tile local memory "
            f"({device.local_mem_bytes}B); increase cas_len/cas_num"
        )
    if w_slice + io_slice > 4 * device.local_mem_bytes:
        # io buffers can spill into neighbor tiles' banks (AIE shares memory
        # with 3 neighbors); beyond 4 banks it cannot work.
        raise ValueError("layer slice working set cannot fit tile memory")
    return spec


def cascade_grid_factor(tp: int, prefer_len: int) -> tuple:
    """Factor a TP degree into (cas_len, cas_num) with cas_len as close to
    ``prefer_len`` as possible. Used by the sharded linear layer to map the
    cascade rectangle onto a 1D model axis."""
    best = (1, tp)
    for cl in range(1, tp + 1):
        if tp % cl == 0 and abs(cl - prefer_len) < abs(best[0] - prefer_len):
            best = (cl, tp // cl)
    return best
