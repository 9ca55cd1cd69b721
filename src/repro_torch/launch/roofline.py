"""Roofline terms of one step on the H100 (the reference's
``repro.launch.roofline``, over :class:`~repro_torch.core.device.H100Target`
in place of its TPU target).

    compute term    = sum over dtype classes of flops / that class's peak
    memory term     = bytes / HBM rate                        [s, per card]
    collective term = collective_bytes / NVLink rate           [s, per card]

Step statistics come from :mod:`repro_torch.launch.step_analysis`. The
compute term takes each class at its own peak: the serving path's fp32
attention products are bounded by 67 TFLOP/s, a bf16 GEMM with an fp32
output by 989, qmatmul's int8 work by 1,979 TOP/s. The output keeps the
reference's keys (``hlo_*`` name the step's dispatched work here); with a
measured step time it adds ``measured_s`` and ``measured_over_bound``.
"""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.device import DEFAULT_H100
from repro_torch.launch.step_analysis import Stats

GPU = DEFAULT_H100


def roofline_terms(
    stats: Stats,
    n_chips: int,
    model_flops_global: float,
    memory_stats: Optional[Dict] = None,
    measured_s: Optional[float] = None,
) -> Dict:
    compute_s = sum(GPU.compute_time_s(f, dtype)
                    for dtype, f in stats.flops_by_dtype.items())
    memory_s = GPU.memory_time_s(stats.bytes)
    collective_s = GPU.collective_time_s(stats.collective_bytes)
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    step_s = max(terms.values())
    model_flops_per_chip = model_flops_global / n_chips
    useful_ratio = (model_flops_per_chip / stats.flops) if stats.flops else 0.0
    # achievable MFU if the dominant term is the critical path and compute
    # overlaps underneath it
    peak = GPU.peak_flops_bf16
    mfu = (model_flops_per_chip / peak) / step_s if step_s else 0.0
    out = {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "hlo_flops_per_chip": stats.flops,
        "hlo_bytes_per_chip": stats.bytes,
        "collective_bytes_per_chip": stats.collective_bytes,
        "per_collective_bytes": dict(stats.per_collective),
        "collective_op_counts": dict(stats.collective_ops),
        "flops_by_dtype": dict(stats.flops_by_dtype),
        "model_flops_global": model_flops_global,
        "model_flops_per_chip": model_flops_per_chip,
        "useful_flops_ratio": useful_ratio,
        "roofline_mfu": mfu,
        "step_time_bound_s": step_s,
    }
    if memory_stats:
        out["memory_analysis"] = memory_stats
    if measured_s is not None:
        out["measured_s"] = measured_s
        out["measured_over_bound"] = measured_s / step_s if step_s else 0.0
        out["measured_mfu"] = (model_flops_per_chip / peak) / measured_s \
            if measured_s else 0.0
    return out


def fmt_seconds(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.1f}us"


def summarize(record: Dict) -> str:
    r = record["roofline"]
    line = (
        f"{record['arch']:<24s} {record['shape']:<12s} "
        f"{record['mesh']:<10s} {record.get('mode','-'):<10s} "
        f"C={fmt_seconds(r['compute_s']):>9s} "
        f"M={fmt_seconds(r['memory_s']):>9s} "
        f"N={fmt_seconds(r['collective_s']):>9s} "
        f"dom={r['dominant']:<10s} "
        f"useful={r['useful_flops_ratio']*100:5.1f}% "
        f"MFU<={r['roofline_mfu']*100:5.1f}%"
    )
    if "measured_s" in r:
        line += (f" measured={fmt_seconds(r['measured_s'])} "
                 f"(x{r['measured_over_bound']:.2f}) "
                 f"MFU={r['measured_mfu']*100:5.1f}%")
    return line
