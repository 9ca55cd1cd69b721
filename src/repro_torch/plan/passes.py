"""The compile-plan passes for one card:

    ResolveDevice -> Quantize -> Compile

The reference's mesh, sharding-rule and stage-placement passes have no
counterpart on one card (ROADMAP Queue 1 item 14). Every decision is
recorded in the :class:`~repro_torch.plan.ir.PlanIR`.

* **ResolveDevice** picks the card (or the device the caller names).
* **Quantize** decides the int8 serving paths: the decode LM head (always,
  when ``quantized``) and the MLP down-projection with per-tensor
  calibrated shifts (``calibrate_mlp_shifts`` refines the defaults once
  real weights exist).
* **Compile** registers the executable catalogue; every entry is built
  through ``repro_torch.serve.cache.ExecutableCache`` and counted there.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.emit import resolve_device
from repro_torch.models.base import HEAD_SHIFTS, ArchConfig
from repro_torch.plan.ir import PlanIR
from repro_torch.quant.qtensor import choose_shift

# Families whose blocks carry a dense SwiGLU "ffn" whose down-projection
# the Quantize pass can route through the qmatmul kernel.
MLP_QUANT_FAMILIES = ("dense", "vlm", "hybrid")

__all__ = ["HEAD_SHIFTS", "MLP_QUANT_FAMILIES", "PLAN_PIPELINE",
           "calibrate_mlp_shifts"]


def resolve_device_pass(ir: PlanIR) -> PlanIR:
    dev = resolve_device(ir.device_request)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ir.device = dev
    ir.record("ResolveDevice", device=str(dev))
    return ir


def _observe_mlp_ranges(cfg: ArchConfig, model, steps: int,
                        batch: int) -> Dict[str, float]:
    """Short greedy decode of the FLOAT model under the swiglu calibration
    scope, returning the observed absmax of the down-projection input
    ("act") and output ("out"). The model runs with a float copy of
    ``cfg`` for the duration."""
    from repro_torch.layers.mlp import swiglu_calibration

    record: Dict[str, float] = {}
    state = model.decode_state(batch, steps + 2)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(
        rng.integers(1, cfg.vocab, (batch,)).astype(np.int32)).to(model.device)
    saved = model.cfg
    model.cfg = cfg.with_(quantized=False, quantized_mlp=False)
    try:
        with swiglu_calibration(record):
            for i in range(steps):
                logits, state = model.decode_step(state, tok, i)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
    finally:
        model.cfg = saved
    return record


def calibrate_mlp_shifts(
    cfg: ArchConfig,
    model,
    *,
    observe: bool = True,
    steps: int = 6,
    batch: int = 2,
) -> Tuple[int, int, int]:
    """Per-tensor calibrated shifts for the a16w8 MLP down-projection.

    ``w_shift`` comes from the absmax over every ``ffn.down`` weight. With
    ``observe`` the activation/output shifts come from the ranges a short
    float calibration decode of ``model`` observes (one headroom bit
    reserved for unseen data); without it they fall back to the analytic
    worst case ``|x|_max * max column-abs-sum(w)``. The output shift is
    capped so the SRS shift stays >= 0.
    """
    x_shift = cfg.mlp_x_shift
    downs = [blk.ffn["down"]["w"] for blk in model.blocks]
    if not downs:
        return (x_shift, cfg.mlp_w_shift, cfg.mlp_out_shift)
    # choose_shift reads only max|w|, so the absmax stands in for the tensor
    amax = max(float(w.abs().max()) for w in downs)
    w_shift = choose_shift(np.asarray([amax], np.float32), "int8")
    record: Dict[str, float] = {}
    if observe:
        record = _observe_mlp_ranges(cfg, model, steps, batch)
    if record.get("act"):
        x_shift = choose_shift(np.asarray([record["act"]]), "int16",
                               margin_bits=1)
        out_amax = max(record.get("out", 0.0), 1e-12)
        out_shift = choose_shift(np.asarray([out_amax]), "int16",
                                 margin_bits=1)
    else:
        # stacked column abs-sum over the contraction dim (d_ff)
        colsum = max(float(w.float().abs().sum(dim=0).max()) for w in downs)
        x_amax = 2.0 ** (15 - x_shift)       # full int16 range at x_shift
        out_shift = choose_shift(
            np.asarray([max(x_amax * colsum, 1e-12)]), "int16")
    out_shift = min(out_shift, x_shift + w_shift)
    return (x_shift, w_shift, out_shift)


def quantize_pass(ir: PlanIR) -> PlanIR:
    if not ir.quantized:
        ir.record("Quantize", enabled=False)
        return ir
    cfg = ir.cfg.with_(quantized=True)
    # MLP quantization is a serving decision: only decode-path plans
    # (serve plans have shape=None) route the down-projection through
    # the qmatmul kernel
    decode_plan = ir.shape is None or ir.shape.kind == "decode"
    mlp = decode_plan and cfg.family in MLP_QUANT_FAMILIES
    if mlp:
        cfg = cfg.with_(quantized_mlp=True)
    ir.cfg = cfg
    ir.quant = {
        "head_shifts": HEAD_SHIFTS,
        "mlp": mlp,
        "mlp_shifts": (cfg.mlp_x_shift, cfg.mlp_w_shift, cfg.mlp_out_shift),
        "calibrated": False,
    }
    ir.record("Quantize", enabled=True, head_shifts=HEAD_SHIFTS, mlp=mlp,
              mlp_shifts=ir.quant["mlp_shifts"])
    return ir


def compile_pass(ir: PlanIR) -> PlanIR:
    """Register the executable catalogue (kind -> shape template).

    Executables are bound lazily through ``ExecutionPlan.executable`` /
    ``serve_executable``; every build goes through the plan's
    ExecutableCache and shows in its counters.
    """
    cat: Dict[str, Dict[str, object]] = {}
    if ir.shape is not None:
        cat[ir.shape.kind] = {
            "batch": ir.shape.global_batch,
            "seq_len": ir.shape.seq_len,
            "shape": ir.shape.name,
        }
    if ir.shape is None or ir.shape.kind == "decode":
        cat.setdefault("decode", {"batch": "per-bucket",
                                  "seq_len": "per-bucket"})
        cat["prefill"] = {"batch": "per-bucket", "seq_len": "per-bucket",
                          "note": "prefill->decode handoff loop"}
    ir.executables = cat
    ir.record("Compile", kinds=sorted(cat), cache="serve.ExecutableCache")
    return ir


PLAN_PIPELINE: List[Tuple[str, object]] = [
    ("ResolveDevice", resolve_device_pass),
    ("Quantize", quantize_pass),
    ("Compile", compile_pass),
]
