"""The compile-plan pass pipeline:

    ResolveDevice -> ResolveMesh -> ResolveSharding -> PlaceStages
        -> Quantize -> Compile

The last five are the reference's passes, with the same entries in
``ir.decisions``; ResolveDevice comes first because the port's plan runs
on one device. Every decision is recorded in the
:class:`~repro_torch.plan.ir.PlanIR`.

* **ResolveDevice** picks the card (or the device the caller names).
* **ResolveMesh** resolves the mesh's axis names and sizes from the
  :class:`~repro_torch.plan.ir.MeshSpec` and checks them against the
  world (``launch.mesh.check_world``: a mesh larger than the world raises
  and is never shrunk). A documented divergence: the reference builds its
  jax ``Mesh`` here, which costs nothing there; the port builds its
  ``DeviceMesh`` (and so a process group) only when the plan must place a
  tensor (``ExecutionPlan.param_placements`` / ``shard_params``), so a
  plan that serves or trains on one card starts no process group.
* **ResolveSharding** builds the mode's rule table and records the fitted
  PartitionSpec of every parameter leaf (``PortedLM.param_specs`` of the
  model built on the ``meta`` device), from the axis sizes alone.
* **PlaceStages** splits the stacked layers into contiguous pipeline
  stages and assigns them to mesh row bands with the paper's Eq. 2
  branch-and-bound (``core.placement.Placer``); the placement turns into
  a ``layers -> data`` rule override and the specs are resolved again.
* **Quantize** decides the int8 serving paths: the decode LM head (always,
  when ``quantized``) and the MLP down-projection with per-tensor
  calibrated shifts (``calibrate_mlp_shifts`` refines the defaults once
  real weights exist).
* **Compile** registers the executable catalogue; every entry is built
  through ``repro_torch.serve.cache.ExecutableCache`` and counted there.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.emit import resolve_device
from repro_torch.core.placement import Block, PlacementResult, Placer
from repro_torch.dist.sharding import ParamSpec, rules_for_mode, spec_to_pspec
from repro_torch.launch.mesh import check_world
from repro_torch.models.base import HEAD_SHIFTS, ArchConfig, build_model
from repro_torch.plan.ir import PlanIR, StagePlacement
from repro_torch.quant.qtensor import choose_shift

# Families whose blocks carry a dense SwiGLU "ffn" whose down-projection
# the Quantize pass can route through the qmatmul kernel.
MLP_QUANT_FAMILIES = ("dense", "vlm", "hybrid")

__all__ = ["HEAD_SHIFTS", "MLP_QUANT_FAMILIES", "PLAN_PIPELINE",
           "assign_stage_slices", "calibrate_mlp_shifts", "param_specs",
           "stack_depth"]


def resolve_device_pass(ir: PlanIR) -> PlanIR:
    dev = resolve_device(ir.device_request)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    ir.device = dev
    ir.record("ResolveDevice", device=str(dev))
    return ir


@functools.lru_cache(maxsize=64)
def param_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    """``{leaf key: ParamSpec}`` of ``cfg``'s model, read off the model
    built on the ``meta`` device (nothing is allocated, so kimi-k2's
    ~1 T parameters resolve anywhere). Cached per config: treat the
    result as read-only."""
    return build_model(cfg, device="meta").param_specs()


def stack_depth(cfg: ArchConfig) -> int:
    """Length of the outer stacked-layers dim (the stage-splittable one).

    The hybrid family stacks its layers in groups (one shared attention
    block per group), so its stackable depth is the group count.
    """
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _resolve_param_pspecs(ir: PlanIR) -> Dict[str, str]:
    """Flat {leaf key: PartitionSpec text} under the current rule table."""
    return {key: str(spec_to_pspec(spec, ir.axes, ir.rules))
            for key, spec in param_specs(ir.cfg).items()}


# ---------------------------------------------------------------------------
# ResolveMesh
# ---------------------------------------------------------------------------


def resolve_mesh_pass(ir: PlanIR) -> PlanIR:
    ir.axes = ir.mesh_spec.axis_sizes()
    n = math.prod(ir.axes.values())
    if ir.mesh_spec.kind == "explicit":
        ir.mesh = ir.mesh_spec.mesh
    else:
        check_world(n)
    ir.record("ResolveMesh", mesh=ir.mesh_spec.label(), axes=dict(ir.axes),
              devices=n)
    return ir


# ---------------------------------------------------------------------------
# ResolveSharding
# ---------------------------------------------------------------------------


def resolve_sharding_pass(ir: PlanIR) -> PlanIR:
    ir.rules = rules_for_mode(ir.mode)
    ir.param_pspecs = _resolve_param_pspecs(ir)
    sharded = {k: v for k, v in ir.param_pspecs.items()
               if v != "PartitionSpec()"}
    ir.record("ResolveSharding", mode=ir.mode,
              params=len(ir.param_pspecs), sharded=len(sharded))
    return ir


# ---------------------------------------------------------------------------
# PlaceStages
# ---------------------------------------------------------------------------


def assign_stage_slices(
    n_cols: int,
    n_rows: int,
    n_stages: int,
    *,
    lam: float = 1.0,
    mu: float = 0.05,
    beam: Optional[int] = 64,
) -> PlacementResult:
    """Assign ``n_stages`` equal stage blocks to mesh slices with the
    paper's Eq. 2 branch-and-bound. The grid is the (model, data) device
    plane: columns = model axis, rows = data axis; each stage is a
    full-width block ``n_rows // n_stages`` rows tall. ``beam=None`` is
    exact.

    The blocks are identical full-width rectangles, so every feasible
    placement is a permutation of the same row bands: the search
    certifies that the banded layout is Eq. 2-optimal and records its
    cost and expansions in the plan.
    """
    if n_rows % n_stages:
        raise ValueError(
            f"{n_stages} stages do not divide the {n_rows}-row axis")
    height = n_rows // n_stages
    blocks = [Block(n_cols, height, f"stage{i}") for i in range(n_stages)]
    placer = Placer(n_cols, n_rows, lam=lam, mu=mu, beam=beam)
    return placer.branch_and_bound(blocks, start=(0, 0))


def place_stages_pass(ir: PlanIR) -> PlanIR:
    S = ir.pipeline_stages
    depth = stack_depth(ir.cfg)
    if S < 1:
        raise ValueError(f"pipeline_stages must be >= 1, got {S}")
    if S > depth:
        raise ValueError(
            f"pipeline_stages={S} exceeds the layer stack depth {depth}")
    if S == 1:
        ir.record("PlaceStages", stages=1, stage_axis=None,
                  note="single stage: layers axis replicated")
        return ir

    n_rows = ir.axes.get("data", 1)
    n_cols = ir.axes.get("model", 1)
    fallback = None
    if n_rows < S or n_rows % S:
        fallback = (f"data axis ({n_rows} rows) cannot hold {S} equal "
                    "stages")
    elif depth % n_rows:
        fallback = (f"layer stack ({depth}) does not divide over the "
                    f"data axis ({n_rows} rows)")
    if fallback:
        ir.record("PlaceStages", stages=S, stage_axis=None,
                  fallback=fallback)
        return ir

    result = assign_stage_slices(n_cols, n_rows, S)
    # the stacked layer dim shards across the axis in row order, so stage
    # k (layers [k*per, (k+1)*per)) goes to the k-th row band; the sort
    # also canonicalizes any cost-tied permutation the search returns
    order = sorted(range(S), key=lambda i: result.positions[i].row)
    per = depth // S
    ir.stages = [
        StagePlacement(k, k * per, per, p.col, p.row, p.width, p.height)
        for k, p in ((k, result.positions[i]) for k, i in enumerate(order))
    ]
    ir.stage_axis = "data"
    ir.placement_cost = result.cost
    ir.placement_method = result.method
    ir.rules = ir.rules.replace(layers="data")
    ir.param_pspecs = _resolve_param_pspecs(ir)
    ir.record(
        "PlaceStages", stages=S, stage_axis="data",
        cost=round(result.cost, 4), method=result.method,
        expanded=result.nodes_expanded,
        slices=[s.as_dict() for s in ir.stages],
    )
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

    ``w_shift`` comes from the absmax over every ``ffn.down`` weight
    (``model.mlp_down_weights()``: every block of the dense LM, the one
    shared block of the hybrid, the vision LM's self and cross blocks).
    With ``observe`` the activation/output shifts come from the ranges a
    short float calibration decode of ``model`` observes (one headroom bit
    reserved for unseen data); without it they fall back to the analytic
    worst case ``|x|_max * max column-abs-sum(w)``. The output shift is
    capped so the SRS shift stays >= 0.
    """
    x_shift = cfg.mlp_x_shift
    downs = model.mlp_down_weights()
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
        cat["masked_decode"] = {
            "batch": "per-bucket", "seq_len": "per-bucket",
            "steps_per_dispatch": "per-scheduler",
            "note": "slot-masked continuous-batching micro-run of k steps "
                    "(cache-keyed by k); paged=(page_count, page_size) "
                    "for the shared page pool joins the key",
        }
    ir.executables = cat
    ir.record("Compile", kinds=sorted(cat), cache="serve.ExecutableCache")
    return ir


PLAN_PIPELINE: List[Tuple[str, object]] = [
    ("ResolveDevice", resolve_device_pass),
    ("ResolveMesh", resolve_mesh_pass),
    ("ResolveSharding", resolve_sharding_pass),
    ("PlaceStages", place_stages_pass),
    ("Quantize", quantize_pass),
    ("Compile", compile_pass),
]
