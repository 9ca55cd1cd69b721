"""One execution-plan API: the pass pipeline (ResolveDevice ->
ResolveMesh -> ResolveSharding -> PlaceStages -> Quantize -> Compile), the
model it owns, where each parameter lives on a mesh, and its step
catalogue behind the shared ``ExecutableCache``."""

from repro_torch.plan.ir import MeshSpec, PlanIR, StagePlacement
from repro_torch.plan.passes import (
    PLAN_PIPELINE,
    assign_stage_slices,
    calibrate_mlp_shifts,
    stack_depth,
)
from repro_torch.plan.plan import ExecutionPlan, build_plan

__all__ = ["ExecutionPlan", "MeshSpec", "PLAN_PIPELINE", "PlanIR",
           "StagePlacement", "assign_stage_slices", "build_plan",
           "calibrate_mlp_shifts", "stack_depth"]
