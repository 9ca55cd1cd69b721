"""One execution-plan API for one card: the pass pipeline (ResolveDevice
-> Quantize -> Compile), the model it owns and its step catalogue behind
the shared ``ExecutableCache``."""

from repro_torch.plan.ir import PlanIR
from repro_torch.plan.passes import PLAN_PIPELINE, calibrate_mlp_shifts
from repro_torch.plan.plan import ExecutionPlan, build_plan

__all__ = ["ExecutionPlan", "PLAN_PIPELINE", "PlanIR", "build_plan",
           "calibrate_mlp_shifts"]
