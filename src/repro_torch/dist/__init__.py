"""Distributed layout: logical-axis sharding over a torch ``DeviceMesh``.

``repro_torch.dist.sharding`` resolves the logical axis names of every
parameter ("fsdp", "col_out", "experts", ...) to mesh axes ("pod",
"data", "model") and to DTensor placements; ``sharding_ctx`` and
``shard_act`` lay activations out by the same names while a plan runs
sharded (``ExecutionPlan.activate()``).
"""

from repro_torch.dist.sharding import (
    MODES,
    ParamSpec,
    PartitionSpec,
    ShardingRules,
    current_ctx,
    fit_pspec,
    logical_to_pspec,
    mesh_axis_sizes,
    pspec_to_placements,
    rules_for_mode,
    serving_grad_mode,
    shard_act,
    sharded,
    sharding_ctx,
    spec_to_pspec,
    specs_to_placements,
)

__all__ = [
    "MODES",
    "ParamSpec",
    "PartitionSpec",
    "ShardingRules",
    "current_ctx",
    "fit_pspec",
    "logical_to_pspec",
    "mesh_axis_sizes",
    "pspec_to_placements",
    "rules_for_mode",
    "serving_grad_mode",
    "shard_act",
    "sharded",
    "sharding_ctx",
    "spec_to_pspec",
    "specs_to_placements",
]
