"""Distributed layout: logical-axis sharding over a torch ``DeviceMesh``.

``repro_torch.dist.sharding`` resolves the logical axis names of every
parameter ("fsdp", "col_out", "experts", ...) to mesh axes ("pod",
"data", "model") and to DTensor placements.
"""

from repro_torch.dist.sharding import (
    MODES,
    ParamSpec,
    PartitionSpec,
    ShardingRules,
    fit_pspec,
    logical_to_pspec,
    mesh_axis_sizes,
    pspec_to_placements,
    rules_for_mode,
    spec_to_pspec,
    specs_to_placements,
)

__all__ = [
    "MODES",
    "ParamSpec",
    "PartitionSpec",
    "ShardingRules",
    "fit_pspec",
    "logical_to_pspec",
    "mesh_axis_sizes",
    "pspec_to_placements",
    "rules_for_mode",
    "spec_to_pspec",
    "specs_to_placements",
]
