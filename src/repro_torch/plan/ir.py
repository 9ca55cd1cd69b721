"""PlanIR: the record every compile-plan pass enriches.

Each pass writes what it decided (the device, the mesh's axes, the rule
table, every parameter's PartitionSpec, the stage placements, the
quantization shifts, the step catalogue) and appends it to
``decisions``, which ``ExecutionPlan.describe()`` replays.

``MeshSpec`` is a declarative mesh description. Nothing here builds a
``DeviceMesh`` or starts a process group: the ResolveMesh pass reads the
axis sizes alone, and :meth:`MeshSpec.build` runs only when the plan must
place a tensor (``ExecutionPlan.param_placements`` / ``shard_params``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.dist.sharding import mesh_axis_sizes
from repro_torch.launch.mesh import (
    MULTI_POD,
    PRODUCTION,
    make_debug_mesh,
    make_production_mesh,
)
from repro_torch.models.base import ArchConfig, ShapeSpec


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh description (resolved by the ResolveMesh pass).

    ``from_mesh`` wraps an already-built mesh: a ``DeviceMesh``, or any
    object with ``axis_names`` and a ``devices`` array (tests).
    """

    kind: str = "debug"                  # "debug" | "production" | "explicit"
    data: int = 1                        # debug: data-axis extent
    model: int = 1                       # debug: model-axis extent
    multi_pod: bool = False              # production: 2x16x16 vs 16x16
    mesh: Optional[Any] = None           # explicit: a prebuilt mesh

    @classmethod
    def debug(cls, data: int = 1, model: int = 1) -> "MeshSpec":
        return cls(kind="debug", data=data, model=model)

    @classmethod
    def production(cls, multi_pod: bool = False) -> "MeshSpec":
        return cls(kind="production", multi_pod=multi_pod)

    @classmethod
    def from_mesh(cls, mesh) -> "MeshSpec":
        return cls(kind="explicit", mesh=mesh)

    def axis_sizes(self) -> Dict[str, int]:
        """``{axis: size}`` in mesh-dim order, without building anything."""
        if self.kind == "debug":
            return {"data": self.data, "model": self.model}
        if self.kind == "production":
            names = ("pod", "data", "model") if self.multi_pod \
                else ("data", "model")
            return dict(zip(names, MULTI_POD if self.multi_pod
                            else PRODUCTION))
        if self.kind == "explicit":
            if self.mesh is None:
                raise ValueError("explicit MeshSpec needs a mesh")
            return mesh_axis_sizes(self.mesh)
        raise ValueError(f"unknown MeshSpec kind {self.kind!r}")

    def build(self, device=None):
        """The ``DeviceMesh`` (the only call that starts a process group);
        an explicit spec returns its mesh."""
        if self.kind == "explicit":
            if self.mesh is None:
                raise ValueError("explicit MeshSpec needs a mesh")
            return self.mesh
        if self.kind == "debug":
            return make_debug_mesh(self.data, self.model, device=device)
        if self.kind == "production":
            return make_production_mesh(multi_pod=self.multi_pod,
                                        device=device)
        raise ValueError(f"unknown MeshSpec kind {self.kind!r}")

    def label(self) -> str:
        if self.kind == "debug":
            return f"debug:{self.data}x{self.model}"
        if self.kind == "production":
            return "production:2x16x16" if self.multi_pod \
                else "production:16x16"
        if self.mesh is None:
            return "explicit:?"
        return "explicit:" + "x".join(
            str(s) for s in mesh_axis_sizes(self.mesh).values())


@dataclasses.dataclass(frozen=True)
class StagePlacement:
    """One pipeline stage's layer range and its mesh-slice rectangle.

    The rectangle lives on the (model, data) grid the PlaceStages pass
    hands to ``core.placement.Placer``: ``col``/``width`` span the model
    axis, ``row``/``height`` span the stage (data) axis.
    """

    index: int
    first_layer: int
    n_layers: int
    col: int
    row: int
    width: int
    height: int

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PlanIR:
    """The one record the plan passes consume and enrich: the request
    first, then every field a pass fills in, then the ordered
    ``decisions`` log."""

    # -- request ------------------------------------------------------------
    cfg: ArchConfig
    shape: Optional[ShapeSpec]           # None: serve plan (bucketed shapes)
    mode: str
    mesh_spec: MeshSpec = dataclasses.field(default_factory=MeshSpec)
    device_request: Any = None           # None: the card
    quantized: bool = False
    pipeline_stages: int = 1

    # -- ResolveDevice ------------------------------------------------------
    device: Optional[torch.device] = None

    # -- ResolveMesh --------------------------------------------------------
    axes: Dict[str, int] = dataclasses.field(default_factory=dict)
    mesh: Optional[Any] = None           # built on first placement

    # -- ResolveSharding ----------------------------------------------------
    rules: Optional[Any] = None          # ShardingRules
    param_pspecs: Dict[str, str] = dataclasses.field(default_factory=dict)

    # -- PlaceStages --------------------------------------------------------
    stages: List[StagePlacement] = dataclasses.field(default_factory=list)
    stage_axis: Optional[str] = None     # mesh axis the layers dim shards on
    placement_cost: float = 0.0
    placement_method: str = ""

    # -- Quantize -----------------------------------------------------------
    quant: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- Compile ------------------------------------------------------------
    executables: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)

    # -- audit trail --------------------------------------------------------
    decisions: List[Tuple[str, Dict[str, Any]]] = dataclasses.field(
        default_factory=list)

    def record(self, pass_name: str, **entry: Any) -> None:
        self.decisions.append((pass_name, entry))

    def pass_names(self) -> List[str]:
        return [name for name, _ in self.decisions]
