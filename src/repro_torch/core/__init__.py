"""AIE4ML core: the paper's compiler (IR, passes, placement, emission)."""

from repro_torch.core.device import AIEMLDevice, NATIVE_TILINGS
from repro_torch.core.ir import (
    Graph,
    Node,
    OpKind,
    TensorSpec,
    CascadeSpec,
    PlacementSpec,
    MemTileEdge,
    DenseSpec,
    build_mlp_graph,
)
from repro_torch.core.passes import CompileConfig, run_passes
from repro_torch.core.placement import Block, Placer, placement_cost
from repro_torch.core.emit import EmittedModel, compile_graph

__all__ = [
    "AIEMLDevice",
    "NATIVE_TILINGS",
    "Graph",
    "Node",
    "OpKind",
    "TensorSpec",
    "CascadeSpec",
    "PlacementSpec",
    "MemTileEdge",
    "DenseSpec",
    "build_mlp_graph",
    "CompileConfig",
    "run_passes",
    "Block",
    "Placer",
    "placement_cost",
    "EmittedModel",
    "compile_graph",
]
