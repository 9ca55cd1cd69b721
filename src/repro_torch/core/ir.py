"""AIE4ML intermediate representation.

The IR is a small SSA-ish graph of named nodes. Each node carries an op kind,
its tensor specification, and attribute namespaces that the pass pipeline
progressively populates (quantization, tiling, cascade parallelism, packing,
graph-plan edges, placement). User-supplied directives land in
``node.overrides`` and are honored by every pass ("inferred attributes can be
overridden by the user configuration").

This mirrors the paper's Fig. 2 pipeline: the hls4ml graph is lowered into
this representation, and every later stage is a pass over it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


class OpKind:
    INPUT = "input"
    DENSE = "dense"          # linear layer, optionally with fused bias/relu
    RELU = "relu"            # standalone (gets fused by the Lower pass)
    RESHAPE = "reshape"
    OUTPUT = "output"


@dataclasses.dataclass
class TensorSpec:
    """Logical tensor: shape is (batch, features) after lowering."""

    shape: tuple
    dtype: str = "float32"
    shift: int = 0  # binary point for integer dtypes

    @property
    def features(self) -> int:
        return int(self.shape[-1])


@dataclasses.dataclass
class CascadeSpec:
    """The paper's CAS_LEN x CAS_NUM rectangle for one layer.

    cas_len tiles split the contraction (input-feature) dimension; cas_num
    rows split the output features. f_in_slice / f_out_slice are the
    per-tile local dimensions.
    """

    cas_len: int = 1
    cas_num: int = 1
    f_in_slice: int = 0
    f_out_slice: int = 0

    @property
    def n_tiles(self) -> int:
        return self.cas_len * self.cas_num


@dataclasses.dataclass
class PlacementSpec:
    """Block placement on the 2D array: lower-left corner + extent."""

    col: int = -1
    row: int = -1
    width: int = 0
    height: int = 0

    @property
    def c_in(self) -> int:
        return self.col  # inputs broadcast up the leftmost column

    @property
    def c_out(self) -> int:
        return self.col + self.width - 1  # cascades exit east

    @property
    def r_in(self) -> int:
        return self.row

    @property
    def r_out(self) -> int:
        return self.row

    @property
    def r_top(self) -> int:
        return self.row + self.height - 1


@dataclasses.dataclass
class MemTileEdge:
    """A memory-tile connection between two layer graphs (GraphPlan pass).

    Writer and reader tilings may differ — the memory tile re-tiles the
    activation stream between layers (paper Sec. III-C).
    """

    src: str
    dst: str
    buffer_shape: tuple
    write_tiling: tuple  # (M, N) tiles produced by src
    read_tiling: tuple   # (M, K) tiles consumed by dst
    zero_pad: tuple = (0, 0)
    dtype: str = "int8"
    double_buffered: bool = True

    @property
    def buffer_bytes(self) -> int:
        elt = {"int8": 1, "int16": 2, "int32": 4, "float32": 4, "bfloat16": 2}[
            self.dtype
        ]
        n = int(np.prod(self.buffer_shape)) * elt
        return 2 * n if self.double_buffered else n


@dataclasses.dataclass
class Node:
    name: str
    op: str
    inputs: List[str] = dataclasses.field(default_factory=list)
    out_spec: Optional[TensorSpec] = None
    # op payload (weights/bias as numpy, activation flags, ...)
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # user directives, honored by passes
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # pass-populated namespaces
    quant: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tile: Dict[str, Any] = dataclasses.field(default_factory=dict)
    cascade: Optional[CascadeSpec] = None
    packed: Dict[str, Any] = dataclasses.field(default_factory=dict)
    place: Optional[PlacementSpec] = None

    def __repr__(self) -> str:  # keep graph dumps readable
        return f"Node({self.name}:{self.op}->{self.out_spec})"


class Graph:
    """Ordered DAG of nodes (insertion order is topological by construction)."""

    def __init__(self, name: str = "model"):
        self.name = name
        self.nodes: Dict[str, Node] = {}
        self.memtile_edges: List[MemTileEdge] = []
        self.meta: Dict[str, Any] = {}

    def add(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name}")
        for i in node.inputs:
            if i not in self.nodes:
                raise ValueError(f"node {node.name} references unknown input {i}")
        self.nodes[node.name] = node
        return node

    def __iter__(self):
        return iter(self.nodes.values())

    def __getitem__(self, name: str) -> Node:
        return self.nodes[name]

    def __len__(self) -> int:
        return len(self.nodes)

    def predecessors(self, name: str) -> List[Node]:
        return [self.nodes[i] for i in self.nodes[name].inputs]

    def successors(self, name: str) -> List[Node]:
        return [n for n in self.nodes.values() if name in n.inputs]

    def inputs(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.op == OpKind.INPUT]

    def outputs(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.op == OpKind.OUTPUT]

    def compute_nodes(self) -> List[Node]:
        return [n for n in self.nodes.values() if n.op == OpKind.DENSE]

    def remove(self, name: str) -> None:
        if self.successors(name):
            raise ValueError(f"cannot remove {name}: has successors")
        del self.nodes[name]

    def rewire(self, old: str, new: str) -> None:
        """Point every consumer of ``old`` at ``new``."""
        for n in self.nodes.values():
            n.inputs = [new if i == old else i for i in n.inputs]

    def validate(self) -> None:
        seen = set()
        for n in self.nodes.values():
            for i in n.inputs:
                if i not in seen:
                    raise ValueError(f"{n.name} uses {i} before definition")
            seen.add(n.name)


# ---------------------------------------------------------------------------
# Frontend builders (the hls4ml-parser role). We accept a simple layer-list
# description — the same information hls4ml's IR would hand us.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DenseSpec:
    """Frontend description of one linear layer."""

    f_out: int
    weight: Optional[np.ndarray] = None  # (f_in, f_out)
    bias: Optional[np.ndarray] = None    # (f_out,)
    activation: Optional[str] = None     # None | "relu"
    name: Optional[str] = None


def build_mlp_graph(
    batch: int,
    f_in: int,
    layers: List[DenseSpec],
    name: str = "mlp",
    seed: int = 0,
) -> Graph:
    """Build a frontend graph for an MLP. Missing weights are sampled
    deterministically (benchmarks and dry-runs use this)."""
    rng = np.random.default_rng(seed)
    g = Graph(name)
    g.add(Node("x", OpKind.INPUT, out_spec=TensorSpec((batch, f_in))))
    prev, prev_f = "x", f_in
    for li, spec in enumerate(layers):
        lname = spec.name or f"dense_{li}"
        w = spec.weight
        if w is None:
            w = rng.standard_normal((prev_f, spec.f_out)) / np.sqrt(prev_f)
        if w.shape != (prev_f, spec.f_out):
            raise ValueError(
                f"{lname}: weight shape {w.shape} != ({prev_f},{spec.f_out})"
            )
        params = {"weight": np.asarray(w, np.float64)}
        if spec.bias is not None:
            params["bias"] = np.asarray(spec.bias, np.float64)
        node = Node(
            lname,
            OpKind.DENSE,
            inputs=[prev],
            out_spec=TensorSpec((batch, spec.f_out)),
            params=params,
        )
        g.add(node)
        if spec.activation == "relu":
            rname = f"{lname}_relu"
            g.add(
                Node(
                    rname,
                    OpKind.RELU,
                    inputs=[lname],
                    out_spec=TensorSpec((batch, spec.f_out)),
                )
            )
            prev = rname
        else:
            prev = lname
        prev_f = spec.f_out
    g.add(Node("y", OpKind.OUTPUT, inputs=[prev], out_spec=TensorSpec((batch, prev_f))))
    g.validate()
    return g
