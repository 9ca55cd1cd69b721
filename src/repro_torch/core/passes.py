"""The AIE4ML pass pipeline (paper Fig. 2).

    Lower -> Quantize -> Resolve -> Pack -> GraphPlan -> Place -> Emit

Each pass consumes and enriches the IR. Inferred attributes are overridable
via ``node.overrides`` (user configuration directives) and are honored as
hard constraints, exactly as in the paper.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.device import AIEMLDevice, NATIVE_TILINGS, MmulTiling
from repro_torch.core.ir import Graph, MemTileEdge, Node, OpKind
from repro_torch.core.cascade import resolve_cascade
from repro_torch.core.packing import ceil_to, pack_bias, pack_dense_weight
from repro_torch.core.placement import Block, Placer
from repro_torch.quant.qtensor import choose_shift, quantize
from repro_torch.quant.srs import requant_shift

_DTYPE_BYTES = {"int8": 1, "int16": 2, "int32": 4}


@dataclasses.dataclass
class CompileConfig:
    """Framework-level configuration (the hls4ml config-dict role)."""

    a_dtype: str = "int8"          # activation dtype between layers
    w_dtype: str = "int8"          # weight dtype
    acc_dtype: str = "int32"
    in_shift: Optional[int] = None  # binary point of the quantized input
    rounding: str = "half_up"
    # placement heuristics (paper Fig. 3 defaults)
    lam: float = 1.0
    mu: float = 0.05
    beam: Optional[int] = 64
    start: Optional[Tuple[int, int]] = (0, 0)
    device: AIEMLDevice = dataclasses.field(default_factory=AIEMLDevice)
    # optional calibration batch (float) for activation ranges; None = use
    # conservative analytic worst-case bounds (never saturates)
    calib: Optional[np.ndarray] = None


# ---------------------------------------------------------------------------
# 1. Lower: fuse Dense+ReLU, initialize device context
# ---------------------------------------------------------------------------


def lower_pass(g: Graph, cfg: CompileConfig) -> Graph:
    g.meta["device"] = cfg.device
    fused = []
    for node in list(g):
        if node.op != OpKind.RELU:
            continue
        (prod,) = g.predecessors(node.name)
        if prod.op == OpKind.DENSE and len(g.successors(prod.name)) == 1:
            prod.params["relu"] = True
            g.rewire(node.name, prod.name)
            fused.append(node.name)
    for name in fused:
        g.remove(name)
    g.validate()
    return g


# ---------------------------------------------------------------------------
# 2. Quantize: integer dtypes + binary points, bit-exact chain
# ---------------------------------------------------------------------------


def quantize_pass(g: Graph, cfg: CompileConfig) -> Graph:
    # activation ranges: calibration if provided, else analytic worst case
    ranges: Dict[str, float] = {}
    if cfg.calib is not None:
        acts = {g.inputs()[0].name: np.asarray(cfg.calib, np.float64)}
        for node in g:
            if node.op == OpKind.DENSE:
                x = acts[node.inputs[0]]
                y = x @ node.params["weight"]
                if "bias" in node.params:
                    y = y + node.params["bias"]
                if node.params.get("relu"):
                    y = np.maximum(y, 0.0)
                acts[node.name] = y
        ranges = {k: float(np.max(np.abs(v))) if v.size else 1.0
                  for k, v in acts.items()}

    in_node = g.inputs()[0]
    a_dt = in_node.overrides.get("a_dtype", cfg.a_dtype)
    if cfg.in_shift is not None:
        in_shift = cfg.in_shift
    elif cfg.calib is not None:
        fake = np.asarray([ranges[in_node.name]])
        in_shift = choose_shift(fake, a_dt)
    else:
        in_shift = 7 if a_dt == "int8" else 15  # inputs assumed in [-1, 1)
    in_node.quant = {"dtype": a_dt, "shift": in_shift}
    in_node.out_spec.dtype = a_dt
    in_node.out_spec.shift = in_shift

    cur_shift, cur_amax = in_shift, ranges.get(in_node.name, 1.0)
    for node in g:
        if node.op != OpKind.DENSE:
            if node.op == OpKind.OUTPUT:
                src = g.predecessors(node.name)[0]
                node.quant = dict(src.quant)
                node.out_spec.dtype = src.out_spec.dtype
                node.out_spec.shift = src.out_spec.shift
            continue
        w = node.params["weight"]
        w_dt = node.overrides.get("w_dtype", cfg.w_dtype)
        a_out_dt = node.overrides.get("a_dtype", cfg.a_dtype)
        w_shift = node.overrides.get("w_shift", choose_shift(w, w_dt))
        wq = quantize(w, w_dt, w_shift, cfg.rounding)

        # output range -> output shift
        if cfg.calib is not None:
            out_amax = max(ranges.get(node.name, 1.0), 1e-12)
        else:
            colsum = float(np.max(np.sum(np.abs(w), axis=0)))
            out_amax = cur_amax * colsum
            if "bias" in node.params:
                out_amax += float(np.max(np.abs(node.params["bias"])))
            out_amax = max(out_amax, 1e-12)
        out_shift = node.overrides.get(
            "out_shift",
            choose_shift(np.asarray([out_amax]), a_out_dt),
        )
        # SRS shift must be >= 0: out binary point can't exceed acc's
        out_shift = min(out_shift, cur_shift + wq.shift)

        bias_q = None
        if "bias" in node.params:
            # bias is added to the accumulator, so it lives at acc scale
            bias_q = quantize(
                node.params["bias"], "int32", cur_shift + wq.shift,
                cfg.rounding,
            )
        node.quant = {
            "a_dtype": a_out_dt,
            "w_dtype": w_dt,
            "acc_dtype": cfg.acc_dtype,
            "in_shift": cur_shift,
            "w_shift": wq.shift,
            "out_shift": out_shift,
            "srs_shift": requant_shift(cur_shift, wq.shift, out_shift),
            "rounding": cfg.rounding,
            "weight_q": wq.data.numpy(),
            "bias_q": None if bias_q is None else bias_q.data.numpy(),
        }
        node.out_spec.dtype = a_out_dt
        node.out_spec.shift = out_shift
        cur_shift = out_shift
        cur_amax = min(out_amax,
                       (2 ** (8 * _DTYPE_BYTES[a_out_dt] - 1)) / 2**out_shift)
    return g


# ---------------------------------------------------------------------------
# 3. Resolve: tilings + cascade parallelism
# ---------------------------------------------------------------------------


def resolve_pass(g: Graph, cfg: CompileConfig) -> Graph:
    dev: AIEMLDevice = g.meta["device"]
    for node in g.compute_nodes():
        a_dt_in = g.predecessors(node.name)[0].out_spec.dtype
        w_dt = node.quant["w_dtype"]
        key = (a_dt_in, w_dt)
        if key not in NATIVE_TILINGS:
            raise ValueError(f"no native mmul tiling for {key}")
        t: MmulTiling = NATIVE_TILINGS[key]
        node.tile = {"M": t.M, "K": t.K, "N": t.N, "tiling": t}
        f_in = g.predecessors(node.name)[0].out_spec.features
        f_out = node.out_spec.features
        batch = node.out_spec.shape[0]
        node.cascade = resolve_cascade(
            f_in, f_out, t, dev,
            batch=min(batch, 128),
            a_bytes=_DTYPE_BYTES[a_dt_in],
            w_bytes=_DTYPE_BYTES[w_dt],
            overrides=node.overrides,
        )
    total = sum(n.cascade.n_tiles for n in g.compute_nodes())
    if total > dev.n_tiles:
        raise ValueError(
            f"model needs {total} tiles > device has {dev.n_tiles}; "
            "reduce parallelism overrides"
        )
    g.meta["tiles_used"] = total
    return g


# ---------------------------------------------------------------------------
# 4. Pack: tile-format weight/bias layouts (+ zero padding)
# ---------------------------------------------------------------------------


def pack_pass(g: Graph, cfg: CompileConfig) -> Graph:
    for node in g.compute_nodes():
        c = node.cascade
        t: MmulTiling = node.tile["tiling"]
        packed = pack_dense_weight(
            node.quant["weight_q"], c.cas_len, c.cas_num,
            c.f_in_slice, c.f_out_slice, t.K, t.N,
        )
        node.packed = {
            "weight_tiles": packed["packed"],
            "weight_padded": packed["padded"],
            "pad_in": packed["padded"].shape[0] - node.quant["weight_q"].shape[0],
            "pad_out": packed["padded"].shape[1] - node.quant["weight_q"].shape[1],
        }
        if node.quant["bias_q"] is not None:
            b_tiles, b_padded = pack_bias(
                node.quant["bias_q"], c.cas_num, c.f_out_slice
            )
            node.packed["bias_tiles"] = b_tiles
            node.packed["bias_padded"] = b_padded
    return g


# ---------------------------------------------------------------------------
# 5. GraphPlan: memory-tile edges between layer graphs
# ---------------------------------------------------------------------------


def graphplan_pass(g: Graph, cfg: CompileConfig) -> Graph:
    dev: AIEMLDevice = g.meta["device"]
    g.memtile_edges = []
    for node in g.compute_nodes():
        for succ in g.successors(node.name):
            if succ.op not in (OpKind.DENSE, OpKind.OUTPUT):
                continue
            batch = node.out_spec.shape[0]
            n_pad = node.cascade.cas_num * node.cascade.f_out_slice
            write_t = (node.tile["M"], node.tile["N"])
            if succ.op == OpKind.DENSE:
                read_t = (succ.tile["M"], succ.tile["K"])
            else:
                read_t = write_t
            edge = MemTileEdge(
                src=node.name,
                dst=succ.name,
                buffer_shape=(min(batch, 128), n_pad),
                write_tiling=write_t,
                read_tiling=read_t,
                zero_pad=(0, n_pad - node.out_spec.features),
                dtype=node.out_spec.dtype,
                double_buffered=True,
            )
            g.memtile_edges.append(edge)
    total_bytes = sum(e.buffer_bytes for e in g.memtile_edges)
    capacity = dev.n_memtiles * dev.memtile_bytes
    if total_bytes > capacity:
        raise ValueError(
            f"memtile demand {total_bytes}B exceeds capacity {capacity}B"
        )
    g.meta["memtile_bytes"] = total_bytes
    return g


# ---------------------------------------------------------------------------
# 6. Place: branch-and-bound placement on the 2D array
# ---------------------------------------------------------------------------


def place_pass(g: Graph, cfg: CompileConfig) -> Graph:
    dev: AIEMLDevice = g.meta["device"]
    nodes = g.compute_nodes()
    blocks = [
        Block(n.cascade.cas_len, n.cascade.cas_num, n.name) for n in nodes
    ]
    fixed = {
        i: tuple(n.overrides["place"])
        for i, n in enumerate(nodes)
        if "place" in n.overrides
    }
    placer = Placer(dev.n_cols, dev.n_rows, cfg.lam, cfg.mu, cfg.beam)
    result = placer.branch_and_bound(blocks, start=cfg.start, fixed=fixed)
    for node, pos in zip(nodes, result.positions):
        node.place = pos
    g.meta["placement_cost"] = result.cost
    g.meta["placement_expanded"] = result.nodes_expanded
    return g


PIPELINE = [lower_pass, quantize_pass, resolve_pass, pack_pass,
            graphplan_pass, place_pass]


def run_passes(g: Graph, cfg: Optional[CompileConfig] = None) -> Graph:
    cfg = cfg or CompileConfig()
    g.meta["config"] = cfg
    for p in PIPELINE:
        g = p(g, cfg)
    return g
