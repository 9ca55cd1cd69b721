"""Project emission: render the resolved IR into executable form.

On AIE hardware this stage instantiates C++ templates into a Vitis project.
In the port, "emission" builds the executable graph directly: a chain of
fused quantized linear calls on one torch device whose two execution modes
mirror the paper's simulation flow —

  * ``mode="x86"``  — the plain torch version per layer (functional sim)
  * ``mode="aie"``  — the qmatmul kernel per layer (the CUDA kernel on the
                      card; the plain version for a model on the CPU)

Both are bit-exact. ``predict()`` accepts float arrays and (optionally)
quantizes inputs / dequantizes outputs, matching the paper's toolflow
(Sec. IV-B). The integer chain stays on the model's device from the input
quantization to the output dequantization.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import torch

from repro_torch.core.ir import Graph
from repro_torch.core.passes import CompileConfig, run_passes
from repro_torch.kernels.qmatmul.ops import qlinear
from repro_torch.kernels.qmatmul.ref import qlinear_ref
from repro_torch.quant.srs import INT_RANGE, TORCH_DTYPES

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a model runs on: the card unless the caller names another.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and none is present; it never runs on the CPU instead.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain torch version"
        )
    return dev


@dataclasses.dataclass
class LayerExec:
    name: str
    weight: torch.Tensor           # padded quantized weight (K_pad, N_pad)
    bias: Optional[torch.Tensor]   # (N_pad,) int32
    srs_shift: int
    relu: bool
    out_dtype: str
    rounding: str
    f_in: int
    f_out: int


class EmittedModel:
    """The generated 'AIE project': executable, introspectable."""

    def __init__(self, graph: Graph, device: DeviceLike = None):
        dev = resolve_device(device)
        layers = []
        for node in graph.compute_nodes():
            q = node.quant
            bias = None
            if q["bias_q"] is not None:
                bias = torch.as_tensor(node.packed["bias_padded"]).to(
                    dev, torch.int32)
            layers.append(
                LayerExec(
                    name=node.name,
                    weight=torch.as_tensor(node.packed["weight_padded"]).to(dev),
                    bias=bias,
                    srs_shift=q["srs_shift"],
                    relu=bool(node.params.get("relu", False)),
                    out_dtype=q["a_dtype"],
                    rounding=q["rounding"],
                    f_in=graph.predecessors(node.name)[0].out_spec.features,
                    f_out=node.out_spec.features,
                )
            )
        self._bind(
            graph, layers, dev,
            in_shift=graph.inputs()[0].quant["shift"],
            in_dtype=graph.inputs()[0].quant["dtype"],
            out_shift=graph.outputs()[0].out_spec.shift,
        )

    @classmethod
    def from_layers(cls, layers: List[LayerExec], device: torch.device, *,
                    in_shift: int, in_dtype: str,
                    out_shift: int) -> "EmittedModel":
        """A model over ready layers, without a graph (no introspection)."""
        model = cls.__new__(cls)
        model._bind(None, layers, device, in_shift=in_shift,
                    in_dtype=in_dtype, out_shift=out_shift)
        return model

    def _bind(self, graph, layers, device, *, in_shift, in_dtype, out_shift):
        self.graph = graph
        self.layers: List[LayerExec] = layers
        self.device = device
        self.in_shift = in_shift
        self.in_dtype = in_dtype
        self.out_shift = out_shift

    # -- execution ----------------------------------------------------------

    def _run_int(self, x_q: torch.Tensor, mode: str) -> torch.Tensor:
        h = x_q
        fn = qlinear if mode == "aie" else qlinear_ref
        for layer in self.layers:
            # pad activations into the zero-padded feature space (the
            # memory-tile zero-padding role)
            k_pad = layer.weight.shape[0]
            if h.shape[-1] < k_pad:
                h = torch.nn.functional.pad(h, (0, k_pad - h.shape[-1]))
            h = fn(
                h, layer.weight, layer.bias,
                shift=layer.srs_shift, relu=layer.relu,
                out_dtype=layer.out_dtype, rounding=layer.rounding,
            )
        # strip final padding back to logical features
        return h[:, : self.layers[-1].f_out]

    def predict(
        self,
        x,
        mode: str = "x86",
        quantize_input: bool = True,
        dequantize_output: bool = True,
    ) -> torch.Tensor:
        """hls4ml-style predict() over float (or pre-quantized int) inputs.

        ``x`` is an array or tensor of shape (batch, f_in); the result is a
        tensor on the model's device (float32 when dequantized).
        """
        if mode not in ("x86", "aie"):
            raise ValueError(f"unknown mode {mode!r}")
        if quantize_input:
            lo, hi = INT_RANGE[self.in_dtype]
            # float32 multiply by a power of two, round half to even, clip:
            # the reference's order and precision
            xf = torch.as_tensor(x, dtype=torch.float32, device=self.device)
            xq = torch.clamp(torch.round(xf * (2.0**self.in_shift)), lo, hi)
            xq = xq.to(TORCH_DTYPES[self.in_dtype])
        else:
            xq = torch.as_tensor(x, device=self.device)
        y = self._run_int(xq.contiguous(), mode)
        if dequantize_output:
            return y.to(torch.float32) * (2.0 ** (-self.out_shift))
        return y

    # -- introspection (benchmarks read these) -------------------------------

    @property
    def tiles_used(self) -> int:
        return self.graph.meta["tiles_used"]

    @property
    def memtile_bytes(self) -> int:
        return self.graph.meta.get("memtile_bytes", 0)

    @property
    def placement_cost(self) -> float:
        return self.graph.meta["placement_cost"]

    def placements(self) -> Dict[str, tuple]:
        return {
            n.name: (n.place.col, n.place.row, n.place.width, n.place.height)
            for n in self.graph.compute_nodes()
        }

    def estimated_cycles(self, batch: int) -> float:
        """Analytical cycle estimate for one inference at the given batch,
        assuming perfectly pipelined layers (throughput = slowest layer)."""
        dev = self.graph.meta["device"]
        worst = 0.0
        for node in self.graph.compute_nodes():
            c = node.cascade
            q = node.quant
            pred = self.graph.predecessors(node.name)[0]
            cyc = dev.kernel_cycles(
                batch, c.f_in_slice, c.f_out_slice,
                pred.out_spec.dtype, q["w_dtype"],
                use_bias=q["bias_q"] is not None,
                use_relu=bool(node.params.get("relu", False)),
            )
            worst = max(worst, cyc)
        return worst


def compile_graph(
    graph: Graph, config: Optional[CompileConfig] = None,
    device: DeviceLike = None,
) -> EmittedModel:
    """The full paper pipeline: passes + emission onto ``device``."""
    dev = resolve_device(device)  # fail before the passes, not after
    run_passes(graph, config)
    return EmittedModel(graph, dev)
