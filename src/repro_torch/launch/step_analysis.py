"""Work analysis of one eager step, for the roofline report (the port's
counterpart of the reference's ``repro.launch.hlo_analysis``).

The reference parses a compiled XLA module and scales while-loop bodies by
their trip counts. An eager torch step has no module: it is the sequence
of ATen ops it dispatches, loops unrolled. :func:`analyze_step` runs the
step once under a ``TorchDispatchMode`` and counts, per card:

  * flops            -- 2 * |result| * contraction for every product op
                        (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``_int_mm``,
                        their ``out_dtype`` forms and convolutions), classed
                        by the dtype of the operands
                        (``flops_by_dtype``), since each class has its own
                        peak on the card
  * bytes            -- for every op that writes a tensor, its inputs read
                        once and its outputs written once; views are free
                        (``view``, a ``reshape`` without a copy, ``slice``,
                        ``expand``, ``transpose``, ``as_strided``). An
                        indexed read (``index``, ``index_select``,
                        ``embedding``, ``gather``) reads only the rows it
                        returns, and an in-place indexed write
                        (``index_put_``, ``index_add_``, ``scatter_``...)
                        moves only the rows it updates.
  * collective_bytes -- wire bytes per card of every functional collective
                        (``_c10d_functional``) the step issues, with the
                        reference's ring factors for a group of G ranks:
                        all-gather result * (G-1)/G, reduce-scatter
                        result * (G-1), all-reduce result * 2(G-1)/G,
                        all-to-all result * (G-1)/G; 0 on one card

On a mesh the step's DTensor ops are counted as each rank runs them: the
mode lets DTensor desugar every op into its local ops and collectives
(as ``CommDebugMode`` does), so the flops and bytes are one rank's, at
its local shapes, and the collectives are the ones it joins.

Bytes diverge from the reference's on purpose. The reference leaves
elementwise ops out, because the TPU fuses them into their neighbours. On
the card eager torch runs each elementwise op as a kernel of its own, which
reads and writes device memory, so the port counts them.

The port's two hand-written kernels launch through ``ctypes``, which a
dispatch mode cannot see. Their wrappers report each call's analytic work
(``repro_torch.kernels.Work``) to the active analysis instead, and the
ops inside a wrapper (the plain version's on the CPU, the allocations on
the card) are not counted: the same step counts alike on the CPU and on
the card, up to the dtype class of products the CPU runs upcast.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels

aten = torch.ops.aten

_DTYPE_CLASS = {
    torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32",
    torch.float64: "fp64", torch.int8: "int8", torch.uint8: "int8",
    torch.float8_e4m3fn: "fp8", torch.float8_e5m2: "fp8",
}

# products: (flops of one call from its tensor arguments)
_MM = {aten.mm, aten.addmm, aten._int_mm}
_BMM = {aten.bmm, aten.baddbmm}
# ops that return a tensor but move nothing: allocation and aliasing
_FREE = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten._unsafe_view, aten.alias, aten.detach,
    aten.lift_fresh, aten.set_, aten.resize_,
}
# ops that write self without reading it
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_,
               aten.uniform_, aten.random_, aten.bernoulli_,
               aten.exponential_}
# indexed reads: the source (first argument) is read where indexed only
_INDEXED_READS = {aten.index, aten.index_select, aten.gather,
                  aten.embedding, aten._unsafe_index}
# in-place indexed writes: (position of the values written, whether the
# destination's updated rows are read too)
_INDEXED_WRITES = {
    aten.index_put_: (2, True), aten._index_put_impl_: (2, True),
    aten.index_add_: (3, True), aten.index_copy_: (3, False),
    aten.scatter_: (3, False), aten.scatter_add_: (3, True),
    aten.scatter_reduce_: (3, True),
}


@dataclasses.dataclass
class Stats:
    """Per-card totals of one step (the reference's ``Stats`` fields, plus
    ``flops_by_dtype`` and the kernel calls the wrappers reported)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    per_collective: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    kernel_launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add_flops(self, flops: float, dtype: str) -> None:
        self.flops += flops
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) \
            + flops


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def dtype_class(t: torch.Tensor) -> str:
    """The peak class of a product over ``t``: its dtype, or "tf32" for
    fp32 on the card while torch lets cuBLAS use TF32."""
    cls = _DTYPE_CLASS.get(t.dtype, str(t.dtype).removeprefix("torch."))
    if cls == "fp32" and t.is_cuda \
            and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return cls


def _product_flops(packet, args) -> float:
    """2 * |result| * contraction of one product op, or 0 for any other."""
    if packet in _MM:
        a, b = (args[1], args[2]) if packet is aten.addmm else args[:2]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in _BMM:
        a, b = (args[1], args[2]) if packet is aten.baddbmm else args[:2]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet is aten.convolution:
        x, w, transposed = args[0], args[1], args[6]
        taps = w.shape[1] * math.prod(w.shape[2:])
        if transposed:
            # w [C_in, C_out / groups, *k]: each input element meets taps
            return 2.0 * x.numel() * taps
        # w [C_out, C_in / groups, *k]: each output element sums taps
        return 2.0 * x.shape[0] * w.shape[0] * _conv_out_elems(x, w, args) \
            * taps
    return 0.0


def _conv_out_elems(x, w, args) -> int:
    stride, padding, dilation = args[3], args[4], args[5]
    n = 1
    for i, size in enumerate(x.shape[2:]):
        k = w.shape[2 + i]
        n *= (size + 2 * padding[i] - dilation[i] * (k - 1) - 1) \
            // stride[i] + 1
    return n


# functional collectives: (wire factor of the result bytes for a group of
# G ranks, the reference's name of the collective)
_COLLECTIVES = {
    "all_gather_into_tensor": (lambda g: (g - 1) / g, "all-gather"),
    "reduce_scatter_tensor": (lambda g: g - 1, "reduce-scatter"),
    "all_reduce": (lambda g: 2 * (g - 1) / g, "all-reduce"),
    "all_to_all_single": (lambda g: (g - 1) / g, "all-to-all"),
}


def _group_size(args) -> int:
    """The size of the process group a functional collective names (its
    last string argument; an all-reduce's reduce op comes before it)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class _Analysis(TorchDispatchMode):
    """The dispatch mode of :func:`analyze_step`; also the sink the kernel
    wrappers report to (``kernels.active_analysis``)."""

    def __init__(self):
        super().__init__()
        self.stats = Stats()
        self._hidden = 0

    @contextlib.contextmanager
    def hidden(self) -> Iterator[None]:
        """Count nothing dispatched inside the body."""
        self._hidden += 1
        try:
            yield
        finally:
            self._hidden -= 1

    def kernel(self, name: str, work: kernels.Work) -> None:
        st = self.stats
        st.add_flops(work.ops, work.dtype)
        st.bytes += work.bytes
        st.kernel_launches[name] = st.kernel_launches.get(name, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            # let DTensor run it: its local ops and collectives come back
            # here, each at one rank's shapes
            return NotImplemented
        kwargs = kwargs or {}
        # a composite op (matmul, einsum, reshape, to) reaches the mode
        # undecomposed where autograd does not run (no_grad, inference):
        # decompose it here, so that its parts are counted
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _collective(self, func, args, out) -> bool:
        """Count a functional collective's wire bytes; False for any other
        op."""
        if func.namespace != "_c10d_functional":
            return False
        entry = _COLLECTIVES.get(func.overloadpacket.__name__)
        if entry is not None:
            factor, name = entry
            wire = sum(_nbytes(o) for o in _tensors(out)) \
                * factor(_group_size(args))
            st = self.stats
            st.collective_bytes += wire
            st.per_collective[name] = st.per_collective.get(name, 0.0) \
                + wire
            st.collective_ops[name] = st.collective_ops.get(name, 0) + 1
        return True                     # wait_tensor & co: no work

    def _count(self, func, args, kwargs, out) -> None:
        if self._collective(func, args, out):
            return
        packet = func.overloadpacket
        flops = _product_flops(packet, args)
        if flops:
            operand = args[1] if packet in (aten.addmm,
                                            aten.baddbmm) else args[0]
            self.stats.add_flops(flops, dtype_class(operand))
        if func.is_view or packet in _FREE:
            return
        outs = _tensors(out)
        if not outs:
            return
        if packet in _INDEXED_WRITES:
            self.stats.bytes += self._indexed_write(packet, args, kwargs)
            return
        reads = {}
        for i, t in enumerate(_tensors((args, kwargs))):
            reads.setdefault(id(t), (i, t))
        total = sum(_nbytes(o) for o in outs)
        for i, t in reads.values():
            if i == 0 and packet in _WRITE_ONLY:
                continue
            if i == 0 and packet in _INDEXED_READS:
                total += sum(_nbytes(o) for o in outs)
                continue
            total += _nbytes(t)
        self.stats.bytes += total

    @staticmethod
    def _indexed_write(packet, args, kwargs) -> float:
        """Bytes of an in-place indexed write: the indices and the values
        read, and the updated rows of the destination written (and read,
        where the op accumulates)."""
        pos, reads_dest = _INDEXED_WRITES[packet]
        dest = args[0]
        values = args[pos] if len(args) > pos else None
        indices = _tensors(args[1:pos])
        if isinstance(values, torch.Tensor):
            moved = _nbytes(values)
            region = values.numel() * dest.element_size()
        else:                      # a scalar written at every index
            moved = 0
            region = sum(t.numel() for t in indices) * dest.element_size()
        return (sum(_nbytes(t) for t in indices) + moved + region
                + (region if reads_dest else 0))


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, type) and issubclass(t, DTensor)


def analyze_step(fn: Callable[..., Any], *args: Any,
                 **kw: Any) -> Tuple[Any, Stats]:
    """Run ``fn(*args, **kw)`` once and return ``(its result, Stats)``:
    the work of every op it dispatched and of every kernel call its
    wrappers reported. The mode costs host time per op: do not time the
    analysed call."""
    if kernels.active_analysis is not None:
        raise RuntimeError("analyze_step does not nest")
    analysis = _Analysis()
    kernels.active_analysis = analysis
    try:
        with analysis:
            result = fn(*args, **kw)
    finally:
        kernels.active_analysis = None
    return result, analysis.stats
