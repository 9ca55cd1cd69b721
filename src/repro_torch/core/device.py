"""Device models: the AMD Versal AIE-ML array and the port's GPU target.

``AIEMLDevice`` is an analytical model of the array (VEK280: 304 compute
tiles on a 38x8 grid plus a row of memory tiles). It reproduces the paper's
Table I single-tile ceilings, drives the cycle model behind
``EmittedModel.estimated_cycles``, and is the geometry the branch-and-bound
placer works on. A copy of the AIE part of ``repro.core.device``.

``H100Target`` holds the roofline constants of the card the port runs on,
in the role the reference's TPU target plays for its roofline.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


# --------------------------------------------------------------------------
# AIE-ML analytical model (paper Table I geometry and ceilings)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MmulTiling:
    """A native aie::mmul <M,K,N> tiling for a given precision pair."""

    M: int
    K: int
    N: int
    dt_a: str
    dt_b: str
    macs_per_cycle: int
    native: bool = True

    @property
    def macs_per_tile(self) -> int:
        return self.M * self.K * self.N

    @property
    def cycles_per_mmul(self) -> float:
        """Cycles for one tile-level multiply at the VMAC issue rate."""
        return self.macs_per_tile / self.macs_per_cycle


# The representative native tilings from paper Table I.
NATIVE_TILINGS: Dict[Tuple[str, str], MmulTiling] = {
    ("int8", "int8"): MmulTiling(4, 8, 8, "int8", "int8", 256),
    ("int16", "int8"): MmulTiling(4, 4, 8, "int16", "int8", 128),
    ("int16", "int16"): MmulTiling(4, 4, 4, "int16", "int16", 64),
}


@dataclasses.dataclass(frozen=True)
class AIEMLDevice:
    """AMD Versal AIE-ML array (VEK280-class) analytical model."""

    n_cols: int = 38
    n_rows: int = 8
    clock_hz: float = 1.25e9
    local_mem_bytes: int = 64 * 1024     # per compute tile
    memtile_bytes: int = 512 * 1024      # per memory tile (row of 38)
    n_memtiles: int = 38
    load_ports: int = 2                  # 256-bit loads per cycle
    load_bits: int = 256
    store_bits: int = 256
    cascade_bits: int = 512              # west->east partial-sum port
    # Calibrated per-macro-step overheads of the 2x2 blocked kernel schedule
    # (fit to paper Table II; see benchmarks/table2_single_kernel.py):
    overhead_base_cycles: float = 3.0        # loop/SRS/store epilogue per macro step
    overhead_bias_relu_cycles: float = 15.0  # + bias prologue + ReLU epilogue
    startup_cycles: float = 120.0            # kernel prologue (first loads, acc init)

    @property
    def n_tiles(self) -> int:
        return self.n_cols * self.n_rows

    # -- Table I -----------------------------------------------------------

    def peak_macs_per_s(self, dt_a: str, dt_b: str) -> float:
        return NATIVE_TILINGS[(dt_a, dt_b)].macs_per_cycle * self.clock_hz

    def peak_gops(self, dt_a: str, dt_b: str) -> float:
        """GOP/s counting one MAC as 2 ops (paper Table I convention)."""
        return 2.0 * self.peak_macs_per_s(dt_a, dt_b) / 1e9

    def memory_bound_macs_per_cycle(self, bytes_per_element: int) -> float:
        """MAC/cycle ceiling with zero reuse: limited by the two load ports."""
        bytes_per_cycle = self.load_ports * self.load_bits // 8
        return bytes_per_cycle / (2.0 * bytes_per_element)

    # -- cycle model for the 2x2 blocked kernel (paper Sec. III-A) ----------

    def kernel_cycles(
        self,
        batch: int,
        f_in: int,
        f_out: int,
        dt_a: str = "int8",
        dt_b: str = "int8",
        use_bias: bool = False,
        use_relu: bool = False,
    ) -> float:
        """Estimated cycles for C[batch, f_out] = A[batch, f_in] @ W.

        The 2x2 accumulator scheme walks macro steps of (2 M-tiles x 2
        N-tiles); each macro step runs k_tiles iterations issuing 4 VMACs.
        Steady state is VMAC-bound (4 loads fit in 2 cycles on 2 ports while
        4 VMACs take 4 cycles), so cycles ~= total_macs / macs_per_cycle plus
        per-macro-step prologue/epilogue overhead.
        """
        t = NATIVE_TILINGS[(dt_a, dt_b)]
        m_tiles = -(-batch // t.M)
        k_tiles = -(-f_in // t.K)
        n_tiles = -(-f_out // t.N)
        macro_steps = -(-m_tiles // 2) * -(-n_tiles // 2)
        steady = macro_steps * k_tiles * 4 * t.cycles_per_mmul
        overhead = self.overhead_base_cycles
        if use_bias or use_relu:
            overhead += self.overhead_bias_relu_cycles
        return self.startup_cycles + steady + macro_steps * overhead

    def kernel_gops(self, batch, f_in, f_out, dt_a="int8", dt_b="int8",
                    use_bias=False, use_relu=False) -> float:
        cycles = self.kernel_cycles(batch, f_in, f_out, dt_a, dt_b,
                                    use_bias=use_bias, use_relu=use_relu)
        ops = 2.0 * batch * f_in * f_out
        return ops / (cycles / self.clock_hz) / 1e9

    def kernel_latency_s(self, batch, f_in, f_out, dt_a="int8", dt_b="int8",
                         use_bias=False, use_relu=False) -> float:
        cycles = self.kernel_cycles(batch, f_in, f_out, dt_a, dt_b,
                                    use_bias=use_bias, use_relu=use_relu)
        return cycles / self.clock_hz


# --------------------------------------------------------------------------
# NVIDIA H100 roofline target
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class H100Target:
    """Roofline constants of one NVIDIA H100 SXM5 80 GB, from NVIDIA's H100
    Tensor Core GPU data sheet: the SXM variant at its 700 W maximum power,
    dense tensor-core rates (without structured sparsity). A card set below
    700 W (``nvidia-smi --query-gpu=power.limit``) runs slower under load.

    ``fp32`` is the rate outside the tensor cores (torch's default for
    fp32 products: TF32 off); ``tf32`` is the tensor cores' fp32 mode."""

    peak_flops_bf16: float = 989e12     # FLOP/s, also fp16
    peak_flops_fp8: float = 1979e12     # FLOP/s
    peak_ops_int8: float = 1979e12      # OP/s
    peak_flops_tf32: float = 495e12     # FLOP/s
    peak_flops_fp32: float = 67e12      # FLOP/s, CUDA cores
    hbm_bw: float = 3.35e12             # bytes/s, HBM3
    hbm_bytes: int = 80 * 10**9
    nvlink_bw: float = 900e9            # bytes/s per GPU, all links
    power_w: float = 700.0

    def peak(self, dtype: str = "bf16") -> float:
        """The peak rate for operands of class ``dtype`` ("bf16", "fp16",
        "fp8", "int8", "tf32", "fp32")."""
        rates = {"bf16": self.peak_flops_bf16, "fp16": self.peak_flops_bf16,
                 "fp8": self.peak_flops_fp8, "int8": self.peak_ops_int8,
                 "tf32": self.peak_flops_tf32, "fp32": self.peak_flops_fp32}
        if dtype not in rates:
            raise ValueError(f"no H100 peak for {dtype!r}; known: "
                             f"{sorted(rates)}")
        return rates[dtype]

    def compute_time_s(self, flops: float, dtype: str = "bf16") -> float:
        return flops / self.peak(dtype)

    def memory_time_s(self, nbytes: float) -> float:
        return nbytes / self.hbm_bw

    def collective_time_s(self, coll_bytes: float) -> float:
        # a GPU moves its collective bytes over all its NVLink links
        return coll_bytes / self.nvlink_bw

    def bound_s(self, ops: float, nbytes: float,
                dtype: str) -> Tuple[float, str]:
        """The least time for ``ops`` operations of class ``dtype`` that
        move ``nbytes``, and what bounds it ("operations" or "bytes")."""
        t_ops = self.compute_time_s(ops, dtype)
        t_bytes = self.memory_time_s(nbytes)
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                     else "bytes")


DEFAULT_AIE = AIEMLDevice()
DEFAULT_H100 = H100Target()
