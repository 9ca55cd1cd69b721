#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Print the card's name and power limit, then build every CUDA kernel of
   the path from the sources in this checkout (one nvcc per source).
2. Hold the qmatmul kernel against its plain torch version on the card with
   ``torch.equal``: the grid of the reference's kernel tests (every shape,
   all three operand pairs, both outputs, all three roundings, shifts 0-12,
   bias and ReLU on and off), the paper models' GEMM shapes, a forced
   int32-wraparound case, and decode-sized M (1, 4, 16, 17) at K = 70 and
   11008 for all three operand pairs with split-K on and off.
3. The main path: compile the five paper models (Table III/V) at their
   published widths with ``build_paper_model(name, device="cuda")`` and
   answer three ``predict(x, "aie")`` requests per model at the Table III
   row counts (mlp_7layer at 1 and at 128 rows). Every answer must equal
   the ``"x86"`` oracle bit for bit, and the kernel's launch counter must
   grow by exactly layers x requests.
4. Timing: each model's median ``predict`` latency with its device time
   split into qmatmul and other ops (torch.profiler), and the kernel's time at
   every path shape beside its bound (H100 SXM int8 peak and memory rate),
   the plain version's time and ``torch._int_mm``'s (a yardstick without
   SRS that the port never calls).
5. Hold the flash-attention kernel against its plain torch version on the
   card: the grid of the reference's flash tests (every shape, causal and
   not, the q_start offset, the block sweep as shapes, bf16, scores x100),
   the ragged q_start case, all of that again in bf16 (the tensor-core
   body), bf16 at every head dim (ragged causal, q_start, non-causal), and
   the yi-6b path shape [2*32, 2048, 128] bf16 causal. Tolerance: fp32
   atol = rtol = 2e-5, bf16 atol 2e-2.
6. Prefill at full width: yi-6b (32 layers, d_model 4096, 6.06 B
   parameters, random bf16 weights from seed 0) through the plan's
   ``executable("prefill")`` on tokens [2, 2048] from numpy seed 0 (cut to
   batch and sequence only). The flash counter must grow by 32 per call,
   the logits must be finite and agree with the same forward through the
   plain chunked attention (``USE_FLASH_KERNEL = False``) within the
   tolerances of ``PREFILL_TOL``.
7. Fifo serving at full width with ``quantized=True``: one bucket of batch 4
   and max_len 256, two waves of 4 requests x 8 tokens. The waves must give
   identical tokens, the second must hit the step cache with no new build,
   and the qmatmul counter must grow by exactly 33 per decode step (the LM
   head and 32 down-projections). Phase 2 also holds qmatmul at the two LM
   shapes.
8. Timing of the LM path: median prefill latency, decode tokens/s, the
   device time of a prefill and of a decode step split into flash, qmatmul
   and other ops (torch.profiler; the kernel's share must be non-zero, so a
   renamed device function cannot hide in "other ops"), qmatmul at the two
   LM shapes with the L2 cold (rotating over weight copies of more than
   50 MB) beside its bound and, for the int8 head, ``torch._int_mm`` with x
   zero-padded to 32 rows (no PyTorch call takes the a16w8 int16
   operands), and the flash kernel at the path shape beside its bound, its
   plain version and ``torch.nn.functional.scaled_dot_product_attention``
   (yardsticks the port never calls).

The last two lines are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense: int8 and bf16 tensor-core peaks and
# the HBM3 rate.
H100_INT8_OPS = 1979e12
H100_BF16_OPS = 989e12
H100_BYTES_PER_S = 3.35e12

KERNEL_SOURCE = "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu"
TPU_KERNEL = "src/repro/kernels/qmatmul/qmatmul.py:149"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
FLASH_TPU_KERNEL = "src/repro/kernels/flash_attention/flash_attention.py:93"

# shapes of tests/test_qmatmul_kernel.py (M, K, N)
GRID_SHAPES = [(1, 8, 8), (4, 8, 8), (8, 128, 128), (128, 128, 128),
               (33, 70, 50), (256, 64, 96), (5, 1, 3)]
OPERANDS = [("int8", "int8"), ("int16", "int8"), ("int16", "int16")]
OUTS = ["int8", "int16"]
ROUNDINGS = ["floor", "half_up", "half_even"]

# request configurations of the main path: (model, rows)
REQUESTS = [("token_mlp_s16", 512), ("channel_mlp_s16", 196),
            ("token_mlp_l16", 1024), ("mlp_2layer", 256),
            ("mlp_7layer", 1), ("mlp_7layer", 128)]
CALLS = 3

# qmatmul on the LM path (M, K, N, x dtype, w dtype, out dtype): the int8
# LM head of a batch-4 decode step and its a16w8 MLP down-projection
LM_QMATMUL = [(4, 4096, 64000, "int8", "int8", "int16"),
              (4, 11008, 4096, "int16", "int8", "int16")]

# decode-sized M for the 16-row tile and split-K: (M, K, N)
SMALL_M_SHAPES = [(M, K, 300) for M in (1, 4, 16, 17) for K in (70, 11008)]

# flash cases (BH, Sq, Sk, hd, dtype, causal, q_start, x100): the grid of
# tests/test_flash_attention.py, its block sweep as shapes, the ragged
# q_start case, the whole grid again in bf16, bf16 at every head dim, and
# the yi-6b path shape
_FLASH_GRID = (
    [(2, s, s, hd, "fp32", c, 0, False)
     for s, hd in ((32, 16), (64, 8), (128, 32), (96, 16))
     for c in (True, False)]
    + [(1, 32, 64, 16, "fp32", True, 32, False),
       (1, 64, 64, 16, "fp32", True, 0, False),
       (2, 64, 64, 16, "bf16", True, 0, False),
       (1, 32, 32, 16, "fp32", False, 0, True),
       (2, 20, 20, 16, "fp32", True, 8, False)]
)
FLASH_CASES = (
    _FLASH_GRID
    + [c[:4] + ("bf16",) + c[5:] for c in _FLASH_GRID if c[4] == "fp32"]
    + [case for hd in (8, 16, 32, 64, 128)
       for case in ((3, 77, 77, hd, "bf16", True, 0, False),
                    (2, 48, 64, hd, "bf16", True, 16, False),
                    (2, 96, 96, hd, "bf16", False, 0, False))]
)
FLASH_TOL = {"fp32": dict(atol=2e-5, rtol=2e-5), "bf16": dict(atol=2e-2,
                                                              rtol=0.0)}

# the LM main path: yi-6b at full width, cut to batch and sequence
PREFILL_BATCH, PREFILL_SEQ = 2, 2048
FLASH_PATH = (PREFILL_BATCH * 32, PREFILL_SEQ, PREFILL_SEQ, 128, "bf16",
              True, 0, False)
# flash vs plain chunked attention through 32 bf16 layers: the two differ
# only in where the probabilities round (bf16 before PV in the plain path),
# so logits agree to bf16 noise
PREFILL_TOL = dict(mean_abs=0.02, max_abs=0.5, argmax_agree=0.99)
SERVE_BATCH, SERVE_MAX_LEN, SERVE_TOKENS, SERVE_WAVES = 4, 256, 8, 2


def _rand(rng, shape, dtype):
    lo, hi = (-128, 128) if dtype == "int8" else (-1024, 1024)
    return rng.integers(lo, hi, shape).astype(dtype)


class Checker:
    """Runs kernel-vs-plain comparisons and keeps the largest difference."""

    def __init__(self, ops, qlinear_ref):
        self.ops, self.qlinear_ref = ops, qlinear_ref
        self.cases = 0
        self.max_abs_err = 0

    def compare(self, x, w, b, plan=None, **kw):
        """The kernel under its own plan, or under ``plan`` if given."""
        got = (self.ops.qlinear(x, w, b, **kw) if plan is None else
               self.ops.qlinear_planned(x, w, b, plan, **kw))
        want = self.qlinear_ref(x, w, b, **kw)
        self.cases += 1
        err = int((got.to(torch.int32) - want.to(torch.int32))
                  .abs().max().item()) if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(
                f"qmatmul kernel != plain version for x{tuple(x.shape)} "
                f"{x.dtype} w{tuple(w.shape)} {w.dtype} bias={b is not None} "
                f"{kw} plan={plan}: max |diff| {err}")


def check_grid(chk, dev):
    rng = np.random.default_rng(42)
    for (M, K, N) in GRID_SHAPES:
        for dt_a, dt_b in OPERANDS:
            x = torch.from_numpy(_rand(rng, (M, K), dt_a)).to(dev)
            w = torch.from_numpy(_rand(rng, (K, N), dt_b)).to(dev)
            b = torch.from_numpy(
                rng.integers(-(2**16), 2**16, (N,)).astype(np.int32)).to(dev)
            for out in OUTS:
                for rounding in ROUNDINGS:
                    for shift in range(13):
                        for bias in (None, b):
                            for relu in (False, True):
                                chk.compare(x, w, bias, shift=shift, relu=relu,
                                            out_dtype=out, rounding=rounding)


def path_shapes(models):
    """Distinct (M, K_pad, N_pad) GEMMs of the request configurations."""
    shapes = []
    for name, rows in REQUESTS:
        for layer in models[name].layers:
            s = (rows, *layer.weight.shape)
            if s not in shapes:
                shapes.append(s)
    return shapes


def check_path_shapes(chk, dev, shapes):
    rng = np.random.default_rng(7)
    for (M, K, N) in shapes:
        x = torch.from_numpy(_rand(rng, (M, K), "int8")).to(dev)
        w = torch.from_numpy(_rand(rng, (K, N), "int8")).to(dev)
        b = torch.from_numpy(
            rng.integers(-(2**20), 2**20, (N,)).astype(np.int32)).to(dev)
        for shift in range(9, 15):
            for relu in (False, True):
                chk.compare(x, w, b, shift=shift, relu=relu)


def check_wraparound(chk, dev):
    """int16 x int16 at K=4096 near +-32767: the int32 sum wraps."""
    rng = np.random.default_rng(3)
    M, K, N = 70, 4096, 90
    sign_x = rng.choice([-1, 1], (M, 1))
    sign_w = rng.choice([-1, 1], (1, N))
    x = (sign_x * rng.integers(32700, 32768, (M, K))).astype(np.int16)
    w = (sign_w * rng.integers(32700, 32768, (K, N))).astype(np.int16)
    b = np.where(rng.random(N) < 0.5, 2**31 - 1 - rng.integers(0, 64, N),
                 -(2**31) + rng.integers(0, 64, N)).astype(np.int32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    if not np.abs(exact).max() > 2**31:
        raise AssertionError("wraparound case does not overflow int32")
    xt, wt, bt = (torch.from_numpy(a).to(dev) for a in (x, w, b))
    for out in OUTS:
        for shift in range(13):
            for relu in (False, True):
                chk.compare(xt, wt, bt, shift=shift, relu=relu,
                            out_dtype=out, rounding="half_up")
    return K


def device_ms(fn, iters=50):
    """Device time of one call: CUDA events around ``iters`` calls queued
    behind a sleep kernel, so the host's launch cost does not leave gaps."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(prof):
    """The profile's device-side entries (kernels, copies, sets) with their
    time. The host-side operator entries carry the same device time again
    as their own, so only these are summed."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def profile_predict(model, x, calls=10):
    """Device time of one ``predict(x, "aie")``: the qmatmul kernel and
    every other device op (torch.profiler), and the profiled wall time,
    which includes the profiler's own host overhead."""
    from torch.profiler import ProfilerActivity, profile

    model.predict(x, "aie")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            model.predict(x, "aie")
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / calls
    kernel = other = 0.0
    for e in device_events(prof):
        if "qmatmul_kernel" in e.key:
            kernel += e.self_device_time_total
        else:
            other += e.self_device_time_total
    kernel, other = kernel / 1e3 / calls, other / 1e3 / calls
    return dict(profiled_wall_ms=wall, qmatmul_ms=kernel, other_device_ms=other)


def bound(M, K, N):
    ops = 2.0 * M * K * N
    nbytes = M * K + K * N + 4 * N + M * N  # int8 x, w, y; int32 bias
    return ops, nbytes


def time_shapes(qlinear, qlinear_ref, dev, shapes):
    rng = np.random.default_rng(11)
    rows = []
    for (M, K, N) in shapes:
        x = torch.from_numpy(_rand(rng, (M, K), "int8")).to(dev)
        w = torch.from_numpy(_rand(rng, (K, N), "int8")).to(dev)
        b = torch.from_numpy(
            rng.integers(-(2**20), 2**20, (N,)).astype(np.int32)).to(dev)
        kw = dict(shift=10, relu=True)
        ms = device_ms(lambda: qlinear(x, w, b, **kw))
        plain = device_ms(lambda: qlinear_ref(x, w, b, **kw), iters=20)
        lib, lib_note = None, None
        if M > 16 and K % 8 == 0 and N % 8 == 0:
            try:
                lib = device_ms(lambda: torch._int_mm(x, w))
            except RuntimeError as e:  # a yardstick only: record why not
                lib_note = str(e).splitlines()[0]
        else:
            lib_note = "torch._int_mm takes M > 16 only"
        ops, nbytes = bound(M, K, N)
        t_ops, t_bytes = ops / H100_INT8_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        rows.append(dict(
            M=M, K=K, N=N, ms=ms, plain_ms=plain, library_ms=lib,
            library_note=lib_note, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            ops=ops, bytes=nbytes,
        ))
        print(f"qmatmul {M}x{K}x{N} int8: kernel {ms:.6f} ms, bound "
              f"{max(t_ops, t_bytes):.6f} ms ({rows[-1]['bound_by']}), plain "
              f"{plain:.6f} ms (not a yardstick), torch._int_mm "
              f"{'n/a' if lib is None else f'{lib:.6f} ms'}")
    return rows


def check_small_m(chk, dev, sms):
    """Decode-sized M over the full int16 range (the sum wraps int32 at
    K = 11008), all three operand pairs, both outputs, each shape under its
    own plan, with one split, and with six splits where K allows."""
    rng = np.random.default_rng(17)
    n_split = 0
    for (M, K, N) in SMALL_M_SHAPES:
        auto = chk.ops.plan(M, K, N, sms)
        plans = {auto, chk.ops.Plan(auto.block_m, 1, K)}
        if K > 1024:
            plans.add(chk.ops.Plan(auto.block_m, 6, 1856))  # 6 x 1856 >= K
        n_split += sum(p.splits > 1 for p in plans)
        for dt_a, dt_b in OPERANDS:
            x = torch.from_numpy(rng.integers(
                -(2**15) if dt_a == "int16" else -128,
                2**15 if dt_a == "int16" else 128, (M, K)).astype(dt_a)).to(dev)
            w = torch.from_numpy(_rand(rng, (K, N), dt_b)).to(dev)
            b = torch.from_numpy(rng.integers(
                -(2**31), 2**31, (N,)).astype(np.int32)).to(dev)
            for p in plans:
                for out in OUTS:
                    chk.compare(x, w, b, plan=p, shift=9, relu=out == "int8",
                                out_dtype=out, rounding="half_even")
    if n_split == 0:
        raise AssertionError("no small-M case ran with split-K")
    return n_split


def check_lm_shapes(chk, dev):
    """qmatmul at the LM shapes with the path's operand types; int16 x over
    both a moderate and the full range (the int32 sum then wraps)."""
    rng = np.random.default_rng(5)
    for (M, K, N, dx, dw, out) in LM_QMATMUL:
        w = torch.from_numpy(_rand(rng, (K, N), dw)).to(dev)
        xs = [torch.from_numpy(_rand(rng, (M, K), dx)).to(dev)]
        if dx == "int16":
            xs.append(torch.from_numpy(rng.integers(
                -32768, 32768, (M, K)).astype(np.int16)).to(dev))
        for x in xs:
            for shift in (2, 7, 10):
                chk.compare(x, w, None, shift=shift, out_dtype=out)


class FlashChecker:
    """Flash kernel vs plain version; keeps the largest difference."""

    def __init__(self, ops, attention_ref):
        self.ops, self.ref = ops, attention_ref
        self.cases = 0
        self.max_abs_err = 0.0

    def compare(self, BH, Sq, Sk, hd, dtype, causal, q_start, x100, dev):
        q, k, v = flash_inputs(BH, Sq, Sk, hd, dtype, dev, seed=self.cases)
        if x100:
            q, k = q * 100, k * 100
        got = self.ops.flash_attention(q, k, v, causal=causal,
                                       q_start=q_start)
        want = self.ref(q, k, v, causal=causal, q_start=q_start)
        torch.cuda.synchronize()
        self.cases += 1
        err = float((got.float() - want.float()).abs().max())
        self.max_abs_err = max(self.max_abs_err, err)
        if got.dtype != want.dtype or not torch.isfinite(got).all():
            raise AssertionError(f"flash {BH, Sq, Sk, hd, dtype}: bad output")
        torch.testing.assert_close(got.float(), want.float(),
                                   **FLASH_TOL[dtype])
        return err


def flash_inputs(BH, Sq, Sk, hd, dtype, dev, seed=0):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    return [torch.randn((BH, S, hd), generator=gen, device=dev).to(dt)
            for S in (Sq, Sk, Sk)]


def flash_bound(BH, Sq, Sk, hd, dtype, causal):
    ops = 4.0 * BH * Sq * Sk * hd / (2 if causal else 1)
    elem = 4 if dtype == "fp32" else 2
    nbytes = elem * BH * hd * (2 * Sq + 2 * Sk)      # q, k, v read, o written
    t_ops, t_bytes = ops / H100_BF16_OPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            ops, nbytes)


def lm_tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int64)


def prefill_agreement(flash_logits, plain_logits):
    diff = (flash_logits - plain_logits).abs()
    top2 = torch.topk(plain_logits, 2, dim=-1).values
    robust = (top2[..., 0] - top2[..., 1]) > 0.1
    agree = (flash_logits.argmax(-1) == plain_logits.argmax(-1))[robust]
    return dict(mean_abs=float(diff.mean()), max_abs=float(diff.max()),
                robust_positions=int(robust.sum()),
                argmax_agree=float(agree.float().mean()) if agree.numel()
                else 1.0)


def serve_requests(vocab, wave):
    rng = np.random.default_rng(100)     # the same prompts every wave
    return [dict(request_id=f"w{wave}r{i}",
                 prompt=[int(t) for t in rng.integers(
                     1, vocab, int(rng.integers(2, 9)))],
                 max_new_tokens=SERVE_TOKENS)
            for i in range(SERVE_BATCH)]


def profile_split(fn, calls=3):
    """Device time of one ``fn()``: flash kernel, qmatmul kernel and every
    other device op (torch.profiler), and the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / calls
    split = dict(flash_ms=0.0, qmatmul_ms=0.0, other_device_ms=0.0)
    for e in device_events(prof):
        key = ("flash_ms" if "flash_kernel" in e.key else
               "qmatmul_ms" if "qmatmul_kernel" in e.key else
               "other_device_ms")
        split[key] += e.self_device_time_total / 1e3 / calls
    split["profiled_wall_ms"] = wall
    return split


def device_busy_ms(split):
    return split["flash_ms"] + split["qmatmul_ms"] + split["other_device_ms"]


def run_prefill(dev, flash_ops, attention):
    """Phase 6: yi-6b forward at full width through the flash kernel."""
    from repro_torch.models.base import ShapeSpec
    from repro_torch.plan import build_plan

    shape = ShapeSpec(f"prefill_{PREFILL_BATCH}x{PREFILL_SEQ}", PREFILL_SEQ,
                      PREFILL_BATCH, "prefill")
    plan = build_plan("yi-6b", shape, device=dev)
    cfg = plan.cfg
    t0 = time.perf_counter()
    model = plan.init_params(seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"yi-6b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads (kv {cfg.n_kv}), d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}: {n_params / 1e9:.3f} B parameters, "
          f"{sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f}"
          f" GB, init {time.perf_counter() - t0:.1f} s")
    prefill = plan.executable("prefill")
    batch = {"tokens": torch.from_numpy(
        lm_tokens(cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ), 0)).to(dev)}

    flash_ops.launches = 0
    logits = prefill.fn(model, batch)
    torch.cuda.synchronize()
    launches = flash_ops.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"flash launched {launches} times in one "
                             f"forward, expected {cfg.n_layers}")
    if logits.shape != (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    attention.USE_FLASH_KERNEL = False
    try:
        plain = prefill.fn(model, batch)
    finally:
        attention.USE_FLASH_KERNEL = True
    agree = prefill_agreement(logits, plain)
    del plain
    print(f"prefill [{PREFILL_BATCH}, {PREFILL_SEQ}]: {launches} flash "
          f"launches == layers x 1 call; logits finite; vs plain chunked "
          f"attention: mean |diff| {agree['mean_abs']:.6f}, max |diff| "
          f"{agree['max_abs']:.6f}, argmax agreement "
          f"{agree['argmax_agree']:.6f} at {agree['robust_positions']} "
          f"positions with top-2 gap > 0.1 (tolerance {PREFILL_TOL})")
    if not (agree["mean_abs"] <= PREFILL_TOL["mean_abs"]
            and agree["max_abs"] <= PREFILL_TOL["max_abs"]
            and agree["argmax_agree"] >= PREFILL_TOL["argmax_agree"]):
        raise AssertionError(f"flash prefill disagrees with plain: {agree}")

    lat = []
    for _ in range(5):
        t = time.perf_counter()
        prefill.fn(model, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    split = profile_split(lambda: prefill.fn(model, batch), calls=2)
    return model, dict(launches=launches, agreement=agree,
                       median_ms=statistics.median(lat), latencies_ms=lat,
                       split=split)


def run_serve(dev, model, qmatmul_ops):
    """Phase 7: fifo serving, quantized, at full width."""
    from repro_torch.plan import build_plan
    from repro_torch.serve import Bucket, BucketPolicy, DecodeRequest

    plan = build_plan("yi-6b", None, quantized=True, device=dev)
    t0 = time.perf_counter()
    plan.load_params(model)           # calibrates the MLP shifts
    torch.cuda.synchronize()
    print(f"serve plan: calibrated MLP shifts {plan.ir.quant['mlp_shifts']} "
          f"in {time.perf_counter() - t0:.1f} s")
    batcher = plan.make_batcher(
        policy=BucketPolicy([Bucket(SERVE_MAX_LEN, SERVE_BATCH)]))
    waves, cache = [], []
    qmatmul_ops.launches = 0
    for wave in range(SERVE_WAVES):
        for r in serve_requests(plan.cfg.vocab, wave):
            batcher.submit(DecodeRequest(**r))
        res = batcher.run()
        waves.append([res[f"w{wave}r{i}"].tokens for i in range(SERVE_BATCH)])
        cache.append(dict(batcher.cache.stats()))
    torch.cuda.synchronize()
    launches = qmatmul_ops.launches
    m = batcher.metrics[Bucket(SERVE_MAX_LEN, SERVE_BATCH).label]
    decode_steps = m.slot_steps // SERVE_BATCH   # prefill + decode positions
    per_step = plan.cfg.n_layers + 1
    if launches != per_step * decode_steps or launches == 0:
        raise AssertionError(f"qmatmul launched {launches} times over "
                             f"{decode_steps} decode steps, expected "
                             f"{per_step} per step")
    if waves[0] != waves[1]:
        raise AssertionError(f"waves differ: {waves}")
    if any(len(t) != SERVE_TOKENS or not all(0 <= x < plan.cfg.vocab
                                             for x in t) for t in waves[0]):
        raise AssertionError(f"bad tokens {waves[0]}")
    if not (cache[1]["hits"] > cache[0]["hits"]
            and cache[1]["builds"] == cache[0]["builds"]):
        raise AssertionError(f"second wave did not hit the cache: {cache}")
    print(f"serve: {SERVE_WAVES} waves x {SERVE_BATCH} requests x "
          f"{SERVE_TOKENS} tokens, identical waves {waves[0]}; {launches} "
          f"qmatmul launches == {per_step} x {decode_steps} decode steps; "
          f"cache after waves {cache}")

    # decode tokens/s: the bucket's decode step alone, state resident
    decode = plan.serve_executable("decode", batch=SERVE_BATCH,
                                   max_len=SERVE_MAX_LEN)
    state = batcher.pool.acquire(SERVE_BATCH, SERVE_MAX_LEN)
    tok = torch.ones(SERVE_BATCH, dtype=torch.int32, device=dev)

    def steps(n, p0):
        nonlocal tok, state
        for i in range(n):
            logits, state = decode.fn(model, state, tok, p0 + i)
            tok = plan.token_argmax(logits)

    steps(4, 0)
    torch.cuda.synchronize()
    n = 32
    t = time.perf_counter()
    steps(n, 4)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t) * 1e3 / n
    split = profile_split(lambda: steps(1, 40), calls=4)
    batcher.pool.release(SERVE_BATCH, SERVE_MAX_LEN, state)
    return dict(launches=launches, decode_steps=decode_steps,
                step_ms=step_ms, tokens_per_s=SERVE_BATCH * 1e3 / step_ms,
                split=split, batcher=batcher.stats()["buckets"],
                shifts=plan.ir.quant["mlp_shifts"])


L2_BYTES = 50e6   # the H100's L2: rotating over more than this keeps it cold


def time_lm_qmatmul(qlinear, qlinear_ref, dev):
    """qmatmul at the LM shapes with the L2 cold: a decode step streams 32
    layers' different weights, so each call takes the next of enough weight
    copies to exceed the L2. The int8 head gets ``torch._int_mm`` with x
    zero-padded to 32 rows as a yardstick for the product alone (no SRS);
    no PyTorch call takes the a16w8 int16 operands."""
    rng = np.random.default_rng(13)
    rows = []
    for (M, K, N, dx, dw, out) in LM_QMATMUL:
        x = torch.from_numpy(_rand(rng, (M, K), dx)).to(dev)
        n_copies = int(2 * L2_BYTES // (K * N)) + 1
        ws = [torch.from_numpy(_rand(rng, (K, N), dw)).to(dev)
              for _ in range(n_copies)]
        kw = dict(shift=7, out_dtype=out)
        turn = iter(range(10**9))

        def cold(fn):
            return lambda: fn(ws[next(turn) % n_copies])

        ms = device_ms(cold(lambda w: qlinear(x, w, None, **kw)))
        plain = device_ms(lambda: qlinear_ref(x, ws[0], None, **kw), iters=10)
        lib, lib_note = None, "no PyTorch call takes int16 x int8 operands"
        if dx == "int8":
            xp = torch.zeros((32, K), dtype=torch.int8, device=dev)
            xp[:M] = x
            lib = device_ms(cold(lambda w: torch._int_mm(xp, w)))
            lib_note = (f"torch._int_mm with x zero-padded from {M} to 32 "
                        f"rows, int32 out, no SRS")
        ops = 2.0 * M * K * N
        nbytes = x.numel() * x.element_size() + K * N + M * N * 2
        t_ops = ops / H100_INT8_OPS * 1e3
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        rows.append(dict(
            M=M, K=K, N=N, x=dx, w=dw, out=out, ms=ms, plain_ms=plain,
            library_ms=lib, library_note=lib_note, l2="cold",
            weight_copies=n_copies, bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            ops=ops, bytes=nbytes))
        print(f"qmatmul {M}x{K}x{N} {dx}x{dw}->{out}, L2 cold ({n_copies} "
              f"weight copies): kernel {ms:.6f} ms, bound "
              f"{max(t_ops, t_bytes):.6f} ms ({rows[-1]['bound_by']}), plain "
              f"{plain:.6f} ms (not a yardstick), library "
              f"{'n/a' if lib is None else f'{lib:.6f} ms'} ({lib_note})")
        del ws
    return rows


def time_flash(flash_ops, attention_ref, dev):
    """The flash kernel at the path shape beside its bound, its plain
    version and SDPA (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    BH, Sq, Sk, hd, dtype, causal, _, _ = FLASH_PATH
    q, k, v = flash_inputs(BH, Sq, Sk, hd, dtype, dev, seed=1)
    ms = device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal),
                   iters=20)
    plain = device_ms(lambda: attention_ref(q, k, v, causal=causal), iters=5)
    q4, k4, v4 = (t.view(1, BH, -1, hd) for t in (q, k, v))
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), iters=20)
    bound_ms, bound_by, ops, nbytes = flash_bound(BH, Sq, Sk, hd, dtype,
                                                  causal)
    print(f"flash [{BH}, {Sq}, {hd}] {dtype} causal: kernel {ms:.6f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by}), plain {plain:.6f} ms (not a "
          f"yardstick), SDPA {sdpa:.6f} ms (yardstick, never called by the "
          f"port)")
    return dict(ms=ms, plain_ms=plain, library_ms=sdpa, bound_ms=bound_ms,
                bound_by=bound_by, ops=ops, bytes=nbytes)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.configs.paper_models import PAPER_MODELS, build_paper_model
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.qmatmul import ops
    from repro_torch.kernels.qmatmul.ref import qlinear_ref
    from repro_torch.layers import attention

    dev = torch.device("cuda")
    # phase 1: the card, then the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    reports = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    for name in build.SOURCES:
        build.load(name)

    # phase 2: kernel vs plain version
    chk = Checker(ops, qlinear_ref)
    check_grid(chk, dev)
    n_grid = chk.cases
    models = {name: build_paper_model(name, device=dev) for name in PAPER_MODELS}
    shapes = path_shapes(models)
    check_path_shapes(chk, dev, shapes)
    wrap_k = check_wraparound(chk, dev)
    n_split = check_small_m(
        chk, dev, torch.cuda.get_device_properties(0).multi_processor_count)
    check_lm_shapes(chk, dev)
    torch.cuda.synchronize()
    print(f"kernel == plain: {chk.cases} cases ({n_grid} grid, path shapes "
          f"{shapes}, wraparound K={wrap_k}, small M {SMALL_M_SHAPES} with "
          f"{n_split} split-K plans, LM shapes {LM_QMATMUL}), max |diff| "
          f"{chk.max_abs_err}")

    # phase 3: the main path, counted from zero
    rng = np.random.default_rng(0)
    inputs = {(name, rows): [
        rng.uniform(-1, 1, (rows, PAPER_MODELS[name][1])).astype(np.float32)
        for _ in range(CALLS)] for name, rows in REQUESTS}
    ops.launches = 0
    answers = {key: [models[key[0]].predict(x, "aie") for x in xs]
               for key, xs in inputs.items()}
    torch.cuda.synchronize()
    launches = ops.launches
    expected = sum(len(models[name].layers) * CALLS for name, _ in REQUESTS)
    if launches != expected or launches == 0:
        raise AssertionError(
            f"qmatmul launched {launches} times on the main path, "
            f"expected layers x calls = {expected}")
    for (name, rows), xs in inputs.items():
        widths = PAPER_MODELS[name][2]
        for x, y in zip(xs, answers[(name, rows)]):
            oracle = models[name].predict(x, "x86")
            if y.shape != (rows, widths[-1]) or not torch.isfinite(y).all():
                raise AssertionError(f"{name}: bad output {tuple(y.shape)}")
            if not torch.equal(y, oracle):
                raise AssertionError(f"{name} rows={rows}: aie != x86")
        print(f"{name} rows={rows}: {CALLS} aie requests == x86 oracle, "
              f"{len(models[name].layers)} layers, out {tuple(y.shape)}")
    print(f"main path: {launches} qmatmul launches == layers x calls")

    # phase 4: timing
    for name, rows in REQUESTS:
        x = inputs[(name, rows)][0]
        lat = []
        for i in range(25):
            t = time.perf_counter()
            models[name].predict(x, "aie")
            torch.cuda.synchronize()
            if i >= 5:
                lat.append((time.perf_counter() - t) * 1e3)
        med = statistics.median(lat)
        prof = profile_predict(models[name], x)
        busy = prof["qmatmul_ms"] + prof["other_device_ms"]
        print(f"predict {name} rows={rows}: median {med:.4f} ms (host clock, "
              f"numpy in, tensor out, after warm-up); device: qmatmul "
              f"{prof['qmatmul_ms']:.4f} ms + other ops "
              f"{prof['other_device_ms']:.4f} ms, idle share "
              f"{1.0 - busy / med:.3f} of the median (profiled wall "
              f"{prof['profiled_wall_ms']:.4f} ms)")
    rows_t = time_shapes(ops.qlinear, qlinear_ref, dev, shapes)

    # phase 5: flash kernel vs plain version
    fchk = FlashChecker(flash_ops, attention_ref)
    for case in FLASH_CASES + [FLASH_PATH]:
        err = fchk.compare(*case, dev)
        print(f"flash {case[:7]}{' x100' if case[7] else ''}: kernel vs "
              f"plain max |diff| {err:.3g} (tolerance {FLASH_TOL[case[4]]})")
    print(f"flash kernel == plain within tolerance: {fchk.cases} cases, max "
          f"|diff| {fchk.max_abs_err:.3g}")

    # phase 6: prefill at full width, counted from zero
    model, pre = run_prefill(dev, flash_ops, attention)
    # phase 7: fifo serving at full width, quantized, counted from zero
    srv = run_serve(dev, model, ops)

    # phase 8: timing of the LM path; a kernel renamed out of the
    # profiler's match would show as zero here
    if pre["split"]["flash_ms"] <= 0 or srv["split"]["qmatmul_ms"] <= 0:
        raise AssertionError(
            f"profiler split found no kernel time: prefill {pre['split']}, "
            f"decode step {srv['split']}")
    print(f"prefill [{PREFILL_BATCH}, {PREFILL_SEQ}] yi-6b: median "
          f"{pre['median_ms']:.4f} ms (host clock, 5 calls after warm-up, "
          f"all {[round(x, 4) for x in pre['latencies_ms']]}); device: flash "
          f"{pre['split']['flash_ms']:.4f} ms + qmatmul "
          f"{pre['split']['qmatmul_ms']:.4f} ms + other ops "
          f"{pre['split']['other_device_ms']:.4f} ms, idle share "
          f"{1 - device_busy_ms(pre['split']) / pre['median_ms']:.3f} of "
          f"the median (profiled wall "
          f"{pre['split']['profiled_wall_ms']:.4f} ms)")
    print(f"decode yi-6b quantized batch {SERVE_BATCH}: {srv['step_ms']:.4f} "
          f"ms per step, {srv['tokens_per_s']:.2f} tokens/s (host clock, 32 "
          f"steps); device per step: flash {srv['split']['flash_ms']:.4f} ms "
          f"+ qmatmul {srv['split']['qmatmul_ms']:.4f} ms + other ops "
          f"{srv['split']['other_device_ms']:.4f} ms, idle share "
          f"{1 - device_busy_ms(srv['split']) / srv['step_ms']:.3f} of "
          f"the step (profiled wall "
          f"{srv['split']['profiled_wall_ms']:.4f} ms); "
          f"batcher {srv['batcher']}")
    lm_rows = time_lm_qmatmul(ops.qlinear, qlinear_ref, dev)
    fl = time_flash(flash_ops, attention_ref, dev)

    per = {(r["M"], r["K"], r["N"]): r for r in rows_t + lm_rows}
    # one aie predict of every request configuration, and one quantized
    # yi-6b decode step at batch 4 (the head and 32 down-projections)
    path = [(rows, *layer.weight.shape) for name, rows in REQUESTS
            for layer in models[name].layers]
    path += [LM_QMATMUL[0][:3]] + [LM_QMATMUL[1][:3]] * model.cfg.n_layers
    tot_ops = sum(per[s]["ops"] for s in path)
    tot_bytes = sum(per[s]["bytes"] for s in path)
    t_ops, t_bytes = tot_ops / H100_INT8_OPS * 1e3, tot_bytes / H100_BYTES_PER_S * 1e3
    libs = [per[s]["library_ms"] for s in path]
    record = {"kernels": [{
        "name": "qmatmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches + srv["launches"],
        "launches_by_path": {"paper models (phase 3)": launches,
                             "yi-6b fifo serve (phase 7)": srv["launches"]},
        "exact": True, "max_abs_err": chk.max_abs_err, "cases": chk.cases,
        "work": "one aie predict of every request configuration and one "
                "quantized yi-6b decode step at batch 4",
        "ms": sum(per[s]["ms"] for s in path),
        "plain_ms": sum(per[s]["plain_ms"] for s in path),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None if None in libs else sum(libs),
        "shapes": rows_t + lm_rows,
    }, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL, "launches": pre["launches"],
        "launches_by_path": {"yi-6b prefill (phase 6)": pre["launches"]},
        "max_abs_err": fchk.max_abs_err, "cases": fchk.cases,
        "work": f"one call at the path shape [{FLASH_PATH[0]}, "
                f"{FLASH_PATH[1]}, {FLASH_PATH[3]}] bf16 causal",
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"],
    }]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
