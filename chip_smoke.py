#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Print the card's name and power limit, then build every CUDA kernel of
   the path from the sources in this checkout (one nvcc per source).
2. Hold the qmatmul kernel against its plain torch version on the card with
   ``torch.equal``: the grid of the reference's kernel tests (every shape,
   all three operand pairs, both outputs, all three roundings, shifts 0-12,
   bias and ReLU on and off), the paper models' GEMM shapes, and a forced
   int32-wraparound case.
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

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core peak and HBM3 rate.
H100_INT8_OPS = 1979e12
H100_BYTES_PER_S = 3.35e12

KERNEL_SOURCE = "src/repro_torch/kernels/qmatmul/csrc/qmatmul.cu"
TPU_KERNEL = "src/repro/kernels/qmatmul/qmatmul.py:149"

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


def _rand(rng, shape, dtype):
    lo, hi = (-128, 128) if dtype == "int8" else (-1024, 1024)
    return rng.integers(lo, hi, shape).astype(dtype)


class Checker:
    """Runs kernel-vs-plain comparisons and keeps the largest difference."""

    def __init__(self, qlinear, qlinear_ref):
        self.qlinear, self.qlinear_ref = qlinear, qlinear_ref
        self.cases = 0
        self.max_abs_err = 0

    def compare(self, x, w, b, **kw):
        got = self.qlinear(x, w, b, **kw)
        want = self.qlinear_ref(x, w, b, **kw)
        self.cases += 1
        err = int((got.to(torch.int32) - want.to(torch.int32))
                  .abs().max().item()) if got.numel() else 0
        self.max_abs_err = max(self.max_abs_err, err)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(
                f"qmatmul kernel != plain version for x{tuple(x.shape)} "
                f"{x.dtype} w{tuple(w.shape)} {w.dtype} bias={b is not None} "
                f"{kw}: max |diff| {err}")


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
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0:
            continue
        if "qmatmul_kernel" in e.key:
            kernel += us
        else:
            other += us
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.configs.paper_models import PAPER_MODELS, build_paper_model
    from repro_torch.kernels import build
    from repro_torch.kernels.qmatmul import ops
    from repro_torch.kernels.qmatmul.ref import qlinear_ref

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
    build.load("qmatmul")

    # phase 2: kernel vs plain version
    chk = Checker(ops.qlinear, qlinear_ref)
    check_grid(chk, dev)
    n_grid = chk.cases
    models = {name: build_paper_model(name, device=dev) for name in PAPER_MODELS}
    shapes = path_shapes(models)
    check_path_shapes(chk, dev, shapes)
    wrap_k = check_wraparound(chk, dev)
    torch.cuda.synchronize()
    print(f"kernel == plain: {chk.cases} cases ({n_grid} grid, path shapes "
          f"{shapes}, wraparound K={wrap_k}), max |diff| {chk.max_abs_err}")

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
    per = {(r["M"], r["K"], r["N"]): r for r in rows_t}
    # one aie predict of every request configuration
    path = [(rows, *layer.weight.shape) for name, rows in REQUESTS
            for layer in models[name].layers]
    tot_ops = sum(per[s]["ops"] for s in path)
    tot_bytes = sum(per[s]["bytes"] for s in path)
    t_ops, t_bytes = tot_ops / H100_INT8_OPS * 1e3, tot_bytes / H100_BYTES_PER_S * 1e3
    libs = [per[s]["library_ms"] for s in path]
    record = {"kernels": [{
        "name": "qmatmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": launches, "exact": True,
        "max_abs_err": chk.max_abs_err, "cases": chk.cases,
        "work": "one aie predict of every request configuration",
        "ms": sum(per[s]["ms"] for s in path),
        "plain_ms": sum(per[s]["plain_ms"] for s in path),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None if None in libs else sum(libs),
        "shapes": rows_t,
    }]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
