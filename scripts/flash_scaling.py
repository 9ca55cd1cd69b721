#!/usr/bin/env python3
"""The port's bf16 flash kernel as the sequence grows, beside SDPA.

    python3 scripts/flash_scaling.py

Times ``repro_torch.kernels.flash_attention.flash_attention`` and
``torch.nn.functional.scaled_dot_product_attention`` (a yardstick the port
never calls) on one CUDA card at the path's head dims, with the same work
spread over fewer, longer sequences: at S = 2048 a causal block of the
Hopper body walks 8.5 key tiles on average, at 16,384 it walks 64.5, so the
per-block costs (the first loads, the first product and softmax that
nothing overlaps, the epilogue) and the masked diagonal weigh less. Prints
the card's name and power limit, then one line per shape: ms (CUDA events
over 30 calls queued behind a sleep kernel), the ratio to SDPA and the
tensor work issued per second (1.5 x ``ops.work``: P.V runs for P's hi and
lo parts). Exits non-zero without a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels.flash_attention import ops  # noqa: E402

# (BH, S, hd, causal): the yi-6b and seamless-encoder path shapes, then the
# same operation count at longer sequences
SHAPES = [(64, 2048, 128, True), (16, 8192, 128, True), (4, 16384, 128, True),
          (64, 2048, 128, False), (16, 8192, 128, False),
          (32, 2048, 64, False), (8, 8192, 64, False)]
ISSUED = 1.5


def device_ms(fn, iters=30):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_scaling: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    for BH, S, hd, causal in SHAPES:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        q, k, v = (torch.randn((BH, S, hd), generator=gen,
                               device=dev).bfloat16() for _ in range(3))
        ms = device_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        q4, k4, v4 = (t.view(1, BH, S, hd) for t in (q, k, v))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal))
        work = ops.work(BH, S, S, hd, q.dtype, causal)
        print(f"flash [{BH}, {S}, {hd}] {'causal' if causal else 'non-causal'}"
              f": kernel {ms:.6f} ms, SDPA {sdpa:.6f} ms, kernel/SDPA "
              f"{ms / sdpa:.3f}, {ISSUED * work.ops / ms / 1e9:.1f} TFLOP/s "
              f"issued")
    return 0


if __name__ == "__main__":
    sys.exit(main())
