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
   int32-wraparound case, decode-sized M (1, 4, 16, 17) at K = 70 and
   11008 for all three operand pairs with split-K on and off, and the two
   LM shapes at M = 4, at M = 8 (phase 9's batch) and at M = 32 (phase
   10's verify, 8 slots x 4 positions) with split-K on and off.
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
   each launch within the bf16 flash tolerance of the plain attention on
   its own inputs, and the logits must be finite and agree with the same
   forward through the
   plain chunked attention (``USE_FLASH_KERNEL = False``) within the
   tolerances of ``PREFILL_TOL``.
7. Fifo serving at full width with ``quantized=True``: one bucket of batch 4
   and max_len 256, two waves of 4 requests x 8 tokens. The waves must give
   identical tokens, the second must hit the step cache with no new build,
   and the qmatmul counter must grow by exactly 33 per decode step (the LM
   head and 32 down-projections). Phase 2 also holds qmatmul at the two LM
   shapes. The plan's mesh passes run first (every plan resolves its 1x1
   mesh). Then, for each sharding mode, ``plan.iter_shard_params`` places
   the resident model on the 1x1 ``cuda`` DeviceMesh (a world-1 nccl
   group) one parameter at a time, each DTensor dropped after its check:
   ``to_local()`` must be ``torch.equal`` to the parameter and its
   placements those of ``pspec_to_placements`` over the leaf's
   PartitionSpec in ``describe()["params"]`` (stacked dims dropped); one
   ``mesh 1x1 (nccl, world 1) <mode>: ...`` line per mode. Then the model
   runs sharded: a megatron_sp plan's ``shard_model`` installs the
   DTensors into the resident model one parameter at a time, and under
   ``plan.activate()`` one prefill [2, 2048] must launch flash 32 times on
   DTensor operands with logits held to the unsharded call by
   ``PREFILL_TOL`` (their max difference printed), and phase 7's first
   fifo wave must launch qmatmul 33 times per decode step with every
   stream equal to phase 7's plain stream up to the first step whose
   top-2 gap (a plain greedy loop) is under 0.1, and with the state placed
   by its specs. A ``sharded 1x1`` line prints ms per decode step beside
   phase 7's plain ms, the device idle share and the peak growth; then
   ``unshard_model`` puts the plain parameters back, each ``torch.equal``
   to the original, before phase 8.
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

9. Continuous serving at full width, quantized, on phase 6's model and
   phase 7's calibrated plan: one bucket of batch 8 x max_len 512,
   ``steps_per_dispatch`` 4, the paged KV pool of ``paged=True`` (264 pages
   of 16 tokens), two waves of 12 requests (a shared 40-token system
   prompt plus 2-8 unique tokens, ``max_new_tokens`` staggered over 4-24,
   numpy seed fixed here), then one wave through the dense KV cache. Each
   run is counted from zero: qmatmul must launch 33 x k per micro-run; the
   scheduler must refill slots; wave 2 must map prefix pages published by
   wave 1; after each run the pages in use must be the scratch pages and
   the prefix entries; wave 2 must build no step and hit the cache. Every
   stream must equal a plain greedy loop over ``DecoderLM.decode_step``
   (each request in its own batch row from position 0, quantized, same
   model) up to the first step whose top-2 logit gap is under
   ``CONT_MIN_GAP``. Prints tokens/s on the host clock, dispatches,
   micro-runs, refills, the prefix-skip share, ms per micro-run, and the
   device time split, largest device entries and idle share of one
   micro-run in steady decode, paged and dense.
10. Speculative serving at full width, quantized, on the same model and
   plan: bucket 8 x 512, ``speculative=4`` with the default draft (the
   first 16 layers), phase 9's first wave of traffic once through a paged
   batcher (264 pages of 16 tokens plus the draft's twin pool) and once
   through a dense batcher behind ``AsyncServeServer`` (concurrent
   ``generate`` calls). Each run is counted from zero: qmatmul must launch
   4 x (16 + 1) + 33 = 101 times per micro-run (the draft's down-
   projections and head at M = 8, the verify's at M = 32) and flash never;
   there must be verifies, accepted <= drafted tokens and refills; the
   streams are held to the plain greedy loop as in phase 9; after the
   paged run only scratch and prefix pages are in use. Prints tokens/s,
   micro-runs, the speculative counters, the async server's p50/p99 time
   to the first token and outcomes, and one speculative micro-run's host
   time and device split, paged and dense.

11. The hybrid family at full width: zamba2-2.7b, cut in depth for the
   run's time limit to 18 of its 54 Mamba2 layers (3 of its 9 groups of
   6, one weight-shared attention block after each group), d_model 2560,
   32 heads of dim 80, random bf16 weights from seed 0; the yi-6b model is
   freed first. Prefill [2, 2048] through the plan's
   ``executable("prefill")``: flash must launch exactly 3 times per call
   (one per call site, head dim 80), each launch within the bf16 flash
   tolerance of the plain attention on its own inputs. The random Mamba2
   stack is chaotic (a 2**-8 relative noise on the embeddings decorrelates
   its full-depth logits), so the full-depth flash-vs-plain logits are
   printed beside that noise, and ``PREFILL_TOL`` holds the model cut to
   its first group, with flash and without (phase 6 runs the per-launch
   check too). Then quantized continuous serving, bucket 8 x 512, k = 4:
   one paged wave and one dense wave of the same 12 requests (42-48
   prompt tokens drawn apart, so no two share a full page,
   ``max_new_tokens`` staggered over 4-24), each counted from zero:
   qmatmul must launch 4 x 4 per micro-run (the LM head and the shared
   block's down-projection at 3 call sites) and flash never; the scheduler
   must refill slots; every stream is held, by phase 9's gap rule, to a
   plain greedy loop over ``HybridModel.decode_step`` replayed after the
   wave at the positions each request ran at, in batches of 8 (so every
   product rounds as in the step); after the paged wave the pages in use
   must be the scratch pages and the prefix entries. Prints a ``hybrid
   micro-run`` line with the profiler split. Phase 2 also holds
   qmatmul at the hybrid's two decode shapes (8x2560x32000 int8 and
   8x10240x2560 a16w8) with split-K on and off, and phase 5 holds flash at
   head dim 80 (the reference grid in fp32 and bf16, and the path shape
   [2*32, 2048, 80] bf16 causal), timed in phase 8.
12-14. The other dense configs, the MoE family and RWKV at full width, each
   model freed before the next is loaded, each as phase 11 runs the
   hybrid (random bf16 weights from seed 0; prefill [2, 2048]; quantized
   continuous serving, bucket 8 x 512, k = 4, one paged and one dense
   wave of 12 requests counted from zero, every stream held by phase 9's
   gap rule to the plain loop replayed at its positions in batches of 8;
   a prefill line and a micro-run line with the profiler split):
   12. qwen1.5-4b (QKV bias, vocab 151,936) cut in depth to 10 of its 40
       layers for the run's time limit (phase 17 trains all 40): 10 flash
       launches per prefill, each held to the plain attention on its own
       inputs, and the logits held to ``PREFILL_TOL`` against the plain
       chunked attention; phase 9's first wave (shared system prompt);
       qmatmul 11 x 4 per micro-run (the head and 10 down-projections).
   13. phi3.5-moe-42b-a6.6b cut in depth to 12 of its 32 layers (the whole
       model does not fit one card; 12 for the run's time limit): 12 flash
       launches per prefill, each
       held as for qwen; the share of expert assignments that capacity
       dropped; rounding-sized differences flip the random router's
       choices, so the free logits are printed beside the 2**-8 noise
       yardstick (which must move them more) and ``PREFILL_TOL`` holds
       the full depth with the plain forward taking the flash forward's
       routing; phase 9's first wave; qmatmul 1 x 4 per micro-run (the
       head; the expert FFNs stay float, as in the reference).
   14. rwkv6-7b at full width, cut in depth to 4 of its 32 layers (the
       run's time limit; 64 wkv heads of 64): no flash; the prefill of
       the first 64 tokens against 64 decode steps over them, printed at
       the cut depth beside the noise yardstick (the random stack is chaotic,
       as zamba2's) and held to ``PREFILL_TOL`` on the model cut to its
       first layer; the device split is profiled on a [2, 256] prefill;
       prompts that share no full page (the prefix cache breaks recurrent
       state, as for the hybrid); qmatmul 1 x 4 per micro-run.
   Phase 2 also holds qmatmul at their decode shapes (8x2560x151936 and
   8x4096x32064, ragged N, 8x4096x65536 int8; 8x6912x2560 a16w8; and
   32x4096x32064, phi3.5-moe's head at a speculative verify) with split-K
   on and off, and phase 5 holds flash at qwen's path shape [2*20, 2048,
   128] bf16 causal, all timed in phase 8.
15-16. The cross-attention families, each run as phases 12-14 run theirs
   (random bf16 weights from seed 0, each model freed before the next;
   quantized continuous serving, bucket 8 x 512, k = 4, phase 9's first
   wave once paged and once dense, counted from zero, every stream held by
   phase 9's gap rule to the plain loop replayed at its positions in
   batches of 8, pages in use == scratch + prefix entries after the paged
   wave; a prefill line and a micro-run line with the profiler split). In
   both, serving leaves the cross caches at zero and the decode head is
   float, as in the reference.
   15. seamless-m4t-large-v2 at its full size (24 encoder and 24 decoder
       layers, 1,632,800,768 parameters): prefill of frames [2, 2048,
       1024] bf16 (standard normal, numpy seed 0, standing in for the
       stubbed audio frontend) and tokens [2, 512]: 48 flash launches
       (24 non-causal in the encoder, 24 causal in the decoder), each held
       to the plain attention on its own inputs, and ``PREFILL_TOL`` at
       full depth; qmatmul 0 x 4 per micro-run (its GELU MLP has no
       quantized route).
   16. llama-3.2-vision-90b at full width, cut to 3 of its 20 superblocks
       (15 of 100 layers): every cross gate drawn from
       a seed, uniform in [0.5, 1] (the reference starts them at zero);
       prefill of tokens [2, 2048] and vision [2, 4096, 8192] bf16: 12
       flash launches, each held on its own inputs, ``PREFILL_TOL`` at the
       cut depth, the logits with the gates as set against the gates at 0
       (how far the cross-attention moves them), and 64 decode steps over
       ``init_cross_cache(vision)`` held to the forward's first 64
       positions by ``PREFILL_TOL``; qmatmul 12 x 4 per micro-run (the 4
       self blocks' down-projections in each of 3 superblocks).
   Phase 2 also holds qmatmul at 8x28672x8192 a16w8 (the vlm
   down-projection) with split-K on and off, and phase 5 holds flash at
   [2*16, 2048, 64] bf16 non-causal, [2*16, 512, 64] causal and [2*64,
   2048, 128] causal, all timed in phase 8 beside their bounds and SDPA.
17. Training at full size: qwen1.5-4b (40 layers, 3.95 B random bf16
    parameters from ``init_train_state(0)``), the train_4k shape cut
    to batch 2 x 4096, adamw at the config's lr (3e-4) on the synthetic
    stream's first batch (seed 0), through ``plan.executable("train")``.
    The step-0 training loss (the plain attention, as in the reference's
    training) is held within ``TRAIN_LOSS_TOL`` of the cross-entropy of
    the prefill forward's logits (flash) on the same batch; 8 steps on
    that batch, the loss falling by ``TRAIN_LOSS_DROP`` (on fresh batches
    the config's lr, without warmup as in the reference, spikes in the
    first steps at this width); flash and qmatmul launched 0 times over the
    steps; the peak memory, the median step time, tokens/s, the profiler
    split of one step and its roofline line (below). Then restart:
    qwen1.5-4b at full width cut to 2 layers (the full vocab), 6 steps
    with a checkpoint every 3 and a failure injected at step 4, resumed
    by a new trainer, on the stream: its losses are printed, and its
    parameters are ``torch.equal`` to an uninterrupted run's; each
    checkpoint's size and save time are printed, in a directory under
    ``build/`` deleted after (the step-3 checkpoint is hard-linked into
    a directory of its own for phase 20, deleted by it).
18. adafactor at full width: mistral-large-123b cut to 2 of 88 layers (d
    12288, d_ff 28672, vocab 32768: 3.57 B parameters), batch 1 x 4096, 3
    steps: finite losses and grad norms, the factored state's bytes, the
    peak memory and the step time.
19. The plan smoke CLI at full width, with no model resident:
    ``python -m repro_torch.plan --arch yi-6b --quantized --warm --out
    build/plan_yi-6b.json`` as a subprocess (6.06 B random bf16
    parameters, two waves of the default bucket's batch). It must exit 0,
    print ``=> OK`` (the second wave built no step and hit the cache) and
    launch qmatmul; its ``describe()`` is read back: ``mesh_axes`` must be
    ``{"data": 1, "model": 1}`` and ``params`` must hold one key per leaf
    of ``bridge.leaf_groups``. Then ``--data 2`` and ``--multi-pod`` (in
    parallel) must exit non-zero within ``MESH_CLI_TIMEOUT_S``, printing
    ``need 2 devices, have 1`` and ``need 512 devices, have 1``.
20. Training sharded on the 1x1 nccl mesh: phase 17's restart config
    under its mode (megatron), the parameters and the optimizer state
    placed as DTensors (``plan.init_train_state(0, shard=True)``), a
    ``Trainer`` on the plan's mesh resumes from phase 17's step-3
    checkpoint (plain -> mesh) and runs steps 3-5 (0 launches of either
    kernel); its final parameters, its losses and its step-6 checkpoint
    (written from the mesh, read back as plain tensors: mesh -> plain)
    must be ``torch.equal`` to phase 17's uninterrupted plain run (every
    shard is whole on one device). One more sharded step is profiled
    (the idle share beside phase 17's plain one), one step's gradients
    go through the collective ``error_feedback_reduce`` over "data" (a
    group of one), equal to the local form, and the train CLI ``--debug
    --mode megatron --steps 2`` runs in its own process beside the
    phase. Prints the step times beside the plain resume's, the peak
    memory and the save time from the mesh.
21. The staged placement and the production dry run, each in a process
    of its own (``chip_smoke.py --staged-placement`` and one
    ``python -m repro_torch.launch.dryrun`` per cell, all started
    together). The placement process holds yi-6b at full width (random
    bf16 from seed 0) and, as rank 0 and then rank 4 of a fake world of 8
    (``launch.mesh.placeholder_world``) on a 2x4 ``cuda`` mesh, places
    the two-stage megatron plan's parameters
    (``plan.iter_shard_params``): every local shard must be
    ``torch.equal`` to its slice of the plain parameter; the growth of the
    caching allocator's requested bytes over the placement must equal the
    shards' bytes, and its allocated bytes (each block rounded up to 512
    bytes, a large block's unsplit remainder of up to 1 MB with it) must
    cover them in 512-byte blocks; the dry run's per-device parameter
    bytes for the same plan (``launch.dryrun.placed_param_bytes``, on
    meta) must equal the shards' bytes; and the two ranks' staged members
    must be disjoint and cover all 32 layers. The dry-run cells: yi-6b
    ``train_4k`` single-pod with one and with two stages, phi3.5-moe
    ``decode_32k`` multi-pod, zamba2 ``long_500k`` single-pod (each "1
    ok") and yi-6b ``long_500k`` (skipped with the reference's reason);
    each record's memory and roofline lines are printed.
22. The port's static analysis: ``python -m repro_torch.analysis --json
    -`` in a process of its own (stdlib only; the chip host's Python). It
    must exit 0 with an ``ok`` report of RA201, RA401 and RA501 over
    ``src/repro_torch`` under ``analysis_baseline_torch.json``; prints
    ``analysis: OK (N files, 3 rules, B baselined)``.

Roofline lines: the yi-6b prefill (phase 6), the yi-6b quantized paged
micro-run (phase 9) and the qwen1.5-4b train step (phase 17) each run one
extra, untimed call under ``repro_torch.launch.step_analysis.analyze_step``
and print ``roofline <step>: C=... M=... dom=... bound=... measured=...
(x...) model-FLOPs share ...``: the compute and memory terms over the
H100's peaks (``launch.roofline``), the measured time from the phase's
timed calls, and the model FLOPs (``launch.model_flops``) over it against
989 TFLOP/s. The kernel calls the wrappers report to the analysis must
equal each wrapper's launches over the call (32 flash in the prefill, 33 x
4 qmatmul in the micro-run, none in training), and the step's flops must
be at least its model FLOPs. Every bound is the kernel's analytic work
(``ops.work`` of each kernel) over ``H100Target``.

The last two lines are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import os

# cuBLAS reads this once, when it first starts: the training phases run
# with deterministic algorithms (their restart is held bit for bit)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# NVIDIA H100 SXM data sheet, dense rates, 700 W: every bound below
from repro_torch.core.device import DEFAULT_H100 as H100  # noqa: E402

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
# LM head of a batch-4 decode step and its a16w8 MLP down-projection, the
# same at batch 8 (the continuous bucket of phase 9 and phase 10's draft)
# and at 8 slots x 4 positions (phase 10's verify)
LM_QMATMUL = [(4, 4096, 64000, "int8", "int8", "int16"),
              (4, 11008, 4096, "int16", "int8", "int16")]
LM_QMATMUL_M8 = [(8,) + s[1:] for s in LM_QMATMUL]
LM_QMATMUL_M32 = [(32,) + s[1:] for s in LM_QMATMUL]
# zamba2's quantized decode step at batch 8 (phase 11): the int8 LM head
# and the shared block's a16w8 down-projection
HYBRID_QMATMUL = [(8, 2560, 32000, "int8", "int8", "int16"),
                  (8, 10240, 2560, "int16", "int8", "int16")]
# phases 12-14's quantized decode at batch 8: qwen1.5-4b's int8 head and
# a16w8 down-projection, and the int8 heads of phi3.5-moe and rwkv6-7b
# (their FFNs stay float, as in the reference); and phi3.5-moe's head at a
# speculative verify's M = 32 (8 slots x 4 positions)
FAMILY_QMATMUL = [(8, 2560, 151936, "int8", "int8", "int16"),
                  (8, 6912, 2560, "int16", "int8", "int16"),
                  (8, 4096, 32064, "int8", "int8", "int16"),
                  (8, 4096, 65536, "int8", "int8", "int16"),
                  (32, 4096, 32064, "int8", "int8", "int16")]
# phase 16's quantized decode at batch 8: llama-3.2-vision's a16w8 SwiGLU
# down-projection of a self block (its head and cross blocks stay float,
# and seamless runs no qmatmul at all, as in the reference)
VLM_QMATMUL = [(8, 28672, 8192, "int16", "int8", "int16")]
LM_SHAPES = (LM_QMATMUL + LM_QMATMUL_M8 + LM_QMATMUL_M32 + HYBRID_QMATMUL
             + FAMILY_QMATMUL + VLM_QMATMUL)

# decode-sized M for the 16-row tile and split-K: (M, K, N)
SMALL_M_SHAPES = [(M, K, 300) for M in (1, 4, 16, 17) for K in (70, 11008)]

# flash cases (BH, Sq, Sk, hd, dtype, causal, q_start, x100): the grid of
# tests/test_flash_attention.py, its block sweep as shapes, the ragged
# q_start case, the whole grid again in bf16, bf16 at every head dim, the
# grid at zamba2's head dim 80 in fp32 and bf16, and the two LM path
# shapes
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
    + [case for hd in (8, 16, 32, 64, 80, 128)
       for case in ((3, 77, 77, hd, "bf16", True, 0, False),
                    (2, 48, 64, hd, "bf16", True, 16, False),
                    (2, 96, 96, hd, "bf16", False, 0, False))]
    + [c[:3] + (80, dtype) + c[5:] for c in _FLASH_GRID if c[4] == "fp32"
       for dtype in ("fp32", "bf16")]
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
# phase 11: zamba2 at full width, its prefill shape through flash (one
# launch per shared-block call site)
HYBRID_ARCH = "zamba2-2.7b"
FLASH_PATH_HYBRID = (PREFILL_BATCH * 32, PREFILL_SEQ, PREFILL_SEQ, 80,
                     "bf16", True, 0, False)
HYBRID_PROMPT = (42, 48)      # prompt lengths: phase 9's 40 + 2-8
# phases 12-14: the other dense configs, the MoE family and RWKV at full
# width; phi3.5-moe cannot run whole on one 80 GB card (83.7 GB in bf16)
QWEN_ARCH, RWKV_ARCH = "qwen1.5-4b", "rwkv6-7b"
MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_LAYERS = 12
# rwkv6-7b (4 of its 32 layers), zamba2 (18 of 54: 3 of 9 groups),
# qwen1.5-4b (10 of 40), phi3.5-moe (12 of 32) and llama-3.2-vision (3 of
# 20 superblocks) are cut in depth for the run's time limit: their
# serving waves and plain replays are host-bound (rwkv6's prefill loops
# over the tokens on the host layer by layer), so their time scales with
# the layers; a slower host took 1,167 s with twice these depths
RWKV_LAYERS, HYBRID_LAYERS, QWEN_LAYERS = 4, 18, 10
FLASH_PATH_QWEN = (PREFILL_BATCH * 20, PREFILL_SEQ, PREFILL_SEQ, 128, "bf16",
                   True, 0, False)
# phases 15-16: the cross-attention families. seamless-m4t-large-v2 at its
# full size; its prefill runs 2048 frames through the encoder (non-causal
# flash, head dim 64) and max(2048 // 4, 128) = 512 tokens through the
# decoder (causal flash); its cross-attention (512 queries over 2048 frames)
# runs the plain path, as in the reference. llama-3.2-vision-90b at full
# width, cut in depth (the whole model's 175 GB does not fit one 80 GB
# card); its self-attention runs causal flash at head dim 128 and its
# cross-attention (2048 queries over 4096 patches) the plain path
SEAMLESS_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "llama-3.2-vision-90b"
VLM_SUPERBLOCKS = 3
SEAMLESS_DEC_SEQ = max(PREFILL_SEQ // 4, 128)
FLASH_PATH_SEAMLESS_ENC = (PREFILL_BATCH * 16, PREFILL_SEQ, PREFILL_SEQ, 64,
                           "bf16", False, 0, False)
FLASH_PATH_SEAMLESS_DEC = (PREFILL_BATCH * 16, SEAMLESS_DEC_SEQ,
                           SEAMLESS_DEC_SEQ, 64, "bf16", True, 0, False)
FLASH_PATH_VLM = (PREFILL_BATCH * 64, PREFILL_SEQ, PREFILL_SEQ, 128, "bf16",
                  True, 0, False)
# the vision LM's cross-attention gates start at zero (a fresh cross block
# adds nothing from its attention); phase 16 draws them from this seed,
# uniform in [0.5, 1]
VLM_GATE_SEED = 16
FLASH_PATHS_CROSS = [FLASH_PATH_SEAMLESS_ENC, FLASH_PATH_SEAMLESS_DEC,
                     FLASH_PATH_VLM]
# RWKV's prefill runs its recurrence token by token on the host (the
# reference has no kernel for it): its latency is the median of 2 calls,
# and its device split is profiled on the first 256 tokens (the profiler's
# cost grows with the 3 launches per token and layer)
RWKV_PREFILL_REPS, RWKV_PROFILE_SEQ = (2, 1), 256
# phase 17: qwen1.5-4b trained at full size; train_4k cut to batch 2, 8
# steps on the synthetic stream's first batch (seed 0): on fresh batches
# the config's adamw (lr 3e-4, no warmup, as in the reference) spikes in
# its first steps at this width, so whether the model learns is read on
# one batch. The step-0 training loss (plain attention) against the
# cross-entropy of the flash forward's logits on the same batch: the two
# round attention at other places, which averages out over 8192 positions
# (nats, absolute)
TRAIN_ARCH = QWEN_ARCH
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 4096, 8
TRAIN_LOSS_TOL = 0.02
# the loss after the 8th step is at least this far below step 0's (nats)
TRAIN_LOSS_DROP = 2.0
# restart: qwen at full width cut to 2 layers, a checkpoint every 3 steps,
# a failure injected at step 4
RESTART_LAYERS, RESTART_STEPS, RESTART_CKPT_EVERY = 2, 6, 3
RESTART_FAIL_AT = 4
# phase 20: the train CLI on the 1x1 mesh, in a process of its own
TRAIN_CLI_TIMEOUT_S = 120
# phase 19: the plan smoke CLI at full width, in a process of its own
PLAN_CLI_ARCH = "yi-6b"
PLAN_CLI_TIMEOUT_S = 300
PLAN_CLI_PATH = "yi-6b plan CLI warm check, two waves (phase 19)"
# phase 20: phase 17's restart resumed sharded on the 1x1 mesh
SHARDED_TRAIN_PATH = (f"{TRAIN_ARCH} ({RESTART_LAYERS} layers) sharded 1x1 "
                      f"resume, steps 3-5 (phase 20)")
# phase 7: the resident yi-6b run sharded on the 1x1 mesh
SHARDED_MODE = "megatron_sp"
SHARDED_TIMED_STEPS = 8
SHARDED_PATH = "yi-6b sharded 1x1 prefill/fifo (phase 7)"
# phase 19: mesh flags larger than the world must fail this fast
MESH_CLI_TIMEOUT_S = 30
MESH_CLI_FAILS = ((["--data", "2"], "need 2 devices, have 1"),
                  (["--multi-pod"], "need 512 devices, have 1"))

# phase 21: the staged placement at full width as two ranks of a fake
# world of 8, and the dry run's cells, each process with its time limit
STAGED_ARCH, STAGED_MESH, STAGED_RANKS = "yi-6b", (2, 4), (0, 4)
STAGED_TIMEOUT_S = 150
ALLOC_BLOCK = 512                 # the caching allocator's smallest block
DRYRUN_TIMEOUT_S = 150
ANALYSIS_TIMEOUT_S = 60           # phase 22: seconds on any host
DRYRUN_CELLS = (                  # (arch, shape, flags, status)
    ("yi-6b", "train_4k", ["--single-pod", "--stages", "1"], "ok"),
    ("yi-6b", "train_4k", ["--single-pod", "--stages", "2"], "ok"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", ["--multi-pod"], "ok"),
    ("zamba2-2.7b", "long_500k", ["--single-pod"], "ok"),
    ("yi-6b", "long_500k", ["--single-pod"], "skipped"),
)

# phase 18: adafactor at mistral-large's full width, cut to 2 of 88 layers
ADAFACTOR_ARCH, ADAFACTOR_LAYERS = "mistral-large-123b", 2
ADAFACTOR_BATCH, ADAFACTOR_STEPS = 1, 3

# the positions of a prefill held against a decode-step replay
RECURRENT_CHECK = 64
SERVE_BATCH, SERVE_MAX_LEN, SERVE_TOKENS, SERVE_WAVES = 4, 256, 8, 2
# phase 9: continuous serving; streams are held to the plain loop up to the
# first step whose top-2 logit gap is under CONT_MIN_GAP (random
# full-width weights guarantee no gap beyond it)
CONT_BATCH, CONT_MAX_LEN, CONT_K = 8, 512, 4
CONT_WAVES, CONT_REQUESTS, CONT_SYSTEM = 2, 12, 40
CONT_SEED, CONT_MIN_GAP = 900, 0.1
# phase 10: speculative lanes, k = phase 9's, the default draft depth
SPEC_K = CONT_K


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


def bound_ms(work):
    """A kernel call's least time on the card, in ms, and what bounds it:
    its analytic work (``ops.work``) over the H100's peaks."""
    t, by = H100.bound_s(work.ops, work.bytes, work.dtype)
    return t * 1e3, by


def time_shapes(qlinear, qlinear_ref, dev, shapes):
    from repro_torch.kernels.qmatmul.ops import work

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
        wk = work(M, K, N, x.dtype, w.dtype, "int8", bias=True)
        t, by = bound_ms(wk)
        rows.append(dict(
            M=M, K=K, N=N, ms=ms, plain_ms=plain, library_ms=lib,
            library_note=lib_note, bound_ms=t, bound_by=by,
            ops=wk.ops, bytes=wk.bytes,
        ))
        print(f"qmatmul {M}x{K}x{N} int8: kernel {ms:.6f} ms, bound "
              f"{t:.6f} ms ({by}), plain "
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


def check_lm_shapes(chk, dev, sms):
    """qmatmul at the LM shapes with the path's operand types, at M = 4, 8
    and 32, each under its own plan, with one split and with four; int16 x
    over both a moderate and the full range (the int32 sum then wraps).
    Returns the number of split-K plans run."""
    rng = np.random.default_rng(5)
    n_split = 0
    for (M, K, N, dx, dw, out) in LM_SHAPES:
        w = torch.from_numpy(_rand(rng, (K, N), dw)).to(dev)
        xs = [torch.from_numpy(_rand(rng, (M, K), dx)).to(dev)]
        if dx == "int16":
            xs.append(torch.from_numpy(rng.integers(
                -32768, 32768, (M, K)).astype(np.int16)).to(dev))
        auto = chk.ops.plan(M, K, N, sms)
        plans = {auto, chk.ops.Plan(auto.block_m, 1, K),
                 chk.ops.Plan(auto.block_m, 4, K // 4)}
        n_split += sum(p.splits > 1 for p in plans)
        for x in xs:
            for p in plans:
                for shift in (2, 7, 10):
                    chk.compare(x, w, None, plan=p, shift=shift,
                                out_dtype=out)
    return n_split


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


def within_prefill_tol(agree):
    return (agree["mean_abs"] <= PREFILL_TOL["mean_abs"]
            and agree["max_abs"] <= PREFILL_TOL["max_abs"]
            and agree["argmax_agree"] >= PREFILL_TOL["argmax_agree"])


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
    events = device_events(prof)
    for e in events:
        key = ("flash_ms" if "flash_kernel" in e.key else
               "qmatmul_ms" if "qmatmul_kernel" in e.key else
               "other_device_ms")
        split[key] += e.self_device_time_total / 1e3 / calls
    split["profiled_wall_ms"] = wall
    # the largest device entries, ms per call
    split["top"] = [(e.key[:60], e.self_device_time_total / 1e3 / calls)
                    for e in sorted(events, key=lambda e:
                                    -e.self_device_time_total)[:6]]
    return split


def device_busy_ms(split):
    return split["flash_ms"] + split["qmatmul_ms"] + split["other_device_ms"]


def check_unbuilt_head_dim(dev, flash_ops, attention, hd=96):
    """``mha`` routes a prefill at any ``hd % 8 == 0`` (the reference's
    rule) to the flash wrapper; at a head dim the kernel is not built for,
    the wrapper must raise on the card, not give way to the plain
    attention."""
    if hd in flash_ops.HEAD_DIMS:
        raise AssertionError(f"head dim {hd} is built; pick another")
    q, k, v = (torch.randn(2, 40, h, hd, device=dev, dtype=torch.bfloat16)
               for h in (4, 2, 2))
    before = flash_ops.launches
    try:
        attention.mha(q, k, v, causal=True)
    except ValueError as e:
        if flash_ops.launches != before:
            raise AssertionError("flash launched at an unbuilt head dim")
        print(f"mha at unbuilt head dim {hd} on the card raises: {e}")
        return
    raise AssertionError(f"mha at unbuilt head dim {hd} ran on the card")


def attention_sites(cfg):
    """Self-attention calls per forward: every layer of the decoder LMs,
    one per group (the shared block) of the hybrid, none in RWKV, every
    encoder and decoder layer of the encoder-decoder, every self block of
    the vision LM (its cross-attention never runs flash here: Sq != Sk)."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return (cfg.n_enc_layers or cfg.n_layers) + cfg.n_layers
    if cfg.family == "vlm":
        n_super = cfg.n_layers // cfg.cross_attn_every
        return n_super * (cfg.cross_attn_every - 1)
    return cfg.n_layers


def qmatmul_per_step(cfg):
    """qmatmul launches per quantized decode step: the int8 LM head (the
    encoder-decoder's and the vision LM's heads stay float, as in the
    reference) and each a16w8 down-projection call where the MLP is
    quantized (every self block; the hybrid's shared block at each call
    site)."""
    head = 0 if cfg.family in ("encdec", "vlm") else 1
    return head + (attention_sites(cfg) if cfg.quantized_mlp else 0)


def describe_model(cfg, model, arch):
    """One line of the model's widths, its cut and its size."""
    from repro_torch.configs import get_config
    from repro_torch.launch.model_flops import param_counts

    full = get_config(arch)
    n_params = sum(p.numel() for p in model.parameters())
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if cfg.family == "hybrid":
        shape = (f" in {attention_sites(cfg)} groups with one shared "
                 f"attention block, ssm state {cfg.ssm_state}, ssm head dim "
                 f"{cfg.ssm_head_dim}")
    elif cfg.family == "moe":
        shape = (f", {cfg.n_experts} experts of d_ff {cfg.moe_d_ff} (top "
                 f"{cfg.top_k}, {cfg.n_shared_experts} shared)")
    elif cfg.family == "ssm":
        shape = (f", {cfg.d_model // cfg.ssm_head_dim} wkv heads of "
                 f"{cfg.ssm_head_dim}")
    elif cfg.family == "encdec":
        shape = (f" in the decoder and {cfg.n_enc_layers} in the encoder, "
                 f"LayerNorm, GELU MLP with biases")
    elif cfg.family == "vlm":
        shape = (f" in {cfg.n_layers // cfg.cross_attn_every} superblocks of "
                 f"{cfg.cross_attn_every - 1} self blocks and one gated "
                 f"cross block, {cfg.n_image_tokens} image tokens")
    else:
        shape = ", QKV bias" if cfg.qkv_bias else ""
    cut = ""
    if cfg.n_layers != full.n_layers:
        fits = param_counts(full)[0] * 2 <= H100.hbm_bytes   # bf16
        why = ("the run's time limit" if fits
               else "the whole model does not fit one card")
        cut = f" (cut in depth from {full.n_layers}: {why})"
    return (f"{cfg.name}: {cfg.n_layers} layers{cut}{shape}, d_model "
            f"{cfg.d_model}, {cfg.n_heads} heads (kv {cfg.n_kv}, head dim "
            f"{cfg.head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params}"
            f" = {n_params / 1e9:.3f} B parameters, {n_bytes / 1e9:.2f} GB")


@contextlib.contextmanager
def moe_routing(counts=None, routes=None, replay=None):
    """Within the block, every MoE dispatch adds its valid slots and its
    assignments to ``counts`` (``kept``, ``assigned``); every routing is
    appended to ``routes``; with ``replay`` (a list of routings) each
    routing is taken from it in order instead of computed."""
    import repro_torch.layers.moe as moe

    real_route, real_dispatch = moe.route, moe.dispatch
    held = iter(replay) if replay is not None else None

    def route(*args):
        out = next(held) if held is not None else real_route(*args)
        if routes is not None:
            routes.append(out)
        return out

    def dispatch(expert_ids, gate_vals, n_experts, cap):
        out = real_dispatch(expert_ids, gate_vals, n_experts, cap)
        if counts is not None:
            counts["kept"] += int(out[1].sum())
            counts["assigned"] += expert_ids.numel()
        return out

    moe.route, moe.dispatch = route, dispatch
    try:
        yield
    finally:
        moe.route, moe.dispatch = real_route, real_dispatch


def run_prefill(dev, flash_ops, attention, arch="yi-6b", overrides=None,
                reps=(5, 2), profile_seq=None, smi=None):
    """Phases 6 and 11-14: a forward at full width (``overrides`` cut its
    depth) through the flash kernel; ``reps`` are the timed calls and the
    profiled ones; with ``profile_seq`` the profiled calls take only the
    first ``profile_seq`` tokens of each sequence, and the idle share is
    read against their own host-clock median. With ``smi`` (the card's
    name and power limit) also the forward's roofline line."""
    from repro_torch.models.base import ShapeSpec
    from repro_torch.plan import build_plan

    shape = ShapeSpec(f"prefill_{PREFILL_BATCH}x{PREFILL_SEQ}", PREFILL_SEQ,
                      PREFILL_BATCH, "prefill")
    plan = build_plan(arch, shape, device=dev, config_overrides=overrides)
    cfg = plan.cfg
    t0 = time.perf_counter()
    model = plan.init_params(seed=0)
    torch.cuda.synchronize()
    print(describe_model(cfg, model, arch)
          + f", init {time.perf_counter() - t0:.1f} s")
    if cfg.family == "vlm":
        gates = set_gates(model)
        print(f"{cfg.name}: cross-attention gates set from seed "
              f"{VLM_GATE_SEED}, uniform in [0.5, 1] (bf16): {gates}")
    prefill = plan.executable("prefill")
    batch = prefill_batch(cfg, shape, dev)

    sites = attention_sites(cfg)
    site_errs = []
    drops = dict(kept=0, assigned=0)
    routes = []               # the MoE routing of each layer, in order
    flash_ops.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with held_sites(attention, site_errs), moe_routing(drops, routes):
        logits = prefill.fn(model, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = flash_ops.launches
    if launches != sites or len(site_errs) != sites:
        raise AssertionError(f"flash launched {launches} times in one "
                             f"{cfg.name} forward, expected {sites}")
    if logits.shape != (*batch["tokens"].shape, cfg.vocab) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    held = (f"each site's flash output vs the plain attention on its own "
            f"inputs: max |diff| {max(site_errs):.6f} (tolerance "
            f"{FLASH_TOL['bf16']})" if sites else "no attention")
    inputs = ", ".join(f"{name} {list(t.shape)}" for name, t in batch.items())
    print(f"prefill {cfg.name} ({inputs}): {launches} "
          f"flash launches == attention sites x 1 call; logits finite; "
          f"{held}; first call {first_s:.1f} s, peak card memory "
          f"{peak_gb:.2f} GB")
    if cfg.family == "moe":
        if drops["assigned"] != cfg.n_layers * PREFILL_BATCH * PREFILL_SEQ \
                * cfg.top_k:
            raise AssertionError(f"MoE dispatch counted {drops}")
        print(f"prefill {cfg.name}: capacity dropped "
              f"{drops['assigned'] - drops['kept']} of {drops['assigned']} "
              f"expert assignments (share "
              f"{1 - drops['kept'] / drops['assigned']:.6f}; capacity "
              f"factor 1.25)")
    if sites:
        plain = plain_forward(model, batch, attention)
        agree = prefill_agreement(logits, plain)
        line = (f"vs plain chunked attention: mean |diff| "
                f"{agree['mean_abs']:.6f}, max |diff| {agree['max_abs']:.6f}"
                f", argmax agreement {agree['argmax_agree']:.6f} at "
                f"{agree['robust_positions']} positions with top-2 gap > 0.1")
        if cfg.family == "hybrid":
            # the random hybrid stack amplifies any rounding difference
            # (see hybrid_agreement); the logits are held on its first group
            agree = hybrid_agreement(model, batch, attention, plain, agree,
                                     line)
        elif cfg.family == "moe":
            # rounding-sized differences flip routing choices (see
            # routing_held_agreement); the logits are held with the flash
            # forward's routing
            agree = routing_held_agreement(model, batch, attention, plain,
                                           agree, line, logits, routes)
        else:
            print(f"prefill {cfg.name}: logits {line} (tolerance "
                  f"{PREFILL_TOL})")
        del plain
    else:
        agree = recurrent_agreement(model, batch, attention)
    del routes
    if not within_prefill_tol(agree):
        raise AssertionError(f"{cfg.name} prefill disagrees: {agree}")
    if cfg.family == "vlm":
        vlm_cross_checks(model, batch, logits)
    del logits

    lat = []
    for _ in range(reps[0]):
        t = time.perf_counter()
        prefill.fn(model, batch)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    out = dict(launches=launches, agreement=agree,
               median_ms=statistics.median(lat), latencies_ms=lat)
    if smi is not None:
        out["roofline"] = roofline(
            f"{cfg.name} prefill [{PREFILL_BATCH}, {PREFILL_SEQ}]",
            lambda: prefill.fn(model, batch), out["median_ms"], cfg, shape,
            {"qmatmul": 0, "flash_attention": sites}, smi)
    if profile_seq is None:
        out["split"] = profile_split(lambda: prefill.fn(model, batch),
                                     calls=reps[1])
    else:
        short = {"tokens": batch["tokens"][:, :profile_seq]}
        with torch.inference_mode():
            lat = []
            for _ in range(3):
                t = time.perf_counter()
                model(short)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t) * 1e3)
            out["split"] = profile_split(lambda: model(short), calls=reps[1])
        out.update(split_seq=profile_seq,
                   split_median_ms=statistics.median(lat))
    if cfg.family == "moe":
        out["drops"] = drops
    return model, out


def prefill_batch(cfg, shape, dev):
    """The family's prefill inputs at ``shape``: tokens from numpy seed 0,
    and the stubbed frontends' frame or patch embeddings, standard normal
    from numpy seed 0, in bf16."""
    from repro_torch.models.base import prefill_inputs

    rng = np.random.default_rng(0)
    batch = {}
    for name, (dims, dtype) in prefill_inputs(cfg, shape).items():
        if name == "tokens":
            batch[name] = torch.from_numpy(lm_tokens(cfg.vocab, dims, 0))
        else:
            batch[name] = torch.from_numpy(
                rng.standard_normal(dims, dtype=np.float32)).to(dtype)
    return {name: t.to(dev) for name, t in batch.items()}


def set_gates(model):
    """Draw every cross block's gate from ``VLM_GATE_SEED``, uniform in
    [0.5, 1] (the reference starts them at zero, where the cross-attention
    adds nothing); returns them as stored (bf16)."""
    vals = np.random.default_rng(VLM_GATE_SEED).uniform(
        0.5, 1.0, len(model.cross_blocks))
    with torch.no_grad():
        for blk, g in zip(model.cross_blocks, vals):
            blk.gate.fill_(float(g))
    return [round(float(blk.gate.float()), 4) for blk in model.cross_blocks]


def vlm_cross_checks(model, batch, logits, n=RECURRENT_CHECK):
    """Phase 16's two checks of the cross path on the prefill's inputs.

    How far the cross-attention moves the logits: the forward with every
    gate at 0 against ``logits`` (gates as set); it must move them. And
    decode over a filled cross cache: ``init_cross_cache`` of the patch
    embeddings, then ``n`` decode steps over the first ``n`` tokens, held
    to ``logits`` at those positions by PREFILL_TOL (the cross-attention
    does not mix positions, so decode sees what the forward saw)."""
    gates = [blk.gate.clone() for blk in model.cross_blocks]
    with torch.no_grad():
        for blk in model.cross_blocks:
            blk.gate.zero_()
    try:
        zero = model(batch)
    finally:
        with torch.no_grad():
            for blk, g in zip(model.cross_blocks, gates):
                blk.gate.copy_(g)
    moved = prefill_agreement(logits, zero)
    del zero
    if not moved["mean_abs"] > 0:
        raise AssertionError("the cross-attention does not move the logits")
    state = model.decode_state(PREFILL_BATCH, n)
    state["cross_k"], state["cross_v"] = model.init_cross_cache(
        batch["vision"])
    with torch.inference_mode():
        steps = torch.stack([model.decode_step(state, batch["tokens"][:, i],
                                               i)[0] for i in range(n)],
                            dim=1)
    agree = prefill_agreement(steps, logits[:, :n])
    print(f"prefill {model.cfg.name}: gates as set vs gates at 0: mean "
          f"|diff| {moved['mean_abs']:.6f}, max |diff| "
          f"{moved['max_abs']:.6f}, argmax agreement "
          f"{moved['argmax_agree']:.6f} at {moved['robust_positions']} "
          f"positions with top-2 gap > 0.1 (how far the cross-attention "
          f"moves the logits); {n} decode steps over init_cross_cache vs "
          f"the forward's first {n} positions: mean |diff| "
          f"{agree['mean_abs']:.6f}, max |diff| {agree['max_abs']:.6f}, "
          f"argmax agreement {agree['argmax_agree']:.6f} at "
          f"{agree['robust_positions']} positions (tolerance {PREFILL_TOL})")
    if not within_prefill_tol(agree):
        raise AssertionError(f"decode over the cross cache disagrees with "
                             f"the forward: {agree}")


def recurrent_agreement(model, batch, attention, n=RECURRENT_CHECK):
    """RWKV's prefill against decode steps over the same tokens, held on
    its first layer.

    The prefill of the first ``n`` tokens and ``n`` decode steps from the
    zero state run the same recurrence, with every product at another
    shape (M = 2 n against M = 2), which cuBLAS rounds differently. The
    random stack amplifies that layer by layer, and a 2**-8 relative noise
    on the embeddings alone moves the full-depth logits further than the
    decode replay does. That is checked here (else the call raises); the
    full depth is printed beside that yardstick, and PREFILL_TOL holds the
    same model cut to its first layer (with the final norm and head)."""
    short = {"tokens": batch["tokens"][:, :n]}

    def replay():
        state = model.decode_state(PREFILL_BATCH, n)
        with torch.inference_mode():
            steps = [model.decode_step(state, short["tokens"][:, i], i)[0]
                     for i in range(n)]
            return model(short), torch.stack(steps, dim=1)

    prefill, steps = replay()
    full = prefill_agreement(steps, prefill)
    noise = embedding_noise(model, short, attention, prefill)
    if not noise["mean_abs"] > full["mean_abs"]:
        raise AssertionError(
            f"the 2**-8 embedding noise moves the full-depth logits by mean "
            f"|diff| {noise['mean_abs']}, no more than the decode replay "
            f"does ({full['mean_abs']}): the full depth must be held")
    blocks = model.blocks
    model.blocks = blocks[:1]
    try:
        agree = prefill_agreement(*reversed(replay()))
    finally:
        model.blocks = blocks
    print(f"prefill {model.cfg.name}: the first {n} positions vs {n} decode "
          f"steps, all {len(blocks)} layers: mean |diff| "
          f"{full['mean_abs']:.6f}, max "
          f"|diff| {full['max_abs']:.6f}, argmax agreement "
          f"{full['argmax_agree']:.6f} at {full['robust_positions']} "
          f"positions with top-2 gap > 0.1 (not held: 2**-8 relative noise "
          f"on the embeddings gives mean |diff| {noise['mean_abs']:.6f}, "
          f"argmax agreement {noise['argmax_agree']:.6f}); cut to its first "
          f"layer: mean |diff| {agree['mean_abs']:.6f}, max |diff| "
          f"{agree['max_abs']:.6f}, argmax agreement "
          f"{agree['argmax_agree']:.6f} at {agree['robust_positions']} "
          f"positions (tolerance {PREFILL_TOL})")
    return agree


def routing_held_agreement(model, batch, attention, plain, full_agree, line,
                           logits, routes):
    """The MoE's flash-vs-plain logits, held with the flash forward's
    routing.

    Each flash call rounds its output otherwise than the plain attention
    (every launch is held to it on its own inputs). In a random MoE that
    difference flips near-tied top-2 choices and, where capacity drops
    assignments, which ones keep a slot; each flip moves a token's FFN
    output by O(1), from the first layer on, so no cut in depth holds the
    free logits. A 2**-8 relative noise on the embeddings moves them
    further than flash does: that is checked here (else the call raises).
    So the free full depth is printed beside that yardstick, and
    PREFILL_TOL holds the full depth with the plain forward taking the
    flash forward's ``routes`` (each layer's expert ids and gates)."""
    noise = embedding_noise(model, batch, attention, plain)
    if not noise["mean_abs"] > full_agree["mean_abs"]:
        raise AssertionError(
            f"the 2**-8 embedding noise moves the full-depth logits by mean "
            f"|diff| {noise['mean_abs']}, no more than flash does "
            f"({full_agree['mean_abs']}): the free routing must be held")
    if len(routes) != model.cfg.n_layers:
        raise AssertionError(f"{len(routes)} routings recorded for "
                             f"{model.cfg.n_layers} layers")
    with moe_routing(replay=routes):
        held = plain_forward(model, batch, attention)
    agree = prefill_agreement(logits, held)
    print(f"prefill {model.cfg.name} free routing: logits {line} (not held: "
          f"the plain forward with 2**-8 relative noise on the embeddings "
          f"gives mean |diff| {noise['mean_abs']:.6f} > flash's, argmax "
          f"agreement {noise['argmax_agree']:.6f}); routing held to the "
          f"flash forward's: mean |diff| {agree['mean_abs']:.6f}, max |diff| "
          f"{agree['max_abs']:.6f}, argmax agreement "
          f"{agree['argmax_agree']:.6f} at {agree['robust_positions']} "
          f"positions (tolerance {PREFILL_TOL})")
    return agree


@contextlib.contextmanager
def held_sites(attention, errs):
    """Within the block, every flash call of a forward is also run through
    its plain version on the same inputs, and the largest difference per
    call is appended to ``errs``; a call outside ``FLASH_TOL`` raises. The
    plain version launches no kernel, so the launch count is the path's.

    The plain version's result is taken in fp32, before it would round to
    bf16: the kernel's bf16 output is held to the exact attention. A model
    whose attention outputs reach 4 (seamless's encoder does) has a bf16
    step of 0.031 there, so two roundings of one fp32 value, the kernel's
    and the plain version's, can differ by more than the 2e-2 tolerance
    while both are within half a step of it."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    real = attention.flash_attention

    def checked(q, k, v, *, causal=True, q_start=0, **kw):
        o = real(q, k, v, causal=causal, q_start=q_start, **kw)
        want = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             q_start=q_start)
        errs.append(float((o.float() - want.float()).abs().max()))
        torch.testing.assert_close(o.float(), want.float(),
                                   **FLASH_TOL["bf16"])
        return o

    attention.flash_attention = checked
    try:
        yield
    finally:
        attention.flash_attention = real


def plain_forward(model, batch, attention):
    """The same forward with the flash switch off (plain chunked
    attention)."""
    attention.USE_FLASH_KERNEL = False
    try:
        with torch.inference_mode():
            return model(batch)
    finally:
        attention.USE_FLASH_KERNEL = True


def embedding_noise(model, batch, attention, plain):
    """The plain forward with a 2**-8 relative noise on the embeddings,
    against ``plain``: the yardstick of how far a rounding-sized change
    moves the random stack's logits."""
    module = sys.modules[type(model).__module__]
    real_embed = module.embed
    gen = torch.Generator(device=plain.device)
    gen.manual_seed(1)
    noised = []

    def noisy_embed(params, tokens):
        noised.append(tokens.shape)
        e = real_embed(params, tokens)
        noise = torch.randn(e.shape, generator=gen, device=e.device)
        return (e.float() * (1 + 2.0 ** -8 * noise)).to(e.dtype)

    module.embed = noisy_embed
    try:
        noisy = plain_forward(model, batch, attention)
    finally:
        module.embed = real_embed
    if not noised:
        raise AssertionError("the embedding noise was never applied")
    return prefill_agreement(noisy, plain)


def hybrid_agreement(model, batch, attention, plain, full_agree, line):
    """The hybrid's flash-vs-plain logits, held on its first group.

    With random weights the Mamba2 stack is chaotic: the bf16 rounding
    difference of the first call site grows layer by layer, and a 2**-8
    relative noise on the embeddings alone moves the full-depth logits
    further than flash does. That is checked here: the noise yardstick's
    mean |diff| must exceed flash's at full depth (``full_agree``), or the
    call raises. So the full depth is printed beside that yardstick, and
    PREFILL_TOL holds the same model cut to its first group (6 Mamba2
    layers, one shared block call, the final norm and head) with flash and
    without."""
    noise = embedding_noise(model, batch, attention, plain)
    if not noise["mean_abs"] > full_agree["mean_abs"]:
        raise AssertionError(
            f"the 2**-8 embedding noise moves the full-depth logits by mean "
            f"|diff| {noise['mean_abs']}, no more than flash does "
            f"({full_agree['mean_abs']}): the full depth must be held, not "
            f"a cut")
    full = model.mamba_blocks
    model.mamba_blocks = full[:1]
    try:
        with torch.inference_mode():
            cut = model(batch)
        agree = prefill_agreement(cut, plain_forward(model, batch, attention))
    finally:
        model.mamba_blocks = full
    print(f"prefill {model.cfg.name} full depth: logits {line} (not held: "
          f"the plain forward with 2**-8 relative noise on the embeddings "
          f"gives mean |diff| {noise['mean_abs']:.6f} > flash's, argmax "
          f"agreement {noise['argmax_agree']:.6f}); cut to its first group: "
          f"flash vs plain mean |diff| {agree['mean_abs']:.6f}, max |diff| "
          f"{agree['max_abs']:.6f}, argmax agreement "
          f"{agree['argmax_agree']:.6f} at {agree['robust_positions']} "
          f"positions (tolerance {PREFILL_TOL})")
    return agree


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
                shifts=plan.ir.quant["mlp_shifts"], plan=plan, waves=waves)


def continuous_requests(vocab, wave):
    """One wave of phase 9: the shared system prompt plus 2-8 unique tokens
    each, ``max_new_tokens`` staggered over 4-24."""
    from repro_torch.serve import DecodeRequest

    system = [int(t) for t in np.random.default_rng(CONT_SEED).integers(
        1, vocab, CONT_SYSTEM)]
    rng = np.random.default_rng(CONT_SEED + 1 + wave)
    return [DecodeRequest(
        f"c{wave}r{i}",
        system + [int(t) for t in rng.integers(1, vocab,
                                               int(rng.integers(2, 9)))],
        max_new_tokens=4 + (20 * i) // (CONT_REQUESTS - 1))
        for i in range(CONT_REQUESTS)]


def greedy_loop(model, reqs, max_len, start=0, batch=None):
    """The plain version of continuous serving: greedy decode over the
    model's ``decode_step``, each request in its own batch row (rows never
    see each other), teacher-forcing its prompt, from position ``start``
    (attention windowed there when > 0) in a batch of ``batch`` rows
    (default: one per request; spare rows decode token 1). Returns per
    request id its generated tokens and the top-2 logit gap at each."""
    dev = model.device
    B = batch or len(reqs)
    steps = max(len(r.prompt) + r.max_new_tokens - 1 for r in reqs)
    feed = np.full((steps, B), -1, np.int32)
    feed[:, len(reqs):] = 1
    for b, r in enumerate(reqs):
        feed[:len(r.prompt), b] = r.prompt
    feed_t = torch.from_numpy(feed).to(dev)
    state = model.decode_state(B, max_len)
    window = (torch.full((B,), start, dtype=torch.int32, device=dev)
              if start else None)
    prev = torch.zeros(B, dtype=torch.int32, device=dev)
    toks, gaps = [], []
    for i in range(steps):
        logits, state = model.decode_step(
            state, torch.where(feed_t[i] >= 0, feed_t[i], prev), start + i,
            window_start=window)
        top2 = torch.topk(logits, 2, dim=-1).values
        prev = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(prev)
        gaps.append(top2[:, 0] - top2[:, 1])
    toks = torch.stack(toks).cpu().numpy()
    gaps = torch.stack(gaps).cpu().numpy()
    out = {}
    for b, r in enumerate(reqs):
        lo = len(r.prompt) - 1
        out[r.request_id] = ([int(t) for t in toks[lo:lo + r.max_new_tokens,
                                                    b]],
                             [float(g) for g in gaps[lo:lo + r.max_new_tokens,
                                                     b]])
    return out


def replay_loop(model, reqs, batcher):
    """The plain version of one continuous wave, replayed after it: the
    greedy loop at the positions the scheduler gave each request (paged:
    its local positions, from 0; dense: from its admission position), in
    batches of the bucket's size, so that every product has the serving
    step's shape and rounds as it does. Requests admitted at one position
    share a batch."""
    bucket = batcher.policy.buckets[0]
    ids = {r.request_id for r in reqs}
    starts = {e.request_id: 0 if batcher.paged else e.step
              for e in batcher.scheduler.events
              if e.kind == "admit" and e.request_id in ids}
    out = {}
    for start in sorted(set(starts.values())):
        group = [r for r in reqs if starts[r.request_id] == start]
        for j in range(0, len(group), bucket.batch):
            out.update(greedy_loop(model, group[j:j + bucket.batch],
                                   bucket.max_len, start, bucket.batch))
    return out


def hold_to_loop(results, loop):
    """Every stream equals the loop's up to the first step whose gap is under
    CONT_MIN_GAP; returns (tokens compared, streams equal in full)."""
    compared = full = 0
    for rid, (want, gaps) in loop.items():
        got = results[rid].tokens
        if len(got) != len(want):
            raise AssertionError(f"{rid}: {len(got)} tokens, expected "
                                 f"{len(want)}")
        n = next((i for i, g in enumerate(gaps) if g < CONT_MIN_GAP),
                 len(want))
        if got[:n] != want[:n]:
            raise AssertionError(
                f"{rid}: continuous {got} != plain loop {want} within the "
                f"first {n} steps (gaps {[round(g, 4) for g in gaps]})")
        compared += n
        full += got == want
    return compared, full


def serve_wave(batcher, reqs, plain, label, per_step, qmatmul_ops,
               flash_ops):
    """Serve one wave through a continuous batcher, counted from zero:
    qmatmul must launch ``per_step`` x k per micro-run and flash never,
    slots must be refilled, the streams are held to the plain loop that
    ``plain(batcher)`` gives after the wave ran, and a paged run must
    leave only scratch and prefix pages in use."""
    sched = batcher.scheduler
    before = dict(sched.stats())
    alloc = batcher.pool.allocator
    paged0 = alloc.stats() if alloc is not None else None
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    qmatmul_ops.launches = 0
    flash_ops.launches = 0
    t = time.perf_counter()
    res = batcher.run()              # fetches its tokens: synchronized
    wall = time.perf_counter() - t
    launches, flash = qmatmul_ops.launches, flash_ops.launches
    loop = plain(batcher)
    after = sched.stats()
    runs = after["micro_runs"] - before["micro_runs"]
    if launches != per_step * CONT_K * runs or runs == 0:
        raise AssertionError(f"{label}: qmatmul launched {launches} "
                             f"times over {runs} micro-runs, expected "
                             f"{per_step} x {CONT_K} per micro-run")
    if flash:
        raise AssertionError(f"{label}: flash launched {flash} times")
    refills = after["refills"] - before["refills"]
    if refills <= 0:
        raise AssertionError(f"{label}: no slot was refilled")
    compared, full = hold_to_loop(res, loop)
    if compared == 0:
        raise AssertionError(f"{label}: no step clears the gap rule")
    tokens = sum(len(r.tokens) for r in res.values())
    row = dict(label=label, wall_s=wall, tokens=tokens,
               tokens_per_s=tokens / wall, launches=launches,
               dispatches=after["dispatches"] - before["dispatches"],
               micro_runs=runs, refills=refills,
               ms_per_micro_run=wall * 1e3 / runs, compared=compared,
               full=full, streams=len(res), cache=batcher.cache.stats())
    if alloc is not None:
        p = alloc.stats()
        if p["pages_in_use"] != p["scratch_pages"] + p["prefix_entries"]:
            raise AssertionError(f"{label}: pages not reclaimed: {p}")
        row["prefix_hits"] = p["prefix_hits"] - paged0["prefix_hits"]
        skipped = p["skipped_prefill_tokens"] - paged0[
            "skipped_prefill_tokens"]
        row["skipped_prefill_tokens"] = skipped
        row["prompt_tokens"] = sum(len(r.prompt) for r in reqs)
        row["prefix_skip_share"] = skipped / row["prompt_tokens"]
        row["paged"] = p
    print(f"continuous {label}: {len(res)} requests, {tokens} tokens in "
          f"{wall:.4f} s = {row['tokens_per_s']:.4f} tokens/s (host "
          f"clock); {row['dispatches']} dispatches, {runs} micro-runs "
          f"({row['ms_per_micro_run']:.4f} ms each), {refills} refills; "
          f"{launches} qmatmul launches == {per_step} x {CONT_K} x {runs}; "
          f"vs plain loop: {compared} tokens compared, {full}/{len(res)} "
          f"streams equal in full"
          + (f"; prefix hits {row['prefix_hits']}, prefill skipped "
             f"{row['skipped_prefill_tokens']}/{row['prompt_tokens']} "
             f"prompt tokens ({row['prefix_skip_share']:.4f}); pages in "
             f"use {row['paged']['pages_in_use']} == scratch "
             f"{row['paged']['scratch_pages']} + prefix entries "
             f"{row['paged']['prefix_entries']}"
             if alloc is not None else "") + f"; cache {row['cache']}")
    return row


def run_continuous(dev, model, plan, qmatmul_ops, flash_ops, smi):
    """Phase 9: continuous serving at full width, paged then dense; the
    paged micro-run's roofline line."""
    from repro_torch.serve import Bucket, BucketPolicy

    cfg = plan.cfg
    bucket = Bucket(CONT_MAX_LEN, CONT_BATCH)
    per_step = cfg.n_layers + 1
    waves = [continuous_requests(cfg.vocab, w) for w in range(CONT_WAVES)]
    t0 = time.perf_counter()
    loops = [greedy_loop(model, reqs, CONT_MAX_LEN) for reqs in waves]
    print(f"continuous: plain greedy loop over {CONT_WAVES} x "
          f"{CONT_REQUESTS} requests in {time.perf_counter() - t0:.1f} s")
    out = dict(launches={})

    paged = plan.make_batcher(policy=BucketPolicy([bucket]),
                              schedule="continuous", steps_per_dispatch=CONT_K,
                              paged=True)
    # K and V, bf16
    pool_bytes = (2 * 2 * cfg.n_layers * paged.paged[0] * paged.paged[1]
                  * cfg.n_kv * cfg.head_dim)
    print(f"continuous paged: bucket {bucket.label}, k={CONT_K}, pool "
          f"{paged.paged} = {pool_bytes / 1e9:.3f} GB for K and V")
    rows = [serve_wave(paged, reqs, lambda _b, loop=loop: loop,
                       f"paged wave {w}", per_step, qmatmul_ops, flash_ops)
            for w, (reqs, loop) in enumerate(zip(waves, loops))]
    out["launches"]["paged"] = sum(r["launches"] for r in rows)
    if rows[1]["prefix_hits"] <= 0:
        raise AssertionError("wave 2 mapped no prefix page of wave 1")
    c0, c1 = rows[0]["cache"], rows[1]["cache"]
    if not (c1["builds"] == c0["builds"] and c1["hits"] > c0["hits"]):
        raise AssertionError(f"wave 2 built a step or missed the cache: "
                             f"{c0} -> {c1}")

    dense = plan.make_batcher(policy=BucketPolicy([bucket]),
                              schedule="continuous", steps_per_dispatch=CONT_K)
    row = serve_wave(dense, waves[0], lambda _b: loops[0], "dense wave 0",
                     per_step, qmatmul_ops, flash_ops)
    out["launches"]["dense"] = row["launches"]

    out["micro_run"] = {label: time_micro_run(
        dev, plan, model, batcher, smi=smi if label == "paged" else None)
        for label, batcher in (("paged", paged), ("dense", dense))}
    out["waves"], out["loops"] = waves, loops
    return out


def time_micro_run(dev, plan, model, batcher, qmatmul=True, smi=None):
    """One micro-run of the batcher's step in steady decode, its state
    resident: every lane active at positions 100-103 (a speculative step
    accepts nothing here; its work per call is the same). Host-clock
    median of 5 calls and the device split of 2, which must show qmatmul
    time where the step launches it (``qmatmul``); with ``smi`` (the
    card's name and power limit) also the micro-run's roofline line."""
    k, B, L = CONT_K, CONT_BATCH, CONT_MAX_LEN
    lanes = [torch.full((k, B), -1, dtype=torch.int32, device=dev),
             torch.ones(B, dtype=torch.int32, device=dev), 100,
             torch.zeros((k, B), dtype=torch.int32, device=dev),
             torch.ones((k, B), dtype=torch.bool, device=dev),
             torch.zeros((k, B), dtype=torch.bool, device=dev)]
    kw = {}
    if batcher.paged:
        kw["paged"] = batcher.paged
        n_tables = L // batcher.paged[1]
        lanes.append(torch.arange(B * n_tables, dtype=torch.int32,
                                  device=dev).view(B, n_tables))
    if batcher.spec:
        kw["spec"] = batcher.spec
    exe = plan.serve_executable("masked_decode", batch=B, max_len=L,
                                steps_per_dispatch=k, **kw)
    state = batcher.pool.acquire(B, L)

    def micro_run():
        exe.fn(model, state, *lanes)

    micro_run()
    torch.cuda.synchronize()
    lat = []
    for _ in range(5):
        t = time.perf_counter()
        micro_run()
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    split = profile_split(micro_run, calls=2)
    if smi is not None:
        from repro_torch.models import ShapeSpec

        cfg = plan.cfg
        label = "paged" if batcher.paged else "dense"
        roofline(f"{cfg.name} quantized {label} micro-run [{B} x {L}, "
                 f"k={k}]", micro_run, statistics.median(lat), cfg,
                 ShapeSpec("decode", L, B, "decode"),
                 {"qmatmul": (cfg.n_layers + 1) * k, "flash_attention": 0},
                 smi, steps=k)
    batcher.pool.release(B, L, state)
    if (split["qmatmul_ms"] > 0) != qmatmul:
        raise AssertionError(f"profiler split of a micro-run disagrees with "
                             f"its qmatmul launches ({qmatmul}): {split}")
    return dict(median_ms=statistics.median(lat), latencies_ms=lat,
                split=split)


def micro_run_line(name, mr):
    cs = mr["split"]
    return (f"{name}: median {mr['median_ms']:.4f} ms (host clock, 5 calls, "
            f"all {[round(x, 4) for x in mr['latencies_ms']]}); device: "
            f"flash {cs['flash_ms']:.4f} ms + qmatmul {cs['qmatmul_ms']:.4f} "
            f"ms + other ops {cs['other_device_ms']:.4f} ms, idle share "
            f"{1 - device_busy_ms(cs) / mr['median_ms']:.3f} of the median "
            f"(profiled wall {cs['profiled_wall_ms']:.4f} ms); largest "
            f"device entries (ms per micro-run) "
            f"{[(k, round(v, 4)) for k, v in cs['top']]}")


def run_speculative(dev, model, plan, qmatmul_ops, flash_ops, reqs, loop):
    """Phase 10: speculative serving at full width, paged through the
    batcher, then dense behind the async server."""
    import asyncio

    from repro_torch.serve import AsyncServeServer, Bucket, BucketPolicy

    cfg = plan.cfg

    def make(paged):
        return plan.make_batcher(
            policy=BucketPolicy([Bucket(CONT_MAX_LEN, CONT_BATCH)]),
            schedule="continuous", steps_per_dispatch=SPEC_K,
            paged=paged, speculative=SPEC_K)

    paged, dense = make(True), make(None)
    spec_k, draft = paged.spec
    # the draft's k steps run `draft` down-projections and the head at
    # M = batch; the verify runs every layer's and the head at M = batch k
    per_run = spec_k * (draft + 1) + cfg.n_layers + 1
    draft_mb = 2 * 2 * draft * paged.paged[0] * paged.paged[1] * \
        cfg.n_kv * cfg.head_dim / 1e6
    print(f"speculative: k={spec_k}, draft = the first {draft} of "
          f"{cfg.n_layers} layers, draft pool twin {draft_mb:.1f} MB; "
          f"{per_run} qmatmul launches expected per micro-run")
    out = dict(launches={}, rows={})

    def counted(label, batcher, serve):
        torch.cuda.synchronize()
        qmatmul_ops.launches = 0
        flash_ops.launches = 0
        t = time.perf_counter()
        res, extra = serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, flash = qmatmul_ops.launches, flash_ops.launches
        st = batcher.scheduler.stats()
        sp, runs = st["spec"], st["micro_runs"]
        if launches != per_run * runs or runs == 0:
            raise AssertionError(f"{label}: qmatmul launched {launches} "
                                 f"times over {runs} micro-runs, expected "
                                 f"{per_run} per micro-run")
        if flash:
            raise AssertionError(f"{label}: flash launched {flash} times")
        if sp["verifies"] <= 0 or not 0 < sp["accepted_tokens"] <= \
                sp["draft_tokens"]:
            raise AssertionError(f"{label}: speculative counters {sp}")
        if st["refills"] <= 0:
            raise AssertionError(f"{label}: no slot was refilled")
        compared, full = hold_to_loop(res, loop)
        if compared == 0:
            raise AssertionError(f"{label}: no step clears the gap rule")
        tokens = sum(len(r.tokens) for r in res.values())
        row = dict(label=label, wall_s=wall, tokens=tokens,
                   tokens_per_s=tokens / wall, launches=launches,
                   micro_runs=runs, refills=st["refills"],
                   ms_per_micro_run=wall * 1e3 / runs, spec=sp,
                   compared=compared, full=full, streams=len(res),
                   cache=batcher.cache.stats(), **extra)
        note = ""
        if batcher.pool.allocator is not None:
            p = batcher.pool.allocator.stats()
            if p["pages_in_use"] != p["scratch_pages"] + p["prefix_entries"]:
                raise AssertionError(f"{label}: pages not reclaimed: {p}")
            row["paged"] = p
            note = (f"; pages in use {p['pages_in_use']} == scratch "
                    f"{p['scratch_pages']} + prefix entries "
                    f"{p['prefix_entries']}, draft pages committed "
                    f"{p['draft_pages_committed']}, rolled back "
                    f"{p['draft_pages_rolled_back']}")
        if "server" in extra:
            sv = extra["server"]
            note += (f"; async server: p50 TTFT {sv['p50_ttft_s']} s, p99 "
                     f"TTFT {sv['p99_ttft_s']} s, outcomes {sv['outcomes']}")
        print(f"speculative {label}: {len(res)} requests, {tokens} tokens "
              f"in {wall:.4f} s = {row['tokens_per_s']:.4f} tokens/s (host "
              f"clock); {runs} micro-runs ({row['ms_per_micro_run']:.4f} ms "
              f"each), {st['refills']} refills; {sp['verifies']} verifies, "
              f"{sp['accepted_tokens']}/{sp['draft_tokens']} draft tokens "
              f"accepted ({sp['accepted_tokens_per_dispatch']} per verify), "
              f"{sp['rollbacks']} rollbacks, {sp['continuations']} "
              f"continuations, {sp['partial_results']} partial results; "
              f"{launches} qmatmul launches == {per_run} x {runs}; vs plain "
              f"loop: {compared} tokens compared, {full}/{len(res)} streams "
              f"equal in full{note}; cache {row['cache']}")
        return row

    def through_batcher():
        for r in reqs:
            paged.submit(r)
        return paged.run(), {}

    def through_server():
        async def drive():
            async with AsyncServeServer(dense) as server:
                got = await asyncio.gather(*[server.generate(r)
                                             for r in reqs])
                return {r.request_id: r for r in got}, server.stats()

        res, sv = asyncio.run(drive())
        if sv["outcomes"] != {"done": len(reqs)}:
            raise AssertionError(f"async server outcomes {sv['outcomes']}")
        return res, dict(server=dict(p50_ttft_s=sv["p50_ttft_s"],
                                     p99_ttft_s=sv["p99_ttft_s"],
                                     outcomes=sv["outcomes"]))

    out["rows"]["paged"] = counted("paged wave 0", paged, through_batcher)
    out["rows"]["dense"] = counted("dense wave 0, async server", dense,
                                   through_server)
    out["launches"] = {k: r["launches"] for k, r in out["rows"].items()}
    out["micro_run"] = {label: time_micro_run(dev, plan, model, batcher)
                        for label, batcher in (("paged", paged),
                                               ("dense", dense))}
    return out


def unshared_requests(vocab):
    """Phases 11 and 14's wave: phase 9's lengths without the shared system
    prompt, so that no two prompts share a full page (the prefix cache
    would otherwise skip tokens that the recurrent state needs, a fault of
    the reference that the port keeps)."""
    from repro_torch.serve import DecodeRequest

    rng = np.random.default_rng(CONT_SEED + 10)
    return [DecodeRequest(
        f"h{i}", [int(t) for t in rng.integers(
            1, vocab, int(rng.integers(HYBRID_PROMPT[0],
                                       HYBRID_PROMPT[1] + 1)))],
        max_new_tokens=4 + (20 * i) // (CONT_REQUESTS - 1))
        for i in range(CONT_REQUESTS)]


def run_family(dev, flash_ops, qmatmul_ops, attention, arch, overrides=None,
               recurrent=False, prefill_reps=(5, 2), profile_seq=None):
    """Phases 11-14: ``arch`` at full width (``overrides`` cut its depth),
    prefill, then quantized continuous serving paged and dense, each
    counted from zero. A ``recurrent`` model (the hybrid, RWKV) serves
    prompts that share no full page; the others serve phase 9's first
    wave. Each wave is held to the plain loop replayed at the positions it
    ran at, in batches of the bucket's size: the random hybrid stack
    amplifies any rounding difference, and an MoE step's capacity couples
    the rows of a batch above 8 tokens."""
    from repro_torch.plan import build_plan
    from repro_torch.serve import Bucket, BucketPolicy

    model, pre = run_prefill(dev, flash_ops, attention, arch, overrides,
                             prefill_reps, profile_seq)
    plan = build_plan(arch, None, quantized=True, device=dev,
                      config_overrides=overrides)
    t0 = time.perf_counter()
    plan.load_params(model)           # calibrates any a16w8 MLP shifts
    torch.cuda.synchronize()
    cfg = plan.cfg
    per_step = qmatmul_per_step(cfg)
    reqs = (unshared_requests(cfg.vocab) if recurrent
            else continuous_requests(cfg.vocab, 0))
    print(f"{cfg.name} serve plan: quantized MLP {plan.ir.quant['mlp']}, "
          f"shifts {plan.ir.quant['mlp_shifts']} in "
          f"{time.perf_counter() - t0:.1f} s; {per_step} qmatmul launches "
          f"expected per decode step")

    def replay(batcher):
        t0 = time.perf_counter()
        loop = replay_loop(model, reqs, batcher)
        print(f"{cfg.name}: plain replay of {len(reqs)} requests in "
              f"{time.perf_counter() - t0:.1f} s")
        return loop

    bucket = Bucket(CONT_MAX_LEN, CONT_BATCH)
    out = dict(prefill=pre, launches={}, rows={})
    batchers = {}
    for label, paged in (("paged", True), ("dense", None)):
        batchers[label] = plan.make_batcher(
            policy=BucketPolicy([bucket]), schedule="continuous",
            steps_per_dispatch=CONT_K, paged=paged)
        row = serve_wave(batchers[label], reqs, replay,
                         f"{cfg.name} {label} wave 0", per_step,
                         qmatmul_ops, flash_ops)
        out["rows"][label] = row
        out["launches"][label] = row["launches"]
    if recurrent and out["rows"]["paged"]["prefix_hits"]:
        raise AssertionError(f"a {cfg.name} prompt mapped a prefix page")
    out["micro_run"] = time_micro_run(dev, plan, model, batchers["paged"],
                                      qmatmul=per_step > 0)
    return out


def prefill_line(name, pre):
    sp = pre["split"]
    at, median = "", pre["median_ms"]
    if "split_seq" in pre:
        at = (f" for a prefill of [{PREFILL_BATCH}, {pre['split_seq']}] "
              f"(median {pre['split_median_ms']:.4f} ms on the host clock)")
        median = pre["split_median_ms"]
    return (f"prefill [{PREFILL_BATCH}, {PREFILL_SEQ}] {name}: median "
            f"{pre['median_ms']:.4f} ms (host clock, "
            f"{len(pre['latencies_ms'])} calls after warm-up, all "
            f"{[round(x, 4) for x in pre['latencies_ms']]}); device{at}: "
            f"flash {sp['flash_ms']:.4f} ms + qmatmul {sp['qmatmul_ms']:.4f} "
            f"ms + other ops {sp['other_device_ms']:.4f} ms, idle share "
            f"{1 - device_busy_ms(sp) / median:.3f} of the median; largest "
            f"device entries (ms per call) "
            f"{[(k, round(v, 4)) for k, v in sp['top']]}")


def free_card():
    """Drop the last model's tensors before the next one is loaded."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"card memory in use before the next model: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")


L2_BYTES = 50e6   # the H100's L2: rotating over more than this keeps it cold


def time_lm_qmatmul(qlinear, qlinear_ref, dev):
    """qmatmul at the LM shapes with the L2 cold: a decode step streams 32
    layers' different weights, so each call takes the next of enough weight
    copies to exceed the L2. The int8 head gets ``torch._int_mm`` with x
    zero-padded to 32 rows (its least M; none at M = 32) as a yardstick for
    the product alone (no SRS); no PyTorch call takes the a16w8 int16
    operands."""
    from repro_torch.kernels.qmatmul.ops import work

    rng = np.random.default_rng(13)
    rows = []
    for (M, K, N, dx, dw, out) in LM_SHAPES:
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
            lib_note = ("torch._int_mm" + (
                f" with x zero-padded from {M} to 32 rows" if M < 32 else "")
                + ", int32 out, no SRS")
        wk = work(M, K, N, x.dtype, ws[0].dtype, out, bias=False)
        t, by = bound_ms(wk)
        rows.append(dict(
            M=M, K=K, N=N, x=dx, w=dw, out=out, ms=ms, plain_ms=plain,
            library_ms=lib, library_note=lib_note, l2="cold",
            weight_copies=n_copies, bound_ms=t, bound_by=by,
            ops=wk.ops, bytes=wk.bytes))
        print(f"qmatmul {M}x{K}x{N} {dx}x{dw}->{out}, L2 cold ({n_copies} "
              f"weight copies): kernel {ms:.6f} ms, bound "
              f"{t:.6f} ms ({by}), plain "
              f"{plain:.6f} ms (not a yardstick), library "
              f"{'n/a' if lib is None else f'{lib:.6f} ms'} ({lib_note})")
        del ws
    return rows


def time_flash(flash_ops, attention_ref, dev, case):
    """The flash kernel at a path shape beside its bound, its plain
    version and SDPA (the yardstick; the port never calls it)."""
    import torch.nn.functional as F

    BH, Sq, Sk, hd, dtype, causal, _, _ = case
    q, k, v = flash_inputs(BH, Sq, Sk, hd, dtype, dev, seed=1)
    ms = device_ms(lambda: flash_ops.flash_attention(q, k, v, causal=causal),
                   iters=20)
    plain = device_ms(lambda: attention_ref(q, k, v, causal=causal), iters=5)
    q4, k4, v4 = (t.view(1, BH, -1, hd) for t in (q, k, v))
    sdpa = device_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal), iters=20)
    wk = flash_ops.work(BH, Sq, Sk, hd, q.dtype, causal)
    t, by = bound_ms(wk)
    mode = "causal" if causal else "non-causal"
    print(f"flash [{BH}, {Sq}, {hd}] {dtype} {mode}: kernel {ms:.6f} ms, "
          f"bound {t:.6f} ms ({by}), plain {plain:.6f} ms (not a "
          f"yardstick), SDPA {sdpa:.6f} ms (yardstick, never called by the "
          f"port)")
    return dict(ms=ms, plain_ms=plain, library_ms=sdpa, bound_ms=t,
                bound_by=by, ops=wk.ops, bytes=wk.bytes)


def roofline(name, fn, measured_ms, cfg, shape, want, smi, steps=1):
    """One extra call of ``fn`` under ``analyze_step`` (not timed: the
    dispatch mode costs host time), its roofline over the H100 against
    ``measured_ms`` from the phase's timed calls, and its checks: the
    kernel calls the wrappers reported equal each wrapper's launches over
    the call, and those equal ``want``; the step's flops are at least the
    model FLOPs of ``steps`` steps of ``shape``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.qmatmul import ops as qmatmul_ops
    from repro_torch.launch.model_flops import model_flops
    from repro_torch.launch.roofline import fmt_seconds, roofline_terms
    from repro_torch.launch.step_analysis import analyze_step

    counters = {"qmatmul": qmatmul_ops, "flash_attention": flash_ops}
    before = {k: m.launches for k, m in counters.items()}
    t = time.perf_counter()
    _, st = analyze_step(fn)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    launched = {k: m.launches - before[k] for k, m in counters.items()}
    hooked = {k: st.kernel_launches.get(k, 0) for k in counters}
    if hooked != launched or launched != want \
            or set(st.kernel_launches) - set(counters):
        raise AssertionError(f"roofline {name}: the hook counted "
                             f"{st.kernel_launches}, the wrappers launched "
                             f"{launched}, expected {want}")
    mf = model_flops(cfg, shape) * steps
    if st.flops < mf:
        raise AssertionError(f"roofline {name}: {st.flops:.6g} flops "
                             f"dispatched, fewer than the {mf:.6g} model "
                             f"FLOPs")
    r = roofline_terms(st, 1, mf, measured_s=measured_ms / 1e3)
    by_class = {k: float(f"{v:.6g}") for k, v in st.flops_by_dtype.items()}
    print(f"roofline {name}: C={fmt_seconds(r['compute_s'])} "
          f"M={fmt_seconds(r['memory_s'])} dom={r['dominant']} "
          f"bound={fmt_seconds(r['step_time_bound_s'])} "
          f"measured={fmt_seconds(r['measured_s'])} "
          f"(x{r['measured_over_bound']:.2f}) model-FLOPs share "
          f"{r['measured_mfu']:.4f} of {H100.peak_flops_bf16 / 1e12:.0f} "
          f"TFLOP/s bf16; flops {st.flops:.6g} by class {by_class}, bytes "
          f"{st.bytes:.6g}, model FLOPs {mf:.6g} (useful share "
          f"{r['useful_flops_ratio']:.4f}); kernel calls hooked == launched "
          f"== {launched}; the analysed call took {host_s:.1f} s on the host "
          f"clock; [{smi}]")
    return r


def forward_ce(logits, labels, chunk=512):
    """Mean next-token cross-entropy of fp32 logits [B, S, V], in chunks."""
    total = 0.0
    for i in range(0, logits.shape[1], chunk):
        lg = logits[:, i:i + chunk]
        gold = torch.gather(lg, -1, labels[:, i:i + chunk].long()[..., None])
        total += float(torch.sum(torch.logsumexp(lg, -1) - gold[..., 0]))
    return total / labels.numel()


def train_stream(cfg, batch, seq):
    from repro_torch.data import make_train_iterator

    return lambda start: make_train_iterator(cfg.vocab, seq, batch, seed=0,
                                             start_step=start)


def run_training(dev, flash_ops, qmatmul_ops, smi):
    """Phase 17: qwen1.5-4b trained at full size, then the restart check
    at 2 layers."""
    from repro_torch.models import ShapeSpec
    from repro_torch.plan import build_plan
    from repro_torch.train.trainer import batch_to_device

    shape = ShapeSpec("train_4k_b2", TRAIN_SEQ, TRAIN_BATCH, "train")
    plan = build_plan(TRAIN_ARCH, shape, device=dev)
    cfg = plan.cfg
    t0 = time.perf_counter()
    model, opt_state = plan.init_train_state(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    batch = batch_to_device(next(train_stream(cfg, TRAIN_BATCH,
                                              TRAIN_SEQ)(0)), model)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {n_params:,} parameters, {cfg.n_layers} layers, "
          f"initialised in {time.perf_counter() - t0:.1f} s; batch "
          f"[{TRAIN_BATCH}, {TRAIN_SEQ}]")
    # the step-0 loss against the flash forward's cross-entropy
    flash_ops.launches = 0
    logits = plan.executable("prefill").fn(model,
                                           {"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    fwd_flash = flash_ops.launches
    if fwd_flash != cfg.n_layers:
        raise AssertionError(f"the {cfg.name} forward launched flash "
                             f"{fwd_flash} times, not {cfg.n_layers}")
    ce = forward_ce(logits, batch["labels"])
    del logits
    train = plan.executable("train")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    flash_ops.launches = 0
    qmatmul_ops.launches = 0
    losses, gnorms, times = [], [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        metrics = train.fn(model, opt_state, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(metrics["grad_norm"]))
    launches = dict(flash=flash_ops.launches, qmatmul=qmatmul_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    print(f"{cfg.name} train: losses {[round(x, 4) for x in losses]}, grad "
          f"norms {[round(x, 4) for x in gnorms]}, step times (ms, host "
          f"clock + synchronize) {[round(x, 1) for x in times]}")
    print(f"{cfg.name} train: flash launches == {launches['flash']} and "
          f"qmatmul launches == {launches['qmatmul']} over "
          f"{TRAIN_STEPS} steps")
    if launches["flash"] or launches["qmatmul"]:
        raise AssertionError(f"a kernel ran on the training path: "
                             f"{launches}")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"non-finite training metrics: {losses}, "
                             f"{gnorms}")
    if abs(losses[0] - ce) > TRAIN_LOSS_TOL:
        raise AssertionError(f"step-0 training loss {losses[0]} vs the "
                             f"flash forward's cross-entropy {ce}: beyond "
                             f"{TRAIN_LOSS_TOL}")
    if losses[-1] > losses[0] - TRAIN_LOSS_DROP:
        raise AssertionError(f"the loss fell from {losses[0]} to "
                             f"{losses[-1]}, less than {TRAIN_LOSS_DROP}")
    med = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    split = profile_split(lambda: train.fn(model, opt_state, batch),
                          calls=1)
    busy = device_busy_ms(split)
    print(f"{cfg.name} train [{TRAIN_BATCH}, {TRAIN_SEQ}] adamw on the "
          f"stream's first batch: step-0 "
          f"loss {losses[0]:.4f} vs the flash forward's cross-entropy "
          f"{ce:.4f} (|diff| {abs(losses[0] - ce):.5f} <= "
          f"{TRAIN_LOSS_TOL}); loss {losses[0]:.4f} -> {losses[-1]:.4f} in "
          f"{TRAIN_STEPS} steps; median step {med:.1f} ms over steps "
          f"1-{TRAIN_STEPS - 1} (host clock + synchronize), "
          f"{tokens / med * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB (resident before the steps "
          f"{resident / 1e9:.2f} GB); [{smi}]")
    print(f"{cfg.name} train step profile: device {busy:.1f} ms (other ops; "
          f"flash {split['flash_ms']:.4f}, qmatmul {split['qmatmul_ms']:.4f})"
          f", profiled wall {split['profiled_wall_ms']:.1f} ms, idle share "
          f"{1 - busy / split['profiled_wall_ms']:.3f} of the profiled step "
          f"({1 - busy / med:.3f} of the median); largest device entries "
          f"(ms) {[(k, round(v, 2)) for k, v in split['top']]}; [{smi}]")
    # one more step, analysed (after every check on the steps above)
    rl = roofline(f"{cfg.name} adamw train step [{TRAIN_BATCH}, {TRAIN_SEQ}]",
                  lambda: train.fn(model, opt_state, batch), med, cfg, shape,
                  {"qmatmul": 0, "flash_attention": 0}, smi)
    del model, opt_state, batch, train, plan
    free_card()
    restart = run_restart(dev, smi)
    return dict(launches=launches, fwd_flash=fwd_flash, losses=losses,
                step_ms=med, peak_gb=peak / 1e9, split=split,
                restart=restart, roofline=rl)


def run_restart(dev, smi):
    """Phase 17's restart: qwen at full width cut to 2 layers, 6 steps
    straight and again with a failure at step 4 resumed from the step-3
    checkpoint by a new trainer; the final parameters are compared with
    ``torch.equal``. Keeps for phase 20 the straight run's final
    parameters (on the host), the crash's step-3 checkpoint (hard-linked
    into a directory of its own under ``build/``), and the plain resume's
    step times, peak memory and one profiled step."""
    from repro_torch.models import ShapeSpec
    from repro_torch.plan import build_plan
    from repro_torch.train import FailureInjector, Trainer, TrainerConfig
    from repro_torch.train.fault import InjectedFailure
    from repro_torch.train.trainer import model_loss

    plan = build_plan(TRAIN_ARCH, ShapeSpec("train_4k_b2", TRAIN_SEQ,
                                            TRAIN_BATCH, "train"),
                      device=dev,
                      config_overrides={"n_layers": RESTART_LAYERS})
    saves = []

    def fresh():
        return plan.init_train_state(seed=0)

    def trainer(ckpt_dir, every):
        t = Trainer(model_loss, plan.optimizer, TrainerConfig(
            steps=RESTART_STEPS, ckpt_every=every, ckpt_dir=ckpt_dir,
            keep=1, log_every=1))
        save = t.ckpt.save

        def timed(step, state, metadata=None):
            t0 = time.perf_counter()
            save(step, state, metadata)
            dt = time.perf_counter() - t0
            path = os.path.join(ckpt_dir, f"step_{step:08d}")
            size = sum(os.path.getsize(os.path.join(path, f))
                       for f in os.listdir(path))
            saves.append((step, size, dt))
            print(f"checkpoint step {step}: {size / 1e9:.2f} GB in "
                  f"{dt:.1f} s ({size / 1e9 / dt:.2f} GB/s)")

        t.ckpt.save = timed
        return t

    stream = train_stream(plan.cfg, TRAIN_BATCH, TRAIN_SEQ)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="ckpt_", dir=ROOT / "build")
    resume_dir = tempfile.mkdtemp(prefix="ckpt_phase20_", dir=ROOT / "build")
    try:
        print(f"checkpoint disk: {shutil.disk_usage(tmp).free / 1e9:.1f} "
              f"GB free")
        model, opt_state = fresh()
        straight, _, hist_a = trainer(os.path.join(tmp, "a"), 100).fit(
            model, opt_state, stream, resume=False)
        want = {n: p.detach().cpu()
                for n, p in straight.named_parameters()}
        del straight, model, opt_state
        shutil.rmtree(os.path.join(tmp, "a"))
        crashed = trainer(os.path.join(tmp, "b"), RESTART_CKPT_EVERY)
        crashed.injector = FailureInjector(fail_at_steps=(RESTART_FAIL_AT,))
        model, opt_state = fresh()
        try:
            crashed.fit(model, opt_state, stream)
        except InjectedFailure as e:
            print(f"restart: {e}")
        else:
            raise AssertionError("the injected failure did not fire")
        del model, opt_state, crashed
        # phase 20 resumes from this checkpoint on the mesh: its files
        # hard-linked (the plain resume's retention deletes the original)
        step3 = f"step_{RESTART_CKPT_EVERY:08d}"
        os.makedirs(os.path.join(resume_dir, step3))
        for f in os.listdir(os.path.join(tmp, "b", step3)):
            os.link(os.path.join(tmp, "b", step3, f),
                    os.path.join(resume_dir, step3, f))
        model, opt_state = fresh()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        resumed, opt_state, hist_b = trainer(os.path.join(tmp, "b"),
                                             RESTART_CKPT_EVERY).fit(
            model, opt_state, stream)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        if hist_b[0]["step"] != RESTART_CKPT_EVERY:
            raise AssertionError(f"resumed at step {hist_b[0]['step']}, "
                                 f"not {RESTART_CKPT_EVERY}")
        equal = all(torch.equal(p.cpu(), want[n])
                    for n, p in resumed.named_parameters())
        print(f"restart {TRAIN_ARCH} ({RESTART_LAYERS} layers, vocab "
              f"{plan.cfg.vocab}): {RESTART_STEPS} steps with a failure at "
              f"step {RESTART_FAIL_AT}, resumed at step "
              f"{hist_b[0]['step']} (resume + {len(hist_b)} steps "
              f"{time.perf_counter() - t0:.1f} s): final parameters "
              f"torch.equal to the uninterrupted run's: {equal}; losses "
              f"straight {[round(h['loss'], 4) for h in hist_a]}, resumed "
              f"{[round(h['loss'], 4) for h in hist_b]}; [{smi}]")
        if not equal:
            raise AssertionError("restart is not bit-exact on the card")
        from repro_torch.train.trainer import batch_to_device

        batch = batch_to_device(next(stream(0)), resumed)
        split = profile_split(lambda: plan.executable("train").fn(
            resumed, opt_state, batch), calls=1)
        del resumed, opt_state, model
    except BaseException:
        shutil.rmtree(resume_dir, ignore_errors=True)
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(equal=equal, saves=saves, want=want, resume_dir=resume_dir,
                losses=[h["loss"] for h in hist_b],
                step_ms=[h["dt"] * 1e3 for h in hist_b], peak_gb=peak_gb,
                split=split, mode=plan.mode)


def run_sharded_training(dev, flash_ops, qmatmul_ops, restart, smi):
    """Phase 20: phase 17's restart config (qwen at full width and vocab,
    2 layers, [2, 4096], adamw) trained sharded on the card's 1x1 nccl
    mesh under the config's mode. A new trainer on the mesh resumes from
    the step-3 checkpoint of phase 17's crash at step 4 (plain -> mesh:
    the parameters take their shards, the state comes back at its
    placements) and runs steps 3-5; its step-6 checkpoint is written from
    the mesh (gathered, rank 0 writes). The final parameters, and the
    step-6 checkpoint read back as plain tensors (mesh -> plain), must be
    ``torch.equal`` to phase 17's uninterrupted plain run. Then one step's
    gradients go through the collective ``error_feedback_reduce`` over the
    data axis (a group of one), equal to the local form, and the train
    CLI ``--debug --mode megatron --steps 2`` runs in its own process."""
    from repro_torch.bridge import _flatten, leaf_groups, params_template
    from repro_torch.dist.sharding import is_dtensor, local_value
    from repro_torch.models import ShapeSpec
    from repro_torch.optim import error_feedback_reduce
    from repro_torch.optim.optimizers import local, stacked
    from repro_torch.plan import build_plan
    from repro_torch.train import CheckpointManager, Trainer, TrainerConfig
    from repro_torch.train.trainer import (batch_to_device, model_loss,
                                           on_mesh, value_and_grad)

    t_phase = time.perf_counter()
    ckpt_dir = restart["resume_dir"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli_dir = tempfile.mkdtemp(prefix="ckpt_cli_", dir=ROOT / "build")
    cli_cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               "yi-6b", "--debug", "--mode", "megatron", "--steps", "2",
               "--device", str(dev), "--ckpt-dir", cli_dir]
    cli = subprocess.Popen(cli_cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        plan = build_plan(TRAIN_ARCH, ShapeSpec(
            "train_4k_b2", TRAIN_SEQ, TRAIN_BATCH, "train"), device=dev,
            config_overrides={"n_layers": RESTART_LAYERS})
        if plan.mode != restart["mode"]:
            raise AssertionError(f"mode {plan.mode} != phase 17's "
                                 f"{restart['mode']}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        model, opt_state = plan.init_train_state(seed=0, shard=True)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t
        leaves = list(model.parameters()) + [
            v for d in (opt_state["m"], opt_state["v"]) for v in d.values()]
        leaves.append(opt_state["step"])
        if not all(is_dtensor(v) for v in leaves):
            raise AssertionError("a parameter or state leaf is not placed")
        trainer = Trainer(model_loss, plan.optimizer, TrainerConfig(
            steps=RESTART_STEPS, ckpt_every=RESTART_CKPT_EVERY,
            ckpt_dir=ckpt_dir, keep=2, log_every=1), mesh=plan.mesh,
            rules=plan.rules)
        timed = {}

        def timer(name, fn):
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                timed.setdefault(name, []).append(time.perf_counter() - t0)
                return out
            return call

        trainer.ckpt.save = timer("save", trainer.ckpt.save)
        trainer.ckpt.restore = timer("restore", trainer.ckpt.restore)
        stream = train_stream(plan.cfg, TRAIN_BATCH, TRAIN_SEQ)
        flash_ops.launches = 0
        qmatmul_ops.launches = 0
        model, opt_state, hist = trainer.fit(model, opt_state, stream)
        torch.cuda.synchronize()
        launches = dict(flash=flash_ops.launches,
                        qmatmul=qmatmul_ops.launches)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        if launches["flash"] or launches["qmatmul"]:
            raise AssertionError(f"a kernel ran on the sharded training "
                                 f"path: {launches}")
        if hist[0]["step"] != RESTART_CKPT_EVERY:
            raise AssertionError(f"resumed at step {hist[0]['step']}, not "
                                 f"{RESTART_CKPT_EVERY}")
        want = restart["want"]
        equal = all(torch.equal(local_value(p.detach()).cpu(), want[n])
                    for n, p in model.named_parameters())
        # mesh -> plain: the sharded run's step-6 checkpoint as plain
        # tensors (its parameters only), held to the plain run
        t = time.perf_counter()
        back = CheckpointManager(ckpt_dir).restore(
            RESTART_STEPS, {"params": params_template(model)}, device=dev)
        back_s = time.perf_counter() - t
        groups = leaf_groups(model)
        flat = _flatten(back["params"])
        back_equal = all(
            torch.equal(flat[g.name].reshape(-1, *want[m].shape)[i].cpu(),
                        want[m])
            for g in groups for i, m in enumerate(g.members))
        del back, flat
        losses = [h["loss"] for h in hist]
        step_ms = [h["dt"] * 1e3 for h in hist]
        print(f"sharded restart {TRAIN_ARCH} ({RESTART_LAYERS} layers, "
              f"{plan.mode}, mesh 1x1 {torch.distributed.get_backend()} "
              f"world {torch.distributed.get_world_size()}): {len(leaves)} "
              f"parameter and state leaves all DTensors (placed in "
              f"{place_s:.1f} s); resumed from phase 17's plain step-3 "
              f"checkpoint (plain -> mesh, restore "
              f"{timed['restore'][0]:.1f} s) at step {hist[0]['step']}, "
              f"steps 3-5: final parameters torch.equal to phase 17's "
              f"uninterrupted plain run: {equal}; the step-6 checkpoint "
              f"written from the mesh read back as plain tensors (mesh -> "
              f"plain, {back_s:.1f} s): torch.equal: {back_equal}; losses "
              f"{[round(x, 4) for x in losses]} vs phase 17's resume "
              f"{[round(x, 4) for x in restart['losses']]}; [{smi}]")
        if not equal or not back_equal or losses != restart["losses"]:
            raise AssertionError("the sharded restart is not bit-exact to "
                                 "the plain run on the 1x1 mesh")
        # one more step, profiled, on the same batch as phase 17's
        batch = batch_to_device(next(stream(0)), model)
        split = profile_split(lambda: plan.executable("train").fn(
            model, opt_state, batch), calls=1)
        busy, busy_plain = device_busy_ms(split), device_busy_ms(
            restart["split"])
        ratio = statistics.median(step_ms[1:]) / statistics.median(
            restart["step_ms"][1:])
        saves = timed["save"]
        print(f"sharded restart step ms {[round(x, 4) for x in step_ms]} vs "
              f"plain resume {[round(x, 4) for x in restart['step_ms']]} "
              f"(host clock, loss read back; the first resumed step warms "
              f"up), median of the later steps x{ratio:.2f}; device per "
              f"step {busy:.4f} ms sharded vs {busy_plain:.4f} ms plain, "
              f"idle share {1 - busy / split['profiled_wall_ms']:.3f} vs "
              f"{1 - busy_plain / restart['split']['profiled_wall_ms']:.3f} "
              f"(one profiled step each); peak +{peak_gb:.3f} GB over the "
              f"placement and the sharded resume vs +"
              f"{restart['peak_gb']:.3f} GB over the plain resume; "
              f"checkpoint save from the mesh {saves[-1]:.1f} s (gathered, "
              f"written by rank 0) vs {restart['saves'][-1][2]:.1f} s plain "
              f"({restart['saves'][-1][1] / 1e9:.2f} GB); flash launches == "
              f"{launches['flash']}, qmatmul launches == "
              f"{launches['qmatmul']}; [{smi}]")
        # one step's gradients through the collective reduce (a group of
        # one) and through the local form
        with on_mesh(plan.mesh, plan.rules, model):
            _, grads = value_and_grad(model_loss, model, batch)
            t = time.perf_counter()
            same = 0
            for g in groups:
                block = local(stacked(grads, g))
                res = torch.zeros_like(block)
                a = error_feedback_reduce(block, res, axis_name="data")
                b = error_feedback_reduce(block, res)
                same += torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            torch.cuda.synchronize()
            reduce_s = time.perf_counter() - t
        del grads
        print(f"collective error_feedback_reduce over 'data' "
              f"({torch.distributed.get_backend()}, a group of one): one "
              f"step's gradients, {same} of {len(groups)} leaves' reduced "
              f"gradient and residual torch.equal to the local form "
              f"({reduce_s * 1e3:.1f} ms, host clock); [{smi}]")
        if same != len(groups):
            raise AssertionError("the collective reduce differs from the "
                                 "local form over a group of one")
        out, err = cli.communicate(timeout=TRAIN_CLI_TIMEOUT_S)
        cli_s = time.perf_counter() - t_phase
        last = out.strip().splitlines()[-1] if out.strip() else ""
        if cli.returncode != 0 or "(sharded) mode=megatron" not in out \
                or not last.startswith("done: loss"):
            raise AssertionError(f"train CLI exited {cli.returncode}: "
                                 f"{out[-2000:]} {err[-3000:]}")
        print(f"train CLI {' '.join(cli_cmd[2:-2])}: exit 0 within "
              f"{cli_s:.1f} s (its own process, beside the phase): "
              f"{out.strip().splitlines()[0]!r} ... {last!r}")
        del model, opt_state, trainer, plan
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(cli_dir, ignore_errors=True)
    took = time.perf_counter() - t_phase
    print(f"phase 20 took {took:.1f} s")
    return dict(launches=launches, equal=equal, back_equal=back_equal,
                step_ms=step_ms, peak_gb=peak_gb, split=split,
                save_s=saves[-1], seconds=took)


def run_adafactor(dev, flash_ops, qmatmul_ops, smi):
    """Phase 18: adafactor at mistral-large's full width, 2 layers."""
    from repro_torch.models import ShapeSpec
    from repro_torch.plan import build_plan
    from repro_torch.train.trainer import batch_to_device

    shape = ShapeSpec("train_4k_b1", TRAIN_SEQ, ADAFACTOR_BATCH, "train")
    plan = build_plan(ADAFACTOR_ARCH, shape, device=dev,
                      config_overrides={"n_layers": ADAFACTOR_LAYERS})
    cfg = plan.cfg
    if cfg.optimizer != "adafactor":
        raise AssertionError(f"{cfg.name} trains with {cfg.optimizer}")
    model, opt_state = plan.init_train_state(seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = sum(t.numel() * t.element_size()
                      for f in opt_state["f"].values() for t in f.values())
    stream = train_stream(cfg, ADAFACTOR_BATCH, TRAIN_SEQ)(0)
    train = plan.executable("train")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.launches = 0
    qmatmul_ops.launches = 0
    losses, gnorms, times = [], [], []
    for _ in range(ADAFACTOR_STEPS):
        b = batch_to_device(next(stream), model)
        t = time.perf_counter()
        metrics = train.fn(model, opt_state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        gnorms.append(float(metrics["grad_norm"]))
    launches = dict(flash=flash_ops.launches, qmatmul=qmatmul_ops.launches)
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"non-finite adafactor metrics: {losses}, "
                             f"{gnorms}")
    if launches["flash"] or launches["qmatmul"]:
        raise AssertionError(f"a kernel ran on the training path: "
                             f"{launches}")
    print(f"{cfg.name} ({ADAFACTOR_LAYERS} of 88 layers, {n_params:,} "
          f"parameters) train [{ADAFACTOR_BATCH}, {TRAIN_SEQ}] adafactor: "
          f"losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in gnorms]}, step times (ms, host clock + "
          f"synchronize) {[round(x, 1) for x in times]}; factored state "
          f"{state_bytes / 1e6:.2f} MB (adamw's m and v: "
          f"{8 * n_params / 1e9:.2f} GB); peak memory {peak / 1e9:.2f} GB; "
          f"flash launches == {launches['flash']}, qmatmul launches == "
          f"{launches['qmatmul']}; [{smi}]")
    del model, opt_state, train, plan
    free_card()
    return dict(launches=launches, losses=losses, step_ms=times,
                peak_gb=peak / 1e9, state_bytes=state_bytes)


def run_mesh_placement(dev, model, smi):
    """Phase 7, continued: the resident yi-6b placed on the plan's 1x1
    ``cuda`` DeviceMesh in each sharding mode, one parameter at a time
    (each DTensor dropped after its check, so the peak grows by at most
    the largest parameter): ``to_local()`` must be ``torch.equal`` to the
    parameter, and the placements those ``pspec_to_placements`` gives the
    leaf's PartitionSpec in ``describe()["params"]``, stacked dims
    dropped."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    from repro_torch.bridge import leaf_groups
    from repro_torch.dist.sharding import (
        MODES,
        PartitionSpec,
        pspec_to_placements,
    )
    from repro_torch.models.base import leaf_key
    from repro_torch.plan import build_plan

    groups = leaf_groups(model)
    leaf_of = {m: grp for grp in groups for m in grp.members}
    params = dict(model.named_parameters())
    largest = max(p.numel() * p.element_size() for p in params.values())
    for mode in MODES:
        t = time.perf_counter()
        plan = build_plan(model.cfg.name, None, mode=mode, device=dev)
        want = {key: pspec_to_placements(PartitionSpec.from_str(text),
                                         plan.mesh)
                for key, text in plan.describe()["params"].items()}
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        placed = 0
        for name, dt in plan.iter_shard_params(model):
            grp = leaf_of[name]
            k = len(grp.stack)
            expect = [Shard(p.dim - k) if isinstance(p, Shard) else p
                      for p in want[leaf_key(grp.name)]]
            if list(dt.placements) != expect:
                raise AssertionError(f"{mode} {name}: placements "
                                     f"{dt.placements} != {expect}")
            if not torch.equal(dt.to_local(), params[name]):
                raise AssertionError(f"{mode} {name}: to_local() differs")
            placed += 1
            del dt
        torch.cuda.synchronize()
        grew = torch.cuda.max_memory_allocated() - base
        if placed != len(params):
            raise AssertionError(f"{mode}: placed {placed} of "
                                 f"{len(params)} parameters")
        print(f"mesh 1x1 ({dist.get_backend()}, world "
              f"{dist.get_world_size()}) {mode}: {len(groups)} leaves, "
              f"{placed} tensors placed, all equal, "
              f"{time.perf_counter() - t:.1f} s; peak +{grew / 1e9:.3f} GB "
              f"(largest parameter {largest / 1e9:.3f} GB) [{smi}]")


def run_sharded(dev, model, srv, pre_ms, flash_ops, qmatmul_ops, smi):
    """Phase 7, continued: the resident yi-6b runs sharded on the 1x1 cuda
    mesh under megatron_sp (``plan.shard_model`` + ``plan.activate()``):
    one prefill [2, 2048] (32 flash launches on DTensor operands, logits
    held to the unsharded forward by ``PREFILL_TOL``), phase 7's first fifo
    wave (33 qmatmul launches per decode step, streams held to phase 7's
    under the gap rule), and the timed decode step beside phase 7's; then
    the plain parameters are put back. Returns the launches and times."""
    from torch.distributed.tensor import DTensor

    from repro_torch.dist.sharding import local_value
    from repro_torch.models.base import ShapeSpec
    from repro_torch.plan import build_plan
    from repro_torch.serve import Bucket, BucketPolicy, DecodeRequest

    t_phase = time.perf_counter()
    shape = ShapeSpec("p", PREFILL_SEQ, PREFILL_BATCH, "prefill")
    batch = prefill_batch(model.cfg, shape, dev)
    reqs = [DecodeRequest(**r) for r in serve_requests(model.cfg.vocab, 0)]
    plan = build_plan("yi-6b", None, mode=SHARDED_MODE, quantized=True,
                      device=dev)
    plan.load_params(model, shard=False)          # calibrates (as phase 7)
    # the prefill runs the float path, as phase 6's plan does
    float_cfg = plan.cfg.with_(quantized=False, quantized_mlp=False)
    model.cfg = float_cfg
    plain_logits = model.forward(batch)
    model.cfg = plan.cfg
    loop = greedy_loop(model, reqs, SERVE_MAX_LEN)
    # the restore check holds each parameter on the host, so that the card
    # frees a plain parameter as soon as its DTensor is installed
    originals = {n: p.detach().cpu()
                 for n, p in model.named_parameters()}
    largest = max(p.numel() * p.element_size() for p in originals.values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    plan.shard_model(model)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t
    held_gb = (torch.cuda.memory_allocated() - base) / 1e9
    install_peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    if install_peak_gb * 1e9 > 2 * largest:
        raise AssertionError(f"shard_model grew the peak by "
                             f"{install_peak_gb:.3f} GB, the largest "
                             f"parameter is {largest / 1e9:.3f} GB")
    if not all(isinstance(p, DTensor) for p in model.parameters()):
        raise AssertionError("shard_model left a plain parameter")
    with plan.activate():
        flash_ops.launches = 0
        model.cfg = float_cfg
        t = time.perf_counter()
        logits = model.forward(batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        model.cfg = plan.cfg
        prefill_launches = flash_ops.launches
        if not isinstance(logits, DTensor):
            raise AssertionError("the sharded prefill returned plain logits")
        logits = local_value(logits)
        agree = prefill_agreement(logits, plain_logits)
        if prefill_launches != model.cfg.n_layers \
                or not within_prefill_tol(agree):
            raise AssertionError(f"sharded prefill: {prefill_launches} flash "
                                 f"launches, agreement {agree}")
        del logits, plain_logits
        batcher = plan.make_batcher(
            policy=BucketPolicy([Bucket(SERVE_MAX_LEN, SERVE_BATCH)]))
        qmatmul_ops.launches = 0
        for r in reqs:
            batcher.submit(r)
        res = batcher.run()
        wave = [res[r.request_id].tokens for r in reqs]
        torch.cuda.synchronize()
        launches = qmatmul_ops.launches
        m = batcher.metrics[Bucket(SERVE_MAX_LEN, SERVE_BATCH).label]
        steps = m.slot_steps // SERVE_BATCH
        per_step = plan.cfg.n_layers + 1
        if launches != per_step * steps or launches == 0:
            raise AssertionError(f"sharded fifo: {launches} qmatmul launches "
                                 f"over {steps} decode steps")
        held = 0
        full = sum(a == b for a, b in zip(wave, srv["waves"][0]))
        for i, r in enumerate(reqs):
            want, gaps = loop[r.request_id]
            n = next((j for j, g in enumerate(gaps) if g < CONT_MIN_GAP),
                     len(want))
            for got in (wave[i], srv["waves"][0][i]):
                if got[:n] != want[:n]:
                    raise AssertionError(
                        f"{r.request_id}: {got} != plain loop {want} "
                        f"within {n} steps (phase 7: {srv['waves'][0][i]})")
            held += n
        decode = plan.serve_executable("decode", batch=SERVE_BATCH,
                                       max_len=SERVE_MAX_LEN)
        state = batcher.pool.acquire(SERVE_BATCH, SERVE_MAX_LEN)
        if not all(isinstance(v, DTensor) for v in state.values()):
            raise AssertionError("the sharded state pool handed out a plain "
                                 "state")
        tok = torch.ones(SERVE_BATCH, dtype=torch.int32, device=dev)

        def step_n(n, p0):
            nonlocal tok, state
            for i in range(n):
                lg, state = decode.fn(model, state, tok, p0 + i)
                tok = plan.token_argmax(lg)

        step_n(2, 0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step_n(SHARDED_TIMED_STEPS, 2)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t) * 1e3 / SHARDED_TIMED_STEPS
        split = profile_split(lambda: step_n(1, 40), calls=2)
        batcher.pool.release(SERVE_BATCH, SERVE_MAX_LEN, state)
        del state
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    plan.unshard_model(model)
    for name, p in model.named_parameters():
        if type(p.data) is not torch.Tensor \
                or not torch.equal(p.cpu(), originals[name]):
            raise AssertionError(f"{name}: not restored to its plain value")
    n_params = len(originals)
    del originals
    # phases 8-10 serve through phase 7's plan again
    model.cfg = srv["plan"].cfg
    model.reset_quantized()
    idle = 1 - device_busy_ms(split) / step_ms
    print(f"sharded 1x1 ({SHARDED_MODE}, {torch.distributed.get_backend()}"
          f", world {torch.distributed.get_world_size()}): shard_model "
          f"{install_s:.1f} s, held +{held_gb:.3f} GB, peak "
          f"+{install_peak_gb:.3f} GB (largest parameter "
          f"{largest / 1e9:.3f} GB); prefill [{PREFILL_BATCH}, "
          f"{PREFILL_SEQ}] {prefill_launches} flash launches on DTensor "
          f"operands, {prefill_s * 1e3:.1f} ms (first call; phase 6's "
          f"median {pre_ms:.1f} ms), logits vs "
          f"unsharded: max |diff| {agree['max_abs']:.6f}, mean |diff| "
          f"{agree['mean_abs']:.6f}, argmax agreement "
          f"{agree['argmax_agree']:.6f}; phase 7's fifo wave, {launches} "
          f"qmatmul launches == {per_step} x {steps} decode steps, streams "
          f"{wave} held to phase 7's and to a plain greedy loop over {held} "
          f"tokens (gap >= {CONT_MIN_GAP}), {full} of {len(wave)} equal to "
          f"phase 7's in full")
    print(f"sharded 1x1 decode yi-6b quantized batch {SERVE_BATCH}: "
          f"{step_ms:.4f} ms per step sharded vs {srv['step_ms']:.4f} ms "
          f"plain (phase 7), x{step_ms / srv['step_ms']:.2f} (host clock, "
          f"{SHARDED_TIMED_STEPS} steps); device per step: qmatmul "
          f"{split['qmatmul_ms']:.4f} ms + other ops "
          f"{split['other_device_ms']:.4f} ms, idle share {idle:.3f}; peak "
          f"+{peak_gb:.3f} GB over the sharded run; phase "
          f"{time.perf_counter() - t_phase:.1f} s; restored, all "
          f"{n_params} parameters torch.equal [{smi}]")
    return dict(flash=prefill_launches, qmatmul=launches, step_ms=step_ms,
                idle=idle, peak_gb=peak_gb)


def run_mesh_flags(env):
    """Phase 19, continued: the plan CLI with a mesh larger than the world
    (one process, one card) must exit non-zero with the reference's count
    error, before any model is allocated. Both run side by side."""
    procs = []
    try:
        for flags, want in MESH_CLI_FAILS:
            cmd = [sys.executable, "-m", "repro_torch.plan", "--arch",
                   PLAN_CLI_ARCH, *flags]
            procs.append((flags, want, time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for flags, want, t, proc in procs:
            out, err = proc.communicate(timeout=MESH_CLI_TIMEOUT_S)
            wall = time.perf_counter() - t
            if proc.returncode == 0 or want not in out + err:
                raise AssertionError(f"plan CLI {' '.join(flags)} exited "
                                     f"{proc.returncode}: {err[-2000:]}")
            print(f"plan CLI {' '.join(flags)}: exit {proc.returncode} in "
                  f"{wall:.1f} s, {want!r}")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_plan_cli(smi):
    """Phase 19: ``python -m repro_torch.plan --arch yi-6b --quantized
    --warm --out build/plan_yi-6b.json`` at full width, as a subprocess
    (stopped at ``PLAN_CLI_TIMEOUT_S``): it must exit 0, print ``=> OK``
    (the second wave built no step and hit the cache), launch qmatmul, and
    write a ``describe()`` that ``json`` reads. Returns the kernel launches
    it printed."""
    import re

    from repro_torch.configs import get_config
    from repro_torch.launch.model_flops import param_counts

    out = ROOT / "build" / f"plan_{PLAN_CLI_ARCH}.json"
    cmd = [sys.executable, "-m", "repro_torch.plan", "--arch", PLAN_CLI_ARCH,
           "--quantized", "--warm", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=PLAN_CLI_TIMEOUT_S)
    wall = time.perf_counter() - t
    for line in proc.stdout.splitlines():
        print(f"  plan CLI | {line}")
    m = re.search(r"qmatmul (\d+), flash (\d+)", proc.stdout)
    if proc.returncode != 0 or "=> OK" not in proc.stdout or m is None:
        raise AssertionError(f"plan CLI exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    launched = dict(qmatmul=int(m.group(1)), flash=int(m.group(2)))
    if launched["qmatmul"] <= 0:
        raise AssertionError(f"plan CLI launched no qmatmul: {launched}")
    desc = json.loads(out.read_text())
    if not desc["quantized"] or desc["cache"]["hits"] < 1:
        raise AssertionError(f"plan CLI wrote {desc}")
    from repro_torch.bridge import leaf_groups
    from repro_torch.models.base import build_model, leaf_key

    leaves = {leaf_key(g.name) for g in leaf_groups(build_model(
        get_config(PLAN_CLI_ARCH), device="meta"))}
    if desc["mesh_axes"] != {"data": 1, "model": 1} or \
            set(desc["params"]) != leaves:
        raise AssertionError(f"plan CLI mesh_axes {desc['mesh_axes']}, "
                             f"params {sorted(desc['params'])}")
    total, _ = param_counts(get_config(PLAN_CLI_ARCH))
    print(f"plan CLI {' '.join(cmd[2:])}: {PLAN_CLI_ARCH} at full width "
          f"({total:,} parameters), exit 0, => OK, qmatmul launches "
          f"{launched['qmatmul']} and flash launches {launched['flash']} over "
          f"the two waves, describe() read back from {out.relative_to(ROOT)}"
          f" (cache {desc['cache']}); {wall:.1f} s on the host clock, the "
          f"process's start included; [{smi}]")
    print(f"plan CLI describe(): mesh {desc['mesh']} axes "
          f"{desc['mesh_axes']}, {len(desc['params'])} leaf PartitionSpecs "
          f"(one per leaf group)")
    run_mesh_flags(env)
    return launched


def staged_placement() -> int:
    """Phase 21's placement process (``chip_smoke.py --staged-placement``):
    yi-6b at full width resident on the card, then placed by the
    two-stage megatron plan on a 2x4 ``cuda`` mesh as rank 0 and as rank 4
    of a fake world of 8 (see the module docstring). Prints one line per
    rank and a ``STAGED {json}`` line of the figures."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    from repro_torch.configs import get_config
    from repro_torch.dist.staging import stage_band
    from repro_torch.launch.dryrun import placed_param_bytes
    from repro_torch.launch.mesh import placeholder_world
    from repro_torch.models.base import build_model
    from repro_torch.plan import MeshSpec, build_plan

    def allocated():
        stats = torch.cuda.memory_stats()
        return (stats["allocated_bytes.all.current"],
                stats["requested_bytes.all.current"])

    def plan_of(stages, device):
        return build_plan(STAGED_ARCH, mode="megatron",
                          mesh_spec=MeshSpec.debug(*STAGED_MESH),
                          pipeline_stages=stages, device=device)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cfg = get_config(STAGED_ARCH)
    model = build_model(cfg, device=dev).init_params(0)
    params = dict(model.named_parameters())
    world = STAGED_MESH[0] * STAGED_MESH[1]
    figures, layers = {}, {}
    for rank in STAGED_RANKS:
        placeholder_world(world, rank)
        plan = plan_of(2, dev)
        plan.param_placements()          # the mesh first: not counted
        torch.cuda.synchronize()
        base = allocated()
        t = time.perf_counter()
        placed = dict(plan.iter_shard_params(model))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        grew, asked = (a - b for a, b in zip(allocated(), base))
        held = blocks = empty = 0
        layers[rank] = set()
        for name, dt in placed.items():
            local = dt.to_local()
            nbytes = local.numel() * local.element_size()
            held += nbytes
            blocks += -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK
            band = stage_band(dt)
            if nbytes == 0:
                if band is None or band.owner():
                    raise AssertionError(f"rank {rank} {name}: no shard")
                empty += 1
                continue
            shape, offset = compute_local_shape_and_global_offset(
                dt.shape, dt.device_mesh, dt.placements)
            window = params[name][tuple(slice(o, o + n)
                                        for o, n in zip(offset, shape))]
            if not torch.equal(local, window):
                raise AssertionError(f"rank {rank} {name}: the shard is not "
                                     f"its slice of the parameter")
            if band is not None:
                layers[rank].add(int(name.split(".")[1]))
        if asked != held or grew < blocks:
            raise AssertionError(f"rank {rank}: requested +{asked} and "
                                 f"allocated +{grew} bytes; the shards take "
                                 f"{held}, {blocks} in 512-byte blocks")
        dry = placed_param_bytes(plan_of(2, "meta"))["param_bytes"]
        one = placed_param_bytes(plan_of(1, "meta"))["param_bytes"]
        if dry != held:
            raise AssertionError(f"rank {rank}: the dry run counts {dry} "
                                 f"parameter bytes, the shards hold {held}")
        lo, hi = min(layers[rank]), max(layers[rank])
        print(f"staged 2x4 rank {rank} of a fake world of {world} "
              f"({STAGED_ARCH} megatron, 2 stages): {len(placed)} tensors "
              f"placed in {secs:.1f} s, all torch.equal to their slices; "
              f"staged members of layers [{lo}, {hi}] held, {empty} of the "
              f"other band empty; shards {held} bytes ({held / 1e9:.3f} "
              f"GB) == requested +{asked}; allocated +{grew} ({blocks} in "
              f"512-byte blocks, +{grew - blocks} in large blocks the "
              f"allocator does not split); dry run {dry} bytes; the "
              f"one-stage 2x4 plan's rank holds {one} bytes "
              f"({one / 1e9:.3f} GB) [{smi}]")
        figures[rank] = dict(held=held, asked=asked, grew=grew,
                             blocks=blocks, dry=dry, one_stage=one,
                             layers=[lo, hi], empty=empty, seconds=secs)
        del placed, dt, local, window
    a, b = (layers[r] for r in STAGED_RANKS)
    if a & b or a | b != set(range(cfg.n_layers)):
        raise AssertionError(f"ranks {STAGED_RANKS} hold layers {sorted(a)} "
                             f"and {sorted(b)}")
    torch.distributed.destroy_process_group()
    print("STAGED " + json.dumps(figures))
    return 0


def run_staged(smi):
    """Phase 21: the dry-run cells (one process each) and the staged
    placement process, all started together; each must exit 0 within its
    limit. Prints the placement's lines and each cell's memory and
    roofline lines. Returns the placement's figures."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    procs = []
    try:
        for i, (arch, shape, flags, want) in enumerate(DRYRUN_CELLS):
            out = out_dir / f"cell{i}.json"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, *flags, "--out",
                   str(out)]
            procs.append((cmd, want, out, subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        placement = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--staged-placement"], cwd=ROOT, env=env, capture_output=True,
            text=True, timeout=STAGED_TIMEOUT_S)
        for line in placement.stdout.splitlines():
            if not line.startswith("STAGED "):
                print(f"  placement | {line}")
        if placement.returncode != 0:
            raise AssertionError(f"staged placement exited "
                                 f"{placement.returncode}: "
                                 f"{placement.stderr[-3000:]}")
        figures = json.loads(next(
            line for line in placement.stdout.splitlines()
            if line.startswith("STAGED "))[len("STAGED "):])
        for cmd, want, out, proc in procs:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            tail = stdout.strip().splitlines()[-1] if stdout.strip() else ""
            if not out.exists():
                raise AssertionError(f"{' '.join(cmd[2:])} exited "
                                     f"{proc.returncode}: {stderr[-3000:]}")
            (rec,) = json.loads(out.read_text())
            if proc.returncode != 0:
                raise AssertionError(f"{' '.join(cmd[2:])} exited "
                                     f"{proc.returncode}: "
                                     f"{rec.get('traceback', '')[-3000:]}")
            if rec["status"] != want:
                raise AssertionError(f"{' '.join(cmd[4:8])}: {rec}")
            label = (f"dry run {rec['arch']} {rec['shape']} {rec['mesh']} "
                     f"{rec['mode']} stages={rec['stages']}")
            if want == "skipped":
                print(f"{label}: skipped ({rec['reason']}); {tail}")
                continue
            mem, r = rec["memory"], rec["roofline"]
            useful = r["model_flops_per_chip"]
            print(f"{label}: memory per device {json.dumps(mem)}; traced in "
                  f"{rec['trace_s']} s on the host; {tail} [{smi}]")
            print(f"{label}: roofline per device on the H100 target C="
                  f"{r['compute_s']:.4g} s M={r['memory_s']:.4g} s N="
                  f"{r['collective_s']:.4g} s dom={r['dominant']}, flops "
                  f"{r['hlo_flops_per_chip']:.4g} (model {useful:.4g}), "
                  f"collectives {r['collective_op_counts']} [{smi}]")
            if rec.get("stage_slices"):
                print(f"{label}: stage slices {rec['stage_slices']}")
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"phase 21: {len(DRYRUN_CELLS)} dry-run cells and the placement "
          f"in {time.perf_counter() - t:.1f} s")
    return figures


def run_analysis() -> dict:
    """Phase 22: the port's static analysis (``python -m
    repro_torch.analysis --json -``) in a process of its own under this
    host's Python; it must exit 0 with an ``ok`` report of its three
    rules. Prints ``analysis: OK (N files, 3 rules, B baselined)`` and
    returns the report's counts."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json", "-"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=ANALYSIS_TIMEOUT_S)
    if proc.returncode != 0:
        raise AssertionError(f"repro_torch.analysis exited "
                             f"{proc.returncode}: {proc.stdout[-3000:]}"
                             f"{proc.stderr[-3000:]}")
    report, _ = json.JSONDecoder().raw_decode(proc.stdout)
    rules = [r["id"] for r in report["rules"]]
    if not report["ok"] or rules != ["RA201", "RA401", "RA501"]:
        raise AssertionError(f"analysis report: {report}")
    counts = report["counts"]
    print(f"analysis: OK ({counts['files']} files, {len(rules)} rules, "
          f"{counts['baselined']} baselined) in "
          f"{time.perf_counter() - t:.1f} s")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.configs.paper_models import PAPER_MODELS, build_paper_model
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.qmatmul import ops
    from repro_torch.kernels.qmatmul.ref import qlinear_ref
    from repro_torch.layers import attention

    dev = torch.device("cuda")
    t_start = time.perf_counter()
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n_split = check_small_m(chk, dev, sms)
    n_split_lm = check_lm_shapes(chk, dev, sms)
    torch.cuda.synchronize()
    print(f"kernel == plain: {chk.cases} cases ({n_grid} grid, path shapes "
          f"{shapes}, wraparound K={wrap_k}, small M {SMALL_M_SHAPES} with "
          f"{n_split} split-K plans, LM shapes {LM_SHAPES} "
          f"with {n_split_lm} split-K plans), max |diff| {chk.max_abs_err}")

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
    for case in FLASH_CASES + [FLASH_PATH, FLASH_PATH_HYBRID,
                               FLASH_PATH_QWEN] + FLASH_PATHS_CROSS:
        err = fchk.compare(*case, dev)
        print(f"flash {case[:7]}{' x100' if case[7] else ''}: kernel vs "
              f"plain max |diff| {err:.3g} (tolerance {FLASH_TOL[case[4]]})")
    print(f"flash kernel == plain within tolerance: {fchk.cases} cases, max "
          f"|diff| {fchk.max_abs_err:.3g}")
    check_unbuilt_head_dim(dev, flash_ops, attention)

    # phase 6: prefill at full width, counted from zero
    model, pre = run_prefill(dev, flash_ops, attention, smi=smi)
    # phase 7: fifo serving at full width, quantized, counted from zero
    srv = run_serve(dev, model, ops)
    run_mesh_placement(dev, model, smi)
    shd = run_sharded(dev, model, srv, pre["median_ms"], flash_ops, ops, smi)

    # phase 8: timing of the LM path; a kernel renamed out of the
    # profiler's match would show as zero here
    if pre["split"]["flash_ms"] <= 0 or srv["split"]["qmatmul_ms"] <= 0:
        raise AssertionError(
            f"profiler split found no kernel time: prefill {pre['split']}, "
            f"decode step {srv['split']}")
    print(prefill_line("yi-6b", pre))
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
    fl = time_flash(flash_ops, attention_ref, dev, FLASH_PATH)
    fl_h = time_flash(flash_ops, attention_ref, dev, FLASH_PATH_HYBRID)
    fl_q = time_flash(flash_ops, attention_ref, dev, FLASH_PATH_QWEN)
    fl_x = [time_flash(flash_ops, attention_ref, dev, case)
            for case in FLASH_PATHS_CROSS]

    # phase 9: continuous serving at full width, each run counted from zero
    cont = run_continuous(dev, model, srv["plan"], ops, flash_ops, smi)
    for label, mr in cont["micro_run"].items():
        print(micro_run_line(f"micro-run yi-6b quantized {label}, batch "
                             f"{CONT_BATCH}, k={CONT_K}", mr))
    cont_launches = cont["launches"]["paged"] + cont["launches"]["dense"]
    cont_paged = cont["launches"]["paged"]

    # phase 10: speculative serving at full width, each run counted from zero
    spec = run_speculative(dev, model, srv["plan"], ops, flash_ops,
                           cont["waves"][0], cont["loops"][0])
    for label, mr in spec["micro_run"].items():
        print(micro_run_line(f"spec micro-run yi-6b quantized {label}, "
                             f"batch {CONT_BATCH}, k={SPEC_K}", mr))
    spec_launches = spec["launches"]["paged"] + spec["launches"]["dense"]
    spec_paged = spec["launches"]["paged"]

    print(f"phases 1-10 done at {time.perf_counter() - t_start:.1f} s")
    # phases 11-16: the hybrid, the other dense configs, the MoE family,
    # RWKV, the encoder-decoder and the vision LM at full width, each model
    # freed before the next is loaded
    yi_layers = model.cfg.n_layers
    del model, srv["plan"], cont, spec
    fams = []
    for phase, arch, kw in (
            (11, HYBRID_ARCH, dict(recurrent=True,
                                   overrides={"n_layers": HYBRID_LAYERS})),
            (12, QWEN_ARCH, dict(overrides={"n_layers": QWEN_LAYERS})),
            (13, MOE_ARCH, dict(overrides={"n_layers": MOE_LAYERS})),
            (14, RWKV_ARCH, dict(recurrent=True,
                                 overrides={"n_layers": RWKV_LAYERS},
                                 prefill_reps=RWKV_PREFILL_REPS,
                                 profile_seq=RWKV_PROFILE_SEQ)),
            (15, SEAMLESS_ARCH, {}),
            (16, VLM_ARCH, dict(overrides={
                "n_layers": VLM_SUPERBLOCKS
                * get_config(VLM_ARCH).cross_attn_every}))):
        free_card()
        fam = run_family(dev, flash_ops, ops, attention, arch, **kw)
        fp = fam["prefill"]
        cut = (f" ({kw['overrides']['n_layers']} layers)"
               if "overrides" in kw else "")
        print(prefill_line(arch + cut, fp))
        if (fp["split"]["flash_ms"] > 0) != (fp["launches"] > 0):
            raise AssertionError(f"profiler split of the {arch} prefill "
                                 f"disagrees with its {fp['launches']} "
                                 f"flash launches: {fp['split']}")
        family = get_config(arch).family
        print(micro_run_line(f"{family} micro-run {arch}{cut} quantized "
                             f"paged, batch {CONT_BATCH}, k={CONT_K}",
                             fam["micro_run"]))
        fams.append((phase, arch + cut, fam))
        print(f"phase {phase} done at {time.perf_counter() - t_start:.1f} s")
    fam_launches = sum(f["launches"]["paged"] + f["launches"]["dense"]
                       for _, _, f in fams)
    fam_flash = sum(f["prefill"]["launches"] for _, _, f in fams)

    # phases 17-18: training, each model freed before the next
    free_card()
    trained = run_training(dev, flash_ops, ops, smi)
    print(f"phase 17 done at {time.perf_counter() - t_start:.1f} s")
    ada = run_adafactor(dev, flash_ops, ops, smi)
    print(f"phase 18 done at {time.perf_counter() - t_start:.1f} s")
    # phase 19: the plan CLI at full width, in a process of its own
    free_card()
    plan_cli = run_plan_cli(smi)
    print(f"phase 19 done at {time.perf_counter() - t_start:.1f} s")
    # phase 20: training sharded on the 1x1 mesh, resumed from phase 17
    free_card()
    sharded_train = run_sharded_training(dev, flash_ops, ops,
                                         trained["restart"], smi)
    print(f"phase 20 done at {time.perf_counter() - t_start:.1f} s")
    # phase 21: the staged placement and the dry run, processes of their own
    free_card()
    run_staged(smi)
    print(f"phase 21 done at {time.perf_counter() - t_start:.1f} s")
    # phase 22: the static analysis of the port, in a process of its own
    run_analysis()
    print(f"phase 22 done at {time.perf_counter() - t_start:.1f} s")
    train_paths = {
        f"{TRAIN_ARCH} adamw train, {TRAIN_STEPS} steps (phase 17)":
            trained["launches"],
        f"{ADAFACTOR_ARCH} ({ADAFACTOR_LAYERS} layers) adafactor train, "
        f"{ADAFACTOR_STEPS} steps (phase 18)": ada["launches"],
        SHARDED_TRAIN_PATH: sharded_train["launches"]}

    per = {(r["M"], r["K"], r["N"]): r for r in rows_t + lm_rows}
    # one aie predict of every request configuration, and one quantized
    # yi-6b decode step at batch 4 (the head and 32 down-projections)
    path = [(rows, *layer.weight.shape) for name, rows in REQUESTS
            for layer in models[name].layers]
    path += [LM_QMATMUL[0][:3]] + [LM_QMATMUL[1][:3]] * yi_layers
    tot_ops = sum(per[s]["ops"] for s in path)
    tot_bytes = sum(per[s]["bytes"] for s in path)
    path_bound_s, path_bound_by = H100.bound_s(tot_ops, tot_bytes, "int8")
    libs = [per[s]["library_ms"] for s in path]
    record = {"kernels": [{
        "name": "qmatmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL,
        "launches": launches + srv["launches"] + cont_launches
        + spec_launches + fam_launches + plan_cli["qmatmul"]
        + shd["qmatmul"],
        "launches_by_path": {
            "paper models (phase 3)": launches,
            "yi-6b fifo serve (phase 7)": srv["launches"],
            SHARDED_PATH: shd["qmatmul"],
            "yi-6b continuous paged serve (phase 9)": cont_paged,
            "yi-6b continuous dense serve (phase 9)":
                cont_launches - cont_paged,
            "yi-6b speculative paged serve (phase 10)": spec_paged,
            "yi-6b speculative dense async serve (phase 10)":
                spec_launches - spec_paged,
            **{f"{name} continuous {label} serve (phase {phase})":
               f["launches"][label] for phase, name, f in fams
               for label in ("paged", "dense")},
            **{path: n["qmatmul"] for path, n in train_paths.items()},
            PLAN_CLI_PATH: plan_cli["qmatmul"]},
        "exact": True, "max_abs_err": chk.max_abs_err, "cases": chk.cases,
        "work": "one aie predict of every request configuration and one "
                "quantized yi-6b decode step at batch 4",
        "ms": sum(per[s]["ms"] for s in path),
        "plain_ms": sum(per[s]["plain_ms"] for s in path),
        "bound_ms": path_bound_s * 1e3,
        "bound_by": path_bound_by,
        "library_ms": None if None in libs else sum(libs),
        "shapes": rows_t + lm_rows,
    }, {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_TPU_KERNEL,
        "launches": pre["launches"] + fam_flash + trained["fwd_flash"]
        + plan_cli["flash"] + shd["flash"],
        "launches_by_path": {
            "yi-6b prefill (phase 6)": pre["launches"],
            SHARDED_PATH: shd["flash"],
            **{f"{name} prefill (phase {phase})": f["prefill"]["launches"]
               for phase, name, f in fams if f["prefill"]["launches"]},
            f"{TRAIN_ARCH} prefill of the training batch (phase 17)":
                trained["fwd_flash"],
            **{path: n["flash"] for path, n in train_paths.items()},
            PLAN_CLI_PATH: plan_cli["flash"]},
        "max_abs_err": fchk.max_abs_err, "cases": fchk.cases,
        "work": f"one call at the path shape [{FLASH_PATH[0]}, "
                f"{FLASH_PATH[1]}, {FLASH_PATH[3]}] bf16 causal",
        "ms": fl["ms"], "plain_ms": fl["plain_ms"],
        "bound_ms": fl["bound_ms"], "bound_by": fl["bound_by"],
        "library_ms": fl["library_ms"],
        "shapes": [dict(shape=list(case[:4]), dtype=case[4], causal=case[5],
                        **t)
                   for case, t in ((FLASH_PATH, fl),
                                   (FLASH_PATH_HYBRID, fl_h),
                                   (FLASH_PATH_QWEN, fl_q),
                                   *zip(FLASH_PATHS_CROSS, fl_x))],
    }]}
    # the world-1 group phase 7 started for its mesh
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--staged-placement"]:
        sys.exit(staged_placement())
    sys.exit(main())
