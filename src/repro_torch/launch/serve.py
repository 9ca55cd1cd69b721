"""Serving launcher of the port: a thin CLI over ``repro_torch.plan`` and
``repro_torch.serve``.

It parses flags, builds the plan, submits ``--rounds`` waves of synthetic
requests through the :class:`~repro_torch.serve.ServeBatcher` (fifo or
continuous) or the :class:`~repro_torch.serve.AsyncServeServer`
(``--stream``), and prints the counters (the second wave must show cache
hits and no new builds). Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --debug \\
        --tokens 4 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --debug \\
        --device cpu --schedule continuous --steps-per-dispatch 4 --paged \\
        --policy edf --stream --tokens 6 --rounds 2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --debug \\
        --device cpu --schedule continuous --steps-per-dispatch 4 \\
        --speculative 4 --draft prefix:1 --tokens 6 --rounds 3

Flags:
  --arch       architecture alias (required), e.g. yi-6b
  --debug      reduced config with 2-sequence buckets (default: the full
               config with the decode_32k buckets, batch 128)
  --tokens     tokens to decode per request (default 8, >= 1)
  --quantized  int8 qmatmul decode LM head + a16w8 MLP down-projection
               (shifts calibrated from the loaded weights)
  --rounds     request waves (default 2: warm + cache hits)
  --device     torch device (default: the card)
  --schedule   fifo (fixed dispatch groups, default) | continuous (slot
               reuse inside in-flight dispatches, ContinuousScheduler)
  --steps-per-dispatch
               continuous micro-run length k (default 1): k masked steps
               per step call; long prompts enter k tokens per call
  --policy     admission policy (continuous only): fifo | priority | edf
  --stream     drive the waves through the asyncio streaming server and
               print its p50/p99 time to first token
  --paged      paged KV (continuous only): one shared page pool with
               shared-prefix reuse; optional page size (default 16).
               Every request then opens with the same one-page system
               prompt, and the allocator counters are printed
  --speculative K
               speculative lanes: a layer-prefix draft proposes K tokens
               per micro-run and the whole model verifies them in the same
               step (needs --schedule continuous; K must equal
               --steps-per-dispatch; composes with --paged through
               revocable draft pages). Prints the acceptance counters
  --draft      draft for --speculative: "prefix:N" runs the first N
               layers as the draft (default: half the stack)
"""

from __future__ import annotations

import argparse
import asyncio
import time

from repro_torch.models import SHAPES
from repro_torch.plan import build_plan
from repro_torch.serve import (
    AsyncServeServer,
    BucketPolicy,
    DecodeRequest,
    ServeBatcher,
    make_policy,
)


def build_batcher(args) -> ServeBatcher:
    """One ExecutionPlan -> a ServeBatcher with demo params."""
    if args.debug:
        policy = BucketPolicy.debug()
    else:
        shape = SHAPES["decode_32k"]
        policy = BucketPolicy.production(shape.global_batch, shape.seq_len)
    plan = build_plan(args.arch, None, quantized=args.quantized,
                      debug=args.debug, device=args.device)
    admission = make_policy(args.policy) if args.policy != "fifo" else None
    batcher = plan.make_batcher(policy=policy, schedule=args.schedule,
                                steps_per_dispatch=args.steps_per_dispatch,
                                admission=admission, paged=args.paged,
                                speculative=args.speculative,
                                draft=args.draft)
    return batcher.init_demo_params(seed=0)


def wave_requests(args, batch: int, wave: int):
    """One wave of synthetic requests. Continuous waves hold two requests
    per slot, so slot reuse shows; priorities and tenants cycle so a
    priority policy has classes to order; edf deadlines are generous."""
    size = batch * 2 if args.schedule == "continuous" else batch
    deadline = None
    if args.policy == "edf":
        deadline = (time.monotonic() + 120.0 if args.stream
                    else 1_000_000.0)
    system = [1 + (j * 5) % 50 for j in range(16)] if args.paged else []
    return [DecodeRequest(
        f"w{wave}r{i}", system + [1 + (i + j) % 7 for j in range(i % 3 + 2)],
        max_new_tokens=args.tokens, priority=i % 3, tenant=f"tenant{i % 2}",
        deadline=deadline)
        for i in range(size)]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Bucketed batch decode over cached step functions and "
                    "resident KV caches, wired by one ExecutionPlan.")
    ap.add_argument("--arch", required=True,
                    help="architecture alias, e.g. yi-6b")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config, 2-sequence buckets")
    ap.add_argument("--tokens", type=int, default=8,
                    help="tokens to decode per request (>= 1)")
    ap.add_argument("--quantized", action="store_true",
                    help="int8 qmatmul decode LM head + quantized MLP "
                         "down-projection (calibrated shifts)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="request waves (2nd+ hit the step cache)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--schedule", default="fifo",
                    choices=["fifo", "continuous"],
                    help="fixed fifo groups, or continuous batching with "
                         "in-flight slot reuse")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="continuous micro-run length k (>= 1)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "edf"],
                    help="admission policy (non-fifo needs --schedule "
                         "continuous)")
    ap.add_argument("--stream", action="store_true",
                    help="serve through the asyncio streaming server "
                         "(needs --schedule continuous)")
    ap.add_argument("--paged", nargs="?", const=True, default=None,
                    type=int, metavar="PAGE_SIZE",
                    help="paged KV with shared-prefix reuse (needs "
                         "--schedule continuous); page size default 16")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="speculative decode: draft K tokens per micro-run "
                         "and verify them in the same step (needs "
                         "--schedule continuous; K must equal "
                         "--steps-per-dispatch; composes with --paged)")
    ap.add_argument("--draft", default=None, metavar="PREFIX:N",
                    help="draft model for --speculative: 'prefix:N' = "
                         "first N layers (default: half the stack)")
    args = ap.parse_args(argv)
    if args.tokens < 1:
        ap.error("--tokens must be >= 1")
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")
    if args.steps_per_dispatch < 1:
        ap.error("--steps-per-dispatch must be >= 1")
    continuous = args.schedule == "continuous"
    for flag, used in (("--steps-per-dispatch > 1",
                        args.steps_per_dispatch > 1),
                       ("--policy", args.policy != "fifo"),
                       ("--stream", args.stream),
                       ("--paged", args.paged is not None)):
        if used and not continuous:
            ap.error(f"{flag} needs --schedule continuous")
    if args.paged is not None and args.paged is not True and args.paged < 1:
        ap.error("--paged page size must be >= 1")
    if args.speculative:
        if not continuous:
            ap.error("--speculative needs --schedule continuous")
        if args.speculative != args.steps_per_dispatch:
            ap.error("--speculative must equal --steps-per-dispatch "
                     "(the draft proposes exactly one micro-run)")
    if args.draft is not None and not args.speculative:
        ap.error("--draft needs --speculative")

    batcher = build_batcher(args)
    batch = batcher.policy.buckets[0].batch
    t_first = None
    if args.stream:
        async def run_streaming():
            async with AsyncServeServer(batcher) as server:
                for wave in range(args.rounds):
                    results = await asyncio.gather(*[
                        server.generate(r)
                        for r in wave_requests(args, batch, wave)])
                    sample = min(results, key=lambda r: r.request_id)
                    print(f"wave {wave}: {len(results)} requests x "
                          f"{args.tokens} tokens (streamed), sample "
                          f"{sample.request_id} -> {sample.tokens[:8]}; "
                          f"cache {batcher.cache.stats()}")
                return server.stats()

        sstats = asyncio.run(run_streaming())
        print(f"stream: p50 TTFT {sstats['p50_ttft_s']}s, p99 TTFT "
              f"{sstats['p99_ttft_s']}s, outcomes {sstats['outcomes']}")
    else:
        for wave in range(args.rounds):
            for r in wave_requests(args, batch, wave):
                batcher.submit(r)
            results = batcher.run()
            if t_first is None and results and not continuous:
                t_first = min(r.prefill_seconds for r in results.values())
            sample = results[sorted(results)[0]]
            print(f"wave {wave}: {len(results)} requests x {args.tokens} "
                  f"tokens, sample {sample.request_id} -> "
                  f"{sample.tokens[:8]}; cache {batcher.cache.stats()}")

    stats = batcher.stats()
    for label, m in stats["buckets"].items():
        print(f"bucket {label}: {m['requests']} reqs, {m['new_tokens']} "
              f"tokens, {m['tokens_per_second']:.1f} tok/s, p50 "
              f"{m['p50_latency_s']:.3f}s p99 {m['p99_latency_s']:.3f}s")
    if "scheduler" in stats:
        s = stats["scheduler"]
        print(f"scheduler: {s['admissions']} admissions over "
              f"{s['dispatches']} dispatches ({s['micro_runs']} micro-runs "
              f"of k={s['steps_per_dispatch']}, policy {s['policy']}), "
              f"{s['refills']} refills, busy slot fraction "
              f"{s['busy_slot_fraction']}, mean refill gap "
              f"{s['mean_refill_gap']} steps")
        if "spec" in s:
            sp = s["spec"]
            print(f"speculative: k={sp['spec_k']} draft_layers="
                  f"{sp['draft_layers']}, {sp['accepted_tokens']}/"
                  f"{sp['draft_tokens']} draft tokens accepted "
                  f"({sp['accepted_tokens_per_dispatch']} per verify), "
                  f"{sp['rollbacks']} rollbacks, {sp['continuations']} "
                  "continuations")
    if "paged" in stats:
        p = stats["paged"]
        print(f"paged: {p['pages_in_use']}/{p['page_count']} pages in use "
              f"(peak {p['peak_pages']}), {p['prefix_hits']} prefix hits, "
              f"{p['skipped_prefill_tokens']} prompt tokens skipped (rate "
              f"{p['prefill_skip_rate']:.3f}), {p['evictions']} evictions")
        if args.speculative:
            print(f"draft leases: {p['draft_pages_committed']} pages "
                  f"committed, {p['draft_pages_rolled_back']} rolled back")
    c = stats["cache"]
    first = f"{t_first:.2f}s" if t_first is not None else "n/a"
    print(f"{batcher.cfg.name} on {batcher.device}: first token {first}; "
          f"cache entries={c['entries']} hits={c['hits']} "
          f"misses={c['misses']} builds={c['builds']}")


if __name__ == "__main__":
    main()
