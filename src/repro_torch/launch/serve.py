"""Serving launcher of the port: a thin CLI over ``repro_torch.plan`` and
``repro_torch.serve``.

It parses flags, builds the plan, submits ``--rounds`` waves of synthetic
requests through the fifo :class:`~repro_torch.serve.ServeBatcher` and
prints the cache counters (the second wave must show hits and no new
builds). Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --debug \\
        --tokens 4 --device cpu

Flags:
  --arch       architecture alias (required), e.g. yi-6b
  --debug      reduced config with 2-sequence buckets (default: the full
               config with the decode_32k buckets, batch 128)
  --tokens     tokens to decode per request (default 8, >= 1)
  --quantized  int8 qmatmul decode LM head + a16w8 MLP down-projection
               (shifts calibrated from the loaded weights)
  --rounds     request waves (default 2: warm + cache hits)
  --device     torch device (default: the card)

The reference's --schedule continuous, --steps-per-dispatch, --policy,
--stream, --paged, --speculative and --draft are accepted and raise
NotImplementedError (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import argparse

from repro_torch.models import SHAPES
from repro_torch.plan import build_plan
from repro_torch.serve import BucketPolicy, DecodeRequest, ServeBatcher

_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 11: serve modules)"


def build_batcher(args) -> ServeBatcher:
    """One ExecutionPlan -> a fifo ServeBatcher with demo params."""
    if args.debug:
        policy = BucketPolicy.debug()
    else:
        shape = SHAPES["decode_32k"]
        policy = BucketPolicy.production(shape.global_batch, shape.seq_len)
    plan = build_plan(args.arch, None, quantized=args.quantized,
                      debug=args.debug, device=args.device)
    if args.policy != "fifo":
        raise NotImplementedError(f"--policy {args.policy} {_NOT_PORTED}")
    if args.stream:
        raise NotImplementedError(f"--stream {_NOT_PORTED}")
    batcher = plan.make_batcher(policy=policy, schedule=args.schedule,
                                steps_per_dispatch=args.steps_per_dispatch,
                                paged=args.paged,
                                speculative=args.speculative,
                                draft=args.draft)
    return batcher.init_demo_params(seed=0)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Bucketed fifo batch decode over cached step functions "
                    "and resident KV caches, wired by one ExecutionPlan.")
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
                    help="only fifo is ported")
    ap.add_argument("--steps-per-dispatch", type=int, default=1,
                    help="not ported (continuous only)")
    ap.add_argument("--policy", default="fifo",
                    choices=["fifo", "priority", "edf"],
                    help="not ported (continuous only)")
    ap.add_argument("--stream", action="store_true", help="not ported")
    ap.add_argument("--paged", nargs="?", const=True, default=None,
                    type=int, metavar="PAGE_SIZE", help="not ported")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="not ported")
    ap.add_argument("--draft", default=None, metavar="PREFIX:N",
                    help="not ported")
    args = ap.parse_args(argv)
    if args.tokens < 1:
        ap.error("--tokens must be >= 1")
    if args.rounds < 1:
        ap.error("--rounds must be >= 1")

    batcher = build_batcher(args)
    batch = batcher.policy.buckets[0].batch
    t_first = None
    for wave in range(args.rounds):
        for i in range(batch):
            batcher.submit(DecodeRequest(
                f"w{wave}r{i}", [1 + (i + j) % 7 for j in range(i % 3 + 2)],
                max_new_tokens=args.tokens))
        results = batcher.run()
        if t_first is None and results:
            t_first = min(r.prefill_seconds for r in results.values())
        sample = results[sorted(results)[0]]
        print(f"wave {wave}: {len(results)} requests x {args.tokens} "
              f"tokens, sample {sample.request_id} -> {sample.tokens[:8]}")

    stats = batcher.stats()
    for label, m in stats["buckets"].items():
        print(f"bucket {label}: {m['requests']} reqs, {m['new_tokens']} "
              f"tokens, {m['tokens_per_second']:.1f} tok/s, p50 "
              f"{m['p50_latency_s']:.3f}s p99 {m['p99_latency_s']:.3f}s")
    c = stats["cache"]
    first = f"{t_first:.2f}s" if t_first is not None else "n/a"
    print(f"{batcher.cfg.name} on {batcher.device}: first token {first}; "
          f"cache entries={c['entries']} hits={c['hits']} "
          f"misses={c['misses']} builds={c['builds']}")


if __name__ == "__main__":
    main()
