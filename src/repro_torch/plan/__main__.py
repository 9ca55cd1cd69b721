"""Plan smoke CLI: build an ExecutionPlan on one card, dump ``describe()``,
optionally prove that a warm plan builds no new step (the reference's
``python -m repro.plan``).

    PYTHONPATH=src python -m repro_torch.plan --arch yi-6b --debug --warm \\
        --device cpu --out plan_yi6b.json
    PYTHONPATH=src python -m repro_torch.plan --arch yi-6b --quantized \\
        --warm --out build/plan_yi-6b.json           # full width, the card

``--warm`` builds the plan's ServeBatcher, loads random parameters
(seed 0), dispatches two waves of one bucket's batch, and FAILS (exit 1)
unless the second wave builds no step (``builds`` of the plan's
``ExecutableCache`` unchanged) and hits the cache. It prints the qmatmul
and flash launches of the two waves. ``--out`` writes ``describe()``
after the warm check, so the cache counters are included.

Runs on the card unless ``--device cpu``. ``--mode`` is recorded in the
plan; on one card nothing is sharded. ``--data``, ``--model``,
``--multi-pod`` and ``--stages`` other than their defaults shard over
several cards: multi-GPU is not ported, and they raise.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.qmatmul import ops as qmatmul_ops
from repro_torch.models import SHAPES
from repro_torch.optim.compression import MULTI_GPU_ITEM
from repro_torch.plan import build_plan
from repro_torch.serve import DecodeRequest


def warm_check(plan) -> bool:
    """Two request waves; True iff the second builds no step and hits the
    cache."""
    batcher = plan.make_batcher()
    batcher.init_demo_params(seed=0)
    q0, f0 = qmatmul_ops.launches, flash_ops.launches
    for wave in range(2):
        for i in range(batcher.policy.buckets[0].batch):
            batcher.submit(DecodeRequest(
                f"w{wave}r{i}", [1 + (i + j) % 7 for j in range(2)],
                max_new_tokens=4))
        batcher.run()
        if wave == 0:
            warm = dict(plan.cache.stats())
    after = plan.cache.stats()
    ok = after["builds"] == warm["builds"] and after["hits"] > warm["hits"]
    print(f"kernel launches over the two waves: qmatmul "
          f"{qmatmul_ops.launches - q0}, flash {flash_ops.launches - f0}")
    print(f"warm check: builds {warm['builds']} -> {after['builds']}, hits "
          f"{warm['hits']} -> {after['hits']} => {'OK' if ok else 'FAIL'}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Build an ExecutionPlan on one card, dump its pass "
                    "decisions, and optionally assert that a warm plan "
                    "builds no new step.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="pin a ShapeSpec (default: serve plan, "
                         "per-bucket shapes)")
    ap.add_argument("--mode", default=None,
                    choices=["cascade", "megatron", "megatron_sp"],
                    help="sharding mode, recorded (one card: nothing "
                         "sharded)")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config")
    ap.add_argument("--data", type=int, default=1,
                    help="data-axis extent (multi-GPU: not ported)")
    ap.add_argument("--model", type=int, default=1,
                    help="model-axis extent (multi-GPU: not ported)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="multi-pod mesh (multi-GPU: not ported)")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages (multi-GPU: not ported)")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--warm", action="store_true",
                    help="assert zero new builds on the second wave")
    ap.add_argument("--out", default=None,
                    help="write the describe() JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    for flag, given in (("--data", args.data != 1),
                        ("--model", args.model != 1),
                        ("--multi-pod", args.multi_pod),
                        ("--stages", args.stages != 1)):
        if given:
            raise NotImplementedError(
                f"{flag} shards over several cards: {MULTI_GPU_ITEM}")
    plan = build_plan(args.arch, args.shape, quantized=args.quantized,
                      debug=args.debug, device=args.device,
                      config_overrides=({"sharding_mode": args.mode}
                                        if args.mode else None))

    d = plan.describe()
    print(f"{d['arch']} ({d['family']}) mode={d['mode']} "
          f"device={d['device']} (one card, nothing sharded) stages=1 "
          f"quantized={d['quantized']}")
    for p in d["passes"]:
        entry = {k: v for k, v in p.items() if k != "pass"}
        print(f"  {p['pass']}: {entry}")

    ok = True
    if args.warm:
        ok = warm_check(plan)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(plan.describe(), f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
