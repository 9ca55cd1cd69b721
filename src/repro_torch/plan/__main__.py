"""Plan smoke CLI: build an ExecutionPlan, dump ``describe()``, optionally
prove that a warm plan builds no new step (the reference's ``python -m
repro.plan``).

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

Runs on the card unless ``--device cpu``. The plan resolves every
parameter's PartitionSpec under ``--mode`` on its mesh: ``--data D
--model M`` is a D x M debug mesh (default 1 x 1, with ``--debug`` or
without: the port runs on one card), ``--multi-pod`` the 2x16x16
production mesh. A mesh larger than the world exits non-zero with
``RuntimeError: need N devices, have M`` before any model is allocated.
``--stages S`` runs the PlaceStages pass; on a mesh whose data axis
cannot hold S stages it records the reference's fallback. On a mesh of
several ranks the warm check places the parameters there (each data row
holding only its band of a staged layer stack) and serves under the
plan's sharding context; ranks started by ``torch.distributed.run`` join
its group. The reference's staged CI run, on 8 gloo ranks:

    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 8 -m repro_torch.plan --arch yi-6b --debug \\
        --data 2 --model 4 --stages 2 --warm --device cpu
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.qmatmul import ops as qmatmul_ops
from repro_torch.models import SHAPES
from repro_torch.plan import MeshSpec, build_plan
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
        with plan.activate() if plan.sharded else contextlib.nullcontext():
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
        description="Build an ExecutionPlan, dump its pass "
                    "decisions, and optionally assert that a warm plan "
                    "builds no new step.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None, choices=list(SHAPES),
                    help="pin a ShapeSpec (default: serve plan, "
                         "per-bucket shapes)")
    ap.add_argument("--mode", default=None,
                    choices=["cascade", "megatron", "megatron_sp"],
                    help="sharding mode (default: the config's)")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config")
    ap.add_argument("--data", type=int, default=1,
                    help="debug mesh data-axis extent")
    ap.add_argument("--model", type=int, default=1,
                    help="debug mesh model-axis extent")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 production mesh")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages (the PlaceStages pass)")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--warm", action="store_true",
                    help="assert zero new builds on the second wave")
    ap.add_argument("--out", default=None,
                    help="write the describe() JSON here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    mesh_spec = (MeshSpec.production(multi_pod=True) if args.multi_pod
                 else MeshSpec.debug(args.data, args.model))
    plan = build_plan(args.arch, args.shape, mode=args.mode,
                      mesh_spec=mesh_spec, quantized=args.quantized,
                      pipeline_stages=args.stages, debug=args.debug,
                      device=args.device)

    d = plan.describe()
    print(f"{d['arch']} ({d['family']}) mode={d['mode']} "
          f"device={d['device']} mesh={d['mesh']} "
          f"stages={d['pipeline_stages']} quantized={d['quantized']}")
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
