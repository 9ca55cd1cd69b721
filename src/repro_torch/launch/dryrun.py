"""Production dry run: build an ExecutionPlan for every (architecture x
input shape) on the production meshes, run its step once for one rank of
a placeholder world, and extract the memory and roofline figures (the
reference's ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape train_4k --single-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
        --shape decode_32k --single-pod --mode megatron --stages 2
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.json

The reference forces 512 placeholder devices on XLA and compiles each
plan's executable ahead of time. The port has no compiler to ask, so:

* **The world.** This process becomes rank 0 (``--rank`` names another)
  of a 256-rank (16x16) or 512-rank (2x16x16) world over torch's fake
  process group (``launch.mesh.placeholder_world``): the plan's
  ``DeviceMesh`` is the production mesh, and collectives return at once
  and move nothing.
* **Nothing is allocated.** The model is built on the ``meta`` device and
  placed by the plan (``shard_model``): every parameter, the optimizer
  state, the decode state and the batch are DTensors whose local shards
  are meta tensors of this rank's shapes (a staged member outside the
  rank's band is empty). The kernel wrappers report their work on meta
  and launch nothing.
* **The step.** In place of ``plan.executable()``'s AOT compile, the
  plan's step for the shape's kind (train: one optimizer step; prefill:
  the forward; decode: one ``decode_step`` at the last position) runs once
  on meta under ``launch.step_analysis.analyze_step``, which counts this
  rank's ops at their local shapes and the collectives it joins (with the
  reference's ring factors). ``trace_s`` (the plan, the placement and the
  step) takes the place of ``lower_s``/``compile_s``; there is no XLA
  cost analysis (``xla_cost_analysis`` is null).
* **Memory.** ``memory`` holds exact byte sums of this rank's shards:
  ``argument_bytes`` (parameters, optimizer state, decode state, batch),
  ``output_bytes`` (what the step returns plus what it updates in place),
  ``alias_bytes`` (the part updated in place: parameters and optimizer
  state in training, the decode state when decoding; XLA's donated
  buffers) and the parameters alone (``param_bytes``, of which
  ``stacked_param_bytes`` in the layer stacks). ``temp_bytes`` is null:
  eager torch on meta frees nothing a high-water mark could be read
  from, so ``peak_bytes_est`` leaves the temporaries out.
* ``--hlo-dir`` has no counterpart (there is no HLO) and exits 2.

The run ends with "dry-run: N ok, M skipped, K errors / T cells" and
exits 1 on errors, as the reference's. See ``docs/port_dryrun.md``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ALIASES, get_config, list_archs
from repro_torch.launch.model_flops import model_flops, param_counts
from repro_torch.launch.roofline import roofline_terms, summarize
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models.base import SHAPES, build_model, supports_shape
from repro_torch.plan import MeshSpec, build_plan

WORLDS = {False: 256, True: 512}


def _bytes(tree) -> int:
    """This rank's bytes of every tensor in a (nested) dict or list."""
    from repro_torch.dist.staging import param_bytes

    if isinstance(tree, dict):
        return sum(_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_bytes(v) for v in tree)
    return param_bytes(tree) if torch.is_tensor(tree) else 0


def placed_param_bytes(plan) -> Dict[str, int]:
    """``{"param_bytes", "stacked_param_bytes"}`` of this rank under
    ``plan``: its model built on ``meta`` and placed on the plan's mesh
    (nothing is allocated), the layer stacks' members apart."""
    from repro_torch.bridge import leaf_groups

    model = build_model(plan.cfg, device="meta")
    stacked = {n for g in leaf_groups(model) if g.stack for n in g.members}
    placed = dict(plan.iter_shard_params(model))
    return {"param_bytes": _bytes(list(placed.values())),
            "stacked_param_bytes": _bytes([placed[n] for n in stacked])}


def _batch(plan, model, shape, kind: str) -> Dict[str, Any]:
    """The step's inputs at ``shape`` (the family's ``input_specs``) as
    meta tensors laid out over the data axes by the plan; a prefill takes
    no labels."""
    specs = model.input_specs(shape)
    if kind == "prefill":
        specs.pop("labels", None)
    return plan.place_batch({name: torch.empty(s, dtype=dt, device="meta")
                             for name, (s, dt) in specs.items()
                             if name != "pos"})


def _step(plan, model, shape):
    """``(run, arguments, in-place bytes)`` of the plan's step for the
    shape's kind, its inputs placed as meta shards."""
    kind = shape.kind
    batch = _batch(plan, model, shape, kind)
    params = _bytes(list(model.parameters()))
    if kind == "train":
        opt = plan.placed_opt_state(model)
        exe = plan.executable("train")
        return (lambda: exe.fn(model, opt, batch),
                {"opt_bytes": _bytes(opt), "batch_bytes": _bytes(batch)},
                params + _bytes(opt))
    if kind == "prefill":
        exe = plan.executable("prefill")
        return (lambda: exe.fn(model, batch), {"batch_bytes": _bytes(batch)},
                0)
    state = plan.fresh_decode_state(shape.global_batch, shape.seq_len)
    exe = plan.executable("decode")
    pos = shape.seq_len - 1
    return (lambda: exe.fn(model, state, batch["tokens"], pos),
            {"state_bytes": _bytes(state), "batch_bytes": _bytes(batch)},
            _bytes(state))


def _returned(result) -> int:
    """Bytes of the tensors a step returns that it made (its logits,
    metrics), leaving out what it returns of its own arguments."""
    if isinstance(result, tuple):       # (logits, state): the state aliases
        result = result[0]
    return _bytes(result)


def run_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    mode: Optional[str] = None,
    pipeline_stages: int = 1,
    verbose: bool = True,
    config_overrides: Optional[dict] = None,
    rank: int = 0,
) -> dict:
    """One (arch x shape) cell on the production mesh for ``rank`` of the
    placeholder world: the record of the reference's ``run_cell`` (see
    the module docstring for what each figure means here)."""
    from repro_torch.launch.mesh import placeholder_world

    cfg = get_config(arch)
    if config_overrides:
        cfg = cfg.with_(**config_overrides)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    record = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh_name,
        "mode": mode or cfg.sharding_mode,
        "stages": pipeline_stages,
    }
    ok, reason = supports_shape(cfg, shape_name)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        if verbose:
            print(f"SKIP {cfg.name} x {shape_name}: {reason}")
        return record
    try:
        t0 = time.perf_counter()
        n_chips = WORLDS[multi_pod]
        placeholder_world(n_chips, rank)
        plan = build_plan(
            cfg, shape, mode=mode,
            mesh_spec=MeshSpec.production(multi_pod=multi_pod),
            pipeline_stages=pipeline_stages, device="meta")
        held = placed_param_bytes(plan)
        model = plan.load_params(build_model(plan.cfg, device="meta"),
                                 shard=True)
        with plan.activate():
            run, args, aliased = _step(plan, model, shape)
            result, stats = analyze_step(run)
        trace_s = time.perf_counter() - t0
        argument = held["param_bytes"] + sum(args.values())
        output = _returned(result) + aliased
        mem = {
            "argument_bytes": argument,
            "output_bytes": output,
            "temp_bytes": None,
            "alias_bytes": aliased,
            "peak_bytes_est": argument + output - aliased,
            **held,
            **args,
        }
        total_p, active_p = param_counts(cfg)
        record.update(
            status="ok",
            trace_s=round(trace_s, 2),
            params_total=total_p,
            params_active=active_p,
            memory=mem,
            xla_cost_analysis=None,
            roofline=roofline_terms(stats, n_chips,
                                    model_flops(cfg, shape), mem),
        )
        record["roofline"]["kernel_calls"] = dict(stats.kernel_launches)
        if pipeline_stages > 1:
            record["stage_slices"] = [s.as_dict() for s in plan.ir.stages]
        if verbose:
            print(f"== {cfg.name} x {shape_name} on {mesh_name} "
                  f"({record['mode']}, rank {rank} of {n_chips}) ==")
            print(f"memory (per device, exact from the shards): {mem}")
            print(f"step analysis: flops {stats.flops:.3e} bytes "
                  f"{stats.bytes:.3e} collective bytes "
                  f"{stats.collective_bytes:.3e} {stats.collective_ops}")
            print(summarize(record))
    except Exception as e:  # noqa: BLE001 -- record the failure, keep batch
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
        if verbose:
            print(f"ERROR {cfg.name} x {shape_name} on {mesh_name}: "
                  f"{record['error']}")
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default=None,
                   help=f"one of {list(ALIASES)} (or module id)")
    p.add_argument("--shape", default=None, choices=list(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--single-pod", action="store_true")
    p.add_argument("--mode", default=None,
                   choices=["cascade", "megatron", "megatron_sp"],
                   help="sharding mode override (default: per-arch config)")
    p.add_argument("--stages", type=int, default=1,
                   help="pipeline stages (PlaceStages pass)")
    p.add_argument("--all", action="store_true",
                   help="every (arch x shape) on the requested mesh(es)")
    p.add_argument("--moe-groups", type=int, default=None,
                   help="group-limited MoE dispatch (0/None = global sort)")
    p.add_argument("--q-chunk", type=int, default=None)
    p.add_argument("--microbatches", type=int, default=None,
                   help="gradient-accumulation factor for train shapes")
    p.add_argument("--out", default=None, help="write JSON records here")
    p.add_argument("--hlo-dir", default=None,
                   help="the reference's HLO dump: no counterpart here")
    p.add_argument("--rank", type=int, default=0,
                   help="the placeholder rank whose shards are measured")
    args = p.parse_args(argv)

    if args.hlo_dir is not None:
        print("--hlo-dir: the port compiles no HLO (its step runs eagerly "
              "on meta tensors); there is nothing to dump")
        return 2
    if args.single_pod and not args.multi_pod:
        meshes = [False]
    elif args.multi_pod and not args.single_pod:
        meshes = [True]
    else:  # default: prove both the single-pod and the multi-pod mesh
        meshes = [False, True]

    cells = []
    if args.all:
        for arch in list_archs():
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not args.arch or not args.shape:
            p.error("--arch and --shape required unless --all")
        cells.append((args.arch, args.shape))

    overrides = {}
    if args.moe_groups is not None:
        overrides["moe_groups"] = args.moe_groups
    if args.q_chunk is not None:
        overrides["q_chunk"] = args.q_chunk
    if args.microbatches is not None:
        overrides["microbatches"] = args.microbatches

    records = []
    for arch, shape in cells:
        for mp in meshes:
            records.append(
                run_cell(arch, shape, multi_pod=mp, mode=args.mode,
                         pipeline_stages=args.stages,
                         config_overrides=overrides or None,
                         rank=args.rank))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out if args.out.endswith(".json")
                  else args.out + ".json", "w") as f:
            json.dump(records, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skipped" for r in records)
    n_err = sum(r["status"] == "error" for r in records)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors "
          f"/ {len(records)} cells")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
