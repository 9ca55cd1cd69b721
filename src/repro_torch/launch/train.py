"""Training launcher of the port: a thin CLI over ``repro_torch.plan`` and
the restart-safe ``repro_torch.train.Trainer`` (the reference's
``repro.launch.train``).

It builds one plan, makes the random parameters and the optimizer state
(``plan.init_train_state``) and runs the trainer on the synthetic token
stream, resuming from the newest checkpoint in ``--ckpt-dir``. Runs on the
card unless ``--device cpu``. With ``--debug``: the reduced config at
seq 32, batch 4.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --debug \\
        --steps 20 --device cpu --ckpt-dir "$(mktemp -d)"
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --debug \\
        --mode megatron --steps 2 --device cpu --ckpt-dir "$(mktemp -d)"

The mesh flags are the reference's. Given any of them the model trains
sharded: its parameters and optimizer state placed as DTensors on the
plan's mesh, every step under the plan's sharding context. With
``--debug`` the mesh is 1x1, as the reference's; without it the port
runs on the 1x1 mesh too (one card; the plan CLI's divergence) unless
``--multi-pod`` asks for the 2x16x16 production mesh, which exits with
``RuntimeError: need 512 devices, have N`` before any model is
allocated when the world is smaller. ``--stages S`` runs PlaceStages: on
a mesh whose data axis cannot hold S stages it records the reference's
fallback and trains one stage; a plan that does stage refuses to place
its parameters (ROADMAP Queue 1 item 2, part 2c).

The encoder-decoder's frames and the vision LM's patch embeddings (stub
frontends, as in the reference) are drawn once from seed 0 and ride every
batch.

Flags:
  --arch          architecture alias (required), e.g. yi-6b
  --shape         ShapeSpec name (default train_4k); ignored under --debug
  --debug         reduced config, seq 32, batch 4
  --steps         training steps (default 50)
  --ckpt-dir      checkpoint directory (resume is automatic from the
                  newest checkpoint found there)
  --microbatches  gradient-accumulation factor
  --compress-grads  int8 error-feedback gradient compression
  --device        torch device (default: the card)
  --mode          sharding mode (default: the config's); trains sharded
  --multi-pod     the 2x16x16 production mesh (ignored under --debug, as
                  in the reference); trains sharded
  --stages        pipeline stages (the PlaceStages pass); trains sharded
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.data.pipeline import make_train_iterator
from repro_torch.launch.steps import train_inputs
from repro_torch.models.base import SHAPES, ShapeSpec
from repro_torch.plan import MeshSpec, build_plan
from repro_torch.train.trainer import Trainer, TrainerConfig, model_loss

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(),
                                "repro_torch_launch_train")


def frontend_inputs(cfg, shape: ShapeSpec) -> dict:
    """The batch's float inputs beside the tokens (frames, vision) at
    ``shape``, drawn once from seed 0 as fp32 numpy."""
    rng = np.random.default_rng(0)
    return {name: rng.standard_normal(s).astype(np.float32)
            for name, s in train_inputs(cfg, shape).items()
            if name not in ("tokens", "labels")}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Training with the restart-safe Trainer loop, wired "
                    "by one ExecutionPlan (sharded on its mesh given a "
                    "mesh flag).")
    ap.add_argument("--arch", required=True,
                    help="architecture alias, e.g. yi-6b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES),
                    help="ShapeSpec (ignored under --debug)")
    ap.add_argument("--mode", default=None,
                    choices=["cascade", "megatron", "megatron_sp"],
                    help="sharding mode override (default: per-arch "
                         "config); trains sharded")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (pod,data,model) production mesh "
                         "(ignored under --debug); trains sharded")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config on the 1x1 mesh (seq=32, batch=4)")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages (PlaceStages pass); trains "
                         "sharded")
    ap.add_argument("--steps", type=int, default=50,
                    help="training steps to run")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR,
                    help="checkpoint dir (resumes from the newest found)")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="gradient-accumulation factor")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    # cuBLAS reads this once, when it first starts: the trainer's
    # deterministic steps need it (no effect on the CPU)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    sharded = args.mode is not None or args.multi_pod or args.stages != 1
    if args.debug:
        shape = ShapeSpec("debug_train", 32, 4, "train")
        mesh_spec = MeshSpec.debug(1, 1)
    else:
        shape = SHAPES[args.shape]
        mesh_spec = (MeshSpec.production(multi_pod=True) if args.multi_pod
                     else MeshSpec.debug(1, 1))
    plan = build_plan(args.arch, shape, mode=args.mode, mesh_spec=mesh_spec,
                      pipeline_stages=args.stages, debug=args.debug,
                      device=args.device)
    model, opt_state = plan.init_train_state(seed=0, shard=sharded)
    n = sum(p.numel() for p in model.parameters())
    print(f"{plan.cfg.name}: {n/1e6:.1f}M params on {plan.device}, mesh "
          f"{plan.ir.mesh_spec.label()} {dict(plan.ir.axes)}"
          f"{' (sharded)' if sharded else ''} mode={plan.mode} "
          f"stages={args.stages}")
    if args.stages != 1:
        print("  PlaceStages: " + ", ".join(
            f"{k}={v}" for name, entry in plan.ir.decisions
            if name == "PlaceStages" for k, v in entry.items()))
    for st in plan.ir.stages:
        print(f"  stage {st.index}: layers [{st.first_layer}, "
              f"{st.first_layer + st.n_layers}) on rows "
              f"[{st.row}, {st.row + st.height})")

    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, log_every=5,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
    )
    trainer = Trainer(model_loss, plan.optimizer, tcfg,
                      mesh=plan.mesh if sharded else None, rules=plan.rules)
    batch, seq = train_inputs(plan.cfg, shape)["tokens"]
    extra = frontend_inputs(plan.cfg, shape)

    def iters(start):
        return make_train_iterator(plan.cfg.vocab, seq, batch, seed=0,
                                   start_step=start, extra=extra or None)

    _, _, hist = trainer.fit(model, opt_state, iters)
    if hist:
        print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    else:
        print(f"done: checkpoint in {args.ckpt_dir} is already at "
              f">= {args.steps} steps; nothing to do (use a fresh "
              "--ckpt-dir or raise --steps)")


if __name__ == "__main__":
    main()
