"""Training launcher of the port: a thin CLI over ``repro_torch.plan`` and
the restart-safe ``repro_torch.train.Trainer`` (the reference's
``repro.launch.train`` on one card).

It builds one plan, makes the random parameters and the optimizer state
(``plan.init_train_state``) and runs the trainer on the synthetic token
stream, resuming from the newest checkpoint in ``--ckpt-dir``. Runs on the
card unless ``--device cpu``. With ``--debug``: the reduced config at
seq 32, batch 4.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --debug \\
        --steps 20 --device cpu --ckpt-dir "$(mktemp -d)"

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
  --mode, --multi-pod, --stages
                  the reference's sharding flags: multi-GPU, not ported
                  (ROADMAP Queue 1 item 2); they raise
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.data.pipeline import make_train_iterator
from repro_torch.launch.steps import train_inputs
from repro_torch.models.base import SHAPES, ShapeSpec
from repro_torch.optim.compression import MULTI_GPU_ITEM
from repro_torch.plan import build_plan
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
        description="Training on one card with the restart-safe Trainer "
                    "loop, wired by one ExecutionPlan.")
    ap.add_argument("--arch", required=True,
                    help="architecture alias, e.g. yi-6b")
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES),
                    help="ShapeSpec (ignored under --debug)")
    ap.add_argument("--mode", default=None,
                    choices=["cascade", "megatron", "megatron_sp"],
                    help="sharding mode (multi-GPU: not ported)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="multi-pod mesh (multi-GPU: not ported)")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config (seq=32, batch=4)")
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stages (multi-GPU: not ported)")
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

    for flag, given in (("--mode", args.mode is not None),
                        ("--multi-pod", args.multi_pod),
                        ("--stages", args.stages != 1)):
        if given:
            raise NotImplementedError(
                f"{flag} shards over several cards: {MULTI_GPU_ITEM}")
    # cuBLAS reads this once, when it first starts: the trainer's
    # deterministic steps need it (no effect on the CPU)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    shape = (ShapeSpec("debug_train", 32, 4, "train") if args.debug
             else SHAPES[args.shape])
    plan = build_plan(args.arch, shape, debug=args.debug, device=args.device)
    model, opt_state = plan.init_train_state(seed=0)
    n = sum(p.numel() for p in model.parameters())
    print(f"{plan.cfg.name}: {n/1e6:.1f}M params on {plan.device} "
          f"mode={plan.mode} stages=1")

    tcfg = TrainerConfig(
        steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, log_every=5,
        microbatches=args.microbatches, compress_grads=args.compress_grads,
    )
    trainer = Trainer(model_loss, plan.optimizer, tcfg)
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
