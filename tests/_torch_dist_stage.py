"""A two-stage plan on 8 gloo ranks (a 2x4 ("data", "model") mesh): each
data row holds only its band of the layer stack.

Run as a script, in a process of its own (``tests/test_torch_dist_stage.py``
does):

    python tests/_torch_dist_stage.py INIT_FILE OUT_DIR WEIGHTS TRAIN_WEIGHTS

Spawns 8 ranks (rendezvous through ``file://INIT_FILE``, one thread each).
Every rank builds the reduced yi-6b (``vocab=64``, 4 layers) twice on the
2x4 mesh, one stage and two, installs the reference's weights
(``WEIGHTS``: fp32, flat keys, as ``bridge.params_to_arrays`` lays them
out) and runs the counterparts of ``tests/test_plan.py``'s two stage
tests: the train executable's loss of each plan on ones ``[8, 16]``, the
plans' stage decisions and cache keys, the staged decode state's
placements, and four requests of four tokens through the staged plan's
batcher, sharded and over the unsharded model (with the unsharded greedy
gaps for the gap rule). Then, in fp32 on the
train spawn's model (``_torch_dist_run.YI_MODEL``, 2 layers, the
reference's weights in ``TRAIN_WEIGHTS``): every gradient of the staged
plan against the unsharded one, one adamw step of the staged plan's
``Trainer`` with its checkpoint, the same step unsharded, and
``restore_elastic`` of the checkpoint onto a one-stage 4x2 mesh and back
onto the staged 2x4 plan. Rank 0 writes
``OUT_DIR/stage.json``; any rank's exception fails the spawn. Nothing
here imports JAX.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _torch_dist_run import (  # noqa: E402
    YI_MODEL,
    _grads,
    _setup,
    _write,
    greedy_gaps,
    loss_batch,
)

ROOT = Path(__file__).resolve().parents[1]
STAGE_TIMEOUT_S = 150
ARCH = "yi_6b"
OVERRIDES = dict(vocab=64)                # the reference's: 4 layers
MESH = (2, 4)
ELASTIC_MESH = (4, 2)
SHAPE = ("t", 16, 8, "train")
BUCKET = (32, 4)                          # (max_len, batch) of the batcher
TRACE = [(f"r{i}", [1 + i, 2, 3], 4) for i in range(4)]
CKPT_STEP = 1


def run(tmp_path, weights, train_weights):
    """The spawn in a subprocess with a hard timeout; any rank's failure
    fails the caller with every rank's stderr. Returns rank 0's record."""
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, __file__, str(tmp_path / "init"), str(out),
         str(weights), str(train_weights)],
        capture_output=True, text=True, timeout=STAGE_TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stderr[-20000:]
    return json.loads((out / "stage.json").read_text())


def _cfg(overrides=OVERRIDES):
    from repro_torch.configs import reduced_config

    return reduced_config(ARCH).with_(**overrides)


def _plan(stages, shape=None, mesh=MESH, cfg=None):
    from repro_torch.models.base import ShapeSpec
    from repro_torch.plan import MeshSpec, build_plan

    return build_plan(cfg or _cfg(), ShapeSpec(*shape) if shape else None,
                      mesh_spec=MeshSpec.debug(*mesh), pipeline_stages=stages,
                      device="cpu")


def _model(plan, tree, dtype):
    import torch  # noqa: F401

    from repro_torch.bridge import load_arrays
    from repro_torch.models.base import build_model

    return load_arrays(build_model(plan.cfg, device="cpu", dtype=dtype),
                       tree)


def _losses(tree, rec):
    """The train executable's loss of the one- and two-stage plans (bf16,
    sharded on the mesh), as the reference's test takes it (one step, the
    loss before the update)."""
    import torch

    from repro_torch.dist.sharding import local_value
    from repro_torch.dist.staging import param_bytes

    ones = torch.ones((8, 16), dtype=torch.int32)
    batch = {"tokens": ones, "labels": ones.clone()}
    losses, keys = [], set()
    for stages in (1, 2):
        plan = _plan(stages, SHAPE)
        model = plan.load_params(_model(plan, tree, torch.bfloat16),
                                 shard=True)
        opt = plan.placed_opt_state(model)
        rec[f"param_bytes_{stages}"] = sum(param_bytes(p)
                                           for p in model.parameters())
        rec[f"opt_bytes_{stages}"] = sum(param_bytes(v)
                                         for v in _leaves(opt))
        metrics = plan.executable("train").fn(model, opt, batch)
        losses.append(float(local_value(metrics["loss"])))
        keys |= {k.stages for k in plan.cache._entries}
        if stages == 2:
            rec.update(
                stage_axis=plan.ir.stage_axis,
                layers_rule=plan.rules.get("layers"),
                placement_method=plan.ir.placement_method,
                stages=[(s.first_layer, s.n_layers, s.row, s.height)
                        for s in plan.ir.stages],
                wq_pspec=plan.ir.param_pspecs[
                    "['blocks']['attn']['wq']['w']"])
        else:
            rec["wq_pspec_1"] = plan.ir.param_pspecs[
                "['blocks']['attn']['wq']['w']"]
    rec.update(losses=losses, cache_stages=sorted(keys))


def _serve(tree, rec):
    """Four requests of four tokens through the two-stage serve plan's
    batcher, sharded on the mesh, and through the same plan's batcher
    over the unsharded model (one stage); the staged decode state's
    placements; the unsharded greedy gaps."""
    import torch

    from repro_torch.serve import Bucket, BucketPolicy, DecodeRequest

    policy = BucketPolicy([Bucket(*BUCKET)])
    plan = _plan(2)
    model = plan.load_params(_model(plan, tree, torch.bfloat16),
                             shard=False)
    rec["gaps"] = {rid: greedy_gaps(plan, model, prompt, n)
                   for rid, prompt, n in TRACE}

    def serve():
        batcher = plan.make_batcher(policy=policy)
        for rid, prompt, n in TRACE:
            batcher.submit(DecodeRequest(rid, prompt, max_new_tokens=n))
        return {r: list(v.tokens) for r, v in batcher.run().items()}

    rec["one_stage"] = serve()
    plan.shard_model(model)
    with plan.activate():
        state = plan.fresh_decode_state(8, 32)
        rec["state_placements"] = {k: str(v.placements)
                                   for k, v in state.items()}
        rec["state_local"] = {k: list(v.to_local().shape)
                              for k, v in state.items()}
        rec["two_stage"] = serve()


def _train(tree, out_dir, rank, rec):
    """fp32 on the train spawn's model: the staged plan's gradients against
    the unsharded ones; one adamw step of the staged plan's Trainer
    (checkpointed) and of the unsharded trainer; the checkpoint restored
    elastically onto a one-stage 4x2 mesh and onto the staged 2x4 plan."""
    import torch

    from repro_torch.bridge import leaf_groups, params_template
    from repro_torch.data import make_train_iterator
    from repro_torch.dist.sharding import is_dtensor, local_value
    from repro_torch.models.base import build_model
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.trainer import model_loss

    def stream(start):
        return make_train_iterator(64, 16, 8, seed=7, start_step=start)

    def fit(plan, ckpt_dir, sharded):
        model = _model(plan, tree, torch.float32)
        if sharded:
            plan.load_params(model, shard=True)
            opt = plan.placed_opt_state(model)
        else:
            opt = plan.optimizer.init(dict(model.named_parameters()),
                                      leaf_groups(model))
        trainer = Trainer(model_loss, plan.optimizer, TrainerConfig(
            steps=CKPT_STEP, ckpt_every=CKPT_STEP, ckpt_dir=ckpt_dir,
            log_every=100), mesh=plan.mesh if sharded else None,
            rules=plan.rules)
        _, state, hist = trainer.fit(model, opt, stream, resume=False)
        return model, state, [h["loss"] for h in hist], trainer

    cfg = _cfg(YI_MODEL)
    staged_plan = _plan(2, cfg=cfg)
    model = _model(staged_plan, tree, torch.float32)
    batch = loss_batch(cfg.vocab)
    _, want = _grads(model, batch)
    staged_plan.load_params(model, shard=True)
    with staged_plan.activate():
        _, got = _grads(model, batch)
    rec["grad_err"] = max(float((got[n] - want[n]).abs().max())
                          for n in want)
    plain, _, plain_losses, _ = fit(staged_plan, os.path.join(
        out_dir, f"plain-{rank}"), sharded=False)
    model, state, losses, trainer = fit(staged_plan, os.path.join(
        out_dir, "staged"), sharded=True)
    want = {n: p.detach() for n, p in plain.named_parameters()}
    got = {n: local_value(p.detach()) for n, p in model.named_parameters()}
    rec["train"] = {
        "losses": losses, "plain_losses": plain_losses,
        "param_err": max(float((got[n] - want[n]).abs().max())
                         for n in want),
        "staged_state": sum(v.ndim > 0 and v.placements[0].is_shard(0)
                            for v in _leaves(state))}
    want_tree = _flat(params_arrays(plain))
    for name, mesh, stages in (("one_stage_4x2", ELASTIC_MESH, 1),
                               ("staged_2x4", MESH, 2)):
        plan = _plan(stages, mesh=mesh, cfg=cfg)
        meta = build_model(plan.cfg, device="meta", dtype=torch.float32)
        groups = leaf_groups(meta)
        template = {
            "params": params_template(meta),
            "opt": plan.optimizer.init(dict(meta.named_parameters()),
                                       groups),
            "res": {g.name: torch.zeros((), device="meta") for g in groups}}
        restored = trainer.restore_elastic(
            CKPT_STEP, template, plan.train_state_shardings(meta))
        params = _flat(restored["params"])
        rec[name] = {
            "mesh": list(plan.mesh.shape),
            "all_dtensor": all(is_dtensor(v) for v in params.values()),
            # leaves whose stacked dim lies on data (mesh dim 0)
            "staged_leaves": sum(v.placements[0].is_shard(0)
                                 for v in params.values()),
            "param_err": max(float(np.abs(
                v.full_tensor().numpy() - want_tree[k]).max())
                for k, v in params.items())}


def params_arrays(model):
    from repro_torch.bridge import params_to_arrays

    return params_to_arrays(model)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree(path):
    from repro_torch.bridge import _nest

    with np.load(path) as z:
        return _nest({k: z[k] for k in z.files})


def stage_rank(rank, init_file, out_dir, weights, train_weights):
    _setup(rank, init_file)
    tree = _tree(weights)
    rec = {}
    t0 = time.perf_counter()
    _losses(tree, rec)
    rec["seconds_loss"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    _serve(tree, rec)
    rec["seconds_serve"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    _train(_tree(train_weights), out_dir, rank, rec)
    rec["seconds_train"] = time.perf_counter() - t1
    rec["seconds"] = time.perf_counter() - t0
    if rank == 0:
        _write(out_dir, "stage", rec)


def main(argv):
    import torch.multiprocessing as mp

    mp.spawn(stage_rank, args=tuple(argv), nprocs=8)


if __name__ == "__main__":
    main(sys.argv[1:])
