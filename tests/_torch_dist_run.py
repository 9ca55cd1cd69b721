"""The port's models run sharded on 8 gloo ranks (a 2x4 ("data",
"model") mesh), each held to the same model run unsharded on every rank.

Run as a script, in a process of its own (``tests/test_torch_dist_model.py``
and ``tests/test_torch_dist_serve.py`` do):

    python tests/_torch_dist_run.py model INIT_FILE OUT_DIR WEIGHTS_DIR
    python tests/_torch_dist_run.py family INIT_FILE OUT_DIR
    python tests/_torch_dist_run.py serve INIT_FILE OUT_DIR
    python tests/_torch_dist_run.py train INIT_FILE OUT_DIR WEIGHTS G_FILE

Each spawns 8 ranks (rendezvous through ``file://INIT_FILE``, one thread
each) that build the plan's 2x4 mesh, install the same weights, compute
the unsharded result on the plain model, then ``plan.shard_model`` and
compute it again under ``plan.activate()``. Rank 0 writes
``OUT_DIR/<check>.json`` with what the test holds; any rank's exception
fails the spawn. Nothing here imports JAX: ``model`` reads the
reference's weights from ``WEIGHTS_DIR/<name>.npz`` (fp32, flat keys, as
``bridge.params_to_arrays`` lays them out), written by the test.

* ``model``: the reduced yi-6b (the reference's ``vocab=64, n_layers=2,
  d_model=64, n_heads=8, n_kv=4``) in each mode, bf16: the loss and the
  gradient of the reference's first leaf; the reduced phi3.5-moe
  (``vocab=64``) under megatron: the loss and one ``decode_step`` over a
  placed state at position 3 (``tests/test_distributed.py``'s two model
  tests); a two-stage plan's refusal.
* ``family``: every family's reduced config, cut to one block of its
  kind, in fp32 under megatron, the decode state cast to fp32 too:
  ``forward``, and four ``decode_step``s dense and paged over a placed
  state (random cross caches where the family has them).
* ``serve``: the reduced yi-6b (``vocab=64, n_layers=2``) under
  megatron_sp through ``plan.make_batcher()``: two fifo waves, then one
  continuous paged wave, with the streams and the plan cache's counters
  (``tests/test_distributed.py::test_serve_batcher_on_sharded_mesh``).
* ``train``: the reduced yi-6b (as ``model``) in fp32 on the reference's
  weights (``WEIGHTS``), trained by the port's ``Trainer`` unsharded on
  every rank and sharded on the mesh (``TRAIN_RUNS``: adamw in each mode,
  adafactor and int8 compression under megatron), with the losses and
  the final parameters; a sharded run crashed at step 2 of 4 and resumed
  on the mesh beside the straight run; ``restore_elastic`` of its
  checkpoint onto a 4x2 mesh; and the collective
  ``error_feedback_reduce`` of each rank's data block of ``G_FILE``'s
  ``g`` over "data" (``reduce_<rank>.npz``).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT_S = 240
WORLD = 8
MESH = (2, 4)
YI = "yi-6b"
YI_MODEL = dict(vocab=64, n_layers=2, d_model=64, n_heads=8, n_kv=4)
MOE = "phi3.5-moe-42b-a6.6b"
FAMILIES = ("yi-6b", "zamba2-2.7b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
            "seamless-m4t-large-v2", "llama-3.2-vision-90b")
# each family's reduced config cut to one block of its kind (a hybrid
# group, a vision superblock, one encoder and one decoder layer): every
# DTensor op is a synchronisation of the 8 ranks, and the spawn must stay
# inside its timeout on a loaded host
FAMILY_DEPTH = {"encdec": dict(n_layers=1, n_enc_layers=1)}
FAMILY_LAYERS = 2
DRAWN_FAMILIES = ("encdec", "vlm")
MODES = ("cascade", "megatron", "megatron_sp")
SERVE_WAVES = 2
SERVE_BUCKET = (64, 4)                   # (max_len, batch)
SERVE_PAGED = (64, 16)                   # (page_count, page_size)
SERVE_K = 4


def run(check, tmp_path, *extra):
    """Run one spawn in a subprocess with a hard timeout; any rank's
    failure fails the caller with every rank's stderr. Returns rank 0's
    record."""
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, __file__, check, str(tmp_path / "init"), str(out),
         *map(str, extra)],
        capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stderr[-20000:]
    return json.loads((out / f"{check}.json").read_text())


def weights_path(weights_dir, name):
    return os.path.join(weights_dir, f"{name}.npz")


def model_cfgs():
    """``{name: (arch, overrides, mode)}`` of the model spawn's runs."""
    out = {f"yi-{m}": (YI, YI_MODEL, m) for m in MODES}
    out["moe-megatron"] = (MOE, dict(vocab=64), "megatron")
    return out


def loss_batch(vocab):
    """The reference test's batch: ones [8, 16] as tokens and labels."""
    import torch

    ones = torch.ones((8, 16), dtype=torch.int32)
    return {"tokens": ones, "labels": ones.clone()}


def _setup(rank, init_file):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)


def _plan(arch, mode, overrides=None, mesh=MESH):
    from repro_torch.configs import reduced_config
    from repro_torch.plan import MeshSpec, build_plan

    cfg = reduced_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    return build_plan(cfg, mode=mode, mesh_spec=MeshSpec.debug(*mesh),
                      device="cpu")


def _grads(model, batch, grads=True):
    """The loss and every parameter's gradient, by name (plain); with
    ``grads`` False the loss alone (no backward)."""
    import torch

    from repro_torch.dist.sharding import local_value

    if not grads:
        with torch.no_grad():
            return float(local_value(model.loss(batch))), {}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss = model.loss(batch)
    loss.backward()
    grads = {n: local_value(p.grad).float() for n, p in params.items()}
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    return float(local_value(loss)), grads


def first_leaf(model):
    """The leaf group ``jax.tree.leaves`` of the reference's tree lists
    first (its dicts flatten in sorted key order): ``blocks.attn.wk.w``
    for the decoder LMs."""
    from repro_torch.bridge import leaf_groups

    return min(leaf_groups(model), key=lambda g: g.name.split("."))


def moe_decode(plan, model, tokens, rec=None):
    """One ``decode_step`` at position 3 over a fresh state of 8 slots and
    16 positions (placed on a sharded model), in the model's bf16 and
    again on an fp32 copy of its parameters and state: the logits of each,
    plain. bf16 logits move by a few bf16 steps under any change of the
    reduction order, so the tight comparison is the fp32 one."""
    import torch

    from repro_torch.dist.sharding import local_value

    out = []
    for dtype in (torch.bfloat16, torch.float32):
        state = {k: v.to(dtype)
                 for k, v in plan.fresh_decode_state(8, 16).items()}
        if rec is not None and dtype == torch.bfloat16:
            rec["state_placements"] = {
                k: str(v.placements) for k, v in state.items()}
        model.to(dtype)
        logits, _ = model.decode_step(state, tokens, 3)
        out.append(local_value(logits))
    model.to(torch.bfloat16)
    return out


def model_rank(rank, init_file, out_dir, weights_dir):
    import torch

    from repro_torch.bridge import _nest, load_arrays
    from repro_torch.dist.sharding import local_value
    from repro_torch.models.base import build_model

    _setup(rank, init_file)
    out = {}
    for name, (arch, overrides, mode) in model_cfgs().items():
        plan = _plan(arch, mode, overrides)
        with np.load(weights_path(weights_dir, name)) as z:
            tree = _nest({k: z[k] for k in z.files})
        model = load_arrays(build_model(plan.cfg, device="cpu"), tree)
        plan.load_params(model, shard=False)
        batch = loss_batch(plan.cfg.vocab)
        # the MoE run holds the loss alone, as the reference's test does
        ref_loss, ref_grads = _grads(model, batch, grads=arch != MOE)
        rec = {"plain_loss": ref_loss}
        if arch == MOE:
            tokens = torch.ones((8,), dtype=torch.int32)
            ref_logits = moe_decode(plan, model, tokens)
        plan.shard_model(model)
        with plan.activate():
            loss, grads = _grads(model, batch, grads=arch != MOE)
            if arch == MOE:
                logits = moe_decode(plan, model, tokens, rec)
                rec["decode_shape"] = [list(t.shape) for t in logits]
                rec["decode_finite"] = all(bool(torch.isfinite(t).all())
                                           for t in logits)
                rec["decode_err"] = [float((a - b).abs().max())
                                     for a, b in zip(logits, ref_logits)]
                top = torch.topk(ref_logits[0], 2).values
                rec["decode_gap"] = float((top[:, 0] - top[:, 1]).min())
                rec["decode_tokens_equal"] = bool(torch.equal(
                    logits[0].argmax(-1), ref_logits[0].argmax(-1)))
        rec.update(sharded_loss=loss, dtensor_params=sum(
            type(p).__name__ == "DTensor" for p in model.parameters()))
        if grads:
            first = first_leaf(model)
            rec.update(first_leaf=first.name, first_grad_err=max(
                float((grads[n] - ref_grads[n]).abs().max())
                for n in first.members))
        out[name] = rec
    out["staged"] = staged_refusal()
    if rank == 0:
        _write(out_dir, "model", out)


def staged_refusal():
    """A two-stage plan (``layers -> data`` on the 2x4 mesh) refuses to
    place its model: which member of a staged leaf goes to which row band
    is part 2c. Returns the error and whether every parameter stayed
    plain."""
    from repro_torch.configs import reduced_config
    from repro_torch.plan import MeshSpec, build_plan

    plan = build_plan(reduced_config(YI).with_(**YI_MODEL), mode="megatron",
                      mesh_spec=MeshSpec.debug(*MESH), pipeline_stages=2,
                      device="cpu")
    try:
        plan.init_params(0)
    except NotImplementedError as exc:
        return {"error": str(exc), "plain": all(
            type(p).__name__ != "DTensor"
            for p in plan.model.parameters()), "sharded": plan.sharded}
    return {"error": None}


def draw_zero_leaves(model, seed):
    """Every bias drawn from N(0, 0.5^2) and every gate uniform in [0.5,
    1] (``tests/_torch_serve_ref.py``'s ``draw_zero_leaves``, in torch):
    the encoder-decoder's and the vision LM's zero initialisers would hide
    their biases and cross-attention."""
    import torch

    rng = np.random.default_rng(seed + 23)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gate":
                new = rng.uniform(0.5, 1.0, tuple(p.shape))
            elif leaf in ("b", "bias"):
                new = rng.standard_normal(tuple(p.shape)) * 0.5
            else:
                continue
            p.copy_(torch.as_tensor(new, dtype=p.dtype))
    model.reset_quantized()


def _inputs(cfg, rng, B=4, S=16):
    import torch

    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S // 2 if cfg.family == "encdec"
                                    else S)), dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(
            rng.standard_normal((B, S, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["vision"] = torch.as_tensor(
            rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)),
            dtype=torch.float32)
    return batch


def _decode(plan, model, state, tokens, paged):
    """Four decode steps over ``state``: the logits of each, plain."""
    import torch

    from repro_torch.dist.sharding import local_value
    from repro_torch.models.base import PageView

    B = tokens.shape[1]
    out = []
    for i in range(tokens.shape[0]):
        pages = None
        if paged is not None:
            n = FAMILY_LEN // paged[1]
            table = torch.arange(B * n, dtype=torch.int32).view(B, n)
            pages = PageView(table, torch.full((B,), i, dtype=torch.int32),
                             paged[1])
        logits, _ = model.decode_step(state, tokens[i], i, pages=pages)
        out.append(local_value(logits))
    return out


FAMILY_LEN = 32
FAMILY_PAGE = 8


def _family_state(plan, model, B, paged, cross, place):
    """A zeroed fp32 state of B slots (its cross caches set to ``cross``),
    placed on the mesh when ``place``."""
    from torch.distributed.tensor import distribute_tensor

    state = plan.fresh_decode_state(B, FAMILY_LEN, paged=paged)
    state = {k: v.float() for k, v in state.items()}
    for k, v in cross.items():
        state[k] = (distribute_tensor(v, plan.mesh, state[k].placements)
                    if place else v.clone())
    return state


def family_rank(rank, init_file, out_dir):
    import torch

    from repro_torch.dist.sharding import local_value
    from repro_torch.models.base import CROSS_STATE_KEYS, build_model

    _setup(rank, init_file)
    out = {}
    from repro_torch.configs import reduced_config

    for arch in FAMILIES:
        t0 = time.perf_counter()
        family = reduced_config(arch).family
        plan = _plan(arch, "megatron", FAMILY_DEPTH.get(
            family, dict(n_layers=FAMILY_LAYERS)))
        cfg = plan.cfg
        model = build_model(cfg, device="cpu", dtype=torch.float32)
        model.init_params(0)
        if cfg.family in DRAWN_FAMILIES:
            draw_zero_leaves(model, 0)
        plan.load_params(model, shard=False)
        rng = np.random.default_rng(5)
        batch = _inputs(cfg, rng)
        B = batch["tokens"].shape[0]
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (4, B)),
                                 dtype=torch.int32)
        layouts = {"dense": None, "paged": (B * FAMILY_LEN // FAMILY_PAGE,
                                            FAMILY_PAGE)}
        plain = plan.fresh_decode_state(B, FAMILY_LEN)
        cross = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape)),
                                    dtype=torch.float32)
                 for k, v in plain.items() if k in CROSS_STATE_KEYS}
        ref = {"forward": model.forward(batch)}
        for name, paged in layouts.items():
            state = _family_state(plan, model, B, paged, cross, False)
            ref[name] = _decode(plan, model, state, tokens, paged)
        plan.shard_model(model)
        rec = {}
        with plan.activate():
            got = local_value(model.forward(batch))
            rec["forward_err"] = float((got - ref["forward"]).abs().max())
            rec["forward_shape"] = list(got.shape)
            for name, paged in layouts.items():
                state = _family_state(plan, model, B, paged, cross, True)
                rec[f"{name}_placed"] = all(
                    type(v).__name__ == "DTensor" for v in state.values())
                steps = _decode(plan, model, state, tokens, paged)
                rec[f"{name}_err"] = max(float((a - b).abs().max())
                                         for a, b in zip(steps, ref[name]))
        rec["seconds"] = time.perf_counter() - t0
        out[arch] = rec
    if rank == 0:
        _write(out_dir, "family", out)


def serve_trace(wave):
    """Four requests of a wave, each five new tokens."""
    return [(f"w{wave}r{i}", [1 + i, 2, 3], 5) for i in range(4)]


def _run_waves(batcher, waves):
    from repro_torch.serve import DecodeRequest

    streams, builds = {}, []
    for wave in waves:
        for rid, prompt, n in serve_trace(wave):
            batcher.submit(DecodeRequest(rid, prompt, max_new_tokens=n))
        streams.update({r: list(v.tokens) for r, v in batcher.run().items()})
        builds.append(dict(batcher.cache.stats()))
    return streams, builds


def greedy_gaps(plan, model, prompt, n):
    """The top-2 logit gap of each of ``n`` greedy tokens after ``prompt``,
    one request alone from position 0 (``tests/_torch_serve_ref.py``'s
    rule: streams are compared up to the first gap below 0.02)."""
    import torch

    state = plan.fresh_decode_state(1, SERVE_BUCKET[0])
    gaps, tok = [], None
    for pos in range(len(prompt) + n - 1):
        feed = prompt[pos] if pos < len(prompt) else tok
        logits, _ = model.decode_step(
            state, torch.tensor([feed], dtype=torch.int32), pos)
        if pos >= len(prompt) - 1:
            top = torch.topk(logits[0].float(), 2).values
            gaps.append(float(top[0] - top[1]))
            tok = int(torch.argmax(logits[0]))
    return gaps


def serve_rank(rank, init_file, out_dir):
    from repro_torch.serve import Bucket, BucketPolicy

    _setup(rank, init_file)
    out = {}
    policy = BucketPolicy([Bucket(*SERVE_BUCKET)])
    runs = {"fifo": dict(), "continuous": dict(
        schedule="continuous", steps_per_dispatch=SERVE_K,
        paged=SERVE_PAGED)}
    for name, kw in runs.items():
        plan = _plan(YI, "megatron_sp", dict(vocab=64, n_layers=2))
        model = plan.init_params(0, shard=False)
        waves = range(SERVE_WAVES) if name == "fifo" else range(1)
        ref, _ = _run_waves(plan.make_batcher(policy=policy, **kw), waves)
        gaps = {rid: greedy_gaps(plan, model, prompt, n)
                for w in waves for rid, prompt, n in serve_trace(w)}
        plan.shard_model(model)
        with plan.activate():
            batcher = plan.make_batcher(policy=policy, **kw)
            got, builds = _run_waves(batcher, waves)
        pool = batcher.pool
        leaves = {k: v for st in pool._pools[SERVE_BUCKET[::-1]].free
                  for k, v in st.items()}
        leaves.update(pool._pool_leaves or {})
        out[name] = {"plain": ref, "sharded": got, "gaps": gaps,
                     "cache": builds,
                     "placements": {k: str(v.placements)
                                    for k, v in leaves.items()}}
    if rank == 0:
        _write(out_dir, "serve", out)


TRAIN_BATCH = (8, 16)                  # (batch, seq) of the token stream
TRAIN_RUNS = {                         # name: (mode, optimizer, steps, compress)
    "adamw-cascade": ("cascade", "adamw", 3, False),
    "adamw-megatron": ("megatron", "adamw", 3, False),
    "adamw-megatron_sp": ("megatron_sp", "adamw", 3, False),
    "adafactor-megatron": ("megatron", "adafactor", 2, False),
    "compress-megatron": ("megatron", "adamw", 2, True),
}
RESTART = dict(steps=4, ckpt_every=2, fail_at=2)
ELASTIC_MESH = (4, 2)


def _train_stream(vocab):
    from repro_torch.data import make_train_iterator

    return lambda start: make_train_iterator(vocab, TRAIN_BATCH[1],
                                             TRAIN_BATCH[0], seed=7,
                                             start_step=start)


def _fp32_model(plan, tree):
    import torch

    from repro_torch.bridge import load_arrays
    from repro_torch.models.base import build_model

    return load_arrays(build_model(plan.cfg, device="cpu",
                                   dtype=torch.float32), tree)


def _fit(plan, tree, ckpt_dir, steps, compress, sharded, ckpt_every=100,
         fail_at=None, resume=False):
    """One training run of ``plan``'s optimizer from ``tree``: the model
    (plain, or sharded on the plan's mesh) and the losses."""
    from repro_torch.bridge import leaf_groups
    from repro_torch.train import FailureInjector, Trainer, TrainerConfig
    from repro_torch.train.trainer import model_loss

    model = _fp32_model(plan, tree)
    if sharded:
        plan.load_params(model, shard=True)
        opt_state = plan.placed_opt_state(model)
    else:
        opt_state = plan.optimizer.init(dict(model.named_parameters()),
                                        leaf_groups(model))
    trainer = Trainer(model_loss, plan.optimizer, TrainerConfig(
        steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir, log_every=100,
        compress_grads=compress),
        mesh=plan.mesh if sharded else None, rules=plan.rules)
    if fail_at is not None:
        trainer.injector = FailureInjector(fail_at_steps=(fail_at,))
    _, state, hist = trainer.fit(model, opt_state,
                                 _train_stream(plan.cfg.vocab), resume=resume)
    return model, state, [h["loss"] for h in hist], trainer


def _whole(model):
    from repro_torch.dist.sharding import local_value

    return {n: local_value(p.detach()) for n, p in model.named_parameters()}


def train_rank(rank, init_file, out_dir, weights_file, g_file):
    import torch

    from repro_torch.bridge import _nest, leaf_groups, params_template
    from repro_torch.dist.sharding import is_dtensor, sharding_ctx
    from repro_torch.models.base import build_model
    from repro_torch.optim import error_feedback_reduce
    from repro_torch.train.fault import InjectedFailure

    _setup(rank, init_file)
    with np.load(weights_file) as z:
        tree = _nest({k: z[k] for k in z.files})
    out = {}
    t0 = time.perf_counter()
    for name, (mode, opt, steps, compress) in TRAIN_RUNS.items():
        plan = _plan(YI, mode, dict(YI_MODEL, optimizer=opt))
        plain, _, plain_losses, _ = _fit(
            plan, tree, os.path.join(out_dir, f"plain-{rank}-{name}"), steps,
            compress, sharded=False)
        model, state, losses, _ = _fit(
            plan, tree, os.path.join(out_dir, f"mesh-{name}"), steps,
            compress, sharded=True)
        want, got = _whole(plain), _whole(model)
        out[name] = {
            "losses": losses, "plain_losses": plain_losses,
            "param_err": max(float((got[n] - want[n]).abs().max())
                             for n in want),
            "dtensor_params": sum(is_dtensor(p) for p in model.parameters()),
            "dtensor_state": all(is_dtensor(v) for v in _leaves(state)),
            "sharded_state": sum(
                any(p.is_shard() for p in v.placements)
                for v in _leaves(state)),
        }
    out["seconds_runs"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    # crash at step 2 of 4, resumed on the mesh by a new trainer
    plan = _plan(YI, "megatron", YI_MODEL)
    steps, every, fail_at = (RESTART["steps"], RESTART["ckpt_every"],
                             RESTART["fail_at"])
    straight, *_ = _fit(plan, tree, os.path.join(out_dir, "straight"),
                        steps, False, True, ckpt_every=every)
    crash_dir = os.path.join(out_dir, "crash")
    try:
        _fit(plan, tree, crash_dir, steps, False, True, ckpt_every=every,
             fail_at=fail_at)
        fired = False
    except InjectedFailure:
        fired = True
    resumed, _, resumed_losses, trainer = _fit(
        plan, tree, crash_dir, steps, False, True, ckpt_every=every,
        resume=True)
    a, b = _whole(straight), _whole(resumed)
    out["restart"] = {"fired": fired, "resumed_steps": len(resumed_losses),
                      "equal": all(torch.equal(a[n], b[n]) for n in a)}

    out["seconds_restart"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    # the checkpoint of step 4 onto a 4x2 mesh
    plan42 = _plan(YI, "megatron", YI_MODEL, mesh=ELASTIC_MESH)
    meta = build_model(plan42.cfg, device="meta", dtype=torch.float32)
    groups = leaf_groups(meta)
    template = {
        "params": params_template(meta),
        "opt": plan42.optimizer.init(dict(meta.named_parameters()), groups),
        "res": {g.name: torch.zeros((), device="meta") for g in groups}}
    shardings = plan42.train_state_shardings(meta)
    restored = trainer.restore_elastic(steps, template, shardings)
    flat_sh = _flat_paths(shardings)
    with np.load(os.path.join(crash_dir, f"step_{steps:08d}",
                              "shard_0.npz")) as z:
        saved = {k: z[k] for k in z.files}
    flat = _flat_paths(restored)
    out["elastic"] = {
        "mesh": list(plan42.mesh.shape),
        "keys_equal": set(flat) == set(saved),
        "all_dtensor": all(is_dtensor(v) for v in flat.values()),
        "placed_as_given": all(
            tuple(v.placements) == tuple(flat_sh[k][1])
            and v.device_mesh is plan42.mesh for k, v in flat.items()),
        "sharded_leaves": sum(any(p.is_shard() for p in v.placements)
                              for v in flat.values()),
        "bit_equal": all(np.array_equal(
            v.full_tensor().numpy(), saved[k]) for k, v in flat.items()),
    }

    out["seconds_elastic"] = time.perf_counter() - t1
    # the collective error feedback of this rank's data block over "data"
    with np.load(g_file) as z:
        g = torch.from_numpy(z["g"])
    rows = g.shape[0] // MESH[0]
    block = g[(rank // MESH[1]) * rows:(rank // MESH[1] + 1) * rows]
    with sharding_ctx(plan.mesh, plan.rules):
        reduced, res = error_feedback_reduce(block, torch.zeros_like(block),
                                             axis_name="data")
    np.savez(os.path.join(out_dir, f"reduce_{rank}.npz"),
             reduced=reduced.numpy(), residual=res.numpy())
    out["seconds"] = time.perf_counter() - t0
    if rank == 0:
        _write(out_dir, "train", out)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _flat_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = prefix + k.replace(".", "/")
        if isinstance(v, dict):
            out.update(_flat_paths(v, path + "/"))
        else:
            out[path] = v
    return out


def _write(out_dir, name, obj):
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(obj, f, indent=1)


def main(argv):
    import torch.multiprocessing as mp

    check, init_file, out_dir = argv[:3]
    fn = {"model": model_rank, "family": family_rank,
          "serve": serve_rank, "train": train_rank}[check]
    mp.spawn(fn, args=(init_file, out_dir, *argv[3:]), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1:])
