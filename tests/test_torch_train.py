"""The port's training loop on the CPU: the data pipeline against the JAX
package's, checkpointing, the fault tools, restart, gradient
accumulation, the plan's train step, the train CLI, and serving a trained
model.

The model is the reference's fault-tolerance setup: the reduced yi-6b cut
to 2 layers and vocab 64, adamw at lr 1e-3, batches of 4 x 16 tokens of
the synthetic stream (seed 7). Restart is held bit for bit
(``torch.equal``); gradient accumulation as the reference holds it (the
first loss within rtol 2e-2, parameters within atol 3e-2 in bf16) and in
fp32 copies, where the microbatch mean equals the full batch's to rtol
1e-5.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import json
import os
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.train.trainer as trainer_mod
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.data.pipeline import make_train_iterator as jax_train_iterator
from repro.dist.sharding import init_params as jax_init_params
from repro.models import build_model as jax_build_model
from repro.optim.optimizers import adamw as jax_adamw
from repro.train.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import reduced_config as jax_reduced_config
from repro_torch.bridge import (
    leaf_groups,
    load_arrays,
    model_from_arrays,
    params_to_arrays,
)
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticTokens, make_train_iterator
from repro_torch.launch import train as train_cli
from repro_torch.models import ShapeSpec, build_model
from repro_torch.optim import adamw
from repro_torch.plan import build_plan
from repro_torch.train import (
    CheckpointManager,
    FailureInjector,
    StragglerMonitor,
    Trainer,
    TrainerConfig,
)
from repro_torch.train.fault import InjectedFailure
from repro_torch.train.trainer import init_residuals, model_loss


def _cfg():
    return reduced_config("yi_6b").with_(vocab=64, n_layers=2)


def _model(dtype=torch.bfloat16):
    return build_model(_cfg(), device="cpu", dtype=dtype).init_params(0)


def _opt_state(model, opt):
    return opt.init(dict(model.named_parameters()), leaf_groups(model))


def _iter_factory(vocab=64):
    def factory(start):
        return make_train_iterator(vocab, 16, 4, seed=7, start_step=start)
    return factory


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,host_id,n_hosts", [
    (5, 0, 1), (0, 0, 2), (0, 1, 2), (2**31 - 1, 3, 4)])
def test_data_pipeline_equals_reference(seed, host_id, n_hosts):
    ours = SyntheticTokens(97, 8, 8, seed, host_id, n_hosts)
    ref = JaxSyntheticTokens(97, 8, 8, seed, host_id, n_hosts)
    for step in (0, 1, 13, 1000):
        a, b = ours.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    extra = {"frames": np.ones((2, 3), np.float32)}
    it = make_train_iterator(97, 8, 4, seed=seed, start_step=3, extra=extra)
    jt = jax_train_iterator(97, 8, 4, seed=seed, start_step=3, extra=extra)
    for _ in range(3):
        a, b = next(it), next(jt)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_data_pipeline_deterministic_and_resumable():
    ds = SyntheticTokens(vocab=97, seq_len=8, global_batch=4, seed=5)
    np.testing.assert_array_equal(ds.batch(13)["tokens"],
                                  ds.batch(13)["tokens"])
    it = make_train_iterator(97, 8, 4, seed=5, start_step=0)
    stream = [next(it) for _ in range(5)]
    it2 = make_train_iterator(97, 8, 4, seed=5, start_step=3)
    np.testing.assert_array_equal(stream[3]["tokens"], next(it2)["tokens"])
    full = SyntheticTokens(97, 8, 4, seed=5).batch(0)
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["labels"][:, :-1])


def test_data_host_sharding_partitions_batch():
    a = SyntheticTokens(97, 8, 8, seed=5, host_id=0, n_hosts=2).batch(0)
    b = SyntheticTokens(97, 8, 8, seed=5, host_id=1, n_hosts=2).batch(0)
    assert a["tokens"].shape == (4, 8)
    assert not np.array_equal(a["tokens"], b["tokens"])
    with pytest.raises(ValueError, match="divide across hosts"):
        SyntheticTokens(97, 8, 7, n_hosts=2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                        "h": torch.arange(4.0).bfloat16()},
             "opt": {"blocks.attn.wq.w": torch.ones(2, 2)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (10, 20, 30):
        mgr.save(s, state, metadata={"loss": 1.5})
    assert mgr.all_steps() == [20, 30]      # retention pruned step 10
    assert mgr.latest_step() == 30 and mgr.metadata(30) == {"loss": 1.5}
    with open(tmp_path / "step_00000030" / "manifest.json") as f:
        manifest = json.load(f)
    # "." in a key is a level of the path (the reference's keys); bf16 is
    # stored as fp32
    assert manifest["keys"] == ["opt/blocks/attn/wq/w", "params/h",
                                "params/w", "step"]
    data = np.load(tmp_path / "step_00000030" / "shard_0.npz")
    assert data["params/h"].dtype == np.float32
    template = {"params": {"w": torch.empty(2, 3, device="meta"),
                           "h": torch.empty(4, dtype=torch.bfloat16)},
                "opt": {"blocks.attn.wq.w": torch.empty(2, 2)},
                "step": torch.empty((), dtype=torch.int32)}
    got = mgr.restore(30, template)
    assert got["params"]["h"].dtype == torch.bfloat16
    assert got["params"]["w"].device.type == "cpu"
    for path in (("params", "w"), ("params", "h"), ("opt",
                                                    "blocks.attn.wq.w")):
        a, b = got, state
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a, b), path
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    with pytest.raises(ValueError, match="checkpoint shape"):
        mgr.restore(30, {**template, "step": torch.empty(2)})
    # restore reads the members by their offsets, CRC-32 checked: a
    # flipped bit in an array's bytes is refused
    npz = tmp_path / "step_00000030" / "shard_0.npz"
    raw = bytearray(npz.read_bytes())
    at = raw.index(np.arange(6.0, dtype=np.float32).tobytes())
    raw[at + 5] ^= 1
    npz.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="bad CRC-32 for params/w"):
        mgr.restore(30, template)


def test_checkpoint_tmp_is_atomic(tmp_path):
    """A save interrupted before its rename leaves a ``.tmp`` directory
    that is never listed or restored; the next save of that step replaces
    it, and a save over an existing step replaces that step."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(4, {"w": torch.zeros(3)})
    os.makedirs(tmp_path / "step_00000008.tmp")
    (tmp_path / "step_00000008.tmp" / "junk").write_text("partial")
    assert mgr.all_steps() == [4] and mgr.latest_step() == 4
    mgr.save(8, {"w": torch.ones(3)})
    assert not (tmp_path / "step_00000008.tmp").exists()
    assert not (tmp_path / "step_00000008" / "junk").exists()
    mgr.save(8, {"w": torch.full((3,), 2.0)})
    assert mgr.all_steps() == [4, 8]
    assert torch.equal(mgr.restore(8, {"w": torch.empty(3)})["w"],
                       torch.full((3,), 2.0))


def test_trainer_checkpoint_keys_are_the_reference(tmp_path):
    """The port's trainer state is saved under the reference trainer's
    keys and shapes: parameters stacked per leaf, the optimizer state per
    leaf, a residual per leaf."""
    model = _model()
    opt = adamw(lr=1e-3)
    trainer = Trainer(model_loss, opt, TrainerConfig(
        ckpt_dir=str(tmp_path / "port")))
    trainer.save(1, model, _opt_state(model, opt),
                 trainer.init_residuals(model), loss=0.0)
    jcfg = jax_reduced_config("yi_6b").with_(vocab=64, n_layers=2)
    jparams = jax_init_params(jax.random.PRNGKey(0),
                              jax_build_model(jcfg).param_specs())
    JaxCheckpointManager(str(tmp_path / "ref")).save(
        1, {"params": jparams, "opt": jax_adamw().init(jparams),
            "res": jax.tree.map(lambda p: jnp.zeros((), jnp.float32),
                                jparams)})
    ours = np.load(tmp_path / "port" / "step_00000001" / "shard_0.npz")
    ref = np.load(tmp_path / "ref" / "step_00000001" / "shard_0.npz")
    assert sorted(ours.files) == sorted(ref.files)
    for key in ref.files:
        assert ours[key].shape == ref[key].shape, key
        assert ours[key].dtype == ref[key].dtype, key


# ---------------------------------------------------------------------------
# fault tools
# ---------------------------------------------------------------------------


def test_checkpoint_restores_onto_a_mesh(tmp_path):
    """The reference's elastic restore (``tests/test_train_fault.py``): a
    checkpoint written plain restores onto a (1x1) mesh at the placements
    given, as a DTensor; a DTensor template leaf with no sharding given is
    placed at its own placements."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = build_plan("yi-6b", debug=True, device="cpu").mesh
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(16, dtype=torch.float32).reshape(4, 4)}
    mgr.save(5, state)
    sh = {"w": (mesh, [Replicate(), Replicate()])}
    restored = mgr.restore(5, state, shardings=sh)
    assert isinstance(restored["w"], DTensor)
    assert restored["w"].device_mesh is mesh
    assert list(restored["w"].placements) == sh["w"][1]
    assert torch.equal(restored["w"].full_tensor(), state["w"])
    like = mgr.restore(5, {"w": restored["w"].redistribute(
        mesh, [Shard(1), Replicate()])})
    assert list(like["w"].placements) == [Shard(1), Replicate()]
    assert torch.equal(like["w"].full_tensor(), state["w"])
    # and a DTensor state saves its whole value, in the reference's keys
    mgr.save(6, {"w": like["w"]})
    assert np.array_equal(np.load(tmp_path / "step_00000006" /
                                  "shard_0.npz")["w"], state["w"].numpy())


def test_failure_injector_fires_once():
    inj = FailureInjector(fail_at_steps=(3,))
    inj.check(2)
    with pytest.raises(InjectedFailure):
        inj.check(3)
    inj.check(3)  # second time: already fired


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(alpha=0.5, threshold=2.0, warmup=2)
    flags = [mon.observe(i, dt) for i, dt in
             enumerate([1.0, 1.0, 1.0, 1.0, 5.0, 1.0])]
    assert flags == [False, False, False, False, True, False]
    assert len(mon.events) == 1 and mon.events[0]["step"] == 4
    assert mon.ewma < 1.5


def test_step_timing_immune_to_wall_clock_jumps(tmp_path, monkeypatch):
    """Step durations use the monotonic clock: a wall clock that jumps an
    hour on every call must not reach ``dt`` nor spoof the monitor. The
    trainer's monotonic clock is a fake one that ticks 0.25 s per read,
    so that a step slowed by a loaded host cannot flag a straggler: each
    ``dt`` must be exactly one tick apart."""
    base = [1_000_000.0]
    calls = []

    def jumping_wall_clock():
        base[0] += 3600.0 if len(calls) % 2 else -3600.0
        calls.append(None)
        return base[0]

    ticks = [0.0]

    def monotonic_ticks():
        ticks[0] += 0.25
        return ticks[0]

    monkeypatch.setattr(trainer_mod.time, "time", jumping_wall_clock)
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        time=jumping_wall_clock, perf_counter=monotonic_ticks))
    model = _model()
    opt = adamw(lr=1e-3)
    t = Trainer(model_loss, opt, TrainerConfig(
        steps=5, ckpt_every=100, log_every=100,
        ckpt_dir=str(tmp_path / "clock")))
    _, _, hist = t.fit(model, _opt_state(model, opt), _iter_factory(),
                       resume=False)
    assert len(hist) == 5
    for h in hist:
        assert 0.0 <= h["dt"] < 3600.0, h
        assert h["dt"] == 0.25, h
    assert t.monitor.events == []


# ---------------------------------------------------------------------------
# restart and accumulation
# ---------------------------------------------------------------------------


def test_trainer_restart_is_bit_exact(tmp_path):
    """8 steps straight vs a crash at step 5 (checkpoint at 4) and a new
    trainer that resumes: the same parameters and optimizer state, bit
    for bit, and no parameter left requiring grad."""
    opt = adamw(lr=1e-3)
    pa = _model()
    ta = Trainer(model_loss, opt, TrainerConfig(
        steps=8, ckpt_every=100, log_every=100, ckpt_dir=str(tmp_path / "a")))
    pa, oa, _ = ta.fit(pa, _opt_state(pa, opt), _iter_factory(),
                       resume=False)

    cfg_b = TrainerConfig(steps=8, ckpt_every=4, log_every=100,
                          ckpt_dir=str(tmp_path / "b"))
    tb = Trainer(model_loss, opt, cfg_b)
    tb.injector = FailureInjector(fail_at_steps=(5,))
    pb = _model()
    with pytest.raises(InjectedFailure):
        tb.fit(pb, _opt_state(pb, opt), _iter_factory(), resume=True)
    pb2 = _model()
    pb2, ob, hist = Trainer(model_loss, opt, cfg_b).fit(
        pb2, _opt_state(pb2, opt), _iter_factory(), resume=True)
    assert hist[0]["step"] == 4          # resumed, not restarted
    for name, p in _params(pa).items():
        assert torch.equal(p, _params(pb2)[name]), name
    assert torch.equal(oa["step"], ob["step"])
    for key in ("m", "v"):
        for leaf, t in oa[key].items():
            assert torch.equal(t, ob[key][leaf]), (key, leaf)
    assert not any(p.requires_grad for p in pb2.parameters())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grad_accumulation_matches_full_batch(tmp_path, dtype):
    """microbatches=2 gives the same loss trajectory as the full batch (a
    loss linear in the batch gives the same gradients); the microbatch
    gradients are summed in fp32."""
    opt = adamw(lr=1e-3)
    runs = []
    for nmb in (1, 2):
        model = _model(dtype)
        runs.append(Trainer(model_loss, opt, TrainerConfig(
            steps=3, ckpt_every=100, log_every=100, microbatches=nmb,
            ckpt_dir=str(tmp_path / f"m{nmb}"))).fit(
                model, _opt_state(model, opt), _iter_factory(),
                resume=False))
    (p1, _, h1), (p2, _, h2) = runs
    if dtype == torch.float32:
        np.testing.assert_allclose([h["loss"] for h in h1],
                                   [h["loss"] for h in h2], rtol=1e-5)
    np.testing.assert_allclose(h1[0]["loss"], h2[0]["loss"], rtol=2e-2)
    for name, a in _params(p1).items():
        np.testing.assert_allclose(a.float().numpy(),
                                   _params(p2)[name].float().numpy(),
                                   atol=3e-2 if dtype == torch.bfloat16
                                   else 1e-4)


def test_microbatch_grads_accumulate_in_fp32():
    model = _model()
    batch = {k: torch.from_numpy(v) for k, v in
             next(_iter_factory()(0)).items()}
    _, g1 = trainer_mod.value_and_grad(model_loss, model, batch, 1)
    _, g2 = trainer_mod.value_and_grad(model_loss, model, batch, 2)
    assert all(g.dtype == torch.bfloat16 for g in g1.values())
    assert all(g.dtype == torch.float32 for g in g2.values())
    with pytest.raises(ValueError, match="microbatches"):
        trainer_mod.value_and_grad(model_loss, model, batch, 3)


def test_compressed_grads_train_and_keep_residuals(tmp_path):
    """``compress_grads``: int8 error feedback per reference leaf, the
    residuals shaped as the stacked leaves and checkpointed."""
    model = _model()
    opt = adamw(lr=1e-3)
    t = Trainer(model_loss, opt, TrainerConfig(
        steps=3, ckpt_every=100, log_every=100, compress_grads=True,
        ckpt_dir=str(tmp_path)))
    _, _, hist = t.fit(model, _opt_state(model, opt), _iter_factory(),
                       resume=False)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    data = np.load(tmp_path / "step_00000003" / "shard_0.npz")
    assert data["res/blocks/attn/wq/w"].shape == (2, 64, 64)
    assert np.abs(data["res/blocks/attn/wq/w"]).max() > 0
    res = init_residuals(model, leaf_groups(model), False)
    assert all(r.shape == () for r in res.values())


# ---------------------------------------------------------------------------
# the plan, the CLI, serving after training
# ---------------------------------------------------------------------------


def test_train_executable_is_built_once_then_hit():
    plan = build_plan(_cfg(), ShapeSpec("t", 16, 4, "train"), device="cpu")
    model, opt_state = plan.init_train_state(seed=0)
    assert plan.optimizer is plan.optimizer
    assert int(opt_state["step"]) == 0
    exe = plan.executable("train")
    assert plan.executable("train") is exe
    stats = plan.cache.stats()
    assert stats["builds"] == 1 and stats["hits"] == 1
    batch = {k: torch.from_numpy(v) for k, v in
             next(_iter_factory()(0)).items()}
    before = _params(model)
    metrics = exe.fn(model, opt_state, batch)
    assert np.isfinite(float(metrics["loss"])) and float(
        metrics["grad_norm"]) > 0
    assert int(opt_state["step"]) == 1
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    with pytest.raises(ValueError, match="built for"):
        exe.fn(model, opt_state, {"tokens": batch["tokens"]})


def test_train_cli_on_the_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    train_cli.main(["--arch", "yi-6b", "--debug", "--steps", "8",
                    "--device", "cpu", "--ckpt-dir", ckpt])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("yi-6b: ") and "params on cpu" in out[0]
    steps = [line for line in out if line.startswith("step ")]
    assert [line.split()[1] for line in steps] == ["0", "5", "7"]
    line = re.compile(r"step +\d+ loss +[\d.]+ gnorm +[\d.]+ +[\d.]+ms"
                      r"( \[straggler\])?$")
    assert all(line.match(s) for s in steps), steps
    assert re.match(r"done: loss [\d.]+ -> [\d.]+$", out[-1])
    # a checkpoint every 8 // 4 steps, the newest 3 kept
    assert sorted(os.listdir(ckpt)) == ["step_00000004", "step_00000006",
                                        "step_00000008"]
    # a second run resumes at the last checkpoint: nothing left to do
    train_cli.main(["--arch", "yi-6b", "--debug", "--steps", "8",
                    "--device", "cpu", "--ckpt-dir", ckpt])
    assert "nothing to do" in capsys.readouterr().out
    # the mesh flags run sharded on the 1x1 mesh (``--multi-pod`` is
    # ignored under --debug, as in the reference; two stages fall back to
    # one): each restores the plain checkpoint onto the mesh, at step 8
    for flag, want in ((["--stages", "2"], "cannot hold 2 equal stages"),
                       (["--multi-pod"], "mesh debug:1x1"),
                       (["--mode", "cascade"], "mode=cascade")):
        train_cli.main(["--arch", "yi-6b", "--debug", "--steps", "8",
                        "--device", "cpu", "--ckpt-dir", ckpt, *flag])
        out = capsys.readouterr().out
        assert "(sharded)" in out and want in out, out
        assert "nothing to do" in out, out


def test_train_cli_mesh_flags(tmp_path, capsys):
    """``--debug --mode megatron`` trains sharded on the 1x1 mesh;
    ``--multi-pod`` without ``--debug`` asks for the 2x16x16 production
    mesh and exits with the reference's count error before any model is
    allocated."""
    train_cli.main(["--arch", "yi-6b", "--debug", "--mode", "megatron",
                    "--steps", "2", "--device", "cpu", "--ckpt-dir",
                    str(tmp_path / "m")])
    out = capsys.readouterr().out.splitlines()
    assert "(sharded) mode=megatron stages=1" in out[0], out
    assert [line.split()[1] for line in out if line.startswith("step ")] \
        == ["0", "1"], out
    assert re.match(r"done: loss [\d.]+ -> [\d.]+$", out[-1]), out
    with pytest.raises(RuntimeError, match="need 512 devices, have 1"):
        train_cli.main(["--arch", "yi-6b", "--multi-pod", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path / "p")])
    assert not (tmp_path / "p").exists() or not os.listdir(tmp_path / "p")


def _whole(tree):
    from repro_torch.dist.sharding import local_value

    return {k: _whole(v) if isinstance(v, dict) else local_value(v)
            for k, v in tree.items()}


def _equal_trees(a, b):
    return all(_equal_trees(v, b[k]) if isinstance(v, dict)
               else torch.equal(v, b[k]) for k, v in a.items())


def test_sharded_training_on_a_one_by_one_gloo_mesh(tmp_path):
    """The card's set-up on the CPU (``chip_smoke.py`` phase 20): on the
    world-1 1x1 mesh every shard is whole, so 3 sharded bf16 adamw steps
    (DTensor parameters, the state placed by ``state_specs``) are the
    plain trainer's bit for bit, and so is the plan's train executable; a
    crash at step 2 resumes on the mesh bit for bit; the plain run's
    checkpoint restores onto the mesh (DTensors at the plan's placements)
    and back."""
    from torch.distributed.tensor import DTensor

    from repro_torch.bridge import params_template

    shape = ShapeSpec("t", 16, 4, "train")
    plan = build_plan(_cfg(), shape, mode="megatron", device="cpu")

    def run(sub, shard, **kw):
        model, opt_state = plan.init_train_state(seed=0, shard=shard)
        t = Trainer(model_loss, plan.optimizer, TrainerConfig(
            steps=3, log_every=100, ckpt_dir=str(tmp_path / sub),
            **kw.pop("cfg", {})), mesh=plan.mesh if shard else None,
            rules=plan.rules)
        t.injector = kw.pop("injector", None)
        return t.fit(model, opt_state, _iter_factory(), **kw)

    pa, oa, ha = run("a", False, resume=False)
    pb, ob, hb = run("b", True, resume=False)
    assert all(isinstance(p, DTensor) for p in pb.parameters())
    assert all(isinstance(v, DTensor) for v in ob["m"].values())
    assert [h["loss"] for h in ha] == [h["loss"] for h in hb]
    assert _equal_trees(_params(pa), _whole(_params(pb)))
    assert _equal_trees(oa, _whole(ob))
    # the plan's train executable on the sharded model
    model, opt_state = plan.init_train_state(seed=0, shard=True)
    batch = {k: torch.from_numpy(v) for k, v in
             next(_iter_factory()(0)).items()}
    metrics = plan.executable("train").fn(model, opt_state, batch)
    assert float(metrics["loss"].full_tensor()) == ha[0]["loss"]
    # a crash at step 2 (checkpoint at 2), resumed on the mesh
    with pytest.raises(InjectedFailure):
        run("c", True, cfg=dict(ckpt_every=2),
            injector=FailureInjector(fail_at_steps=(2,)))
    pc, oc, hc = run("c", True, cfg=dict(ckpt_every=2))
    assert hc[0]["step"] == 2
    assert _equal_trees(_whole(_params(pc)), _whole(_params(pb)))
    assert _equal_trees(_whole(oc), _whole(ob))
    # the plain checkpoint onto the mesh and back
    template = {"params": params_template(pa), "opt": oa,
                "res": init_residuals(pa, leaf_groups(pa), False)}
    ckpt = CheckpointManager(str(tmp_path / "a"))
    plain = ckpt.restore(3, template)
    placed = ckpt.restore(3, template,
                          shardings=plan.train_state_shardings(pb))
    assert placed["opt"]["m"]["blocks.attn.wq.w"].device_mesh is plan.mesh
    assert _equal_trees(plain, _whole(placed))


def test_train_cli_frontend_family(tmp_path, capsys):
    """The encoder-decoder trains from the CLI too (its frames drawn from
    a seed), with accumulation and compression."""
    train_cli.main(["--arch", "seamless-m4t-large-v2", "--debug", "--steps",
                    "2", "--device", "cpu", "--microbatches", "2",
                    "--compress-grads", "--ckpt-dir", str(tmp_path)])
    assert capsys.readouterr().out.splitlines()[-1].startswith("done: loss")


def test_trained_model_serves_quantized_like_a_fresh_one(tmp_path):
    """After ``fit`` the model's int8 copies are dropped: a trained model
    served quantized gives what a fresh model loaded with the trained
    parameters gives, and not what the copies made before training
    gave."""
    cfg = _cfg().with_(quantized=True)
    model = build_model(cfg, device="cpu").init_params(0)
    tokens = torch.tensor([3, 9], dtype=torch.int32)

    def decode(m):
        state = m.decode_state(2, 8)
        logits, _ = m.decode_step(state, tokens, 0)
        return logits

    stale = decode(model)                       # caches the int8 head
    opt = adamw(lr=1e-2)
    Trainer(model_loss, opt, TrainerConfig(
        steps=3, ckpt_every=100, log_every=100, ckpt_dir=str(tmp_path))).fit(
            model, _opt_state(model, opt), _iter_factory(), resume=False)
    fresh = load_arrays(build_model(cfg, device="cpu"),
                        params_to_arrays(model))
    assert torch.equal(decode(model), decode(fresh))
    assert not torch.equal(decode(model), stale)


def test_params_to_arrays_inverts_model_from_arrays():
    """The bridge's reverse map gives the reference's stacked tree back:
    ``model_from_arrays`` of it rebuilds the same parameters."""
    model = _model(torch.float32)
    tree = params_to_arrays(model)
    assert tree["blocks"]["attn"]["wq"]["w"].shape == (2, 64, 64)
    again = model_from_arrays(_cfg(), tree, "cpu")
    for name, p in model.named_parameters():
        assert torch.equal(p, dict(again.named_parameters())[name]), name
    with pytest.raises(KeyError, match="parameter tree mismatch"):
        load_arrays(model, {"embed": tree["embed"]})
