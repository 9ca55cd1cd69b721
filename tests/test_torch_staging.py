"""The staged placement's collectives, and the fake world kept out of the
product entry points.

* A staged forward of the reduced yi-6b (2 stages on a 2x4 mesh, rank 0
  of torch's fake process group of 8, in a subprocess): each staged
  member is gathered exactly once per use (one all-reduce over ``data``,
  counted by ``CommDebugMode``), and no collective moves a whole layer
  stack. The same recorder sees the trap it guards against: indexing the
  stacked leaf as one ``Shard(0)``-over-``data`` DTensor all-gathers all
  of it.
* Every family's loss and gradients run sharded on a 2x4 mesh with one
  stage and with two (rank 0 of a fake world, shapes and placements
  only; ``tests/test_torch_dist_stage.py`` holds yi-6b's numbers on 8
  gloo ranks). This holds a repaired port fault: zamba2's backward
  failed on the mesh, DTensor handing back the SSD output's gradient
  sharded on the sequence dim the forward had merged from chunks
  (``dist.sharding.reshape`` now replicates the touched dims of the
  gradient too).
* ``repro_torch.launch.serve``, ``repro_torch.launch.train`` and
  ``repro_torch.plan`` (``__main__``) import no ``torch.testing`` module
  beyond those ``import torch`` loads itself, and never name the fake
  world: it is the dry run's only.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 120

GATHER_PROBE = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.bridge import leaf_groups
    from repro_torch.configs import reduced_config
    from repro_torch.dist import staging
    from repro_torch.launch.mesh import placeholder_world
    from repro_torch.plan import MeshSpec, build_plan

    class Collectives:
        # (op, output shape) of every functional collective DTensor calls,
        # inside its own op dispatch too (a dispatch mode misses those)
        OPS = [n for n in dir(funcol) if n.startswith((
            "all_gather", "all_reduce", "reduce_scatter", "all_to_all"))]

        def __init__(self):
            self.seen = []

        def __enter__(self):
            self.saved = {op: getattr(funcol, op) for op in self.OPS}
            for op, fn in self.saved.items():
                setattr(funcol, op, self.wrap(op, fn))
            return self

        def wrap(self, op, fn):
            def call(*args, **kwargs):
                out = fn(*args, **kwargs)
                if isinstance(out, torch.Tensor):
                    self.seen.append((op, tuple(out.shape)))
                return out
            return call

        def __exit__(self, *exc):
            for op, fn in self.saved.items():
                setattr(funcol, op, fn)

    placeholder_world(8, 0)
    plan = build_plan(reduced_config("yi_6b").with_(vocab=64),
                      mesh_spec=MeshSpec.debug(2, 4), pipeline_stages=2,
                      device="cpu")
    model = plan.init_params(0)
    params = dict(model.named_parameters())
    staged = {n for n, p in params.items()
              if staging.stage_band(p) is not None}
    stacks = {}
    for g in leaf_groups(model):
        if g.members[0] in staged:
            m = params[g.members[0]]
            full = staging._local_shape(m.shape, staging.stage_band(m).mesh,
                                        staging.stage_band(m)
                                        .full_placements(m.placements))
            stacks[g.name] = (len(g.members), *full)
    calls = {}
    real = staging.gather_member

    def counted(p):
        name = next(n for n, q in params.items() if q is p)
        calls[name] = calls.get(name, 0) + 1
        return real(p)

    staging.gather_member = counted
    tokens = torch.ones((4, 8), dtype=torch.int32)
    rec = Collectives()
    with CommDebugMode() as comm, rec, plan.activate():
        model.forward({"tokens": tokens})
    counts = {str(k).split(".")[-1]: v
              for k, v in comm.get_comm_counts().items()}
    whole = sorted({n for _, n in rec.seen} & set(stacks.values()))

    # the trap: one stacked leaf as a Shard(0)-over-data DTensor, indexed
    name = "blocks.attn.wq.w"
    g = next(g for g in leaf_groups(model) if g.name == name)
    m = params[g.members[0]]
    stack = distribute_tensor(
        torch.zeros(len(g.members), *m.shape, dtype=m.dtype), plan.mesh,
        [Shard(0), Shard(2)], src_data_rank=None)
    trap = Collectives()
    with CommDebugMode() as trap_comm, trap:
        stack[1]
    trap_counts = {str(k).split(".")[-1]: v
                   for k, v in trap_comm.get_comm_counts().items()}
    trapped = sorted({n for _, n in trap.seen} & {stacks[name]})
    # every member's gather: one all-reduce of its shape on the whole mesh
    member = sorted(n for op, n in rec.seen if op == "all_reduce"
                    and n in {s[1:] for s in stacks.values()})
    print(json.dumps({"staged": sorted(staged), "calls": calls,
                      "counts": counts, "whole": whole,
                      "trapped": trapped, "trap_counts": trap_counts,
                      "member_reduces": len(member),
                      "stacks": stacks}))
""")


def test_staged_forward_gathers_each_member_once_per_use():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", GATHER_PROBE],
                          capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-10000:]
    import json

    got = json.loads(proc.stdout.strip().splitlines()[-1])
    staged = got["staged"]
    # 4 layers of 9 stacked leaves (norms, attention, SwiGLU), all staged
    assert len(staged) == 36, staged
    assert got["calls"] == {n: 1 for n in staged}, got["calls"]
    assert got["counts"].get("all_reduce", 0) >= len(staged), got["counts"]
    assert got["whole"] == [], got
    assert got["member_reduces"] >= len(staged), got
    assert got["trapped"] == [got["stacks"]["blocks.attn.wq.w"]], got
    assert got["trap_counts"] == {"all_gather_into_tensor": 1}, got


FAMILY_PROBE = textwrap.dedent("""
    import json
    import numpy as np
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.dist.sharding import is_dtensor
    from repro_torch.launch.mesh import placeholder_world
    from repro_torch.plan import MeshSpec, build_plan

    FAMILIES = ("yi-6b", "zamba2-2.7b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
                "seamless-m4t-large-v2", "llama-3.2-vision-90b")
    placeholder_world(8, 0)
    out = {}
    for arch in FAMILIES:
        for stages in (1, 2):
            plan = build_plan(reduced_config(arch), mode="megatron",
                              mesh_spec=MeshSpec.debug(2, 4),
                              pipeline_stages=stages, device="cpu")
            model = plan.init_params(0)
            cfg = plan.cfg
            batch = {"tokens": torch.ones((4, 8 if cfg.family == "encdec"
                                           else 16), dtype=torch.int32)}
            batch["labels"] = batch["tokens"].clone()
            if cfg.family == "encdec":
                batch["frames"] = torch.zeros((4, 16, cfg.d_model))
            if cfg.family == "vlm":
                batch["vision"] = torch.zeros((4, cfg.n_image_tokens,
                                               cfg.d_model))
            params = list(model.parameters())
            for p in params:
                p.requires_grad_(True)
            with plan.activate():
                model.loss(batch).backward()
            out[f"{arch}|{stages}"] = sum(
                is_dtensor(p.grad) and tuple(p.grad.shape) == tuple(p.shape)
                for p in params) == len(params)
    print(json.dumps(out))
""")


def test_every_family_loss_runs_staged_on_a_mesh():
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", FAMILY_PROBE],
                          capture_output=True, text=True, timeout=TIMEOUT_S,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-10000:]
    import json

    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(got) == 12 and all(got.values()), got


@pytest.mark.parametrize("module", ["repro_torch.launch.serve",
                                    "repro_torch.launch.train",
                                    "repro_torch.plan"])
def test_product_entry_points_never_import_torch_testing(module):
    # ``import torch`` itself loads a few ``torch.testing`` modules: the
    # entry point must load no other (the fake process group among them)
    probe = textwrap.dedent(f"""
        import runpy, sys
        import torch

        def testing():
            return {{m for m in sys.modules
                    if m == "torch.testing" or m.startswith("torch.testing.")}}

        base = testing()
        sys.argv = ["{module}", "--help"]
        try:
            runpy.run_module("{module}", run_name="__main__")
        except SystemExit:
            pass
        print("TESTING", sorted(testing() - base))
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=TIMEOUT_S, env=env)
    assert proc.returncode == 0, proc.stderr[-5000:]
    assert "TESTING []" in proc.stdout, proc.stdout[-2000:]
    path = ROOT / "src" / (module.replace(".", "/") + (
        "/__main__.py" if module == "repro_torch.plan" else ".py"))
    source = path.read_text()
    assert "placeholder_world" not in source and "fake_pg" not in source
