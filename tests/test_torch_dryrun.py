"""The production dry run (``repro_torch.launch.dryrun``) against the
reference's figures, and the kernel wrappers on the ``meta`` device.

Each cell runs the CLI in a subprocess of its own (rank 0 of a fake
process group of 256, every tensor on meta), with ``--out`` JSON:

* yi-6b ``decode_32k`` on 16x16 under megatron, with one stage and with
  two: ``params_total``/``params_active`` and ``model_flops_global``
  equal the reference's ``param_counts``/``model_flops``; the per-device
  parameter bytes equal the sum over leaves of one rank's shard under the
  reference plan's PartitionSpecs (its rules, ``layers -> data`` on two
  stages), and so do the bytes of the layer stacks alone; the staged
  cell's ``stage_slices`` equal the reference's PlaceStages. (Under
  megatron the one-stage plan already splits every stacked weight over
  ``data``, by its ``fsdp`` dim; two stages move ``data`` to the layer
  dim, so a rank's stacked weights keep their size and only the norm
  scales, whole on every rank of one stage, shrink 16 times.) The
  sharded step joins collectives, so its ``collective_s`` is not 0; the
  process's peak memory stays far below the state a decode cell
  describes (17 GB of KV cache per device).
* yi-6b ``train_4k`` on 16x16 ends "1 ok, 0 skipped, 0 errors".
* yi-6b ``long_500k`` is skipped with the reference's reason.
* ``--hlo-dir`` exits 2.

The wrappers on meta report exactly their ``ops.work`` to the step
analysis, launch nothing and return an empty output of the right shape
and dtype; on a device that is neither the CPU nor the card they raise.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import json
import math
import os
import resource
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.model_flops import model_flops as jax_model_flops
from repro.launch.model_flops import param_counts as jax_param_counts
from repro.models.base import SHAPES as JAX_SHAPES
from repro.models.base import build_model as jax_build_model
from repro.models.base import supports_shape as jax_supports_shape
from repro.plan import MeshSpec as JaxMeshSpec
from repro.plan import build_plan as jax_build_plan
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.qmatmul import ops as qmatmul_ops
from repro_torch.launch import dryrun
from repro_torch.launch.step_analysis import analyze_step

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
RSS_LIMIT_KB = 4 * 1024 * 1024          # 4 GiB


class DuckMesh:
    """What the reference's plan reads of a mesh: axis names and a
    devices array."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.arange(math.prod(shape)).reshape(shape)


def run_cli(tmp_path, *args):
    """``python -m repro_torch.launch.dryrun ... --out`` in a subprocess:
    ``(stdout, records)``; fails on a non-zero exit."""
    out = tmp_path / "dry.json"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
         "--out", str(out)], capture_output=True, text=True,
        timeout=TIMEOUT_S, env=env, cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-5000:], proc.stderr[-10000:])
    return proc.stdout, json.loads(out.read_text())


def reference_bytes(arch, shape, mode, stages):
    """One rank's bytes of every parameter leaf, and of the stacked ones,
    under the reference plan's PartitionSpecs on 16x16; its plan."""
    import jax

    from repro.dist.sharding import ParamSpec

    cfg = jax_get_config(arch)
    plan = jax_build_plan(cfg, shape, mode=mode, pipeline_stages=stages,
                          mesh_spec=JaxMeshSpec.from_mesh(
                              DuckMesh((16, 16), ("data", "model"))))
    sizes = {"data": 16, "model": 16}
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        jax_build_model(plan.cfg).param_specs(),
        is_leaf=lambda x: isinstance(x, ParamSpec))
    total = stacked = 0
    for path, spec in leaves:
        pspec = plan.ir.param_pspecs[jax.tree_util.keystr(path)]
        n = math.prod(spec.shape)
        for entry in eval(pspec, {"PartitionSpec": lambda *e: e}):
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= sizes[ax]
        b = n * np.dtype(spec.dtype).itemsize
        total += b
        stacked += b if spec.logical[0] == "layers" else 0
    return total, stacked, plan


def test_decode_cells_hold_the_reference_figures(tmp_path):
    arch, shape = "yi-6b", "decode_32k"
    cells = {}
    for stages in (1, 2):
        (tmp_path / str(stages)).mkdir()
        out, records = run_cli(tmp_path / str(stages), "--arch", arch,
                               "--shape", shape, "--single-pod", "--mode",
                               "megatron", "--stages", str(stages))
        assert "dry-run: 1 ok, 0 skipped, 0 errors / 1 cells" in out, out
        assert resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss \
            < RSS_LIMIT_KB
        (rec,) = records
        cells[stages] = rec
        cfg = jax_get_config(arch)
        assert rec["status"] == "ok" and rec["mesh"] == "16x16", rec
        assert (rec["params_total"], rec["params_active"]) == \
            jax_param_counts(cfg)
        assert rec["roofline"]["model_flops_global"] == \
            jax_model_flops(cfg, JAX_SHAPES[shape])
        total, stacked, plan = reference_bytes(arch, shape, "megatron",
                                               stages)
        mem = rec["memory"]
        assert mem["param_bytes"] == total, (stages, mem, total)
        assert mem["stacked_param_bytes"] == stacked, (stages, mem, stacked)
        assert mem["state_bytes"] > 0 and mem["temp_bytes"] is None
        assert rec["roofline"]["collective_s"] > 0, rec["roofline"]
        assert rec["roofline"]["kernel_calls"] == {}, rec["roofline"]
        assert rec["xla_cost_analysis"] is None and rec["trace_s"] > 0
        if stages == 2:
            assert rec["stage_slices"] == [s.as_dict()
                                           for s in plan.ir.stages]
        else:
            assert "stage_slices" not in rec
    one, two = (cells[s]["memory"]["stacked_param_bytes"] for s in (1, 2))
    assert two < one, (one, two)


def test_train_cell_ends_ok(tmp_path):
    out, (rec,) = run_cli(tmp_path, "--arch", "yi-6b", "--shape",
                          "train_4k", "--single-pod")
    assert "dry-run: 1 ok, 0 skipped, 0 errors / 1 cells" in out, out
    assert rec["memory"]["opt_bytes"] > 0
    assert rec["roofline"]["hlo_flops_per_chip"] > 0


def test_long_context_full_attention_cell_is_skipped(tmp_path):
    out, (rec,) = run_cli(tmp_path, "--arch", "yi-6b", "--shape",
                          "long_500k", "--single-pod")
    assert "dry-run: 0 ok, 1 skipped, 0 errors / 1 cells" in out, out
    ok, reason = jax_supports_shape(jax_get_config("yi-6b"), "long_500k")
    assert not ok and rec["status"] == "skipped"
    assert rec["reason"] == reason


def test_hlo_dir_has_no_counterpart(tmp_path, capsys):
    assert dryrun.main(["--arch", "yi-6b", "--shape", "train_4k",
                        "--hlo-dir", str(tmp_path)]) == 2
    assert "no HLO" in capsys.readouterr().out


def test_flash_on_meta_reports_its_work_and_launches_nothing():
    q = torch.empty(64, 256, 128, dtype=torch.bfloat16, device="meta")
    before = flash_ops.launches
    out, stats = analyze_step(flash_ops.flash_attention, q, q, q)
    assert flash_ops.launches == before
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype
    work = flash_ops.work(64, 256, 256, 128, torch.bfloat16, True)
    assert stats.kernel_launches == {"flash_attention": 1}
    assert stats.flops == work.ops and stats.bytes == work.bytes
    assert stats.flops_by_dtype == {work.dtype: work.ops}


def test_qmatmul_on_meta_reports_its_work_and_launches_nothing():
    x = torch.empty(8, 4096, dtype=torch.int16, device="meta")
    w = torch.empty(4096, 11008, dtype=torch.int8, device="meta")
    b = torch.empty(11008, dtype=torch.int32, device="meta")
    before = qmatmul_ops.launches
    out, stats = analyze_step(
        lambda: qmatmul_ops.qlinear(x, w, b, shift=9, out_dtype="int16"))
    assert qmatmul_ops.launches == before
    assert out.device.type == "meta" and tuple(out.shape) == (8, 11008) \
        and out.dtype == torch.int16
    work = qmatmul_ops.work(8, 4096, 11008, torch.int16, torch.int8,
                            "int16", True)
    assert stats.kernel_launches == {"qmatmul": 1}
    assert stats.flops == work.ops and stats.bytes == work.bytes


@pytest.mark.parametrize("kernel", ["flash", "qmatmul"])
def test_wrappers_raise_on_another_device(kernel):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        if kernel == "flash":
            q = torch.empty(8, 64, 64, dtype=torch.bfloat16, device="xpu")
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                flash_ops.flash_attention(q, q, q)
        else:
            x = torch.empty(8, 64, dtype=torch.int8, device="xpu")
            w = torch.empty(64, 32, dtype=torch.int8, device="xpu")
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                qmatmul_ops.qlinear(x, w, shift=4)
