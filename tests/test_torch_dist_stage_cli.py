"""The plan and train CLIs on 8 gloo ranks started by
``torch.distributed.run`` (the reference's staged CI run, and the train
CLI's ``--stages 2``): each rank joins the launcher's group from the
environment (``launch.mesh``) and builds the 2x4 debug mesh.

* The plan CLI's warm check, ``--arch yi-6b --debug --data 2 --model 4
  --warm --device cpu``, ends ``warm check: ... => OK`` on every rank with
  one stage and with two (the reference's CI job is the two-stage run).
  The one-stage run also holds a repaired port fault: the serving
  attention's einsum over a batch split on ``data`` and heads split on
  ``model`` failed in DTensor's view rules (``dist.sharding.local_einsum``).
* The train CLI's ``--stages 2`` on the same mesh trains 2 steps: every
  rank prints the sharded plan with its two stages and ``done: loss``.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CLI_TIMEOUT_S = 120
RANKS = 8


def launch(*args):
    """``python -m torch.distributed.run --standalone --nproc-per-node 8
    -m <args>`` with a hard timeout; fails with the output on a non-zero
    exit. Returns stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(RANKS), "-m", *args],
        capture_output=True, text=True, timeout=CLI_TIMEOUT_S, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, (proc.stdout[-5000:], proc.stderr[-15000:])
    return proc.stdout


@pytest.mark.parametrize("stages", [1, 2])
def test_plan_cli_warm_check_on_8_ranks(stages):
    # the ranks share one stdout, so lines may interleave: count matches
    out = launch("repro_torch.plan", "--arch", "yi-6b", "--debug",
                 "--data", "2", "--model", "4", "--stages", str(stages),
                 "--warm", "--device", "cpu")
    ends = re.findall(r"warm check: builds \d+ -> \d+, hits \d+ -> \d+ "
                      r"=> (OK|FAIL)", out)
    assert ends == ["OK"] * RANKS, out
    assert out.count("mesh=debug:2x4") == RANKS, out
    axes = re.findall(r"PlaceStages: \{'stages': (\d), 'stage_axis': "
                      r"('data'|None)", out)
    want = ("2", "'data'") if stages == 2 else ("1", "None")
    assert axes == [want] * RANKS, out


def test_train_cli_two_stages_on_8_ranks(tmp_path):
    out = launch("repro_torch.launch.train", "--arch", "yi-6b", "--debug",
                 "--data", "2", "--model", "4", "--stages", "2",
                 "--steps", "2", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path))
    assert out.count("mesh debug:2x4 {'data': 2, 'model': 4} (sharded) "
                     "mode=megatron stages=2") == RANKS, out
    assert out.count("stage_axis=data") == RANKS, out
    done = re.findall(r"done: loss (\S+) -> (\d+\.\d{4})", out)
    assert len(done) == RANKS and len(set(done)) == 1, out
    assert len(re.findall(r"step +\d+ loss", out)) == 2 * RANKS, out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002"]
