"""The port's decode and serving paths running sharded on 8 gloo ranks,
against the port unsharded (the counterpart of
``tests/test_distributed.py::test_serve_batcher_on_sharded_mesh``, and
every family's forward and decode steps).

Two spawns of ``tests/_torch_dist_run.py``, each in a subprocess with a
hard timeout (``file://`` rendezvous, one thread per rank):

* ``family``: every family in fp32 under megatron, each reduced config
  cut to one block of its kind: ``forward`` and four ``decode_step``s
  dense and paged over a placed state within 1e-4 of the unsharded port
  (a sequence-sharded KV cache, megatron_sp's, runs in the ``serve``
  spawn and on the 1x1 mesh of ``tests/test_torch_dist.py``). bf16
  stacks move under any change of reduction order (a sharded bf16 step
  moves by a few bf16 steps), so the tight check runs in fp32.
* ``serve``: the reduced yi-6b (``vocab=64, n_layers=2``) under
  megatron_sp through ``plan.make_batcher()`` with ``Bucket(64, 4)``: two
  fifo waves of four requests, five tokens each, then one continuous
  paged wave (k = 4). Every stream has five tokens, wave 2's equal wave
  1's, the plan cache builds nothing after wave 1, the states it
  released are placed (the page pool's page axes replicated), and the
  streams equal the unsharded port's up to the first step whose top-2 gap
  is below 0.02 (``tests/_torch_serve_ref.py``'s rule).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FP32_TOL = 1e-4
MIN_GAP = 0.02

sys.path.insert(0, str(ROOT / "tests"))
import _torch_dist_run as spawn  # noqa: E402


def test_every_family_fp32_forward_and_decode_on_8_ranks(tmp_path):
    got = spawn.run("family", tmp_path)
    assert set(got) == set(spawn.FAMILIES)
    for run, rec in got.items():
        ctx = (run, rec)
        assert rec["forward_err"] < FP32_TOL, ctx
        for layout in ("dense", "paged"):
            assert rec[f"{layout}_placed"], ctx
            assert rec[f"{layout}_err"] < FP32_TOL, ctx


def _held(stream, want, gaps):
    """``stream`` equals ``want`` up to the first gap below MIN_GAP."""
    n = next((i for i, g in enumerate(gaps) if g < MIN_GAP), len(want))
    return list(stream[:n]) == list(want[:n])


def test_serve_batcher_on_sharded_8_ranks(tmp_path):
    got = spawn.run("serve", tmp_path)
    fifo, cont = got["fifo"], got["continuous"]
    for run in (fifo, cont):
        assert set(run["sharded"]) == set(run["plain"]), run
        for rid, stream in run["sharded"].items():
            assert len(stream) == 5, (rid, run)
            assert _held(stream, run["plain"][rid], run["gaps"][rid]), (
                rid, run)
    for i in range(4):
        assert fifo["sharded"][f"w1r{i}"] == fifo["sharded"][f"w0r{i}"]
    warm, after = fifo["cache"]
    assert after["builds"] == warm["builds"]
    assert after["hits"] > warm["hits"]
    # the released states are DTensors: fifo's KV slabs batch-sharded on
    # the data axis and sequence-sharded on the model axis (megatron_sp);
    # the page pool replicated (its page axes replicate, and 2 kv heads do
    # not divide the model axis of 4)
    for key in ("cache_k", "cache_v"):
        assert fifo["placements"][key] == \
            "(Shard(dim=1), Shard(dim=2))", fifo
        assert cont["placements"][key] == "(Replicate(), Replicate())", cont
