"""The port's trainer running sharded on 8 gloo ranks (a 2x4 ("data",
"model") mesh), against the port's trainer unsharded and, for the
collective error feedback, the JAX reference's ``shard_map`` (the
counterparts of ``tests/test_train_fault.py``'s restart and elastic
restore and ``tests/test_distributed.py::test_int8_compressed_psum_shard_map``).

One spawn of ``tests/_torch_dist_run.py`` (``train``), in a subprocess
with a hard timeout, on the reduced yi-6b (``vocab=64, n_layers=2,
d_model=64, n_heads=8, n_kv=4``) in fp32 with the reference's own
weights (its ``init_params(PRNGKey(0))``, through the bridge), batches
of 8 x 16 tokens of the synthetic stream (seed 7):

* adamw for 3 steps in each mode, adafactor and int8 compression
  (``compress_grads``) for 2 steps under megatron: the sharded
  ``Trainer``'s losses and final parameters within 1e-4 of the unsharded
  ``Trainer`` on every rank, every parameter a DTensor and the optimizer
  state placed (some of it sharded);
* a sharded run crashed at step 2 of 4 and resumed on the mesh by a new
  trainer, ``torch.equal`` to the straight run;
* ``restore_elastic`` of that checkpoint onto a 4x2 mesh: every leaf a
  DTensor at the placements the 4x2 plan gives, its whole value the saved
  array bit for bit;
* the collective ``error_feedback_reduce`` of the reference's [8, 32]
  input (``jax.random.normal(PRNGKey(1))``) over "data": each rank's
  block equal to the ``shard_map`` outputs of one JAX subprocess with 8
  host devices (rtol 1e-6), and within the reference's own 0.05 of the
  mean over the data blocks.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
REDUCE_RTOL = 1e-6
REDUCE_ATOL = 0.05          # the reference test's own bound on the mean

sys.path.insert(0, str(ROOT / "tests"))
import _torch_dist_run as spawn  # noqa: E402

JAX_REDUCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from functools import partial
    import jax, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.optim.compression import error_feedback_reduce

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    g = jax.numpy.asarray(np.load(sys.argv[1])["g"])

    @partial(shard_map, mesh=mesh,
             in_specs=(P("data", None), P("data", None)),
             out_specs=(P("data", None), P("data", None)))
    def reduce_fn(g, r):
        return error_feedback_reduce(g, r, axis_name="data")

    reduced, res = reduce_fn(g, jax.numpy.zeros_like(g))
    np.savez(sys.argv[2], reduced=np.asarray(reduced),
             residual=np.asarray(res))
""")


def reference_inputs(tmp_path):
    """The reference's weights of the reduced yi-6b (fp32 npz, flat keys)
    and its [8, 32] reduce input."""
    from repro.configs import reduced_config
    from repro.dist.sharding import init_params
    from repro.models import build_model

    from repro_torch.bridge import _flatten

    cfg = reduced_config("yi_6b").with_(**spawn.YI_MODEL)
    params = init_params(jax.random.PRNGKey(0),
                         build_model(cfg).param_specs())
    weights = tmp_path / "weights.npz"
    np.savez(weights, **{k: np.asarray(v, np.float32) for k, v in _flatten(
        jax.tree.map(np.asarray, params)).items()})
    g_file = tmp_path / "g.npz"
    np.savez(g_file, g=np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                    (8, 32)), np.float32))
    return weights, g_file


def test_sharded_training_on_8_ranks(tmp_path):
    weights, g_file = reference_inputs(tmp_path)
    ref_file = tmp_path / "jax_reduce.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_REDUCE, str(g_file), str(ref_file)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        got = spawn.run("train", tmp_path, weights, g_file)
        _, err = jax_proc.communicate(timeout=spawn.SPAWN_TIMEOUT_S)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-5000:]

    for name, (mode, opt, steps, compress) in spawn.TRAIN_RUNS.items():
        rec = got[name]
        ctx = (name, rec)
        assert len(rec["losses"]) == len(rec["plain_losses"]) == steps, ctx
        assert np.allclose(rec["losses"], rec["plain_losses"], rtol=0,
                           atol=TOL), ctx
        assert rec["param_err"] < TOL, ctx
        assert rec["dtensor_params"] > 0 and rec["dtensor_state"], ctx
        assert rec["sharded_state"] > 0, ctx

    restart = got["restart"]
    assert restart["fired"] and restart["equal"], restart
    assert restart["resumed_steps"] == (spawn.RESTART["steps"]
                                        - spawn.RESTART["fail_at"]), restart

    elastic = got["elastic"]
    assert elastic["mesh"] == list(spawn.ELASTIC_MESH), elastic
    for key in ("keys_equal", "all_dtensor", "placed_as_given", "bit_equal"):
        assert elastic[key], (key, elastic)
    assert elastic["sharded_leaves"] > 0, elastic

    g = np.load(g_file)["g"]
    with np.load(ref_file) as z:
        want_reduced, want_res = z["reduced"], z["residual"]
    rows = g.shape[0] // spawn.MESH[0]
    mean = g.reshape(spawn.MESH[0], rows, -1).mean(0)
    for rank in range(spawn.WORLD):
        d = rank // spawn.MESH[1]
        block = slice(d * rows, (d + 1) * rows)
        with np.load(tmp_path / "out" / f"reduce_{rank}.npz") as z:
            np.testing.assert_allclose(z["reduced"], want_reduced[block],
                                       rtol=REDUCE_RTOL, atol=0)
            np.testing.assert_allclose(z["residual"], want_res[block],
                                       rtol=REDUCE_RTOL, atol=0)
            assert np.allclose(z["reduced"], mean, atol=REDUCE_ATOL), rank
