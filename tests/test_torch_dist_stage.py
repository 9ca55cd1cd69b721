"""A two-stage plan on 8 gloo ranks against the one-stage plan and the JAX
reference (the counterparts of ``tests/test_plan.py``'s
``test_two_stage_plan_matches_unpipelined_loss_8dev`` and
``test_two_stage_decode_state_shards_8dev``).

One spawn of ``tests/_torch_dist_stage.py`` in a subprocess with a hard
timeout of its own (150 s), on the reference's weights of the reduced
yi-6b (``vocab=64``, 4 layers; its ``init_params(PRNGKey(0))``, carried
through the bridge):

* the staged plan's train loss within 1e-3 of the one-stage plan's and
  within 1e-2 of the JAX unsharded loss (computed here); the stage axis,
  the rule, the placement method, the stage tuples and the cache keys'
  ``stages`` as the reference's test asserts them; each data row holding
  only its band (the parameter bytes of a rank);
* the staged decode state's ``cache_k`` ``Shard(0)`` on ``data``, and the
  staged batcher's 4 x 4 tokens equal to the one-stage (unsharded)
  port's up to the gap rule of ``tests/_torch_serve_ref.py``;
* in fp32 on the train spawn's 2-layer model (``YI_MODEL``, the
  reference's weights): every staged gradient within 1e-4 of the
  unsharded one; one staged adamw step within 1e-4 of the unsharded
  trainer, and its checkpoint restored by ``restore_elastic`` onto a
  one-stage 4x2 mesh and onto the staged 2x4 plan, each within 1e-4 of
  the unsharded trainer. (adamw's first step is ``lr * g / (|g| + eps)``:
  on the 4-layer vocab-64 model a gradient near ``eps`` moves one
  ``ffn.down`` weight 1.19e-4 from the unsharded trainer under the
  one-stage sharded plan too; ROADMAP port note 14.)
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import _torch_dist_stage as stage  # noqa: E402
from _torch_serve_ref import assert_streams  # noqa: E402

STAGE_TOL = 1e-3
REF_TOL = 1e-2
TRAIN_TOL = 1e-4


def jax_weights_and_loss(path, overrides):
    """Write the reference's weights (fp32 npz, flat keys) of the reduced
    yi-6b with ``overrides`` and return its unsharded loss on ones
    [8, 16]."""
    from repro.configs import reduced_config
    from repro.dist.sharding import init_params
    from repro.models import build_model

    from repro_torch.bridge import _flatten

    cfg = reduced_config(stage.ARCH).with_(**overrides)
    model = build_model(cfg)
    params = init_params(jax.random.PRNGKey(0), model.param_specs())
    flat = {k: np.asarray(v, np.float32)
            for k, v in _flatten(jax.tree.map(np.asarray, params)).items()}
    np.savez(path, **flat)
    ones = jnp.ones((8, 16), jnp.int32)
    return float(model.loss(params, {"tokens": ones, "labels": ones}))


def test_two_stage_plan_on_8_ranks(tmp_path):
    weights = tmp_path / "weights.npz"
    train_weights = tmp_path / "train_weights.npz"
    ref = jax_weights_and_loss(weights, stage.OVERRIDES)
    jax_weights_and_loss(train_weights, stage.YI_MODEL)
    rec = stage.run(tmp_path, weights, train_weights)
    one, two = rec["losses"]
    assert abs(one - two) < STAGE_TOL, rec["losses"]
    assert abs(two - ref) < REF_TOL, (rec["losses"], ref)
    assert rec["stage_axis"] == "data"
    assert rec["layers_rule"] == "data"
    assert rec["placement_method"] == "bnb"
    assert rec["stages"] == [[0, 2, 0, 1], [2, 2, 1, 1]]
    assert rec["wq_pspec"].startswith("PartitionSpec('data'"), rec
    assert not rec["wq_pspec_1"].startswith("PartitionSpec('data'"), rec
    assert rec["cache_stages"] == [1, 2]
    # a rank holds its band: the norm scales, replicated over data on one
    # stage, are split by the layer dim on two
    assert rec["param_bytes_2"] < rec["param_bytes_1"], rec
    assert rec["opt_bytes_2"] < rec["opt_bytes_1"], rec

    # the KV cache's layer dim rides the stage slices: [4, 8, 32, KV, hd]
    # with its layers on data (2 of 4 per row) and its batch whole
    for key in ("cache_k", "cache_v"):
        assert rec["state_placements"][key].startswith(
            "(Shard(dim=0), "), rec["state_placements"]
        assert rec["state_local"][key][:3] == [2, 8, 32], rec["state_local"]
    compared = assert_streams(rec["two_stage"], rec["one_stage"],
                              rec["gaps"], sorted(rec["one_stage"]))
    assert compared > 0
    assert all(len(v) == 4 for v in rec["two_stage"].values())

    assert rec["grad_err"] < TRAIN_TOL, rec["grad_err"]
    train = rec["train"]
    assert train["param_err"] < TRAIN_TOL, train
    assert np.allclose(train["losses"], train["plain_losses"],
                       atol=TRAIN_TOL), train
    assert train["staged_state"] > 0, train
    for name, mesh, staged in (("one_stage_4x2", [4, 2], False),
                               ("staged_2x4", [2, 4], True)):
        got = rec[name]
        assert got["mesh"] == mesh, got
        assert got["all_dtensor"], got
        assert (got["staged_leaves"] > 0) == staged, got
        assert got["param_err"] < TRAIN_TOL, got
