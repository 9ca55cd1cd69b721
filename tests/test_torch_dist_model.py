"""The port's models running sharded on 8 gloo ranks, against the port
unsharded and the JAX reference (the counterparts of
``tests/test_distributed.py::test_sharded_train_step_matches_single_device``
and ``::test_sharded_moe_and_decode``).

One spawn of ``tests/_torch_dist_run.py`` (``model``), in a subprocess
with a hard timeout: the reduced yi-6b with the reference's overrides in
cascade, megatron and megatron_sp, on the reference's own weights (its
``init_params(PRNGKey(0))``, carried through the bridge): the sharded
bf16 loss within 1e-2 of the port's unsharded loss and of the JAX
``model.loss`` (computed here, once), the first leaf's gradient within
1e-2; the reduced phi3.5-moe under megatron: the loss as for yi-6b, and
one ``decode_step`` over a placed ``fresh_decode_state(8, 16)`` at
position 3: [8, vocab] and finite in bf16 (the reference's check), the
same greedy tokens where the unsharded top-2 gap exceeds 0.1, and within
1e-2 of the unsharded step on an fp32 copy (a bf16 step moves by a few
bf16 steps under the sharded reduction order: 0.03 here). A two-stage
plan on the same mesh still refuses to place its parameters
(``NotImplementedError`` naming part 2c) and leaves them plain.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-2

sys.path.insert(0, str(ROOT / "tests"))
import _torch_dist_run as spawn  # noqa: E402


def jax_weights_and_losses(weights_dir):
    """Write each model run's reference weights (fp32 npz, flat keys) and
    return the JAX loss of each on the spawn's batch."""
    from repro.configs import reduced_config
    from repro.dist.sharding import init_params
    from repro.models import build_model

    from repro_torch.bridge import _flatten

    losses = {}
    for name, (arch, overrides, mode) in spawn.model_cfgs().items():
        cfg = reduced_config(arch).with_(**overrides, sharding_mode=mode)
        model = build_model(cfg)
        params = init_params(jax.random.PRNGKey(0), model.param_specs())
        flat = {k: np.asarray(v, np.float32)
                for k, v in _flatten(jax.tree.map(np.asarray,
                                                  params)).items()}
        np.savez(spawn.weights_path(weights_dir, name), **flat)
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in spawn.loss_batch(cfg.vocab).items()}
        losses[name] = float(model.loss(params, batch))
    return losses


def test_sharded_loss_grad_and_moe_decode_on_8_ranks(tmp_path):
    weights = tmp_path / "weights"
    weights.mkdir()
    want = jax_weights_and_losses(weights)
    got = spawn.run("model", tmp_path, weights)
    staged = got.pop("staged")
    assert "part 2c" in staged["error"], staged
    assert staged["plain"] and not staged["sharded"], staged
    assert set(got) == set(want)
    for name, rec in got.items():
        ctx = (name, rec)
        assert rec["dtensor_params"] > 0, ctx
        assert abs(rec["sharded_loss"] - rec["plain_loss"]) < LOSS_TOL, ctx
        assert abs(rec["sharded_loss"] - want[name]) < LOSS_TOL, ctx
        assert abs(rec["plain_loss"] - want[name]) < LOSS_TOL, ctx
        if name.startswith("yi-"):
            assert rec["first_leaf"] == "blocks.attn.wk.w", ctx
            assert rec["first_grad_err"] < LOSS_TOL, ctx
    moe = got["moe-megatron"]
    assert moe["decode_shape"] == [[8, 64], [8, 64]]
    assert moe["decode_finite"]
    bf16_err, fp32_err = moe["decode_err"]
    assert fp32_err < LOSS_TOL, moe
    # bf16: the reference's own check (finite [8, vocab]) and the greedy
    # tokens, where the unsharded step's top-2 gap clears bf16 noise
    if moe["decode_gap"] > 0.1:
        assert moe["decode_tokens_equal"], moe
    # the KV cache lies batch-sharded on the data axis (2 kv heads do not
    # divide the model axis of 4, so its heads replicate)
    assert moe["state_placements"]["cache_k"] == \
        "(Shard(dim=1), Replicate())", moe
