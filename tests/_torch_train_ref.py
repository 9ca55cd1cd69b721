"""Shared checks of the port's training tests against the JAX package
(``tests/test_torch_loss.py`` for the decoder LMs,
``tests/test_torch_loss_families.py`` for the other families).

Weights: a port model of the arch's reduced config from ``init_params(0)``
(the reference's initialisers), given to both packages through the
bridge's reverse map (``params_to_arrays``: the reference's stacked tree),
with the vision LM's gates drawn in [0.5, 1] and the encoder-decoder's
biases drawn (zero at init, they would hide the cross-attention's
gradient), all rounded to bf16 so that the fp32 and bf16 trees hold the
same values. A batch is 2 x 64 tokens of the synthetic stream (the
encoder-decoder: 64 frames and 32 decoder tokens; the vision LM: 8 patch
embeddings); 64 tokens over ``q_chunk`` 32 run the chunked, checkpointed
attention. Gradients are mapped back to the reference's stacked leaves
through ``bridge.leaf_groups``.

Tolerances:

* fp32 copies of both trees: the loss within rtol 1e-5, every leaf's
  gradient within 1e-4 of the reference's norm (``|port - ref| <= 1e-4
  |ref|``, Frobenius); 2.1e-5 is the worst measured (zamba2's ``D``).
* bf16 trees: the loss within rtol 5e-3 (the MoE's routing flips under
  bf16 rounding move phi3.5-moe's by 2.3e-3); every leaf's gradient within
  ``max(0.05 |ref|, 3 |ref_bf16 - ref_fp32|)``: no further from the
  reference's bf16 gradient than three times that is from the
  reference's own fp32 one. XLA keeps excess precision inside its fusions
  on the CPU, so the two packages round bf16 at other places; in leaves
  whose gradient is a sum with heavy cancellation (RWKV's bonus ``u``,
  zamba2's ``D``, the MoE router) that moves the result by up to half its
  norm in both, and MoE routing flips move the phi3.5-moe norms by 5%.
* remat: every gradient ``torch.equal`` with and without checkpointing.
* 10 adamw steps (lr 3e-3, fp32) on the synthetic stream: the loss curves
  within rtol 5e-5, the MoE family 5e-3 and the recurrent families (RWKV,
  the hybrid) 1e-2: routing turns fp32 rounding into expert flips as the
  weights move (5.6e-4 measured on kimi), and the random zamba2 stack is
  chaotic (2.8e-3 measured, 3.4e-4 for RWKV; at most 1e-6 elsewhere).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.optim.optimizers import adamw as jax_adamw
from repro_torch.bridge import _flatten, leaf_groups, load_arrays
from repro_torch.bridge import params_to_arrays
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticTokens
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import stacked
from repro_torch.train.trainer import model_loss, train_step, value_and_grad

B, S = 2, 64
# loss-curve tolerance by family (5e-5 for the dense and cross-attention
# families)
CURVE_RTOL = {"ssm": 1e-2, "hybrid": 1e-2, "moe": 5e-3}


def batch_of(cfg, step=0):
    """The synthetic stream's batch ``step`` (numpy), with the family's
    extra inputs drawn from a seed."""
    b = SyntheticTokens(cfg.vocab, S, B, seed=3).batch(step)
    rng = np.random.default_rng(5 + step)
    if cfg.family == "encdec":
        b = {"tokens": b["tokens"][:, :32], "labels": b["labels"][:, :32],
             "frames": rng.standard_normal((B, S, cfg.d_model))}
    if cfg.family == "vlm":
        b["vision"] = rng.standard_normal((B, cfg.n_image_tokens,
                                           cfg.d_model))
    return {k: v.astype(np.float32) if v.dtype.kind == "f" else v
            for k, v in b.items()}


def _bf16_values(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().float(
    ).numpy()


@functools.lru_cache(maxsize=None)
def arrays(arch):
    """The reference-layout tree (numpy fp32 holding bf16 values)."""
    cfg = reduced_config(arch)
    tree = params_to_arrays(build_model(cfg, device="cpu").init_params(0))
    rng = np.random.default_rng(23)

    def draw(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = draw(v)
            elif cfg.family == "vlm" and k == "gate":
                out[k] = _bf16_values(rng.uniform(0.5, 1.0, v.shape))
            elif cfg.family == "encdec" and k in ("b", "bias"):
                out[k] = _bf16_values(rng.standard_normal(v.shape) * 0.5)
            else:
                out[k] = v
        return out

    return draw(tree)


def _dtypes(fp32):
    return ((jnp.float32, torch.float32) if fp32
            else (jnp.bfloat16, torch.bfloat16))


def jax_tree(arch, fp32):
    return jax.tree.map(lambda a: jnp.asarray(a, _dtypes(fp32)[0]),
                        arrays(arch))


def jax_batch(b, fp32):
    return {k: jnp.asarray(v, _dtypes(fp32)[0]) if v.dtype == np.float32
            else jnp.asarray(v) for k, v in b.items()}


def torch_batch(b, fp32):
    return {k: torch.from_numpy(v).to(_dtypes(fp32)[1])
            if v.dtype == np.float32 else torch.from_numpy(v)
            for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(arch):
    return jax.jit(jax.value_and_grad(
        jax_build_model(jax_reduced_config(arch)).loss))


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, fp32):
    """The reference's loss and gradients (numpy fp32, "."-joined leaf
    paths) on batch 0."""
    loss, grads = jax_value_and_grad(arch)(
        jax_tree(arch, fp32), jax_batch(batch_of(reduced_config(arch)), fp32))
    return float(loss), _flatten(jax.tree.map(
        lambda a: np.asarray(a, np.float32), grads))


def port_model(arch, fp32, **overrides):
    cfg = reduced_config(arch).with_(**overrides)
    model = build_model(cfg, device="cpu", dtype=_dtypes(fp32)[1])
    return load_arrays(model, arrays(arch))


def port_loss_and_grads(arch, fp32, **overrides):
    model = port_model(arch, fp32, **overrides)
    loss, grads = value_and_grad(model_loss, model,
                                 torch_batch(batch_of(model.cfg), fp32))
    return model, float(loss), grads


def check_fp32_grads(arch):
    model, loss, grads = port_loss_and_grads(arch, True)
    ref_loss, ref = jax_loss_and_grads(arch, True)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    groups = leaf_groups(model)
    assert sorted(g.name for g in groups) == sorted(ref)
    for grp in groups:
        got, want = stacked(grads, grp).numpy(), ref[grp.name]
        err = np.linalg.norm(got - want)
        assert err <= 1e-4 * np.linalg.norm(want), (grp.name, err)


def check_bf16_grads(arch):
    model, loss, grads = port_loss_and_grads(arch, False)
    ref_loss, ref = jax_loss_and_grads(arch, False)
    _, ref32 = jax_loss_and_grads(arch, True)
    np.testing.assert_allclose(loss, ref_loss, rtol=5e-3)
    for grp in leaf_groups(model):
        assert grads[grp.members[0]].dtype == torch.bfloat16, grp.name
        got, want = stacked(grads, grp).numpy(), ref[grp.name]
        noise = np.linalg.norm(want - ref32[grp.name])
        err = np.linalg.norm(got - want)
        assert err <= max(0.05 * np.linalg.norm(want), 3 * noise), (
            grp.name, err, noise)


def check_remat(arch):
    """Checkpointing recomputes the same operations: every gradient is
    bit-equal with and without ``cfg.remat``."""
    _, loss, grads = port_loss_and_grads(arch, False, remat=False)
    _, loss_r, grads_r = port_loss_and_grads(arch, False, remat=True)
    assert loss == loss_r
    for name, g in grads.items():
        assert torch.equal(g, grads_r[name]), name


def check_adamw_curve(arch):
    cfg = reduced_config(arch)
    vg = jax_value_and_grad(arch)
    opt = jax_adamw(lr=3e-3)
    params = jax_tree(arch, True)
    state = opt.init(params)

    @jax.jit
    def apply(params, grads, state):
        upd, state, _ = opt.update(grads, state, params)
        return jax.tree.map(lambda p, u: p + u, params, upd), state

    ref = []
    for i in range(10):
        loss, grads = vg(params, jax_batch(batch_of(cfg, i), True))
        params, state = apply(params, grads, state)
        ref.append(float(loss))

    model = port_model(arch, True)
    topt = adamw(lr=3e-3)
    groups = leaf_groups(model)
    tstate = topt.init(dict(model.named_parameters()), groups)
    got = [float(train_step(model, topt, tstate,
                            torch_batch(batch_of(cfg, i), True),
                            groups=groups)["loss"]) for i in range(10)]
    np.testing.assert_allclose(got, ref,
                               rtol=CURVE_RTOL.get(cfg.family, 5e-5))
    assert got[-1] < got[0]
