"""The port's optimizers and gradient compression against the JAX
package's, on the CPU.

The reference's optimizers run over its stacked parameter tree; the
port's over its per-layer tensors, grouped by ``bridge.LeafGroup`` into
the reference's leaves. Both optimizers' ``state_specs`` over every
ported id's parameter specs resolve, in every sharding mode, to the
reference's PartitionSpec strings. Here one tree of stacked leaves ([L, 8, 6]
weights, a [L, 6] norm scale, a [L] scalar per layer, an unstacked
embedding and bias) goes through both, with the same fp32 parameters and
gradients, for several steps: parameters and state within rtol 1e-6
(atol 1e-7 where an update cancels to near zero). The int8 compression is
bit-exact (``array_equal``) to the reference's.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist import sharding as jsh
from repro.models.base import build_model as jax_build_model
from repro.optim.compression import compress_int8 as jax_compress_int8
from repro.optim.compression import error_feedback_reduce as jax_efr
from repro.optim.optimizers import adafactor as jax_adafactor
from repro.optim.optimizers import adamw as jax_adamw
from repro_torch.bridge import LeafGroup
from repro_torch.configs import PORTED_IDS, get_config
from repro_torch.dist import sharding as tsh
from repro_torch.plan import build_plan
from repro_torch.plan.passes import param_specs
from repro_torch.optim import (
    adafactor,
    adamw,
    compress_int8,
    decompress_int8,
    error_feedback_reduce,
    make_optimizer,
)

L = 3
TOL = dict(rtol=1e-6, atol=1e-7)
STACKED = {"blocks": {"w": (L, 8, 6), "scale": (L, 6), "g": (L,)},
           "embed": (10, 6), "b": (6,)}


def _leaves(tree=STACKED, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _groups():
    """The port's view: block leaf ``blocks.w`` is held by ``blocks.<l>.w``
    for each layer l."""
    out = []
    for name, shape in _leaves():
        if name.startswith("blocks."):
            leaf = name.split(".", 1)[1]
            out.append(LeafGroup(name, tuple(f"blocks.{i}.{leaf}"
                                             for i in range(L)), (L,)))
        else:
            out.append(LeafGroup(name, (name,), ()))
    return out


def _draw(rng, scale=1.0, special=None):
    """One stacked tree of numpy fp32 arrays (``special`` may replace a
    leaf)."""
    flat = {name: (rng.standard_normal(shape) * scale).astype(np.float32)
            for name, shape in _leaves()}
    flat.update(special or {})
    return flat


def _nest(flat):
    out = {}
    for name, arr in flat.items():
        *heads, leaf = name.split(".")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(arr)
    return out


def _split(flat):
    """Stacked numpy leaves -> the port's per-layer tensors, by name."""
    out = {}
    for grp in _groups():
        arr = flat[grp.name]
        if grp.stack:
            for i, member in enumerate(grp.members):
                out[member] = torch.from_numpy(np.array(arr[i]))
        else:
            out[grp.name] = torch.from_numpy(arr.copy())
    return out


def _stack(params, grp):
    return np.stack([params[m].numpy() for m in grp.members]).reshape(
        grp.stack + tuple(params[grp.members[0]].shape))


def _flat_state(state, prefix=""):
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_flat_state(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _run_both(jopt, topt, steps=4, grads=None, seed=0):
    """Run both optimizers ``steps`` times on the same parameters and
    gradients; compare after every step."""
    rng = np.random.default_rng(seed)
    p0 = _draw(rng)
    jparams = _nest(p0)
    jstate = jopt.init(jparams)
    tparams = _split(p0)
    groups = _groups()
    tstate = topt.init(tparams, groups)
    for step in range(steps):
        g = grads(rng, step) if grads else _draw(rng, 0.3)
        upd, jstate, jnorm = jopt.update(_nest(g), jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        tnorm = topt.update(_split(g), tstate, tparams, groups)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
        jflat = {name: np.asarray(a) for name, a in
                 _flat_state(jax.tree.map(np.asarray, jparams)).items()}
        for grp in groups:
            np.testing.assert_allclose(_stack(tparams, grp), jflat[grp.name],
                                       **TOL, err_msg=grp.name)
        want = _flat_state(jax.tree.map(np.asarray, jstate))
        # the port keys its state per leaf by the "."-joined leaf path
        got = _flat_state(tstate)
        assert sorted(got) == sorted(want)
        for key, arr in want.items():
            np.testing.assert_allclose(np.asarray(got[key]), arr, **TOL,
                                       err_msg=key)
    return tparams, jparams


@pytest.mark.parametrize("make", [
    lambda m: m.adamw(lr=1e-2),
    lambda m: m.adamw(lr=3e-3, weight_decay=0.1, max_grad_norm=0.5),
    lambda m: m.adafactor(lr=1e-2),
    lambda m: m.adafactor(lr=1e-2, weight_decay=0.05, clip_threshold=0.5),
], ids=["adamw", "adamw-wd-clip", "adafactor", "adafactor-wd-clip"])
def test_optimizer_matches_reference_on_stacked_leaves(make):
    import repro.optim.optimizers as jmod
    import repro_torch.optim.optimizers as tmod

    _run_both(make(jmod), make(tmod))


def _one_layer_outlier(rng, step):
    """Gradients whose update RMS exceeds the clip threshold in layer 0
    only: a rank-1 square profile everywhere, broken in layer 0, where
    one entry dominates its row and its column."""
    g = _draw(rng, 0.3)
    w = np.abs(rng.standard_normal((L, 8, 1))) * np.abs(
        rng.standard_normal((L, 1, 6)))
    w[0] = 1e-3
    w[0, 0, 0] = 10.0
    g["blocks.w"] = w.astype(np.float32)
    return g


def test_adafactor_runs_over_stacked_leaves():
    """The stacked semantics matter: the reference factors a per-layer
    norm scale [d] as [L, d] (its column statistic is a mean over layers)
    and clips each update by the RMS of the whole stacked leaf. With an
    RMS that exceeds the threshold in one layer only, the per-layer
    version (the reference's optimizer run on each layer's own leaves)
    visibly differs; the port equals the stacked reference."""
    tparams, jparams = _run_both(jax_adafactor(lr=1e-2),
                                 adafactor(lr=1e-2), steps=3,
                                 grads=_one_layer_outlier, seed=1)
    # the same run, per layer
    rng = np.random.default_rng(1)
    p0 = _draw(rng)
    opt = jax_adafactor(lr=1e-2)
    per_layer = {f"{k}.{i}": jnp.asarray(p0[f"blocks.{k}"][i])
                 for k in ("w", "scale", "g") for i in range(L)}
    state = opt.init(per_layer)
    for step in range(3):
        g = _one_layer_outlier(rng, step)
        grads = {f"{k}.{i}": jnp.asarray(g[f"blocks.{k}"][i])
                 for k in ("w", "scale", "g") for i in range(L)}
        upd, state, _ = opt.update(grads, state, per_layer)
        per_layer = jax.tree.map(lambda p, u: p + u, per_layer, upd)
    for k in ("w", "scale"):
        stacked_ref = np.asarray(jparams["blocks"][k])
        layered = np.stack([np.asarray(per_layer[f"{k}.{i}"])
                            for i in range(L)])
        moved = np.abs(stacked_ref - p0[f"blocks.{k}"]).max()
        assert np.abs(layered - stacked_ref).max() > 0.05 * moved, k


def test_adamw_grad_clipping_bounds_update():
    opt = adamw(lr=1.0, max_grad_norm=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    groups = [LeafGroup("w", ("w",), ())]
    state = opt.init(params, groups)
    gnorm = opt.update({"w": torch.full((4,), 1e6)}, state, params, groups)
    assert float(gnorm) > 1e5          # raw norm reported
    assert torch.isfinite(params["w"]).all()
    assert params["w"].abs().max() < 20.0


def test_adafactor_state_is_factored():
    """By the stacked shape: a [16, 8] weight stacked over 2 layers has
    [2, 16] row and [2, 8] column statistics, a [8] bias stacked over 2
    layers is factored too ([2] and [8]), an unstacked [8] bias is not."""
    opt = adafactor()
    params = {"blocks.0.w": torch.zeros(16, 8), "blocks.1.w": torch.zeros(
        16, 8), "blocks.0.b": torch.zeros(8), "blocks.1.b": torch.zeros(8),
        "b": torch.zeros(8)}
    groups = [LeafGroup("blocks.w", ("blocks.0.w", "blocks.1.w"), (2,)),
              LeafGroup("blocks.b", ("blocks.0.b", "blocks.1.b"), (2,)),
              LeafGroup("b", ("b",), ())]
    state = opt.init(params, groups)
    f = state["f"]
    assert f["blocks.w"]["vr"].shape == (2, 16)
    assert f["blocks.w"]["vc"].shape == (2, 8)
    assert f["blocks.b"]["vr"].shape == (2,)
    assert f["blocks.b"]["vc"].shape == (8,)
    assert f["b"]["v"].shape == (8,)
    assert state["step"].dtype == torch.int32


def test_make_optimizer():
    assert make_optimizer("adamw") is not None
    assert make_optimizer("adafactor") is not None
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("sgd")


@pytest.mark.parametrize("seed", [0, 7, 1337, 2**31 - 1])
def test_compress_int8_is_bit_exact_to_reference(seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(257) * rng.uniform(0.01, 10)).astype(np.float32)
    # exact halves of the quantum: round half to even in both packages
    g[:4] = np.float32(np.abs(g).max()) / 127 * np.array(
        [0.5, 1.5, -2.5, 126.5], np.float32)
    q, scale = compress_int8(torch.from_numpy(g))
    jq, jscale = jax_compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    err = (decompress_int8(q, scale) - torch.from_numpy(g)).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6
    r = torch.from_numpy(rng.standard_normal(257).astype(np.float32) * 0.01)
    red, res = error_feedback_reduce(torch.from_numpy(g), r)
    jred, jres = jax_efr(jnp.asarray(g), jnp.asarray(r.numpy()))
    np.testing.assert_array_equal(red.numpy(), np.asarray(jred))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))


def test_error_feedback_unbiased_over_time():
    """With error feedback, the accumulated applied update tracks the
    accumulated true gradient (the residual stays bounded)."""
    rng = np.random.default_rng(3)
    residual = torch.zeros(64)
    total_true = np.zeros(64)
    total_applied = np.zeros(64)
    for _ in range(200):
        g = torch.from_numpy((rng.standard_normal(64) * 0.1).astype(
            np.float32))
        applied, residual = error_feedback_reduce(g, residual)
        total_true += g.numpy()
        total_applied += applied.numpy()
    np.testing.assert_allclose(total_applied + residual.numpy(), total_true,
                               atol=1e-3)
    assert residual.abs().max() < 0.05


def test_collective_error_feedback_is_not_ported():
    """The collective form is ported now (its 8-rank check against the
    reference's ``shard_map`` is in ``test_torch_dist_train.py``): over a
    mesh axis of one device it equals the local form and the reference's
    local output bit for bit; an axis name needs a mesh."""
    rng = np.random.default_rng(11)
    g = rng.standard_normal((8, 32)).astype(np.float32)
    res = (rng.standard_normal((8, 32)) * 1e-3).astype(np.float32)
    want = jax_efr(jnp.asarray(g), jnp.asarray(res))
    local = error_feedback_reduce(torch.from_numpy(g), torch.from_numpy(res))
    plan = build_plan("yi-6b", debug=True, device="cpu")
    with tsh.sharding_ctx(plan.mesh, plan.rules):
        got = error_feedback_reduce(torch.from_numpy(g),
                                    torch.from_numpy(res), axis_name="data")
    for a, b, w in zip(got, local, want):
        assert torch.equal(a, b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    with pytest.raises(RuntimeError, match="names a mesh dim"):
        error_feedback_reduce(torch.zeros(4), torch.zeros(4),
                              axis_name="data")
    with tsh.sharding_ctx(plan.mesh, plan.rules), \
            pytest.raises(ValueError, match="lack 'pod'"):
        error_feedback_reduce(torch.zeros(4), torch.zeros(4),
                              axis_name="pod")


# ---------------------------------------------------------------------------
# state specs: where the optimizer state lives on a mesh
# ---------------------------------------------------------------------------


class _Mesh:
    """What both packages read of a mesh: axis names and a devices array
    (the 2x16x16 production mesh, so that every rule resolves)."""

    axis_names = ("pod", "data", "model")
    devices = np.zeros((2, 16, 16))


def _spec_strings(tree, resolve, prefix=""):
    """``{path: (shape, logical axes, dtype, PartitionSpec string)}`` of a
    nested dict of specs whose keys are names or leaf keys (``['a']``)."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k if k.startswith("[") else f"['{k}']")
        if isinstance(v, dict):
            out.update(_spec_strings(v, resolve, path))
        else:
            out[path] = resolve(v)
    return out


@pytest.mark.parametrize("arch", PORTED_IDS)
def test_state_specs_equal_reference(arch):
    """adamw's and adafactor's ``state_specs`` over the full config's
    parameter specs, in cascade, megatron and megatron_sp: every state
    leaf's shape, logical axes, dtype and PartitionSpec string equal the
    reference's (adafactor's ``vr``/``vc`` drop the last and the
    second-to-last axis, an unfactored leaf keeps ``v``)."""
    mesh = _Mesh()
    for mode in jsh.MODES:
        tspecs = param_specs(get_config(arch).with_(sharding_mode=mode))
        jspecs = jax_build_model(jax_get_config(arch).with_(
            sharding_mode=mode)).param_specs()
        trules, jrules = tsh.rules_for_mode(mode), jsh.rules_for_mode(mode)

        def tview(s):
            return (s.shape, s.logical, str(s.dtype)[6:],
                    str(tsh.spec_to_pspec(s, mesh, trules)))

        def jview(s):
            return (tuple(s.shape), tuple(s.logical), np.dtype(s.dtype).name,
                    str(jsh.spec_to_pspec(s, mesh, jrules)))

        for tmake, jmake in ((adamw, jax_adamw), (adafactor, jax_adafactor)):
            got = _spec_strings(tmake().state_specs(dict(tspecs)), tview)
            leaves, _ = jax.tree_util.tree_flatten_with_path(
                jmake().state_specs(jspecs),
                is_leaf=lambda x: isinstance(x, jsh.ParamSpec))
            want = {jax.tree_util.keystr(p): jview(v) for p, v in leaves}
            assert got == want, (mode, tmake.__name__, sorted(
                set(got) ^ set(want))[:5])
