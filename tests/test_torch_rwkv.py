"""The port's RWKV6 family (``layers/rwkv.py``, ``layernorm``,
``groupnorm_heads`` and ``RWKVModel``) against the JAX package's, on the
CPU.

The layers run on the reference's ``rwkv6_spec`` weights (d 64, 8 heads
of 8, as tests/test_layers.py) with inputs from numpy seeds. The model is
the reduced rwkv6-7b (4 layers, d_model 64, 4 wkv heads of 16, vocab 256)
on the reference's weights, carried across with ``rwkv_from_arrays``.

Tolerances: the norms fp32 atol = rtol = 1e-5, bf16 atol 2e-2; the wkv
recurrence fp32 1e-5 (the port's one flat loop against both of the
reference's scans, which equal each other); the mixes with carried state
fp32 1e-5; the port's stepwise against its own batch pass as the
reference's test holds its own (atol 0.1 in bf16, the state 1e-2); logits
and the wkv state fp32 1e-4 (prefill and 6 decode steps), the carried
inputs, which both packages store in bf16, within one bf16 ulp. Serving
streams are held to the reference's own streams in each mode up to the
first step whose reference gap is below 0.1 (its compiled steps keep
excess bf16 precision; see tests/test_torch_hybrid.py).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serve_ref import (
    FAMILY_BUCKET,
    FAMILY_PAGED,
    PARITY_TRACE,
    SHARED_TRACE,
    assert_gap_streams,
    family_arrays,
    family_params,
    family_port_streams,
    family_reference,
)

import repro.layers.rwkv as jrwkv
from repro.configs import reduced_config as jax_reduced_config
from repro.dist.sharding import init_params
from repro.layers.norm import groupnorm_heads as jax_groupnorm_heads
from repro.layers.norm import layernorm as jax_layernorm
from repro.models import build_model as jax_build_model
from repro.models.base import paged_state_specs
from repro_torch.bridge import model_from_arrays, rwkv_from_arrays
from repro_torch.configs import reduced_config
from repro_torch.layers import rwkv as trwkv
from repro_torch.layers.norm import groupnorm_heads, layernorm
from repro_torch.models.base import PageView
from repro_torch.models.rwkv_model import RWKVModel
from repro_torch.plan import build_plan
from repro_torch.serve import Bucket, BucketPolicy
from repro_torch.serve.validation import resolve_speculative

ARCH = "rwkv6_7b"
B, S, D, P = 2, 16, 64, 8
MIN_GAP = 0.1
FP32 = dict(atol=1e-4, rtol=1e-4)
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=0.0)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _x(shape, dtype, seed=0):
    jd, td = DT[dtype]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _mix_params(dtype, seed=0):
    """The reference's ``rwkv6_spec`` weights in both packages."""
    jd, td = DT[dtype]
    p = init_params(jax.random.PRNGKey(seed),
                    jrwkv.rwkv6_spec(D, 4 * D, head_dim=P, mode="megatron"))
    jp = jax.tree.map(lambda a: a.astype(jd), p)
    return jp, jax.tree.map(lambda a: _t(a, td), p)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_layernorm_and_groupnorm_heads(dtype):
    """eps 1e-5 and 64e-5, fp32 inside, with a non-trivial scale and
    bias; x shifted off zero so the mean matters."""
    jx, tx = _x((2, 5, 64), dtype)
    jx, tx = jx + 3, tx + 3
    rng = np.random.default_rng(1)
    scale, bias = (rng.standard_normal(64).astype(np.float32)
                   for _ in range(2))
    jd, td = DT[dtype]
    jp = {"scale": jnp.asarray(scale, jd), "bias": jnp.asarray(bias, jd)}
    tp = {"scale": _t(scale, td), "bias": _t(bias, td)}
    _close(layernorm(tp, tx), jax_layernorm(jp, jx), TOL[dtype])
    hx, tx4 = jx.reshape(2, 5, 4, 16), tx.reshape(2, 5, 4, 16)
    s4, b4 = scale.reshape(4, 16), bias.reshape(4, 16)
    want = jax_groupnorm_heads(hx, jnp.asarray(s4, jd), jnp.asarray(b4, jd))
    got = groupnorm_heads(tx4, _t(s4, td), _t(b4, td))
    assert got.dtype == td
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("T", [64, 40])
@pytest.mark.parametrize("carried", [False, True], ids=["zero", "carried"])
def test_wkv_scan_matches_both_reference_scans(T, carried):
    """The port's flat loop against the reference's chunked scan (16-step
    chunks; T = 40 is ragged, which the reference runs flat) and its flat
    scan, from a zero or a carried state: outputs and final state."""
    rng = np.random.default_rng(0)
    r, k, v = (rng.standard_normal((B, T, 2, 8)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.5, 0.99, (B, T, 2, 8)).astype(np.float32)
    u = rng.standard_normal((2, 8)).astype(np.float32)
    s0 = (rng.standard_normal((B, 2, 8, 8)).astype(np.float32)
          if carried else None)
    js0 = None if s0 is None else jnp.asarray(s0)
    args = [jnp.asarray(a) for a in (r, k, v, w, u)]
    y, final = trwkv.wkv_scan(*(torch.from_numpy(a) for a in (r, k, v, w, u)),
                              None if s0 is None else torch.from_numpy(s0))
    assert y.shape == (B, T, 2, 8) and final.shape == (B, 2, 8, 8)
    for chunk in (16, 10 ** 9):
        jy, jf = jrwkv.wkv_scan(*args, js0, chunk=chunk)
        _close(y, jy, TOL["fp32"])
        _close(final, jf, TOL["fp32"])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_time_and_channel_mix_with_carried_state(dtype):
    """Both mixes on a chunk of 16 tokens after a carried last input and
    wkv state: the outputs and the state they return. fp32 1e-5; bf16
    2e-2 on the outputs (the reference's eager bf16 ops round where the
    port's do) and 5e-2 on the fp32 state, which sums 16 steps of products
    of bf16-rounded projections."""
    jp, tp = _mix_params(dtype)
    jx, tx = _x((B, S, D), dtype, seed=2)
    jprev, tprev = _x((B, D), dtype, seed=3)
    s0 = np.random.default_rng(4).standard_normal((B, 8, P, P)).astype(
        np.float32) * 0.1
    jo, jlast, js = jrwkv.rwkv6_time_mix(
        jp, jx, head_dim=P, tm_prev=jprev, wkv_state=jnp.asarray(s0),
        return_state=True)
    to, tlast, ts = trwkv.rwkv6_time_mix(
        tp, tx, head_dim=P, tm_prev=tprev, wkv_state=torch.from_numpy(s0),
        return_state=True)
    _close(to, jo, TOL[dtype])
    _close(tlast, jlast, dict(atol=0, rtol=0))
    _close(ts, js, TOL["fp32"] if dtype == "fp32" else dict(atol=5e-2,
                                                             rtol=0))
    jo, jlast = jrwkv.rwkv6_channel_mix(jp, jx, cm_prev=jprev,
                                        return_state=True)
    to, tlast = trwkv.rwkv6_channel_mix(tp, tx, cm_prev=tprev,
                                        return_state=True)
    _close(to, jo, TOL[dtype])
    _close(tlast, jlast, dict(atol=0, rtol=0))


def test_time_mix_stepwise_matches_batch():
    """Token by token with the carried state against one batch pass, in
    bf16 (the reference's own test: atol 0.1, state 1e-2), and each step
    against the reference's step in fp32."""
    jp, tp = _mix_params("bf16")
    _, tx = _x((B, S, D), "bf16", seed=5)
    y_batch, _, s_fin = trwkv.rwkv6_time_mix(tp, tx, head_dim=P,
                                             return_state=True)
    prev = torch.zeros((B, D), dtype=torch.bfloat16)
    swk = torch.zeros((B, 8, P, P))
    outs = []
    for t in range(S):
        o, prev, swk = trwkv.rwkv6_time_mix(
            tp, tx[:, t:t + 1], head_dim=P, tm_prev=prev, wkv_state=swk,
            return_state=True)
        outs.append(o)
    y_step = torch.cat(outs, 1)
    _close(y_step, y_batch.float().numpy(), dict(atol=0.1, rtol=0))
    _close(swk, s_fin.numpy(), dict(atol=1e-2, rtol=0))

    jp32, tp32 = _mix_params("fp32")
    jx, tx = _x((B, 3, D), "fp32", seed=6)
    jprev, jswk = jnp.zeros((B, D)), jnp.zeros((B, 8, P, P))
    tprev, tswk = torch.zeros((B, D)), torch.zeros((B, 8, P, P))
    for t in range(3):
        jo, jprev, jswk = jrwkv.rwkv6_time_mix(
            jp32, jx[:, t:t + 1], head_dim=P, tm_prev=jprev,
            wkv_state=jswk, return_state=True)
        to, tprev, tswk = trwkv.rwkv6_time_mix(
            tp32, tx[:, t:t + 1], head_dim=P, tm_prev=tprev,
            wkv_state=tswk, return_state=True)
        _close(to, jo, TOL["fp32"])
        _close(tswk, jswk, TOL["fp32"])


# ---------------------------------------------------------------------------
# the model: bridge, prefill, decode, state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tcfg():
    return reduced_config(ARCH)


def _model(seed, fp32=False):
    return rwkv_from_arrays(reduced_config(ARCH),
                            family_arrays(ARCH, seed, fp32), "cpu")


def _p32(seed):
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        family_params(ARCH, seed))


def test_reduced_config_and_bridge(tcfg, test_seed):
    """The reduced config equals the reference's field by field; every
    port parameter holds the reference leaf's slice bit for bit in its
    dtype; a malformed tree is refused."""
    want = jax_reduced_config(ARCH)
    for field in type(want).__dataclass_fields__:
        assert getattr(tcfg, field) == getattr(want, field), field
    tree = family_arrays(ARCH, test_seed)
    model = model_from_arrays(tcfg, tree, "cpu")
    assert isinstance(model, RWKVModel)
    assert (model.n_heads, model.head_dim) == (4, 16)
    n = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        node = tree
        for key in ([parts[0]] + parts[2:] if parts[0] == "blocks"
                    else parts):
            node = node[key]
        leaf = node[int(parts[1])] if parts[0] == "blocks" else node
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(leaf, np.float32), name)
        n += 1
    stacked = len(jax.tree.leaves(tree["blocks"]))
    assert n == len(jax.tree.leaves(tree)) + stacked * (tcfg.n_layers - 1)
    with pytest.raises(KeyError, match="ln0.bias"):
        rwkv_from_arrays(tcfg, dict(tree, ln0={"scale": tree["ln0"]["scale"]}),
                         "cpu")
    mix = dict(tree["blocks"]["mix"], u=tree["blocks"]["mix"]["u"][:, :2])
    with pytest.raises(ValueError, match="mix.u"):
        rwkv_from_arrays(tcfg, dict(tree, blocks=dict(tree["blocks"],
                                                      mix=mix)), "cpu")


def test_forward_fp32_logits(tcfg, test_seed):
    model = _model(test_seed, fp32=True)
    toks = np.random.default_rng(8).integers(0, 256, (2, 40)).astype(
        np.int32)
    want = np.asarray(jax_build_model(jax_reduced_config(ARCH)).forward(
        _p32(test_seed), {"tokens": jnp.asarray(toks)}))
    got = model({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_forward_bf16_argmax(test_seed):
    toks = np.random.default_rng(9).integers(0, 256, (2, 40)).astype(
        np.int32)
    want = np.asarray(jax_build_model(jax_reduced_config(ARCH)).forward(
        family_params(ARCH, test_seed), {"tokens": jnp.asarray(toks)}))
    got = _model(test_seed)({"tokens": torch.from_numpy(toks)}).numpy()
    assert np.isfinite(got).all()
    top2 = np.sort(want, axis=-1)[..., -2:]
    robust = top2[..., 1] - top2[..., 0] > 0.2
    assert robust.sum() >= 20
    np.testing.assert_array_equal(got.argmax(-1)[robust],
                                  want.argmax(-1)[robust])
    assert np.abs(got - want).mean() < 0.05


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_step_matches_reference(tcfg, paged, test_seed):
    """Six decode steps from the zero state (fp32 weights; the carried
    inputs stored in bf16 and the wkv state in fp32, as both packages
    keep them): the logits and every state leaf. Paged, a page view goes
    in and is ignored, as the reference ignores it."""
    jm = jax_build_model(jax_reduced_config(ARCH))
    p32 = _p32(test_seed)
    model = _model(test_seed, fp32=True)
    Bd = 2
    jstate = init_params(jax.random.PRNGKey(0), jm.decode_state_specs(Bd,
                                                                       16))
    tstate = model.decode_state(Bd, 16)
    assert {k: (tuple(v.shape), v.dtype) for k, v in tstate.items()} == {
        "tm_prev": ((4, Bd, 64), torch.bfloat16),
        "cm_prev": ((4, Bd, 64), torch.bfloat16),
        "wkv": ((4, Bd, 4, 16, 16), torch.float32)}
    toks = np.random.default_rng(11).integers(0, 256, (6, Bd)).astype(
        np.int32)
    table = torch.tensor([[1, 0, 2, 3], [5, 4, 7, 6]], dtype=torch.int32)
    for i in range(6):
        kw = ({"pages": PageView(table, torch.tensor([i, i + 2]), 4)}
              if paged else {})
        jl, jstate = jm.decode_step(p32, jstate, jnp.asarray(toks[i]),
                                    jnp.int32(i))
        tl, out = model.decode_step(tstate, torch.from_numpy(toks[i]),
                                    i + 7, **kw)
        assert out is tstate
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
        np.testing.assert_allclose(tstate["wkv"].numpy(),
                                   np.asarray(jstate["wkv"]), **FP32)
        for name in ("tm_prev", "cm_prev"):       # one bf16 ulp
            np.testing.assert_allclose(
                tstate[name].float().numpy(),
                np.asarray(jstate[name], np.float32), atol=1e-4,
                rtol=2 ** -7)


def test_paged_state_is_all_dense(tcfg, test_seed):
    """The reference's paged state specs keep every RWKV leaf per slot
    (no KV cache to page); the port's paged state has an empty pool half
    and the whole state as its dense half, and no draft."""
    jm = jax_build_model(jax_reduced_config(ARCH))
    dense = jm.decode_state_specs(2, 64)
    paged = paged_state_specs(dense, 8, 16)
    assert {k: v.shape for k, v in paged.items()} == {
        k: v.shape for k, v in dense.items()}
    model = _model(test_seed)
    assert model.decode_state(3, 64, paged=(8, 16), only="pool") == {}
    half = model.decode_state(3, 64, paged=(8, 16), only="dense")
    assert {k: tuple(v.shape) for k, v in half.items()} == {
        k: (s.shape[0], 3) + s.shape[2:] for k, s in dense.items()}
    with pytest.raises(ValueError, match="decode_block"):
        model.decode_state(3, 64, draft_layers=1)


def test_state_pool_and_fresh_lane(test_seed):
    """Paged: ``acquire`` gives the recurrent leaves with an empty pool,
    ``reset_slots`` zeroes one lane, and the step's fresh lane restarts a
    slot from the zero state."""
    plan = build_plan(ARCH, None, debug=True, device="cpu")
    model = plan.load_params(family_arrays(ARCH, test_seed))
    b = plan.make_batcher(policy=BucketPolicy([Bucket(*FAMILY_BUCKET)]),
                          schedule="continuous", paged=FAMILY_PAGED)
    pool = b.pool
    s = pool.acquire(2, 64)
    assert set(s) == {"tm_prev", "cm_prev", "wkv"}
    for leaf in s.values():
        leaf.fill_(1)
    pool.reset_slots(2, 64, s, [False, True])
    assert not s["wkv"][:, 1].any() and s["wkv"][:, 0].all()
    assert not s["tm_prev"][:, 1].any() and s["cm_prev"][:, 0].all()
    exe = plan.serve_executable("masked_decode", batch=2, max_len=64,
                                paged=FAMILY_PAGED)
    table = torch.arange(8, dtype=torch.int32).view(2, 4)
    exe.fn(plan.model, s, torch.tensor([[5, -1]], dtype=torch.int32),
           torch.tensor([0, 7], dtype=torch.int32), 0,
           torch.zeros((1, 2), dtype=torch.int32),
           torch.ones((1, 2), dtype=torch.bool),
           torch.tensor([[True, False]]), table)
    alone = model.decode_state(1, 64)
    model.decode_step(alone, torch.tensor([5], dtype=torch.int32), 0)
    for name in s:
        torch.testing.assert_close(s[name][:, 0], alone[name][:, 0])
    pool.release(2, 64, s)
    assert pool._pool_leaves == {}


# ---------------------------------------------------------------------------
# quantization and the speculative check
# ---------------------------------------------------------------------------


def test_quantized_plan_runs_the_head_only(test_seed, monkeypatch):
    """No MLP route for RWKV (no dense SwiGLU), as in the reference: a
    quantized decode step runs qmatmul once, for the head."""
    import repro_torch.layers.linear as tlinear

    calls = []
    real = tlinear.qlinear
    monkeypatch.setattr(tlinear, "qlinear",
                        lambda x, w, *a, **k: (calls.append(
                            (tuple(x.shape), tuple(w.shape))),
                            real(x, w, *a, **k))[1])
    plan = build_plan(ARCH, None, debug=True, quantized=True, device="cpu")
    assert plan.ir.quant["mlp"] is False and not plan.cfg.quantized_mlp
    model = plan.load_params(family_arrays(ARCH, test_seed))
    state = model.decode_state(2, 8)
    calls.clear()
    model.decode_step(state, torch.tensor([3, 4], dtype=torch.int32), 0)
    assert calls == [((2, 64), (64, 256))]


def test_speculative_raises_the_reference_message():
    from repro.models.rwkv_model import RWKVModel as JaxRWKVModel
    from repro.serve.validation import resolve_speculative as jax_resolve

    msg = re.escape("family 'ssm' has no block-verify decode path "
                    "(decode_block); speculative lanes need one")
    kw = dict(schedule="continuous", steps_per_dispatch=4, n_layers=4)
    with pytest.raises(ValueError, match=msg):
        jax_resolve(4, None, model=JaxRWKVModel, family="ssm", **kw)
    with pytest.raises(ValueError, match=msg):
        resolve_speculative(4, None, family="ssm", **kw)
    plan = build_plan(ARCH, None, debug=True, device="cpu")
    with pytest.raises(ValueError, match=msg):
        plan.make_batcher(schedule="continuous", steps_per_dispatch=4,
                          speculative=4)


# ---------------------------------------------------------------------------
# serving: the reference's streams per mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("schedule,k,paged", [
    ("fifo", 1, False),
    ("continuous", 1, False), ("continuous", 2, False),
    ("continuous", 4, False),
    ("continuous", 1, True), ("continuous", 4, True),
], ids=["fifo", "continuous-k1", "continuous-k2", "continuous-k4",
        "paged-k1", "paged-k4"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_streams_match_reference(test_seed, quantized, schedule, k, paged):
    want, gaps, _ = family_reference(ARCH, test_seed, quantized, schedule,
                                     k, paged, "parity")
    b, got = family_port_streams(ARCH, test_seed, quantized, schedule, k,
                                 paged, PARITY_TRACE)
    compared = assert_gap_streams(got, want, gaps, MIN_GAP,
                                  (quantized, schedule, k, paged))
    assert compared >= 12, compared
    if schedule == "continuous":
        assert b.scheduler.refills > 0
    if paged:
        s = b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


def test_shared_prefix_paged_trace_matches_reference(test_seed):
    """Two waves sharing an 18-token system prompt through paged k = 4:
    wave 2 maps wave 1's published page and skips 16 prompt tokens, which
    never reach its recurrent state (the reference's prefix-cache fault,
    ROADMAP Queue 3). The port gives the reference's streams, held by the
    gap rule with the gaps of a loop that zeroes the recurrent state after
    16 tokens; a loop that keeps the prefix opens some wave-2 stream with
    another token."""
    page = FAMILY_PAGED[1]
    want, gaps, loop = family_reference(ARCH, test_seed, False,
                                        "continuous", 4, True, "shared",
                                        skipped=page)
    b, got = family_port_streams(ARCH, test_seed, False, "continuous", 4,
                                 True, SHARED_TRACE)
    s = b.stats()["paged"]
    assert s["prefix_hits"] == 2 and s["skipped_prefill_tokens"] == 2 * page
    assert assert_gap_streams(got, want, gaps, MIN_GAP, "shared") >= 8
    assert assert_gap_streams(loop, want, gaps, MIN_GAP, "faulted") >= 8
    _, _, clean = family_reference(ARCH, test_seed, False, "continuous", 4,
                                   True, "shared")
    assert any(clean[r][0] != want[r][0] for r in ("s2", "s3"))


def test_serve_cli_rwkv(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "rwkv6-7b", "--debug", "--device", "cpu",
          "--schedule", "continuous", "--steps-per-dispatch", "4",
          "--paged", "--quantized", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "rwkv6-7b on cpu" in out and "paged:" in out
    assert out.rstrip().endswith("builds=1")
