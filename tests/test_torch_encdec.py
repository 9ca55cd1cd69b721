"""The port's encoder-decoder family (``EncDecLM``, seamless-m4t-large-v2)
against the JAX package's, on the CPU: the GELU MLP, the config, the
bridge, prefill (the encoder's non-causal flash), decode (dense and paged,
over a zero and a filled cross cache), the quantized plan, the serving
paths, the CLI.

Reduced seamless (2 encoder and 2 decoder layers, d_model 64, 4 heads of
dim 16, kv 4, dec_ratio 2, vocab 256) with the reference's weights,
carried across with ``encdec_from_arrays``; its MLP and LayerNorm biases,
which the reference starts at zero, are drawn at random in both packages
(``_torch_serve_ref.family_params``). Tolerances: fp32 layers atol = rtol
= 1e-5, fp32 logits and states 1e-4, bf16 layers 2e-2 and bf16 logits by
argmax where the reference's top-2 gap exceeds 0.2; integer shifts equal.
Streams are held to the reference's own streams in the same mode up to
the first step whose reference top-2 gap is under ``MIN_GAP``
(``tests/_torch_serve_ref.py``).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serve_ref import (
    FAMILY_PAGED,
    MIN_GAP,
    PARITY_TRACE,
    SHARED_TRACE,
    assert_gap_streams,
    family_arrays,
    family_params,
    family_port_streams,
    family_reference,
)

import repro.layers.attention as jattn
import repro_torch.layers.attention as tattn
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.dist.sharding import init_params
from repro.layers.mlp import mlp as jax_mlp
from repro.models import build_model as jax_build_model
from repro.models.base import PageView as JaxPageView
from repro.models.base import paged_state_specs
from repro_torch.bridge import encdec_from_arrays, model_from_arrays
from repro_torch.configs import get_config, reduced_config
from repro_torch.layers.mlp import mlp
from repro_torch.models import build_model
from repro_torch.models.base import PageView, ShapeSpec
from repro_torch.models.encdec import EncDecLM
from repro_torch.plan import build_plan
from repro_torch.serve.validation import resolve_speculative

ARCH = "seamless_m4t_large_v2"
PAGED = FAMILY_PAGED
FP32 = dict(atol=1e-4, rtol=1e-4)
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def jcfg():
    return jax_reduced_config(ARCH)


def jparams(seed):
    return family_params(ARCH, seed)


def arrays(seed, fp32=False):
    return family_arrays(ARCH, seed, fp32)


@pytest.fixture(scope="module")
def tcfg():
    return reduced_config(ARCH)


@pytest.fixture(scope="module")
def tmodel(tcfg, test_seed):
    return encdec_from_arrays(tcfg, arrays(test_seed), "cpu")


@pytest.fixture
def flash(monkeypatch):
    """Set both packages' flash switch."""
    def set_(on: bool):
        monkeypatch.setattr(jattn, "USE_FLASH_KERNEL", on)
        monkeypatch.setattr(tattn, "USE_FLASH_KERNEL", on)
    return set_


def _batch(seed, frames=64, tokens=24, d=64):
    """Frames [2, frames, d] (a multiple of the reference flash's block of
    32, so the encoder's non-causal attention takes flash when it is on)
    and decoder tokens [2, tokens]."""
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((2, frames, d)).astype(np.float32),
            "tokens": rng.integers(0, 256, (2, tokens)).astype(np.int32)}


def _jax(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
            for k, v in batch.items()}


def _torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def _p32(seed):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jparams(seed))


# ---------------------------------------------------------------------------
# the GELU MLP
# ---------------------------------------------------------------------------


def _mlp_params(dtype, seed=3, d=64, f=128):
    """Random ``up``/``down`` weights and biases: (jax tree, port tree)."""
    jd, td = DT[dtype]
    rng = np.random.default_rng(seed)
    tree = {"up": {"w": rng.standard_normal((d, f)) * d ** -0.5,
                   "b": rng.standard_normal(f) * 0.5},
            "down": {"w": rng.standard_normal((f, d)) * f ** -0.5,
                     "b": rng.standard_normal(d) * 0.5}}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    return (jax.tree.map(lambda a: jnp.asarray(a, jd), tree),
            jax.tree.map(lambda a: torch.from_numpy(a).to(td), tree))


@pytest.mark.parametrize("act", ["gelu", "relu"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mlp_matches_reference(dtype, act):
    jp, tp = _mlp_params(dtype)
    x = np.random.default_rng(4).standard_normal((2, 7, 64)).astype(
        np.float32) * 2
    jd, td = DT[dtype]
    want = jax_mlp(jp, jnp.asarray(x, jd), act=act)
    got = mlp(tp, torch.from_numpy(x).to(td), act=act)
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def test_mlp_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation, torch's ``gelu``
    to the exact erf form: the same MLP through the erf form misses the
    reference by more than ten times the fp32 tolerance on these inputs,
    the port's ``mlp`` stays within it."""
    import torch.nn.functional as F

    from repro_torch.layers.linear import linear

    jp, tp = _mlp_params("fp32")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 9, 64)).astype(np.float32) * 3)
    want = np.asarray(jax_mlp(jp, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(mlp(tp, x).numpy(), want, **TOL["fp32"])
    erf = linear(tp["down"], F.gelu(linear(tp["up"], x))).numpy()
    assert np.abs(erf - want).max() > 10 * TOL["fp32"]["atol"]


# ---------------------------------------------------------------------------
# the config, the leaf kinds, the bridge
# ---------------------------------------------------------------------------


def test_configs_equal_reference_field_by_field(tcfg):
    for got, want in ((get_config(ARCH), jax_get_config(ARCH)),
                      (tcfg, jcfg())):
        for field in type(want).__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), field
    full = get_config("seamless-m4t-large-v2")
    assert (full.family, full.n_enc_layers, full.vocab) == ("encdec", 24,
                                                            256256)


def test_full_size_parameter_count():
    """The full model's parameter count, from the meta device (nothing is
    allocated): 1,632,800,768, 3.27 GB in bf16."""
    model = build_model(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in model.parameters()) == 1_632_800_768


def test_bridge_round_trip(tcfg, tmodel, test_seed):
    """Every port parameter holds the reference leaf's slice bit for bit,
    in its dtype: ``enc_blocks`` [n_enc, ...] and ``dec_blocks`` [L, ...]
    to one block each; the drawn biases arrive nonzero."""
    tree = arrays(test_seed)
    n = 0
    for name, p in tmodel.named_parameters():
        parts = name.split(".")
        if parts[0] in ("enc_blocks", "dec_blocks"):
            leaf = functools.reduce(lambda t, k: t[k], parts[2:],
                                    tree[parts[0]])[int(parts[1])]
        else:
            leaf = functools.reduce(lambda t, k: t[k], parts, tree)
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(leaf, np.float32), name)
        n += 1
    enc = len(jax.tree.leaves(tree["enc_blocks"]))
    dec = len(jax.tree.leaves(tree["dec_blocks"]))
    assert n == len(jax.tree.leaves(tree)) + enc + dec     # 2 layers each
    assert tmodel.dec_blocks[1].ffn["up"]["b"].abs().max() > 0.1
    assert tmodel.ln_enc["bias"].abs().max() > 0.1
    assert isinstance(model_from_arrays(tcfg, tree, "cpu"), EncDecLM)


def test_bridge_rejects_a_malformed_tree(tcfg, test_seed):
    tree = arrays(test_seed)
    with pytest.raises(KeyError, match="ln_enc.bias"):
        encdec_from_arrays(tcfg, dict(tree, ln_enc={"scale": tree[
            "ln_enc"]["scale"]}), "cpu")
    with pytest.raises(KeyError, match="unexpected"):
        encdec_from_arrays(tcfg, dict(tree, extra={"w": np.zeros(2)}), "cpu")
    short = jax.tree.map(lambda a: a[:1], tree["enc_blocks"])
    with pytest.raises(ValueError, match="n_enc_layers"):
        encdec_from_arrays(tcfg, dict(tree, enc_blocks=short), "cpu")


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_forward_fp32_logits(tcfg, flash, on, test_seed, monkeypatch):
    """fp32 logits of frames [2, 64] and tokens [2, 24] with random
    biases. With flash on, the encoder's non-causal attention and the
    decoder's causal one take the flash wrapper in both packages (its
    plain version here, the reference's interpret-mode kernel), and the
    cross-attention (24 queries over 64 frames) the plain path."""
    flash(on)
    seen = []
    real = tattn.flash_attention

    def spy(q, k, v, *, causal=True, **kw):
        seen.append(causal)
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    model = encdec_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    batch = _batch(8)
    want = np.asarray(jax_build_model(jcfg()).forward(
        _p32(test_seed), _jax(batch)))
    got = model(_torch(batch))
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    assert seen == ([False] * 2 + [True] * 2 if on else [])


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_forward_bf16_argmax(tmodel, flash, on, test_seed):
    flash(on)
    batch = _batch(9)
    want = np.asarray(jax_build_model(jcfg()).forward(
        jparams(test_seed), _jax(batch, jnp.bfloat16)))
    got = tmodel(_torch(batch, torch.bfloat16)).numpy()
    assert np.isfinite(got).all()
    top2 = np.sort(want, axis=-1)[..., -2:]
    robust = top2[..., 1] - top2[..., 0] > 0.2
    assert robust.sum() >= 24
    np.testing.assert_array_equal(got.argmax(-1)[robust],
                                  want.argmax(-1)[robust])


def test_prefill_step_takes_frames_and_the_decoder_run(tcfg, tmodel):
    """The prefill executable of a [2, 256] shape takes frames [2, 256, d]
    and max(256 // dec_ratio, 128) = 128 decoder tokens, and refuses
    another batch."""
    plan = build_plan(ARCH, ShapeSpec("p", 256, 2, "prefill"), debug=True,
                      device="cpu")
    plan.load_params(tmodel)
    exe = plan.executable("prefill")
    batch = _torch(_batch(10, frames=256, tokens=128), torch.bfloat16)
    assert torch.equal(exe.fn(plan.model, batch), tmodel(batch))
    with pytest.raises(ValueError, match="built for"):
        exe.fn(plan.model, dict(batch, tokens=batch["tokens"][:, :64]))
    with pytest.raises(ValueError, match="frames"):
        exe.fn(plan.model, {"tokens": batch["tokens"]})


# ---------------------------------------------------------------------------
# decode, dense and paged
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cross", ["zero", "filled"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_step_matches_reference(tcfg, paged, cross, test_seed):
    """Six decode steps in fp32: the logits and every state leaf. The cross
    caches are the zeros serving leaves them at, or random values in both
    packages; paged, the slots' pages are interleaved in a pool of 8 and
    slot 1 starts at local position 2."""
    jm = jax_build_model(jcfg())
    model = encdec_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    B, L, ps = 2, 16, 4
    sspecs = jm.decode_state_specs(B, L)
    if paged:
        sspecs = paged_state_specs(sspecs, 8, ps)
        table = np.array([[6, 1, 4, 3], [2, 7, 0, 5]], np.int32)
    jstate = {k: v.astype(jnp.float32) for k, v in
              init_params(jax.random.PRNGKey(0), sspecs).items()}
    tstate = {k: v.float() for k, v in model.decode_state(
        B, L, paged=(8, ps) if paged else None).items()}
    per_slot = (8, ps) if paged else (B, L)
    assert {k: tuple(v.shape) for k, v in tstate.items()} == {
        "cache_k": (2, *per_slot, 4, 16), "cache_v": (2, *per_slot, 4, 16),
        "cross_k": (2, B, 128, 4, 16), "cross_v": (2, B, 128, 4, 16)}
    if cross == "filled":
        rng = np.random.default_rng(12)
        for name in ("cross_k", "cross_v"):
            a = rng.standard_normal(tstate[name].shape).astype(np.float32)
            jstate[name] = jnp.asarray(a)
            tstate[name] = torch.from_numpy(a)
    toks = np.random.default_rng(11).integers(0, 256, (6, B)).astype(
        np.int32)
    kw = {}
    for i in range(6):
        if paged:
            local = np.array([i, i + 2], np.int32)
            kw = dict(jax=dict(pages=JaxPageView(jnp.asarray(table),
                                                 jnp.asarray(local), ps)),
                      port=dict(pages=PageView(torch.from_numpy(table),
                                               torch.from_numpy(local), ps)))
        jl, jstate = jm.decode_step(_p32(test_seed), jstate,
                                    jnp.asarray(toks[i]), jnp.int32(i),
                                    **kw.get("jax", {}))
        tl, out = model.decode_step(tstate, torch.from_numpy(toks[i]), i,
                                    **kw.get("port", {}))
        assert out is tstate
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
        for name in tstate:
            np.testing.assert_allclose(tstate[name].numpy(),
                                       np.asarray(jstate[name]), **FP32)


def test_decode_state_halves_and_no_draft(tmodel):
    dense = tmodel.decode_state(3, 512, paged=(10, 8), only="dense")
    pool = tmodel.decode_state(3, 512, paged=(10, 8), only="pool")
    assert set(dense) == {"cross_k", "cross_v"}
    assert set(pool) == {"cache_k", "cache_v"}
    assert dense["cross_k"].shape == (2, 3, 256, 4, 16)    # 512 // 2
    assert pool["cache_k"].shape == (2, 10, 8, 4, 16)
    assert not any(v.any() for v in {**dense, **pool}.values())
    with pytest.raises(ValueError, match="decode_block"):
        tmodel.decode_state(3, 32, draft_layers=1)


# ---------------------------------------------------------------------------
# the quantized plan: no MLP route, a float head
# ---------------------------------------------------------------------------


def test_quantized_plan_matches_reference_and_runs_no_qmatmul(
        test_seed, monkeypatch):
    """The reference's quantize pass gives the encoder-decoder no MLP
    route (its GELU MLP is not in ``MLP_QUANT_FAMILIES``) and its decode
    head ignores ``quantized``: the port's plan records the same decision
    and shifts, and a quantized decode step launches qmatmul 0 times and
    gives the float step's logits."""
    import repro_torch.layers.linear as tlinear
    from repro.launch.mesh import make_debug_mesh
    from repro.plan import build_plan as jax_build_plan

    calls = []
    real = tlinear.qlinear
    monkeypatch.setattr(tlinear, "qlinear", lambda *a, **k: (
        calls.append(1), real(*a, **k))[1])
    mesh = make_debug_mesh(1, 1)
    jplan = jax_build_plan(jcfg(), None, mesh_spec=mesh, quantized=True)
    with mesh:
        jplan.shard_params(jparams(test_seed))
    plan = build_plan(ARCH, None, debug=True, quantized=True, device="cpu")
    model = plan.load_params(arrays(test_seed))
    for key in ("mlp", "mlp_shifts", "calibrated", "head_shifts"):
        assert plan.ir.quant[key] == jplan.ir.quant[key], key
    assert plan.cfg.quantized and not plan.cfg.quantized_mlp
    toks = torch.tensor([3, 4], dtype=torch.int32)
    got, _ = model.decode_step(model.decode_state(2, 8), toks, 0)
    model.cfg = plan.cfg.with_(quantized=False)
    want, _ = model.decode_step(model.decode_state(2, 8), toks, 0)
    assert not calls and torch.equal(got, want)


def test_speculative_raises_the_reference_message():
    from repro.serve.validation import resolve_speculative as jax_resolve

    msg = re.escape("family 'encdec' has no block-verify decode path "
                    "(decode_block); speculative lanes need one")
    kw = dict(schedule="continuous", steps_per_dispatch=4, n_layers=2)
    with pytest.raises(ValueError, match=msg):
        jax_resolve(4, None, model=jax_build_model(jcfg()), family="encdec",
                    **kw)
    with pytest.raises(ValueError, match=msg):
        resolve_speculative(4, None, family="encdec", **kw)
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
    """The parity trace through the port and the reference in one mode,
    over the zero cross caches that serving leaves (in both packages):
    equal streams up to the gap rule, slots refilled (continuous), every
    page back but scratch and prefix pages (paged)."""
    want, gaps, _ = family_reference(ARCH, test_seed, quantized, schedule,
                                     k, paged, "parity")
    b, got = family_port_streams(ARCH, test_seed, quantized, schedule, k,
                                 paged, PARITY_TRACE)
    compared = assert_gap_streams(got, want, gaps, MIN_GAP,
                                  (quantized, schedule, k, paged))
    assert compared >= 24, compared
    if schedule == "continuous":
        assert b.scheduler.refills > 0
    if paged:
        s = b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


def test_shared_prefix_paged_trace_matches_reference(test_seed):
    """Two waves sharing an 18-token system prompt through paged k = 4:
    wave 2 maps wave 1's published page and skips 16 prompt tokens. Only
    the self-attention KV is paged and the cross caches hold no per-token
    state, so the prefix cache is sound here (unlike the recurrent
    families): the streams equal the reference's, whose loop keeps every
    token."""
    page = PAGED[1]
    want, gaps, _ = family_reference(ARCH, test_seed, False, "continuous",
                                     4, True, "shared")
    b, got = family_port_streams(ARCH, test_seed, False, "continuous", 4,
                                 True, SHARED_TRACE)
    s = b.stats()["paged"]
    assert s["prefix_hits"] == 2 and s["skipped_prefill_tokens"] == 2 * page
    assert assert_gap_streams(got, want, gaps, MIN_GAP, "shared") >= 11


def test_serve_cli_encdec(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "seamless-m4t-large-v2", "--debug", "--device", "cpu",
          "--schedule", "continuous", "--steps-per-dispatch", "4",
          "--paged", "--quantized", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "seamless-m4t-large-v2 on cpu" in out and "paged:" in out
    assert out.rstrip().endswith("builds=1")
