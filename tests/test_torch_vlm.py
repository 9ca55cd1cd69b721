"""The port's vision LM family (``VisionLM``, llama-3.2-vision-90b)
against the JAX package's, on the CPU: cross-attention and the gated cross
block, the config, the bridge, prefill, decode (dense and paged, over a
zero and a filled cross cache), ``init_cross_cache``, the quantized plan,
the serving paths, the CLI.

Reduced llama-3.2-vision (2 superblocks of 1 self block and 1 cross block,
d_model 64, 4 heads of dim 16, kv 2, 8 image tokens, vocab 256) with the
reference's weights, carried across with ``vlm_from_arrays``; its
cross-attention gates, which the reference starts at zero (where a cross
block adds nothing from its attention), are drawn uniform in [0.5, 1] in
both packages (``_torch_serve_ref.family_params``). Tolerances: fp32
layers atol = rtol = 1e-5, fp32 logits and states 1e-4, bf16 layers 2e-2
and bf16 logits by argmax where the reference's top-2 gap exceeds 0.2;
integer shifts and launch counts equal. Streams are held to the
reference's own streams in the same mode up to the first step whose
reference top-2 gap is under ``MIN_GAP`` (``tests/_torch_serve_ref.py``).
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
from repro.models import build_model as jax_build_model
from repro.models.base import PageView as JaxPageView
from repro.models.base import paged_state_specs
from repro.models.blocks import cross_block as jax_cross_block
from repro_torch.bridge import model_from_arrays, vlm_from_arrays
from repro_torch.configs import get_config, reduced_config
from repro_torch.layers.attention import cross_attention
from repro_torch.models import build_model
from repro_torch.models.base import PageView, ShapeSpec
from repro_torch.models.vision_lm import VisionLM
from repro_torch.plan import build_plan
from repro_torch.serve.validation import resolve_speculative

ARCH = "llama_3_2_vision_90b"
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
    return vlm_from_arrays(tcfg, arrays(test_seed), "cpu")


@pytest.fixture
def flash(monkeypatch):
    """Set both packages' flash switch."""
    def set_(on: bool):
        monkeypatch.setattr(jattn, "USE_FLASH_KERNEL", on)
        monkeypatch.setattr(tattn, "USE_FLASH_KERNEL", on)
    return set_


def _batch(seed, tokens=40, image=8, d=64):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (2, tokens)).astype(np.int32),
            "vision": rng.standard_normal((2, image, d)).astype(np.float32)}


def _jax(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else v.dtype)
            for k, v in batch.items()}


def _torch(batch, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) if v.dtype == np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def _p32(seed):
    return jax.tree.map(lambda a: a.astype(jnp.float32), jparams(seed))


def _cross0(seed, dtype):
    """Superblock 0's cross block: (jax tree, port tree of tensors)."""
    jd, td = DT[dtype]
    jl = jax.tree.map(lambda a: a[0].astype(jd), jparams(seed)["cross_blocks"])
    tl = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(td), jl)
    return jl, tl


# ---------------------------------------------------------------------------
# cross-attention and the gated cross block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_attention_matches_reference(tcfg, dtype, masked, test_seed):
    """10 queries over 12 memory rows with GQA (4 heads over 2 kv heads),
    with and without ``memory_valid`` (the last rows of slot 1 hidden),
    through a query chunk of 4."""
    from repro.layers.attention import cross_attention as jax_cross_attention

    assert tcfg.n_kv < tcfg.n_heads
    jd, td = DT[dtype]
    jl, tl = _cross0(test_seed, dtype)
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 12, 64)).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones((2, 12), bool)
        valid[1, 7:] = False
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv, head_dim=tcfg.head_dim,
              q_chunk=4)
    want = jax_cross_attention(
        jl["xattn"], jnp.asarray(x, jd), jnp.asarray(mem, jd),
        memory_valid=None if valid is None else jnp.asarray(valid), **kw)
    got = cross_attention(
        tl["xattn"], torch.from_numpy(x).to(td), torch.from_numpy(mem).to(td),
        memory_valid=None if valid is None else torch.from_numpy(valid), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_cross_block_matches_reference(tcfg, tmodel, dtype, test_seed):
    """The gated cross block (RMS norm, cross-attention, tanh(gate), RMS
    norm, SwiGLU) with its drawn gate, against ``blocks.cross_block``."""
    jd, td = DT[dtype]
    jl, _ = _cross0(test_seed, dtype)
    assert float(jl["gate"][0]) > 0.4
    blk = vlm_from_arrays(tcfg, arrays(test_seed, fp32=dtype == "fp32"),
                          "cpu").cross_blocks[0]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 10, 64)).astype(np.float32)
    mem = rng.standard_normal((2, 8, 64)).astype(np.float32)
    want = jax_cross_block(jl, jnp.asarray(x, jd), jnp.asarray(mem, jd),
                           jcfg())
    got = blk(torch.from_numpy(x).to(td), torch.from_numpy(mem).to(td),
              tcfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# the config, the bridge
# ---------------------------------------------------------------------------


def test_configs_equal_reference_field_by_field(tcfg):
    for got, want in ((get_config(ARCH), jax_get_config(ARCH)),
                      (tcfg, jcfg())):
        for field in type(want).__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), field


def test_parameter_count_at_the_chip_cut():
    """Full width cut to 6 of 20 superblocks (the card's run), from the
    meta device: 27,770,986,502 parameters, 55.5 GB in bf16; the whole
    model 87.7 B."""
    full = get_config(ARCH)
    counts = {n: sum(p.numel() for p in build_model(
        full.with_(n_layers=n), device="meta").parameters())
        for n in (30, 100)}
    assert counts[30] == 27_770_986_502
    assert 87.6e9 < counts[100] < 87.8e9


def test_bridge_round_trip(tcfg, tmodel, test_seed):
    """Every port parameter holds the reference leaf's slice bit for bit:
    ``self_blocks`` [n_super, self_per_block, ...] to ``[s][e]``,
    ``cross_blocks`` [n_super, ...] to ``[s]``, the drawn gates among
    them."""
    tree = arrays(test_seed)
    n_super, spb = tmodel.n_super, tmodel.self_per_block
    assert (n_super, spb) == (2, 1)
    n = 0
    for name, p in tmodel.named_parameters():
        parts = name.split(".")
        if parts[0] == "self_blocks":
            s, e = int(parts[1]), int(parts[2])
            leaf = functools.reduce(lambda t, k: t[k], parts[3:],
                                    tree["self_blocks"])[s, e]
        elif parts[0] == "cross_blocks":
            leaf = functools.reduce(lambda t, k: t[k], parts[2:],
                                    tree["cross_blocks"])[int(parts[1])]
        else:
            leaf = functools.reduce(lambda t, k: t[k], parts, tree)
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(leaf, np.float32), name)
        n += 1
    selfs = len(jax.tree.leaves(tree["self_blocks"]))
    cross = len(jax.tree.leaves(tree["cross_blocks"]))
    assert n == len(jax.tree.leaves(tree)) + selfs * (n_super * spb - 1) \
        + cross * (n_super - 1)
    assert all(float(blk.gate) >= 0.5 for blk in tmodel.cross_blocks)
    assert isinstance(model_from_arrays(tcfg, tree, "cpu"), VisionLM)


def test_bridge_rejects_a_malformed_tree(tcfg, test_seed):
    tree = arrays(test_seed)
    cross = dict(tree["cross_blocks"])
    del cross["gate"]
    with pytest.raises(KeyError, match="cross_blocks.0.gate"):
        vlm_from_arrays(tcfg, dict(tree, cross_blocks=cross), "cpu")
    flat = jax.tree.map(lambda a: a[:, 0], tree["self_blocks"])
    with pytest.raises(ValueError, match="self_per_block"):
        vlm_from_arrays(tcfg, dict(tree, self_blocks=flat), "cpu")


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_forward_fp32_logits(tcfg, flash, on, test_seed, monkeypatch):
    """fp32 logits of tokens [2, 40] over vision [2, 8] with the drawn
    gates; with flash on, the self blocks' causal attention takes the
    flash wrapper in both packages and the cross-attention (40 queries
    over 8 patches) the plain path."""
    flash(on)
    seen = []
    real = tattn.flash_attention

    def spy(q, k, v, *, causal=True, **kw):
        seen.append(causal)
        return real(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(tattn, "flash_attention", spy)
    model = vlm_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    batch = _batch(8)
    want = np.asarray(jax_build_model(jcfg()).forward(
        _p32(test_seed), _jax(batch)))
    got = model(_torch(batch))
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    assert seen == ([True] * 2 if on else [])


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
    assert robust.sum() >= 40
    np.testing.assert_array_equal(got.argmax(-1)[robust],
                                  want.argmax(-1)[robust])


def test_the_gates_reach_the_logits(tcfg, test_seed):
    """With the drawn gates the cross-attention moves the logits; with the
    reference's zero gates it adds nothing, in both packages alike."""
    batch = _batch(10)
    model = vlm_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    gated = model(_torch(batch))
    zero_tree = dict(arrays(test_seed, fp32=True))
    zero_tree["cross_blocks"] = dict(zero_tree["cross_blocks"],
                                     gate=np.zeros((2, 1), np.float32))
    ungated = vlm_from_arrays(tcfg, zero_tree, "cpu")(_torch(batch))
    assert (gated - ungated).abs().mean() > 1e-2
    want = np.asarray(jax_build_model(jcfg()).forward(
        jax.tree.map(jnp.asarray, zero_tree), _jax(batch)))
    np.testing.assert_allclose(ungated.numpy(), want, **FP32)


def test_prefill_step_takes_vision(tcfg, tmodel):
    plan = build_plan(ARCH, ShapeSpec("p", 24, 2, "prefill"), debug=True,
                      device="cpu")
    plan.load_params(tmodel)
    exe = plan.executable("prefill")
    batch = _torch(_batch(11, tokens=24), torch.bfloat16)
    assert torch.equal(exe.fn(plan.model, batch), tmodel(batch))
    with pytest.raises(ValueError, match="built for"):
        exe.fn(plan.model, dict(batch, vision=batch["vision"][:, :4]))
    with pytest.raises(ValueError, match="vision"):
        exe.fn(plan.model, {"tokens": batch["tokens"]})


# ---------------------------------------------------------------------------
# decode, dense and paged; the cross cache
# ---------------------------------------------------------------------------


def _flat(a):
    """The reference's [n_super, self_per_block, ...] KV leaf as the
    port's [n_super * self_per_block, ...]."""
    a = np.asarray(a, np.float32)
    return a.reshape(-1, *a.shape[2:])


@pytest.mark.parametrize("cross", ["zero", "filled"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_step_matches_reference(tcfg, paged, cross, test_seed):
    """Six decode steps in fp32: the logits and every state leaf (the KV
    caches flattened from the reference's two layer axes). The cross
    caches are the zeros serving leaves them at, or random values in both
    packages; paged, the slots' pages are interleaved in a pool of 8 and
    slot 1 starts at local position 2."""
    jm = jax_build_model(jcfg())
    model = vlm_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
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
        "cache_k": (2, *per_slot, 2, 16), "cache_v": (2, *per_slot, 2, 16),
        "cross_k": (2, B, 8, 2, 16), "cross_v": (2, B, 8, 2, 16)}
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
        for name in ("cache_k", "cache_v"):
            np.testing.assert_allclose(tstate[name].numpy(),
                                       _flat(jstate[name]), **FP32)
        for name in ("cross_k", "cross_v"):
            np.testing.assert_allclose(tstate[name].numpy(),
                                       np.asarray(jstate[name]), **FP32)


def test_init_cross_cache_matches_reference(tcfg, test_seed):
    model = vlm_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    vision = _batch(13)["vision"]
    jk, jv = jax_build_model(jcfg()).init_cross_cache(
        _p32(test_seed), jnp.asarray(vision))
    tk, tv = model.init_cross_cache(torch.from_numpy(vision))
    assert tk.shape == (2, 2, 8, 2, 16) and tk.dtype == torch.float32
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **TOL["fp32"])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL["fp32"])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_over_init_cross_cache_equals_forward(tcfg, paged,
                                                     test_seed):
    """Decode steps over the cross cache of the patch embeddings give the
    forward's logits at the same positions (the cross-attention does not
    mix positions), dense and paged, fp32."""
    model = vlm_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    batch = _torch(_batch(14, tokens=12))
    want = model(batch)
    L, ps = 16, 4
    state = {k: v.float() for k, v in model.decode_state(
        2, L, paged=(8, ps) if paged else None).items()}
    state["cross_k"], state["cross_v"] = model.init_cross_cache(
        batch["vision"])
    table = torch.tensor([[6, 1, 4, 3], [2, 7, 0, 5]], dtype=torch.int32)
    for i in range(12):
        kw = ({"pages": PageView(table, torch.tensor([i, i]), ps)}
              if paged else {})
        logits, _ = model.decode_step(state, batch["tokens"][:, i], i, **kw)
        np.testing.assert_allclose(logits.numpy(), want[:, i].numpy(),
                                   **FP32)


def test_decode_state_halves_and_no_draft(tmodel):
    dense = tmodel.decode_state(3, 32, paged=(10, 8), only="dense")
    pool = tmodel.decode_state(3, 32, paged=(10, 8), only="pool")
    assert set(dense) == {"cross_k", "cross_v"}
    assert set(pool) == {"cache_k", "cache_v"}
    assert dense["cross_k"].shape == (2, 3, 8, 2, 16)
    assert pool["cache_k"].shape == (2, 10, 8, 2, 16)
    with pytest.raises(ValueError, match="decode_block"):
        tmodel.decode_state(3, 32, draft_layers=1)


# ---------------------------------------------------------------------------
# the quantized plan: the self blocks' downs through qmatmul, all else float
# ---------------------------------------------------------------------------


def test_calibrated_shifts_match_reference(test_seed, monkeypatch):
    """The reference's calibration takes ``w_shift`` over every
    ``ffn/down`` weight, the cross blocks' too, and observes every float
    SwiGLU call of a short decode, the cross blocks' included: the port's
    calibrated shifts equal the reference's, and a calibration step
    observes the SwiGLU of each self and each cross block."""
    import repro_torch.layers.mlp as tmlp
    from repro.launch.mesh import make_debug_mesh
    from repro.plan import build_plan as jax_build_plan

    mesh = make_debug_mesh(1, 1)
    jplan = jax_build_plan(jcfg(), None, mesh_spec=mesh, quantized=True)
    with mesh:
        jplan.shard_params(jparams(test_seed))
    plan = build_plan(ARCH, None, debug=True, quantized=True, device="cpu")
    model = plan.load_params(arrays(test_seed))
    assert plan.ir.quant["calibrated"] and jplan.ir.quant["calibrated"]
    assert plan.ir.quant["mlp_shifts"] == jplan.ir.quant["mlp_shifts"]
    assert len(model.mlp_down_weights()) == 4        # 2 self + 2 cross
    seen = []
    real = tmlp._observe
    monkeypatch.setattr(tmlp, "_observe", lambda record, key, x: (
        seen.append(key), real(record, key, x))[1])
    monkeypatch.setattr(model, "cfg", plan.cfg.with_(quantized=False,
                                                     quantized_mlp=False))
    with tmlp.swiglu_calibration({}):
        model.decode_step(model.decode_state(2, 8),
                          torch.tensor([1, 2], dtype=torch.int32), 0)
    n_ffn = model.n_super * (model.self_per_block + 1)
    assert seen == ["act", "out"] * n_ffn


def test_quantized_decode_step_launches_the_self_downs_only(test_seed,
                                                            monkeypatch):
    """A quantized decode step runs qmatmul once per self block's
    down-projection (self_per_block x n_super) and not for the head or the
    cross blocks' SwiGLU (the plain version stands in on the CPU)."""
    import repro_torch.layers.linear as tlinear

    calls = []
    real = tlinear.qlinear
    monkeypatch.setattr(tlinear, "qlinear",
                        lambda x, w, *a, **k: (calls.append(
                            (tuple(x.shape), tuple(w.shape))),
                            real(x, w, *a, **k))[1])
    plan = build_plan(ARCH, None, debug=True, quantized=True, device="cpu")
    model = plan.load_params(arrays(test_seed))
    calls.clear()
    model.decode_step(model.decode_state(2, 8),
                      torch.tensor([3, 4], dtype=torch.int32), 0)
    assert calls == [((2, 128), (128, 64))] * (model.self_per_block
                                               * model.n_super)


def test_speculative_raises_the_reference_message():
    from repro.serve.validation import resolve_speculative as jax_resolve

    msg = re.escape("family 'vlm' has no block-verify decode path "
                    "(decode_block); speculative lanes need one")
    kw = dict(schedule="continuous", steps_per_dispatch=4, n_layers=4)
    with pytest.raises(ValueError, match=msg):
        jax_resolve(4, None, model=jax_build_model(jcfg()), family="vlm",
                    **kw)
    with pytest.raises(ValueError, match=msg):
        resolve_speculative(4, None, family="vlm", **kw)
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
    over the zero cross caches serving leaves (in both packages): equal
    streams up to the gap rule, slots refilled (continuous), every page
    back but scratch and prefix pages (paged)."""
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
    wave 2 maps wave 1's published page and skips 16 prompt tokens; the
    prefix cache is sound here (only the self-attention KV is paged)."""
    page = PAGED[1]
    want, gaps, _ = family_reference(ARCH, test_seed, False, "continuous",
                                     4, True, "shared")
    b, got = family_port_streams(ARCH, test_seed, False, "continuous", 4,
                                 True, SHARED_TRACE)
    s = b.stats()["paged"]
    assert s["prefix_hits"] == 2 and s["skipped_prefill_tokens"] == 2 * page
    assert assert_gap_streams(got, want, gaps, MIN_GAP, "shared") >= 11


def test_serve_cli_vlm(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "llama-3.2-vision-90b", "--debug", "--device", "cpu",
          "--schedule", "continuous", "--steps-per-dispatch", "4",
          "--paged", "--quantized", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "llama-3.2-vision-90b on cpu" in out and "paged:" in out
    assert out.rstrip().endswith("builds=1")
