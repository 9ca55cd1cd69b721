"""The port's dense decoder LM against the JAX package's, on the CPU.

Reduced yi-6b config (4 layers, d_model 64, 4 heads, kv 2, hd 16, vocab
256). The weights are initialised by the JAX package and carried across
with ``decoder_lm_from_arrays``; inputs come from numpy seeds. The JAX
flash function runs in interpret mode when a test switches
``repro.layers.attention.USE_FLASH_KERNEL`` on.

Tolerances: fp32 layers 1e-5 (fp32 logits 1e-4, after four layers);
bf16 layers 2e-2; integer paths exact. Greedy token streams are compared
on gap-robust prompts only: both packages round to bf16 at the same
places but sum in other orders, so a top-2 logit gap below that noise
(or the int8 quantization noise, ~0.05) may flip, as the reference's own
contract says (src/repro/models/base.py:266-269). The prompts below keep
every top-2 gap of the reference's float and quantized streams above
0.09 at weight seed 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.layers.attention as jattn
import repro_torch.layers.attention as tattn
from repro.configs import reduced_config as jax_reduced_config
from repro.dist.sharding import init_params
from repro.launch.mesh import make_debug_mesh
from repro.layers.linear import linear as jax_linear
from repro.layers.linear import quantized_linear as jax_quantized_linear
from repro.layers.mlp import swiglu as jax_swiglu
from repro.layers.norm import rmsnorm as jax_rmsnorm
from repro.layers.rope import apply_rope as jax_apply_rope
from repro.layers.rope import rope_freqs as jax_rope_freqs
from repro.models import build_model as jax_build_model
from repro.plan import build_plan as jax_build_plan
from repro.serve import DecodeRequest as JaxDecodeRequest
from repro.serve import ServeBatcher as JaxServeBatcher
from repro_torch.bridge import decoder_lm_from_arrays
from repro_torch.configs import get_config, reduced_config
from repro_torch.layers.attention import decode_self_attention, self_attention
from repro_torch.layers.linear import linear, quantize_weight, quantized_linear
from repro_torch.layers.mlp import swiglu
from repro_torch.layers.norm import rmsnorm
from repro_torch.layers.rope import apply_rope, rope_freqs
from repro_torch.models import ArchConfig, build_model
from repro_torch.plan import build_plan
from repro_torch.serve import Bucket, BucketPolicy, DecodeRequest

ROBUST_PROMPTS = [[7, 3], [160, 175, 229, 148], [213, 58, 15, 77],
                  [25, 50], [125, 1, 158], [130, 157, 223, 175]]
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=2e-2)}
DT = {"fp32": (jnp.float32, torch.float32, np.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16, np.float32)}


@pytest.fixture(scope="module")
def jcfg():
    return jax_reduced_config("yi_6b")


@pytest.fixture(scope="module")
def tcfg():
    return reduced_config("yi_6b")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return init_params(jax.random.PRNGKey(0),
                       jax_build_model(jcfg).param_specs())


@pytest.fixture(scope="module")
def arrays(jparams):
    """The reference's parameter tree as numpy arrays (bf16 kept)."""
    return jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def tmodel(tcfg, arrays):
    return decoder_lm_from_arrays(tcfg, arrays, "cpu")


@pytest.fixture
def flash(monkeypatch):
    """Set both packages' flash switch."""
    def set_(on: bool):
        monkeypatch.setattr(jattn, "USE_FLASH_KERNEL", on)
        monkeypatch.setattr(tattn, "USE_FLASH_KERNEL", on)
    return set_


def _layer0(jparams, dtype):
    """Block 0's parameters: (jax tree, port tree of torch tensors)."""
    jd, td, _ = DT[dtype]
    jl = jax.tree.map(lambda a: a[0].astype(jd), jparams["blocks"])
    tl = jax.tree.map(lambda a: torch.from_numpy(
        np.array(a, np.float32)).to(td), jl)
    return jl, tl


def _x(shape, dtype, seed=0):
    jd, td, _ = DT[dtype]
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rmsnorm_linear_swiglu(jparams, dtype):
    jl, tl = _layer0(jparams, dtype)
    jx, tx = _x((2, 5, 64), dtype)
    _close(rmsnorm(tl["ln1"], tx), jax_rmsnorm(jl["ln1"], jx), dtype)
    _close(linear(tl["attn"]["wq"], tx), jax_linear(jl["attn"]["wq"], jx),
           dtype)
    _close(swiglu(tl["ffn"], tx), jax_swiglu(jl["ffn"], jx), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_apply_rope(dtype):
    jx, tx = _x((2, 7, 4, 16), dtype, seed=1)
    pos = np.random.default_rng(2).integers(0, 300, (2, 7)).astype(np.int32)
    want = jax_apply_rope(jx, jnp.asarray(pos), jax_rope_freqs(16, 5e6))
    got = apply_rope(tx, torch.from_numpy(pos), rope_freqs(16, 5e6))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_self_attention(jparams, tcfg, flash, dtype, on):
    flash(on)
    jl, tl = _layer0(jparams, dtype)
    jx, tx = _x((2, 40, 64), dtype, seed=3)   # 40 > q_chunk: chunked path
    pos = np.broadcast_to(np.arange(40), (2, 40)).astype(np.int32)
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv, head_dim=tcfg.head_dim,
              rope_theta=tcfg.rope_theta, q_chunk=8)
    want = jattn.self_attention(jl["attn"], jx, jnp.asarray(pos), **kw)
    got = self_attention(tl["attn"], tx, torch.from_numpy(pos), **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_decode_self_attention_with_window(jparams, tcfg, dtype):
    jl, tl = _layer0(jparams, dtype)
    B, S = 3, 12
    ck, cv = (np.random.default_rng(s).standard_normal(
        (B, S, tcfg.n_kv, tcfg.head_dim)).astype(np.float32) for s in (4, 5))
    jx, tx = _x((B, 1, 64), dtype, seed=6)
    start = np.array([0, 3, 6], np.int32)
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv, head_dim=tcfg.head_dim,
              rope_theta=tcfg.rope_theta)
    jd, td, _ = DT[dtype]
    want, wk, wv = jattn.decode_self_attention(
        jl["attn"], jx, jnp.asarray(ck, jd), jnp.asarray(cv, jd),
        jnp.int32(7), window_start=jnp.asarray(start), **kw)
    tck, tcv = torch.from_numpy(ck).to(td), torch.from_numpy(cv).to(td)
    got, gk, gv = decode_self_attention(
        tl["attn"], tx, tck, tcv, 7, window_start=torch.from_numpy(start),
        **kw)
    assert gk is tck and gv is tcv                  # written in place
    _close(got, want, dtype)
    _close(gk, wk, dtype)
    _close(gv, wv, dtype)


@pytest.mark.parametrize("name,kw", [
    ("int8 head", dict(x_shift=5, w_shift=8, out_shift=11, out_dtype="int16",
                       out_float_dtype="f32")),
    ("a16w8 down", dict(x_shift=11, w_shift=8, out_shift=12, x_dtype="int16",
                        out_dtype="int16")),
])
def test_quantized_linear_is_bit_exact(arrays, name, kw):
    """Same float input and weight, same dequantized output, bit for bit;
    and a weight quantized once at load gives the same bits."""
    w = np.asarray(arrays["head"]["w"] if "head" in name
                   else arrays["blocks"]["ffn"]["down"]["w"][0], np.float32)
    x = np.random.default_rng(7).standard_normal((3, w.shape[0])).astype(
        np.float32) * (2.0 if "head" in name else 0.5)
    jkw = dict(kw, out_float_dtype=jnp.float32) if "out_float_dtype" in kw \
        else kw
    tkw = dict(kw, out_float_dtype=torch.float32) if "out_float_dtype" in kw \
        else kw
    want = jax_quantized_linear({"w": jnp.asarray(w, jnp.bfloat16)},
                                jnp.asarray(x, jnp.bfloat16), **jkw)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = quantized_linear({"w": tw}, tx, **tkw)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    once = quantized_linear({"w": tw}, tx, wq=quantize_weight(tw, 8), **tkw)
    assert torch.equal(once, got)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_forward_fp32_logits(jcfg, tcfg, jparams, flash, on):
    flash(on)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    model = decoder_lm_from_arrays(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
        "cpu")
    toks = np.random.default_rng(8).integers(0, 256, (2, 40)).astype(np.int32)
    want = np.asarray(jax_build_model(jcfg).forward(
        p32, {"tokens": jnp.asarray(toks)}))
    got = model({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_forward_bf16_argmax(jcfg, jparams, tmodel, flash, on):
    flash(on)
    toks = np.random.default_rng(9).integers(0, 256, (2, 40)).astype(np.int32)
    want = np.asarray(jax_build_model(jcfg).forward(
        jparams, {"tokens": jnp.asarray(toks)}))
    got = tmodel({"tokens": torch.from_numpy(toks)}).numpy()
    assert np.isfinite(got).all()
    top2 = np.sort(want, axis=-1)[..., -2:]
    robust = top2[..., 1] - top2[..., 0] > 0.1
    assert robust.sum() >= 40
    np.testing.assert_array_equal(got.argmax(-1)[robust],
                                  want.argmax(-1)[robust])
    np.testing.assert_allclose(got, want, atol=0.25)


def test_decode_step_greedy_streams(jcfg, jparams, tmodel):
    """Teacher-force the prompts, then 8 greedy steps, in both packages."""
    jm = jax_build_model(jcfg)
    B, P = len(ROBUST_PROMPTS), 4
    prompt = np.zeros((B, P), np.int32)
    lengths = np.array([len(p) for p in ROBUST_PROMPTS])
    for b, p in enumerate(ROBUST_PROMPTS):
        prompt[b, :len(p)] = p
    jstate = init_params(jax.random.PRNGKey(0), jm.decode_state_specs(B, 16))
    tstate = tmodel.decode_state(B, 16)
    step = jax.jit(jm.decode_step)
    jt, tt = [], []
    jprev = tprev = None
    for i in range(P + 7):
        feed = prompt[:, min(i, P - 1)]
        jtok = np.where(i < lengths, feed, jprev) if i else feed
        ttok = np.where(i < lengths, feed, tprev) if i else feed
        jl, jstate = step(jparams, jstate, jnp.asarray(jtok, jnp.int32),
                          jnp.int32(i))
        tl, tstate = tmodel.decode_step(tstate, torch.from_numpy(
            ttok.astype(np.int32)), i)
        jprev = np.asarray(jl).argmax(-1)
        tprev = tl.argmax(-1).numpy()
        jt.append(jprev)
        tt.append(tprev)
    gen = slice(P - 1, P + 7)     # the 8 generated steps of every prompt
    np.testing.assert_array_equal(np.stack(tt)[gen], np.stack(jt)[gen])


def test_calibrated_shifts_match_reference(jcfg, jparams, arrays):
    mesh = make_debug_mesh(1, 1)
    jplan = jax_build_plan(jcfg, None, mesh_spec=mesh, quantized=True)
    with mesh:
        jplan.shard_params(jparams)
    plan = build_plan("yi-6b", None, debug=True, quantized=True,
                      device="cpu")
    plan.load_params(arrays)
    assert plan.ir.quant["calibrated"] and jplan.ir.quant["calibrated"]
    assert plan.ir.quant["mlp_shifts"] == jplan.ir.quant["mlp_shifts"]
    assert plan.model.cfg.mlp_x_shift == jplan.cfg.mlp_x_shift


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_fifo_batcher_matches_reference(jcfg, jparams, arrays, quantized):
    mesh = make_debug_mesh(1, 1)
    with mesh:
        jb = JaxServeBatcher(jcfg, mesh, quantized=quantized
                             ).load_params(jparams)
        for i, p in enumerate(ROBUST_PROMPTS):
            jb.submit(JaxDecodeRequest(f"r{i}", p, max_new_tokens=8))
        want = {k: v.tokens for k, v in jb.run().items()}
    plan = build_plan("yi-6b", None, debug=True, quantized=quantized,
                      device="cpu")
    batcher = plan.make_batcher()
    batcher.load_params(arrays)
    waves = []
    for wave in range(2):
        for i, p in enumerate(ROBUST_PROMPTS):
            batcher.submit(DecodeRequest(f"r{i}", p, max_new_tokens=8))
        waves.append({k: v.tokens for k, v in batcher.run().items()})
        if wave == 0:
            cold = dict(batcher.cache.stats())
    assert waves[0] == want
    assert waves[1] == waves[0]
    warm = batcher.cache.stats()
    assert warm["hits"] > cold["hits"] and warm["builds"] == cold["builds"]
    assert all(k.quantized == quantized for k in batcher.cache._entries)
    pool = batcher.pool.stats()["2x64"]
    assert pool["in_use"] == 0 and pool["reused"] > 0


# ---------------------------------------------------------------------------
# API surface
# ---------------------------------------------------------------------------


def test_only_the_dense_yi_6b_is_ported(tcfg):
    assert get_config("yi-6b").d_model == 4096
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        get_config("qwen1.5-4b")
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        build_model(tcfg.with_(family="moe"), device="cpu")


def test_serving_features_not_ported_raise():
    plan = build_plan("yi-6b", None, debug=True, device="cpu")
    for kw in (dict(schedule="continuous"), dict(paged=True),
               dict(speculative=4), dict(admission=object())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            plan.make_batcher(**kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        plan.serve_executable("masked_decode", batch=2, max_len=64)


def test_bridge_rejects_a_malformed_tree(tcfg, arrays):
    bad = dict(arrays, head={})
    with pytest.raises(KeyError, match="head.w"):
        decoder_lm_from_arrays(tcfg, bad, "cpu")
    short = jax.tree.map(lambda a: a, arrays)
    short["blocks"] = jax.tree.map(lambda a: a[:2], arrays["blocks"])
    with pytest.raises(ValueError, match="n_layers"):
        decoder_lm_from_arrays(tcfg, short, "cpu")


def test_bridge_keeps_dtypes_and_bits(tmodel, arrays):
    got = tmodel.blocks[2].ffn["down"]["w"]
    want = np.asarray(arrays["blocks"]["ffn"]["down"]["w"][2], np.float32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_init_params_is_seeded_and_scaled(tcfg):
    a = build_model(tcfg, device="cpu").init_params(3)
    b = build_model(tcfg, device="cpu").init_params(3)
    for (n, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), n
    w = a.blocks[0].ffn["down"]["w"].float()
    assert abs(w.std().item() * tcfg.d_ff ** 0.5 - 1) < 0.05
    assert torch.equal(a.ln_f["scale"], torch.ones_like(a.ln_f["scale"]))


def test_plan_records_its_passes():
    plan = build_plan("yi-6b", None, debug=True, quantized=True,
                      device="cpu")
    assert plan.ir.pass_names() == ["ResolveDevice", "Quantize", "Compile"]
    d = plan.describe()
    assert d["quant"]["mlp"] and d["device"] == "cpu"
    assert sorted(d["executables"]) == ["decode", "prefill"]
    assert isinstance(plan.cfg, ArchConfig)


def test_prefill_executable_is_forward(tmodel):
    from repro_torch.models.base import ShapeSpec

    plan = build_plan("yi-6b", ShapeSpec("p", 24, 2, "prefill"), debug=True,
                      device="cpu")
    plan.load_params(tmodel)
    exe = plan.executable("prefill")
    toks = torch.randint(0, 256, (2, 24))
    assert torch.equal(exe.fn(plan.model, {"tokens": toks}),
                       tmodel({"tokens": toks}))
    assert plan.executable("prefill") is exe
    assert plan.cache.stats()["hits"] == 1
    with pytest.raises(ValueError, match="built for"):
        exe.fn(plan.model, {"tokens": toks[:, :8]})


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "yi-6b", "--debug", "--tokens", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "hits=2" in out and "builds=2" in out
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        main(["--arch", "yi-6b", "--debug", "--device", "cpu", "--stream"])


def test_state_pool_zeroes_on_reuse_and_wipes_slots(tmodel):
    plan = build_plan("yi-6b", None, debug=True, device="cpu")
    plan.load_params(tmodel)
    batcher = plan.make_batcher(policy=BucketPolicy([Bucket(16, 3)]))
    pool = batcher.pool
    s = pool.acquire(3, 16)
    for leaf in s.values():
        leaf.fill_(1)
    pool.reset_slots(3, 16, s, [False, True, False])
    assert not s["cache_k"][:, 1].any() and s["cache_k"][:, 0].all()
    pool.release(3, 16, s)
    s2 = pool.acquire(3, 16)
    assert s2 is s and not s2["cache_v"].any()
    st = pool.stats()["3x16"]
    assert st["created"] == 1 and st["reused"] == 1 and st["slots_wiped"] == 1


def test_lm_entry_points_default_to_the_card(monkeypatch, tcfg, arrays):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_plan("yi-6b", None, debug=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        decoder_lm_from_arrays(tcfg, arrays)
