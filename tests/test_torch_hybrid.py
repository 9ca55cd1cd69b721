"""The port's hybrid family (Mamba2 + one shared attention block,
``HybridModel``) against the JAX package's, on the CPU: the config, the
bridge, prefill, decode (dense and paged), calibration, the serving
paths, and the port faults this family sets off (the per-family
``reduced_config`` overrides, the speculative family check, the flash
routing).

Reduced zamba2 (4 Mamba2 layers in 2 groups, d_model 64, 4 heads of dim
16, ssm state 8, vocab 256) with the reference's weights, carried across
with ``hybrid_from_arrays``. Tolerances: logits and states in fp32 atol =
rtol = 1e-4 (prefill and 6 decode steps); bf16 prefill argmax equal where
the reference's top-2 gap exceeds 0.2, logits within mean 0.05 and atol
0.5, since the reference's scans compile their bodies and XLA keeps excess
precision inside a fusion, which moves bf16 logits by about 0.02 on
average and up to about 0.35 at this depth; integer shifts equal.

Serving streams are held to the reference's own streams in the same mode
(fifo, continuous k 1/2/4 and paged k 1/4, float and quantized), up to the
first step whose gap falls below ``MIN_GAP``; the gaps come from a JAX
greedy loop from position 0 teacher-forced along the reference's streams.
The reference's continuous k = 4 streams differ from its fifo streams
(tests/test_scheduler.py::test_continuous_matches_fifo_on_hybrid_ssm[4]
is red), which is why the port is held to each mode's own streams.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serve_ref import PARITY_TRACE, SHARED_TRACE, waves

import repro.layers.attention as jattn
import repro_torch.layers.attention as tattn
from repro.configs import reduced_config as jax_reduced_config
from repro.dist.sharding import init_params
from repro.launch.mesh import make_debug_mesh
from repro.models import build_model as jax_build_model
from repro.models.base import PageView as JaxPageView
from repro.models.base import paged_state_specs
from repro_torch.bridge import hybrid_from_arrays, model_from_arrays
from repro_torch.configs import reduced_config
from repro_torch.models.base import PageView, wipe_state_slots
from repro_torch.models.hybrid import HybridModel
from repro_torch.plan import build_plan
from repro_torch.serve import Bucket, BucketPolicy, DecodeRequest
from repro_torch.serve.validation import resolve_speculative

ARCH = "zamba2_2_7b"
BUCKET = Bucket(64, 2)
PAGED = (64, 16)            # tests/test_paged_serve.py
# the reference's compiled scans keep excess bf16 precision, which moves a
# decode logit by up to about 0.05 against the port's eager rounding (a
# 0.047 gap flips on the parity trace), and a continuous slot decodes at
# another absolute position than the gap loop from 0; steps whose
# reference gap is below this are left out of the comparison (the value
# chip_smoke.py uses against its plain loop)
MIN_GAP = 0.1
FP32 = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def jcfg():
    return jax_reduced_config(ARCH)


@functools.lru_cache(maxsize=None)
def jparams(seed):
    return init_params(jax.random.PRNGKey(seed),
                       jax_build_model(jcfg()).param_specs())


@functools.lru_cache(maxsize=None)
def arrays(seed, fp32=False):
    """The reference's tree as numpy arrays (bf16 kept, or fp32)."""
    if fp32:
        return jax.tree.map(lambda a: np.asarray(a, np.float32),
                            jparams(seed))
    return jax.tree.map(np.asarray, jparams(seed))


@pytest.fixture(scope="module")
def tcfg():
    return reduced_config(ARCH)


@pytest.fixture(scope="module")
def tmodel(tcfg, test_seed):
    return hybrid_from_arrays(tcfg, arrays(test_seed), "cpu")


@pytest.fixture
def flash(monkeypatch):
    """Set both packages' flash switch."""
    def set_(on: bool):
        monkeypatch.setattr(jattn, "USE_FLASH_KERNEL", on)
        monkeypatch.setattr(tattn, "USE_FLASH_KERNEL", on)
    return set_


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


# ---------------------------------------------------------------------------
# the config: the reference's per-family overrides
# ---------------------------------------------------------------------------


def test_reduced_zamba2_equals_the_reference_field_by_field(tcfg):
    want = jax_reduced_config(ARCH)
    for field in type(want).__dataclass_fields__:
        assert getattr(tcfg, field) == getattr(want, field), field
    assert tcfg.family == "hybrid" and tcfg.n_layers % tcfg.attn_every == 0


def test_reduced_config_applies_every_familys_overrides(monkeypatch):
    """The port's ``reduced_config`` on each of the reference's full
    configs (moe, vlm, encdec, ssm, hybrid, dense) gives the reference's
    reduced config, field by field."""
    import repro_torch.configs as tconfigs
    from repro.configs import ARCH_IDS, get_config
    from repro_torch.models.base import ArchConfig

    families = set()
    for name in ARCH_IDS:
        full = get_config(name)
        families.add(full.family)
        monkeypatch.setattr(
            tconfigs, "get_config",
            lambda _n, full=full: ArchConfig(**{
                f: getattr(full, f) for f in ArchConfig.__dataclass_fields__}))
        got, want = tconfigs.reduced_config(name), jax_reduced_config(name)
        for field in type(want).__dataclass_fields__:
            assert getattr(got, field) == getattr(want, field), (name, field)
    assert families == {"dense", "moe", "vlm", "encdec", "ssm", "hybrid"}


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------


def test_bridge_round_trip(tcfg, tmodel, test_seed):
    """Every port parameter holds the reference leaf's slice bit for bit,
    in its dtype: ``mamba_blocks`` [G, E, ...] to ``[g][e]``, the shared
    block unstacked."""
    tree = arrays(test_seed)
    G, E = tmodel.n_groups, tcfg.attn_every
    assert (G, E) == (2, 2)
    n = 0
    for name, p in tmodel.named_parameters():
        parts = name.split(".")
        if parts[0] == "mamba_blocks":
            g, e, rest = int(parts[1]), int(parts[2]), parts[3:]
            leaf = functools.reduce(lambda t, k: t[k], rest,
                                    tree["mamba_blocks"])[g, e]
        else:
            leaf = functools.reduce(lambda t, k: t[k], parts, tree)
        assert p.dtype == torch.bfloat16 and not p.requires_grad, name
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(leaf, np.float32), name)
        n += 1
    stacked = len(jax.tree.leaves(tree["mamba_blocks"]))
    assert n == len(jax.tree.leaves(tree)) + stacked * (G * E - 1)
    assert model_from_arrays(tcfg, tree, "cpu").shared_attn is not None


def test_bridge_rejects_a_malformed_tree(tcfg, test_seed):
    tree = arrays(test_seed)
    with pytest.raises(KeyError, match="shared_attn.ln1.scale"):
        hybrid_from_arrays(tcfg, dict(tree, shared_attn=dict(
            tree["shared_attn"], ln1={})), "cpu")
    with pytest.raises(KeyError, match="unexpected"):
        hybrid_from_arrays(tcfg, dict(tree, extra={"w": np.zeros(2)}),
                           "cpu")
    flat = jax.tree.map(lambda a: a[:1], tree["mamba_blocks"])
    with pytest.raises(ValueError, match="attn_every"):
        hybrid_from_arrays(tcfg, dict(tree, mamba_blocks=flat), "cpu")
    bad = dict(tree, head={"w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="head.w"):
        hybrid_from_arrays(tcfg, bad, "cpu")


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_forward_fp32_logits(tcfg, flash, on, test_seed):
    flash(on)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams(test_seed))
    model = hybrid_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    toks = _tokens(8, (2, 40))
    want = np.asarray(jax_build_model(jcfg()).forward(
        p32, {"tokens": jnp.asarray(toks)}))
    got = model({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
def test_forward_bf16_argmax(tmodel, flash, on, test_seed):
    flash(on)
    toks = _tokens(9, (2, 40))
    want = np.asarray(jax_build_model(jcfg()).forward(
        jparams(test_seed), {"tokens": jnp.asarray(toks)}))
    got = tmodel({"tokens": torch.from_numpy(toks)}).numpy()
    assert np.isfinite(got).all()
    top2 = np.sort(want, axis=-1)[..., -2:]
    robust = top2[..., 1] - top2[..., 0] > 0.2
    assert robust.sum() >= 40
    np.testing.assert_array_equal(got.argmax(-1)[robust],
                                  want.argmax(-1)[robust])
    assert np.abs(got - want).mean() < 0.05
    np.testing.assert_allclose(got, want, atol=0.5)


# ---------------------------------------------------------------------------
# decode, dense and paged
# ---------------------------------------------------------------------------


def _flat(a, G, E):
    """The reference's [G, E, B, ...] state leaf as the port's [G*E, B,
    ...]."""
    a = np.asarray(a, np.float32)
    return a.reshape(G * E, *a.shape[2:])


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_step_matches_reference(tcfg, paged, test_seed):
    """Six decode steps from zero state in fp32 (the KV caches too): the
    logits and every new SSM, conv and KV state leaf. Paged, the slots'
    pages are interleaved in a pool of 8 and slot 1 starts at local
    position 2 (its first pages hold another request's rows)."""
    jm = jax_build_model(jcfg())
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams(test_seed))
    model = hybrid_from_arrays(tcfg, arrays(test_seed, fp32=True), "cpu")
    B, L, ps = 2, 16, 4
    sspecs = jm.decode_state_specs(B, L)
    kw = {}
    if paged:
        sspecs = paged_state_specs(sspecs, 8, ps)
        table = np.array([[6, 1, 4, 3], [2, 7, 0, 5]], np.int32)
    jstate = {k: v.astype(jnp.float32) for k, v in
              init_params(jax.random.PRNGKey(0), sspecs).items()}
    tstate = {k: v.float() for k, v in model.decode_state(
        B, L, paged=(8, ps) if paged else None).items()}
    assert {k: tuple(v.shape) for k, v in tstate.items()} == {
        "ssm": (4, B, 8, 16, 8), "conv": (4, B, 3, 128),
        "cache_k": (2,) + ((8, ps) if paged else (B, L)) + (4, 16),
        "cache_v": (2,) + ((8, ps) if paged else (B, L)) + (4, 16)}
    toks = _tokens(11, (6, B))
    G, E = model.n_groups, tcfg.attn_every
    for i in range(6):
        if paged:
            local = np.array([i, i + 2], np.int32)
            kw = dict(jax=dict(pages=JaxPageView(jnp.asarray(table),
                                                 jnp.asarray(local), ps)),
                      port=dict(pages=PageView(torch.from_numpy(table),
                                               torch.from_numpy(local), ps)))
        jl, jstate = jm.decode_step(p32, jstate, jnp.asarray(toks[i]),
                                    jnp.int32(i), **kw.get("jax", {}))
        tl, out = model.decode_step(tstate, torch.from_numpy(toks[i]), i,
                                    **kw.get("port", {}))
        assert out is tstate                     # written in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tstate[name].numpy(),
                                       _flat(jstate[name], G, E), **FP32)
        for name in ("cache_k", "cache_v"):
            np.testing.assert_allclose(tstate[name].numpy(),
                                       np.asarray(jstate[name]), **FP32)


def test_decode_state_halves_and_no_draft(tmodel):
    dense = tmodel.decode_state(3, 32, paged=(10, 8), only="dense")
    pool = tmodel.decode_state(3, 32, paged=(10, 8), only="pool")
    assert set(dense) == {"ssm", "conv"} and set(pool) == {"cache_k",
                                                           "cache_v"}
    assert dense["ssm"].dtype == dense["conv"].dtype == torch.float32
    assert pool["cache_k"].shape == (2, 10, 8, 4, 16)
    assert pool["cache_k"].dtype == torch.bfloat16
    assert not any(v.any() for v in {**dense, **pool}.values())
    with pytest.raises(ValueError, match="decode_block"):
        tmodel.decode_state(3, 32, draft_layers=1)


# ---------------------------------------------------------------------------
# the wipe, the state pool and the fresh lane with dense leaves
# ---------------------------------------------------------------------------


def test_wipe_guards_the_batch_axis():
    """A leaf laid out as the reference's [G, E, B, ...] (batch on axis 2)
    is refused, never wiped across the wrong axis."""
    mask = torch.tensor([False, True, False])
    ok = {"ssm": torch.ones(4, 3, 5)}
    wipe_state_slots(ok, mask, {"ssm": 1})
    assert not ok["ssm"][:, 1].any() and ok["ssm"][:, 0].all()
    for shape in ((2, 2, 3, 5), (4,)):
        with pytest.raises(ValueError, match="batch axis"):
            wipe_state_slots({"ssm": torch.ones(shape)}, mask, {"ssm": 1})


def test_state_pool_keeps_the_dense_leaves_beside_the_page_pool(test_seed):
    """Paged: ``acquire`` returns the SSM and conv leaves with the pool's
    KV leaves, ``reset_slots`` zeroes their lanes (and never touches the
    pool), ``release`` keeps them in the bucket's half, and the step's
    fresh lane zeroes them before anything reads them."""
    plan = build_plan(ARCH, None, debug=True, device="cpu")
    model = plan.load_params(arrays(test_seed))
    b = plan.make_batcher(policy=BucketPolicy([BUCKET]),
                          schedule="continuous", paged=PAGED)
    pool = b.pool
    s = pool.acquire(2, 64)
    assert set(s) == {"ssm", "conv", "cache_k", "cache_v"}
    assert s["cache_k"].shape[1:3] == PAGED
    for leaf in s.values():
        leaf.fill_(1)
    pool.reset_slots(2, 64, s, [False, True])
    assert not s["ssm"][:, 1].any() and s["ssm"][:, 0].all()
    assert not s["conv"][:, 1].any() and s["cache_k"].all()
    pool.release(2, 64, s)
    assert set(pool._pools[(2, 64)].free[0]) == {"ssm", "conv"}
    assert set(pool._pool_leaves) == {"cache_k", "cache_v"}
    s2 = pool.acquire(2, 64)
    assert s2["ssm"] is s["ssm"] and not s2["ssm"].any()
    assert s2["cache_k"] is s["cache_k"] and s2["cache_k"].all()
    # the step's fresh lane: slot 0 wiped in the step, slot 1 not
    s2["ssm"].fill_(3)
    s2["conv"].fill_(3)
    exe = plan.serve_executable("masked_decode", batch=2, max_len=64,
                                paged=PAGED)
    table = torch.arange(8, dtype=torch.int32).view(2, 4)
    fresh = torch.tensor([[True, False]])
    before = s2["ssm"][:, 1].clone()
    exe.fn(plan.model, s2, torch.tensor([[5, -1]], dtype=torch.int32),
           torch.tensor([0, 7], dtype=torch.int32), 0,
           torch.zeros((1, 2), dtype=torch.int32),
           torch.ones((1, 2), dtype=torch.bool), fresh, table)
    # slot 0 restarted from zero state: one step from zeros, as alone
    alone = model.decode_state(1, 64)
    model.decode_step(alone, torch.tensor([5], dtype=torch.int32), 0)
    torch.testing.assert_close(s2["ssm"][:, 0], alone["ssm"][:, 0])
    assert not torch.equal(s2["ssm"][:, 1], before)   # it decoded on
    assert (s2["ssm"][:, 1] != 0).any()
    pool.release(2, 64, s2)


# ---------------------------------------------------------------------------
# quantization: calibration of the shared block, launches per step
# ---------------------------------------------------------------------------


def test_calibrated_shifts_match_reference(test_seed):
    """Calibration walks the one shared block's down-projection (the
    reference walks every ``ffn/down`` leaf): the port's shifts from the
    weights alone equal the reference's (its analytic path; the observed
    path is the same code as the dense LM's, held in test_torch_lm.py),
    and a quantized plan installs its calibrated shifts."""
    from repro.plan.passes import calibrate_mlp_shifts as jax_calibrate
    from repro_torch.plan.passes import calibrate_mlp_shifts

    plan = build_plan(ARCH, None, debug=True, quantized=True, device="cpu")
    model = plan.load_params(arrays(test_seed))
    assert plan.cfg.quantized and plan.cfg.quantized_mlp
    assert plan.ir.quant["calibrated"]
    assert plan.ir.quant["mlp_shifts"] == (plan.cfg.mlp_x_shift,
                                           plan.cfg.mlp_w_shift,
                                           plan.cfg.mlp_out_shift)
    assert [tuple(w.shape) for w in model.mlp_down_weights()] == [(128, 64)]
    want = jax_calibrate(jcfg(), jparams(test_seed))
    assert calibrate_mlp_shifts(plan.cfg, model, observe=False) == want


def test_quantized_decode_step_launches_head_and_shared_down(
        test_seed, monkeypatch):
    """A quantized decode step runs qmatmul once for the head and once per
    shared-block call site (the plain version stands in on the CPU)."""
    import repro_torch.layers.linear as tlinear

    calls = []
    real = tlinear.qlinear
    monkeypatch.setattr(tlinear, "qlinear",
                        lambda x, w, *a, **k: (calls.append(
                            (tuple(x.shape), tuple(w.shape))),
                            real(x, w, *a, **k))[1])
    plan = build_plan(ARCH, None, debug=True, quantized=True, device="cpu")
    model = plan.load_params(arrays(test_seed))
    state = model.decode_state(2, 8)
    calls.clear()
    model.decode_step(state, torch.tensor([3, 4], dtype=torch.int32), 0)
    assert calls == [((2, 128), (128, 64))] * model.n_groups \
        + [((2, 64), (64, 256))]


# ---------------------------------------------------------------------------
# the latent faults: speculative family check, flash routing
# ---------------------------------------------------------------------------


def test_speculative_raises_the_reference_message():
    """A hybrid plan refuses speculative lanes with the reference's
    message, from the batcher and from the resolver, before any
    parameters are loaded; the dense family still resolves."""
    from repro.serve.validation import resolve_speculative as jax_resolve

    msg = re.escape("family 'hybrid' has no block-verify decode path "
                    "(decode_block); speculative lanes need one")
    kw = dict(schedule="continuous", steps_per_dispatch=4, n_layers=4)
    with pytest.raises(ValueError, match=msg):
        jax_resolve(4, None, model=HybridModel, family="hybrid", **kw)
    with pytest.raises(ValueError, match=msg):
        resolve_speculative(4, None, family="hybrid", **kw)
    plan = build_plan(ARCH, None, debug=True, device="cpu")
    with pytest.raises(ValueError, match=msg):
        plan.make_batcher(schedule="continuous", steps_per_dispatch=4,
                          speculative=4)
    assert resolve_speculative(4, None, family="dense", **kw) == (4, 2)
    assert resolve_speculative(0, None, family="hybrid", **kw) is None


# case: (head dim, causal, routed to the flash wrapper)
_MHA_CASES = {"noncausal_ragged": (16, False, False),
              "head_dim_80": (80, True, True),
              "head_dim_96": (96, True, True)}


@pytest.mark.parametrize("case", list(_MHA_CASES))
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mha_runs_where_the_reference_plain_path_runs(monkeypatch, case,
                                                     dtype):
    """With the port's flash switch on (its default) and the reference's
    off (its default), ``mha`` takes a non-causal call with Sq = Sk = 40
    (not a multiple of the reference's block of 32, which its flash wrapper
    refuses, so it runs the plain path) and causal calls at head dim 80
    and 96 (``hd % 8 == 0``, the reference's rule, so they go to the flash
    wrapper: its plain version here on the CPU; on the card 96, which the
    kernel is not built for, raises), and equals the reference's plain
    path: fp32 atol 1e-5, bf16 atol 2e-2."""
    from repro.layers.attention import mha as jax_mha
    from repro_torch.kernels.flash_attention import ops as flash_ops

    monkeypatch.setattr(jattn, "USE_FLASH_KERNEL", False)
    monkeypatch.setattr(tattn, "USE_FLASH_KERNEL", True)
    hd, causal, routed = _MHA_CASES[case]
    assert flash_ops.accepts(40, 40, hd, causal) == routed
    jd, td = {"fp32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    rng = np.random.default_rng(12)
    q, k, v = (jnp.asarray(rng.standard_normal((2, 40, h, hd)), jd)
               for h in (4, 2, 2))
    want = jax_mha(q, k, v, causal=causal)
    got = tattn.mha(*(torch.from_numpy(np.array(a, np.float32)).to(td)
                      for a in (q, k, v)), causal=causal)
    tol = (dict(atol=1e-5, rtol=1e-5) if dtype == "fp32"
           else dict(atol=2e-2, rtol=0.0))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# serving: the reference's streams per mode
# ---------------------------------------------------------------------------


def _assert_streams(got, want, gaps, context=()) -> int:
    """Each stream has the reference's length and equals it up to the
    first step whose reference gap is below :data:`MIN_GAP`; returns the
    number of tokens compared."""
    compared = 0
    for rid in want:
        assert len(got[rid]) == len(want[rid]), (context, rid)
        n = next((i for i, g in enumerate(gaps[rid]) if g < MIN_GAP),
                 len(want[rid]))
        assert list(got[rid][:n]) == want[rid][:n], (context, rid, n)
        compared += n
    return compared


@functools.lru_cache(maxsize=None)
def _jax_batcher_streams(seed, quantized, schedule, k, paged, trace_name):
    """The reference batcher's streams on a trace, one wave after another,
    with its plan and sharded (calibrated) parameters."""
    from repro.serve import Bucket as JaxBucket
    from repro.serve import BucketPolicy as JaxBucketPolicy
    from repro.serve import DecodeRequest as JaxDecodeRequest
    from repro.serve import ServeBatcher as JaxServeBatcher

    mesh = make_debug_mesh(1, 1)
    tokens = {}
    with mesh:
        b = JaxServeBatcher(
            jcfg(), mesh, quantized=quantized,
            policy=JaxBucketPolicy([JaxBucket(BUCKET.max_len,
                                              BUCKET.batch)]),
            schedule=schedule, steps_per_dispatch=k,
            paged=PAGED if paged else None).load_params(jparams(seed))
        for wave in waves(TRACES[trace_name]):
            for rid, p, n in wave:
                b.submit(JaxDecodeRequest(rid, p, max_new_tokens=n))
            tokens.update({r: v.tokens for r, v in b.run().items()})
    return tokens, b.plan, b.params


@functools.lru_cache(maxsize=None)
def _jax_step(cfg):
    """The reference's jitted ``decode_step`` for a (calibrated) config."""
    return jax.jit(jax_build_model(cfg).decode_step)


TRACES = {"parity": PARITY_TRACE, "shared": SHARED_TRACE}


def jax_streams(seed, quantized, schedule, k, paged, trace_name,
                skipped=0):
    """The reference batcher's streams on a trace, and the per-request
    gaps and argmax tokens of a JAX greedy loop from position 0
    teacher-forced along them. ``skipped`` N > 0 reproduces the prefix
    cache on waves after the first: their SSM and conv state is zeroed
    after N prompt tokens, as a follower that maps N tokens of published
    pages starts from a fresh recurrent state (the KV rows of those
    tokens are the same either way)."""
    tokens, plan, sparams = _jax_batcher_streams(seed, quantized, schedule,
                                                 k, paged, trace_name)
    step = _jax_step(plan.cfg)
    gaps, loop = {}, {}
    with plan.activate():
        for w, wave in enumerate(waves(TRACES[trace_name])):
            for rid, prompt, n in wave:
                state = plan.fresh_decode_state(1, BUCKET.max_len)
                g, top = [], []
                for i in range(len(prompt) + n - 1):
                    if w and skipped and i == skipped:
                        state = dict(state, ssm=jnp.zeros_like(state["ssm"]),
                                     conv=jnp.zeros_like(state["conv"]))
                    t_in = (prompt[i] if i < len(prompt)
                            else tokens[rid][i - len(prompt)])
                    logits, state = step(sparams, state,
                                         jnp.asarray([t_in], jnp.int32),
                                         jnp.int32(i))
                    if i >= len(prompt) - 1:
                        lg = np.asarray(logits[0], np.float64)
                        top.append(int(np.argmax(lg)))
                        lg = np.sort(lg)
                        g.append(float(lg[-1] - lg[-2]))
                gaps[rid], loop[rid] = g, top
    return tokens, gaps, loop


def _port_streams(seed, quantized, schedule, k, paged, trace):
    plan = build_plan(ARCH, None, debug=True, quantized=quantized,
                      device="cpu")
    kw = dict(steps_per_dispatch=k, paged=PAGED if paged else None)
    if schedule == "fifo":
        kw = {}
    b = plan.make_batcher(policy=BucketPolicy([BUCKET]), schedule=schedule,
                          **kw).load_params(arrays(seed))
    out = {}
    for wave in waves(trace):
        for rid, p, n in wave:
            b.submit(DecodeRequest(rid, p, max_new_tokens=n))
        out.update({r: v.tokens for r, v in b.run().items()})
    return b, out


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
    """The parity trace through the port and the reference in one mode:
    equal streams up to the gap rule, slots refilled (continuous), every
    page back but scratch and prefix pages (paged), one step per mode."""
    want, gaps, _ = jax_streams(test_seed, quantized, schedule, k, paged,
                                "parity")
    b, got = _port_streams(test_seed, quantized, schedule, k, paged,
                           PARITY_TRACE)
    compared = _assert_streams(got, want, gaps,
                               (quantized, schedule, k, paged))
    assert compared >= 18, compared
    assert all(key.quantized == quantized for key in b.cache._entries)
    if schedule == "continuous":
        assert b.scheduler.refills > 0
        keys = [key for key in b.cache._entries
                if key.kind == "masked_decode"]
        assert len(keys) == 1 and keys[0].steps == k
        assert keys[0].paged == (PAGED if paged else ())
    if paged:
        s = b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


def test_shared_prefix_paged_trace_matches_reference(test_seed):
    """Two waves sharing an 18-token system prompt through paged k = 4:
    wave 2 maps wave 1's published page and skips 16 prompt tokens. Both
    packages carry the reference's prefix-cache fault here: the skipped
    tokens never reach the follower's SSM and conv state, which start
    fresh, so wave 2 decodes from a state that lacks the prefix. The port
    must give the reference's (faulty) streams, held by the gap rule with
    the gaps of a loop that drops the SSM state after 16 tokens the same
    way."""
    page = PAGED[1]
    want, gaps, loop = jax_streams(test_seed, False, "continuous", 4, True,
                                   "shared", skipped=page)
    b, got = _port_streams(test_seed, False, "continuous", 4, True,
                           SHARED_TRACE)
    s = b.stats()["paged"]
    assert s["prefix_hits"] == 2 and s["skipped_prefill_tokens"] == 2 * page
    assert _assert_streams(got, want, gaps, "shared") >= 8
    # the faulted loop is the reference's computation: its own argmax
    # gives the reference's streams under the same rule, while a loop that
    # keeps the prefix in the SSM state opens s2 with another token
    assert _assert_streams(loop, want, gaps, "faulted loop") >= 8
    _, clean_gaps, clean = jax_streams(test_seed, False, "continuous", 4,
                                       True, "shared")
    assert clean["s2"][0] != want["s2"][0] and clean_gaps["s2"][0] > MIN_GAP


def test_serve_cli_hybrid(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "zamba2-2.7b", "--debug", "--device", "cpu",
          "--schedule", "continuous", "--steps-per-dispatch", "4",
          "--paged", "--quantized", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "zamba2-2.7b on cpu" in out and "paged:" in out
    assert out.rstrip().endswith("builds=1")
    with pytest.raises(ValueError, match="block-verify"):
        main(["--arch", "zamba2-2.7b", "--debug", "--device", "cpu",
              "--schedule", "continuous", "--steps-per-dispatch", "2",
              "--speculative", "2"])
