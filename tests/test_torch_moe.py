"""The port's MoE family (``layers/moe.py`` and ``DecoderLM`` with expert
blocks) against the JAX package's, on the CPU.

The layer: ``moe`` on the reference's ``moe_spec`` weights (d 64, inputs
from numpy seeds) at capacity factors 4.0, 1.25 and 0.1 (heavy drops),
global and grouped; its dispatch tensors (each slot's token, validity and
gate) and aux loss against the reference's. Every input is drawn at
random, so no two router probabilities of a token tie: ``torch.topk`` and
``jax.lax.top_k`` order ties differently, which would move assignments
between slots.

The models: reduced phi3.5-moe (4 experts, top 2) and kimi-k2 (the same
with one shared expert), 4 layers, d_model 64, vocab 256, on the
reference's weights carried across with ``decoder_lm_from_arrays``.

Tolerances: layer outputs fp32 atol = rtol = 1e-5 and bf16 atol 2e-2 (the
expert products sum in fp32 in another order; bf16 rounds the SwiGLU and
the output); aux 1e-6; logits fp32 atol = rtol = 1e-4 (prefill, 6 decode
steps, ``decode_block`` float), ``decode_block`` quantized atol 1e-3 (two
int16 steps of the head's 2**-11 output scale); the dispatch's tokens
and validity equal, its gates 1e-6. Serving streams are held to the
reference's own streams in each mode (fifo, continuous k 1/4, paged k
1/4, speculative k 4 dense and paged; float and quantized) up to the
first step whose reference gap is below 0.1: the reference's compiled
steps keep excess bf16 precision inside a fusion, which moves a decode
logit by up to about 0.05 against the port's eager rounding (see
tests/test_torch_hybrid.py).
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serve_ref import (
    PARITY_TRACE,
    assert_gap_streams,
    family_arrays,
    family_params,
    family_port_streams,
    family_reference,
)

import repro.layers.attention as jattn
import repro.layers.moe as jmoe
import repro_torch.layers.attention as tattn
from repro.configs import reduced_config as jax_reduced_config
from repro.dist.sharding import init_params
from repro.models import build_model as jax_build_model
from repro.models.base import PageView as JaxPageView
from repro.models.base import paged_state_specs
from repro_torch.bridge import decoder_lm_from_arrays, model_from_arrays
from repro_torch.configs import reduced_config
from repro_torch.layers import moe as tmoe
from repro_torch.models.base import PageView
from repro_torch.plan import build_plan

ARCHS = ["phi3_5_moe_42b", "kimi_k2_1t"]
B, S, D = 2, 16, 64
MIN_GAP = 0.1
FP32 = dict(atol=1e-4, rtol=1e-4)
DT = {"fp32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
LAYER_TOL = {"fp32": dict(atol=1e-5, rtol=1e-5),
             "bf16": dict(atol=2e-2, rtol=0.0)}


@pytest.fixture
def flash(monkeypatch):
    """Set both packages' flash switch."""
    def set_(on: bool):
        monkeypatch.setattr(jattn, "USE_FLASH_KERNEL", on)
        monkeypatch.setattr(tattn, "USE_FLASH_KERNEL", on)
    return set_


def _layer(E, f, dtype, seed=0, shape=(B, S, D)):
    """The reference's ``moe_spec`` weights and an input, in both
    packages."""
    jd, td = DT[dtype]
    p = init_params(jax.random.PRNGKey(seed),
                    jmoe.moe_spec(D, f, E, "megatron"))
    jp = {k: v.astype(jd) for k, v in p.items()}
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(td)
          for k, v in p.items()}
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(
        np.float32)
    return jp, tp, jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,k,E,cf", [(32, 2, 8, 4.0), (32, 2, 4, 0.1),
                                      (4096, 2, 16, 1.25), (8, 2, 16, 1.25),
                                      (40, 2, 16, 1.25), (7, 8, 384, 1.25)])
def test_capacity_matches_reference(T, k, E, cf):
    assert tmoe.capacity(T, k, E, cf) == jmoe._capacity(T, k, E, cf)


@pytest.mark.parametrize("cf,E,f", [(4.0, 8, 128), (1.25, 8, 128),
                                    (0.1, 4, 64)],
                         ids=["ample", "default", "drops"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_moe_matches_reference(dtype, cf, E, f):
    """``moe`` (one group) gives the reference's output and aux loss; with
    ample capacity the aux is at least its lower bound 1, and at 0.1 the
    output stays finite though most assignments drop."""
    jp, tp, jx, tx = _layer(E, f, dtype)
    want, jaux = jmoe.moe(jp, jx, n_experts=E, top_k=2, capacity_factor=cf)
    got, aux = tmoe.moe(tp, tx, n_experts=E, top_k=2, capacity_factor=cf)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert torch.isfinite(got.float()).all()
    _close(got, want, LAYER_TOL[dtype])
    assert abs(float(aux) - float(jaux)) < 1e-6
    if cf == 4.0:
        assert float(aux) >= 1.0 - 1e-3


@pytest.mark.parametrize("cf", [8.0, 1.25])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_grouped_matches_reference_and_global(dtype, cf):
    """Four groups of 16 tokens: the port's grouped dispatch gives the
    reference's ``moe_grouped`` output and aux; with ample capacity it
    equals the global dispatch (atol 2e-2, the reference's own test)."""
    E = 8
    jp, tp, jx, tx = _layer(E, 128, dtype, shape=(4, 16, D))
    want, jaux = jmoe.moe(jp, jx, n_experts=E, top_k=2, capacity_factor=cf,
                          n_groups=4)
    got, aux = tmoe.moe(tp, tx, n_experts=E, top_k=2, capacity_factor=cf,
                        n_groups=4)
    _close(got, want, LAYER_TOL[dtype])
    assert abs(float(aux) - float(jaux)) < 1e-6
    if cf == 8.0:
        flat, faux = tmoe.moe(tp, tx, n_experts=E, top_k=2,
                              capacity_factor=cf)
        _close(got, flat.float().numpy(), dict(atol=2e-2, rtol=0.0))
        assert abs(float(aux) - float(faux)) < 1e-5


class _Spy:
    """``jax.numpy`` for the reference's moe module, recording the calls
    that carry its dispatch tensors: ``where(valid, gates, 0)`` (the first
    ``where``) and the token gather (``take`` in ``moe``,
    ``take_along_axis`` of the hiddens in ``moe_grouped``)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(jnp, name)
        if name not in ("where", "take", "take_along_axis"):
            return fn

        def rec(*args, **kw):
            out = fn(*args, **kw)
            self.calls.append((name, args, out))
            return out
        return rec

    def dispatch(self, G, E, C):
        _, (valid, _, _), gate = next(c for c in self.calls
                                      if c[0] == "where")
        if G == 1:
            _, (_, tok), _ = next(c for c in self.calls if c[0] == "take")
        else:
            _, (_, idx), _ = [c for c in self.calls
                              if c[0] == "take_along_axis"][-1]
            tok = idx[..., 0]
        return [np.asarray(a).reshape(G, E, C) for a in (tok, valid, gate)]


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [1.25, 0.1])
def test_dispatch_tensors_equal_reference(monkeypatch, groups, cf):
    """Each slot's token and validity equal the reference's (recorded from
    its eager run), and its gate within 1e-6 (the fp32 router products sum
    in another order), at a capacity with drops."""
    E, k = 4, 2
    jp, tp, jx, tx = _layer(E, 64, "fp32", seed=3, shape=(4, 16, D))
    spy = _Spy()
    monkeypatch.setattr(jmoe, "jnp", spy)
    jmoe.moe(jp, jx, n_experts=E, top_k=k, capacity_factor=cf,
             n_groups=groups)
    Tg = 64 // groups
    C = tmoe.capacity(Tg, k, E, cf)
    want = spy.dispatch(groups, E, C)
    gate_vals, ids, _ = tmoe.route(tp["router"], tx.reshape(groups, Tg, D),
                                   k)
    got = tmoe.dispatch(ids, gate_vals, E, C)
    for name, g, w in zip(("tok", "valid"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, name)
    np.testing.assert_allclose(got[2].numpy(), want[2], atol=1e-6, rtol=0)
    valid = got[1]
    assert 0 < int(valid.sum()) <= 64 * k
    if cf == 0.1:
        assert int(valid.sum()) < 64 * k         # assignments dropped


def test_gates_are_renormalised_and_sharpen():
    """The k gates of a token are the reference's renormalised top-k
    probabilities and sum to 1; doubling the router logits keeps that and
    sharpens the top gate (the reference's gate-scaling test)."""
    E, k = 4, 2
    jp, tp, jx, tx = _layer(E, 64, "fp32", shape=(1, 4, D))
    xf = tx.reshape(1, 4, D)
    gates, ids, _ = tmoe.route(tp["router"], xf, k)
    logits = jnp.einsum("td,de->te", jx.reshape(-1, D), jp["router"])
    vals, jids = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    np.testing.assert_allclose(gates[0].numpy(),
                               np.asarray(vals / vals.sum(-1, keepdims=True)),
                               atol=1e-6)
    np.testing.assert_array_equal(ids[0].numpy(), np.asarray(jids))
    sharp, sharp_ids, _ = tmoe.route(tp["router"] * 2, xf, k)
    np.testing.assert_allclose(sharp.sum(-1).numpy(), 1.0, atol=1e-6)
    assert torch.equal(sharp_ids, ids)
    assert (sharp[..., 0] >= gates[..., 0]).all()


def test_decode_batch_drops_nothing():
    """At a decode step of 8 tokens, phi3.5-moe's capacity (8 slots) holds
    every assignment: one token picks an expert at most once, so no expert
    gets more than 8 of the 16."""
    E, k, T = 16, 2, 8
    assert tmoe.capacity(T, k, E, 1.25) == 8
    rng = np.random.default_rng(4)
    for _ in range(20):
        probs = torch.from_numpy(rng.random((1, T, E)).astype(np.float32))
        gates, ids = torch.topk(probs, k, dim=-1)
        _, valid, _ = tmoe.dispatch(ids, gates, E, 8)
        assert int(valid.sum()) == T * k


# ---------------------------------------------------------------------------
# the models: config, bridge, prefill, decode
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jcfg(arch):
    return jax_reduced_config(arch)


def _model(arch, seed, fp32=False):
    return decoder_lm_from_arrays(reduced_config(arch),
                                  family_arrays(arch, seed, fp32), "cpu")


def _p32(arch, seed):
    return jax.tree.map(lambda a: a.astype(jnp.float32),
                        family_params(arch, seed))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_and_blocks(arch):
    """The reduced config equals the reference's field by field; its
    blocks hold the expert weights (and kimi's shared expert) and no dense
    ``ffn``."""
    cfg, want = reduced_config(arch), _jcfg(arch)
    for field in type(want).__dataclass_fields__:
        assert getattr(cfg, field) == getattr(want, field), field
    model = _model(arch, 0)
    blk = model.blocks[0]
    assert not hasattr(blk, "ffn") and model.ffn_blocks() == []
    assert tuple(blk.moe["w_up"].shape) == (4, 64, 64)
    assert tuple(blk.moe["w_down"].shape) == (4, 64, 64)
    assert tuple(blk.moe["router"].shape) == (64, 4)
    assert (blk.shared is not None) == (arch == "kimi_k2_1t")


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_and_rejects(arch, test_seed):
    """Expert leaves stacked [L, E, ...] land in block l bit for bit; a
    tree without a leaf, with a stray one or with a wrong expert count is
    refused."""
    tree = family_arrays(arch, test_seed)
    model = model_from_arrays(reduced_config(arch), tree, "cpu")
    for name in ("w_gate", "w_up", "w_down", "router"):
        for i in (0, 3):
            np.testing.assert_array_equal(
                model.blocks[i].moe[name].float().numpy(),
                np.asarray(tree["blocks"]["moe"][name][i], np.float32))
    cfg = reduced_config(arch)
    blocks = dict(tree["blocks"], moe=dict(tree["blocks"]["moe"]))
    del blocks["moe"]["w_gate"]
    with pytest.raises(KeyError, match="w_gate"):
        decoder_lm_from_arrays(cfg, dict(tree, blocks=blocks), "cpu")
    with pytest.raises(KeyError, match="unexpected"):
        decoder_lm_from_arrays(cfg, dict(tree, extra={"w": np.zeros(2)}),
                               "cpu")
    blocks = dict(tree["blocks"], moe=dict(
        tree["blocks"]["moe"], w_up=tree["blocks"]["moe"]["w_up"][:, :3]))
    with pytest.raises(ValueError, match="w_up"):
        decoder_lm_from_arrays(cfg, dict(tree, blocks=blocks), "cpu")


@pytest.mark.parametrize("on", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_fp32_logits_and_aux(arch, flash, on, test_seed):
    """Prefill of [2, 40] tokens (80 tokens route at once, with drops):
    the logits, and the aux loss summed over the layers."""
    flash(on)
    jm = jax_build_model(_jcfg(arch))
    p32 = _p32(arch, test_seed)
    model = _model(arch, test_seed, fp32=True)
    toks = np.random.default_rng(8).integers(0, 256, (2, 40)).astype(
        np.int32)
    want = np.asarray(jm.forward(p32, {"tokens": jnp.asarray(toks)}))
    got = model({"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    _, jaux = jm.backbone(p32, jnp.asarray(toks))
    _, aux = model.backbone(torch.from_numpy(toks))
    assert abs(float(aux) - float(jaux)) < 1e-5
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_bf16_argmax(arch, flash, test_seed):
    flash(True)
    toks = np.random.default_rng(9).integers(0, 256, (2, 40)).astype(
        np.int32)
    want = np.asarray(jax_build_model(_jcfg(arch)).forward(
        family_params(arch, test_seed), {"tokens": jnp.asarray(toks)}))
    got = _model(arch, test_seed)({"tokens": torch.from_numpy(toks)}).numpy()
    assert np.isfinite(got).all()
    top2 = np.sort(want, axis=-1)[..., -2:]
    robust = top2[..., 1] - top2[..., 0] > 0.2
    assert robust.sum() >= 20
    np.testing.assert_array_equal(got.argmax(-1)[robust],
                                  want.argmax(-1)[robust])
    assert np.abs(got - want).mean() < 0.05


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_reference(arch, paged, test_seed):
    """Six decode steps from a zero fp32 KV cache: logits and KV. Paged,
    the slots' pages interleave in a pool of 8 and slot 1 starts at local
    position 2."""
    jm = jax_build_model(_jcfg(arch))
    p32 = _p32(arch, test_seed)
    model = _model(arch, test_seed, fp32=True)
    Bd, L, ps = 2, 16, 4
    sspecs = jm.decode_state_specs(Bd, L)
    if paged:
        sspecs = paged_state_specs(sspecs, 8, ps)
        table = np.array([[6, 1, 4, 3], [2, 7, 0, 5]], np.int32)
    jstate = {k: v.astype(jnp.float32) for k, v in
              init_params(jax.random.PRNGKey(0), sspecs).items()}
    tstate = {k: v.float() for k, v in model.decode_state(
        Bd, L, paged=(8, ps) if paged else None).items()}
    toks = np.random.default_rng(11).integers(0, 256, (6, Bd)).astype(
        np.int32)
    kw = {}
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
        assert out is tstate
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
        for name in ("cache_k", "cache_v"):
            np.testing.assert_allclose(tstate[name].numpy(),
                                       np.asarray(jstate[name]), **FP32)


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_block_matches_reference(arch, quantized, paged, m,
                                        test_seed):
    """``decode_block`` (the speculative draft and verify pass) on fp32
    weights and KV: three slots at local positions 6, 13 and 0; logits
    and the written KV. With m = 4 the block routes 12 tokens at once."""
    q = dict(quantized=quantized)
    jcfg, tcfg = _jcfg(arch).with_(**q), reduced_config(arch).with_(**q)
    model = _model(arch, test_seed, fp32=True)
    model.cfg = tcfg
    rng = np.random.default_rng(5)
    Bd, ps = 3, 4
    per = (12, ps) if paged else (Bd, 16)
    kv = {n: rng.standard_normal((tcfg.n_layers, *per, tcfg.n_kv,
                                  tcfg.head_dim)).astype(np.float32) * 0.5
          for n in ("cache_k", "cache_v")}
    table = np.array([[0, 1, 2, 8], [0, 3, 4, 9], [10, 10, 10, 10]],
                     np.int32)
    local = np.array([6, 13, 0], np.int32)
    toks = rng.integers(0, tcfg.vocab, (Bd, m)).astype(np.int32)
    jpages = (JaxPageView(jnp.asarray(table), jnp.asarray(local), ps)
              if paged else None)
    want, jstate = jax_build_model(jcfg).decode_block(
        _p32(arch, test_seed), {n: jnp.asarray(v) for n, v in kv.items()},
        jnp.asarray(toks), jnp.asarray(local), pages=jpages)
    tpages = (PageView(torch.from_numpy(table), torch.from_numpy(local), ps)
              if paged else None)
    tstate = {n: torch.from_numpy(v.copy()) for n, v in kv.items()}
    got, _ = model.decode_block(tstate, torch.from_numpy(toks),
                                torch.from_numpy(local), pages=tpages)
    assert got.shape == (Bd, m, tcfg.vocab)
    tol = dict(atol=1e-3, rtol=0.0) if quantized else FP32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for n in kv:
        np.testing.assert_allclose(tstate[n].numpy(), np.asarray(jstate[n]),
                                   atol=1e-3, rtol=0.0)


# ---------------------------------------------------------------------------
# quantization: the head only, as in the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_plan_runs_the_head_only(arch, test_seed, monkeypatch):
    """The quantize pass reports no MLP route for the MoE family (its
    blocks have no dense FFN), calibration does nothing, and a quantized
    decode step runs qmatmul once, for the head."""
    import repro_torch.layers.linear as tlinear
    from repro.plan import MeshSpec
    from repro.plan import build_plan as jax_build_plan

    calls = []
    real = tlinear.qlinear
    monkeypatch.setattr(tlinear, "qlinear",
                        lambda x, w, *a, **k: (calls.append(
                            (tuple(x.shape), tuple(w.shape))),
                            real(x, w, *a, **k))[1])
    plan = build_plan(arch, None, debug=True, quantized=True, device="cpu")
    jplan = jax_build_plan(_jcfg(arch), None, quantized=True,
                           mesh_spec=MeshSpec.debug(1, 1))
    assert plan.ir.quant["mlp"] is False is jplan.ir.quant["mlp"]
    assert plan.cfg.quantized and not plan.cfg.quantized_mlp
    model = plan.load_params(family_arrays(arch, test_seed))
    assert not plan.ir.quant["calibrated"] and model.mlp_down_weights() == []
    state = model.decode_state(2, 8)
    calls.clear()
    model.decode_step(state, torch.tensor([3, 4], dtype=torch.int32), 0)
    assert calls == [((2, 64), (64, 256))]


# ---------------------------------------------------------------------------
# serving: the reference's streams per mode
# ---------------------------------------------------------------------------

_MODES = {"fifo": ("fifo", 1, False, False),
          "continuous-k1": ("continuous", 1, False, False),
          "continuous-k4": ("continuous", 4, False, False),
          "paged-k1": ("continuous", 1, True, False),
          "paged-k4": ("continuous", 4, True, False),
          "spec-k4": ("continuous", 4, False, True),
          "spec-paged-k4": ("continuous", 4, True, True)}


def check_streams(arch, quantized, mode, test_seed):
    """The parity trace through the port and the reference in one mode
    (``tests/test_torch_moe_streams.py`` runs every mode; a file of its
    own, so that ``--dist loadfile`` runs it beside this one): equal
    streams up to the gap rule, one step per mode, slots refilled
    (continuous), speculative verifies (spec), every page back but scratch
    and prefix pages (paged). The speculative verify routes 2 x 4 tokens
    at once, so its capacity couples the slots; both packages drop the
    same assignments, so the reference's own speculative streams hold."""
    schedule, k, paged, spec = _MODES[mode]
    want, gaps, _ = family_reference(arch, test_seed, quantized, schedule,
                                     k, paged, "parity", spec=spec)
    b, got = family_port_streams(arch, test_seed, quantized, schedule, k,
                                 paged, PARITY_TRACE, spec=spec)
    compared = assert_gap_streams(got, want, gaps, MIN_GAP,
                                  (arch, quantized, mode))
    assert compared >= 15, compared
    assert all(key.quantized == quantized for key in b.cache._entries)
    if schedule == "continuous":
        assert b.scheduler.refills > 0
        keys = [key for key in b.cache._entries
                if key.kind == "masked_decode"]
        assert len(keys) == 1 and keys[0].steps == k
    if spec:
        assert b.scheduler.stats()["spec"]["verifies"] > 0
    if paged:
        s = b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


def test_serve_cli_moe(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "phi3.5-moe-42b-a6.6b", "--debug", "--device", "cpu",
          "--schedule", "continuous", "--steps-per-dispatch", "2",
          "--speculative", "2", "--quantized", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "phi3.5-moe-42b-a6.6b on cpu" in out
    assert "speculative: k=2 draft_layers=2," in out
    assert out.rstrip().endswith("builds=1")
