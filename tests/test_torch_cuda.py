"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one. They import nothing of
JAX, so they also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.qmatmul import ops
from repro_torch.kernels.qmatmul.ref import qlinear_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rand(rng, shape, dtype, dev):
    lo, hi = (-128, 128) if dtype == "int8" else (-1024, 1024)
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype)).to(dev)


@pytest.mark.parametrize("M,K,N", [(1, 8, 8), (33, 70, 50), (196, 2048, 512),
                                   (5, 1, 3), (130, 257, 65)])
@pytest.mark.parametrize("dt_a,dt_b", [("int8", "int8"), ("int16", "int8"),
                                       ("int16", "int16")])
def test_qmatmul_kernel_equals_plain(cuda, M, K, N, dt_a, dt_b):
    rng = np.random.default_rng(M * K + N)
    x = _rand(rng, (M, K), dt_a, cuda)
    w = _rand(rng, (K, N), dt_b, cuda)
    b = torch.from_numpy(
        rng.integers(-(2**16), 2**16, (N,)).astype(np.int32)).to(cuda)
    before = ops.launches
    for out in ("int8", "int16"):
        for rounding in ("floor", "half_up", "half_even"):
            for shift in (0, 1, 7, 12):
                kw = dict(shift=shift, relu=shift % 2 == 1, out_dtype=out,
                          rounding=rounding)
                got = ops.qlinear(x, w, b, **kw)
                assert got.is_cuda
                assert torch.equal(got, qlinear_ref(x, w, b, **kw))
    assert ops.launches == before + 24


def test_qmatmul_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.int8, device=cuda)
    w = torch.zeros((8, 6), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ops.qlinear(x, w.t().contiguous().t(), shift=0)
    with pytest.raises(TypeError):
        ops.qlinear(x, w.to(torch.int16), shift=0)  # int8 x int16
    with pytest.raises(ValueError):
        ops.qlinear(x, w, shift=0, out_dtype="int32")
    with pytest.raises(ValueError):
        ops.qlinear(x, w, shift=32)
    with pytest.raises(ValueError):
        ops.qlinear(x, w, torch.zeros(6, dtype=torch.int64, device=cuda),
                    shift=0)
    with pytest.raises(ValueError):
        ops.qlinear(x, w.cpu(), shift=0)


@pytest.mark.parametrize("M", [1, 4, 16, 17])
@pytest.mark.parametrize("K", [70, 11008])
@pytest.mark.parametrize("dt_a,dt_b", [("int8", "int8"), ("int16", "int8"),
                                       ("int16", "int16")])
def test_qmatmul_small_m_and_split_k_equal_plain(cuda, M, K, dt_a, dt_b):
    """The 16- and 64-row tiles at decode-sized M, each with its plan's
    split of K and with one split, over the full int16 range (the sum
    wraps int32 at K = 11008)."""
    rng = np.random.default_rng(M * K)
    N = 300
    x = torch.from_numpy(rng.integers(
        -(2**15) if dt_a == "int16" else -128,
        2**15 if dt_a == "int16" else 128, (M, K)).astype(dt_a)).to(cuda)
    w = _rand(rng, (K, N), dt_b, cuda)
    b = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (N,)).astype(np.int32)).to(cuda)
    auto = ops.plan(M, K, N, 132)
    plans = {auto, ops.Plan(auto.block_m, 1, K)}
    if K > 1024:
        plans.add(ops.Plan(auto.block_m, 6, 1856))   # 6 splits tile 11008
    before = ops.launches
    for p in plans:
        for out in ("int8", "int16"):
            kw = dict(shift=9, relu=out == "int8", out_dtype=out,
                      rounding="half_even")
            got = ops.qlinear_planned(x, w, b, p, **kw)
            assert torch.equal(got, qlinear_ref(x, w, b, **kw)), (p, out)
    assert ops.launches == before + 2 * len(plans)


def _qkv(rng, BH, Sq, Sk, hd, dtype, dev, scale=1.0):
    return [(torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(
        np.float32)) * scale).to(dtype).to(dev) for S in (Sq, Sk, Sk)]


# the grid of tests/test_flash_attention.py (block sweep as shapes), the
# ragged causal q_start case, and the reduced and full head dims
@pytest.mark.parametrize("BH,Sq,Sk,hd,causal,q_start", [
    (2, 32, 32, 16, True, 0), (2, 64, 64, 8, True, 0),
    (2, 128, 128, 32, True, 0), (2, 96, 96, 16, True, 0),
    (2, 32, 32, 16, False, 0), (2, 64, 64, 8, False, 0),
    (2, 128, 128, 32, False, 0), (2, 96, 96, 16, False, 0),
    (1, 32, 64, 16, True, 32), (2, 20, 20, 16, True, 8),
    (3, 130, 130, 64, True, 0), (4, 200, 200, 128, True, 0),
    (2, 130, 130, 80, True, 0), (2, 96, 96, 80, False, 0),
    (2, 48, 64, 80, True, 16),
])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_flash_kernel_matches_plain(cuda, BH, Sq, Sk, hd, causal, q_start,
                                    dtype):
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    q, k, v = _qkv(np.random.default_rng(Sq * hd + BH), BH, Sq, Sk, hd, dt,
                   cuda)
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, q_start=q_start)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, q_start=q_start)
    assert got.dtype == dt and got.is_cuda
    tol = dict(atol=2e-5, rtol=2e-5) if dtype == "fp32" else dict(atol=2e-2,
                                                                  rtol=0)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 80, 128])
@pytest.mark.parametrize("causal,Sk,q_start", [
    (True, 77, 0), (False, 77, 0), (True, 93, 16), (False, 128, 0),
])
def test_flash_bf16_every_head_dim(cuda, hd, causal, Sk, q_start):
    """The tensor-core body at every instantiated head dim, with a ragged
    Sk and a q_start offset."""
    assert hd in flash_ops.HEAD_DIMS
    Sq = Sk - q_start
    q, k, v = _qkv(np.random.default_rng(hd + Sk), 3, Sq, Sk, hd,
                   torch.bfloat16, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=causal, q_start=q_start,
                                    block_k=Sk if not causal else None)
    torch.cuda.synchronize()
    want = attention_ref(q, k, v, causal=causal, q_start=q_start)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("Sq,Sk,hd,causal,q_start", [
    (2000, 2000, 128, True, 0), (2000, 2000, 80, True, 0),
    (2000, 2000, 128, True, 48), (2000, 2000, 80, True, 48),
    (2016, 2016, 64, False, 0),
])
def test_flash_bf16_body_at_path_width_ragged(cuda, Sq, Sk, hd, causal,
                                                q_start):
    """The bf16 body at path width where TMA's zero fill is reached: Sq
    and Sk off its 128-row tiles, causal with and without a q_start, and
    non-causal with Sk a multiple of 32 but not of 128."""
    q, k, v = _qkv(np.random.default_rng(Sk + hd + q_start), 2, Sq, Sk, hd,
                   torch.bfloat16, cuda)
    before = flash_ops.launches
    got = flash_ops.flash_attention(q, k, v, causal=causal, q_start=q_start)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, q_start=q_start)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


def test_flash_kernel_is_stable_at_large_scores(cuda):
    """Scores x100 reach ~1e4, where one fp32 ulp is ~1e-3: the kernel's
    sequential FMAs and the plain version's cuBLAS product round the
    scores differently, which moves a near-tied softmax by up to ~1e-3.
    The online softmax must stay finite and within that."""
    q, k, v = _qkv(np.random.default_rng(9), 1, 32, 32, 16, torch.float32,
                   cuda)
    got = flash_ops.flash_attention(q * 100, k * 100, v, causal=False)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(
        got, attention_ref(q * 100, k * 100, v, causal=False),
        atol=2e-3, rtol=0)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(np.random.default_rng(1), 2, 16, 16, 16, torch.float32,
                   cuda)
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(1, 2).contiguous()
                                  .transpose(1, 2), k, v)
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_ops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(q[..., :12].contiguous(),
                                  k[..., :12].contiguous(),
                                  v[..., :12].contiguous())
    with pytest.raises(ValueError):
        flash_ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="q_start"):
        flash_ops.flash_attention(q, k, v, q_start=-1)
    with pytest.raises(ValueError, match="non-causal"):
        flash_ops.flash_attention(q[:, :12].contiguous(),
                                  k[:, :12].contiguous(),
                                  v[:, :12].contiguous(), causal=False)


def test_mha_at_an_unbuilt_head_dim_raises_on_the_card(cuda, monkeypatch):
    """``mha`` routes a self-attention prefill at any ``hd % 8 == 0`` (the
    reference's rule) to the flash wrapper; at a head dim the kernel is not
    built for, the wrapper raises on CUDA tensors rather than the call
    running the plain attention on the card."""
    from repro_torch.layers import attention

    monkeypatch.setattr(attention, "USE_FLASH_KERNEL", True)
    assert 96 not in flash_ops.HEAD_DIMS
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, h, 96)))
               .to(cuda, torch.bfloat16) for h in (4, 2, 2))
    before = flash_ops.launches
    with pytest.raises(ValueError, match="head dim 96"):
        attention.mha(q, k, v, causal=True)
    assert flash_ops.launches == before


def test_reduced_forward_launches_flash_once_per_layer(cuda):
    from repro_torch.plan import build_plan

    plan = build_plan("yi-6b", None, debug=True)
    model = plan.init_params(seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, plan.cfg.vocab, (2, 40))).to(cuda)
    before = flash_ops.launches
    logits = model({"tokens": toks})
    torch.cuda.synchronize()
    assert flash_ops.launches == before + plan.cfg.n_layers
    assert logits.shape == (2, 40, plan.cfg.vocab)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# the continuous serve path on the card
# ---------------------------------------------------------------------------

# the LM shapes at the continuous bucket's batch: (K, N, x dtype, w dtype)
_LM_SHAPES = [(4096, 64000, "int8", "int8"), (11008, 4096, "int16", "int8")]
# zamba2's: the LM head and the shared block's down-projection
_HYBRID_SHAPES = [(2560, 32000, "int8", "int8"),
                  (10240, 2560, "int16", "int8")]
# qwen1.5-4b's head (ragged N) and down-projection, the heads of
# phi3.5-moe (ragged N) and rwkv6-7b
_FAMILY_SHAPES = [(2560, 151936, "int8", "int8"),
                  (6912, 2560, "int16", "int8"),
                  (4096, 32064, "int8", "int8"),
                  (4096, 65536, "int8", "int8")]


@pytest.mark.parametrize("K,N,dt_a,dt_b",
                         _LM_SHAPES + _HYBRID_SHAPES + _FAMILY_SHAPES)
@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_qmatmul_m8_lm_shapes_equal_plain(cuda, K, N, dt_a, dt_b, split):
    """M = 8 (the continuous bucket's batch) at the LM shapes of yi-6b,
    zamba2, qwen1.5-4b, phi3.5-moe and rwkv6-7b, over the full int16
    range, with one split of K and with several."""
    M = 8
    rng = np.random.default_rng(K + N)
    lo = -(2 ** 15) if dt_a == "int16" else -128
    x = torch.from_numpy(rng.integers(lo, -lo, (M, K)).astype(dt_a)).to(cuda)
    w = _rand(rng, (K, N), dt_b, cuda)
    auto = ops.plan(M, K, N, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    p = (ops.Plan(auto.block_m, 4, K // 4) if split
         else ops.Plan(auto.block_m, 1, K))
    for shift in (2, 7, 10):
        kw = dict(shift=shift, out_dtype="int16")
        assert torch.equal(ops.qlinear_planned(x, w, None, p, **kw),
                           qlinear_ref(x, w, None, **kw))


_TRACE = [("p0", [63, 51, 50], 7), ("p1", [33, 17, 32], 5),
          ("p2", [63, 1], 2), ("p3", [30, 52], 4), ("p4", [39, 53], 7),
          ("p5", [55, 44, 23], 7)]
# the card's cuBLAS sums bf16 products in another order than the CPU's BLAS;
# streams are held equal up to the first step whose CPU gap is under this
_CARD_MIN_GAP = 0.05


def _continuous(device, quantized, paged, state_dict, speculative=0,
                arch="yi-6b"):
    from repro_torch.models import build_model
    from repro_torch.plan import build_plan
    from repro_torch.serve import DecodeRequest

    overrides = dict(n_layers=2, vocab=64) if arch == "yi-6b" else None
    plan = build_plan(arch, None, debug=True, quantized=quantized,
                      config_overrides=overrides, device=device)
    model = build_model(plan.cfg, device=device)
    model.load_state_dict(state_dict)
    plan.load_params(model)
    b = plan.make_batcher(schedule="continuous", steps_per_dispatch=4,
                          paged=paged, speculative=speculative)
    for rid, p, n in _TRACE:
        b.submit(DecodeRequest(rid, p, max_new_tokens=n))
    return b, {r: v.tokens for r, v in b.run().items()}


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_continuous_serving_on_card_equals_cpu(cuda, quantized, paged):
    """The reduced config's continuous run (k = 4) on the card gives its CPU
    run's tokens on the parity trace, and launches qmatmul 3 x k times per
    micro-run when quantized."""
    from repro_torch.models import build_model
    from repro_torch.configs import reduced_config

    cfg = reduced_config("yi-6b").with_(n_layers=2, vocab=64)
    weights = build_model(cfg, device="cpu").init_params(0).state_dict()
    cpu_b, want = _continuous("cpu", quantized, paged, weights)
    before = ops.launches
    card_b, got = _continuous("cuda", quantized, paged, weights)
    torch.cuda.synchronize()
    runs = card_b.scheduler.stats()["micro_runs"]
    assert ops.launches - before == (3 * 4 * runs if quantized else 0)
    _hold_to_cpu_run(cpu_b.plan.model, got, want)
    if paged:
        s = card_b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_hybrid_serving_on_card_equals_cpu(cuda, quantized, paged):
    """The reduced zamba2 (2 groups of 2 Mamba2 layers) served continuous
    (k = 4) on the card gives its CPU run's tokens, with the SSM and conv
    lanes wiped on the card, and launches qmatmul (2 + 1) x k times per
    micro-run when quantized: the head and the shared block's
    down-projection at both call sites."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config("zamba2-2.7b")
    weights = build_model(cfg, device="cpu").init_params(0).state_dict()
    cpu_b, want = _continuous("cpu", quantized, paged, weights,
                              arch="zamba2-2.7b")
    before = ops.launches
    card_b, got = _continuous("cuda", quantized, paged, weights,
                              arch="zamba2-2.7b")
    torch.cuda.synchronize()
    runs = card_b.scheduler.stats()["micro_runs"]
    assert card_b.scheduler.refills > 0
    assert ops.launches - before == (3 * 4 * runs if quantized else 0)
    _hold_to_cpu_run(cpu_b.plan.model, got, want)
    if paged:
        s = card_b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


def test_reduced_hybrid_forward_launches_flash_once_per_group(cuda):
    from repro_torch.plan import build_plan

    plan = build_plan("zamba2-2.7b", None, debug=True)
    model = plan.init_params(seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, plan.cfg.vocab, (2, 40))).to(cuda)
    before = flash_ops.launches
    logits = model({"tokens": toks})
    torch.cuda.synchronize()
    assert flash_ops.launches == before + model.n_groups
    assert logits.shape == (2, 40, plan.cfg.vocab)
    assert torch.isfinite(logits).all()


def _hold_to_cpu_run(model, got, want, forced=False, min_compared=20):
    """Every card stream has its length and equals the CPU run's up to the
    first step whose gap, in a CPU greedy loop from position 0 per request
    (teacher-forced along the CPU run's streams with ``forced``), is under
    ``_CARD_MIN_GAP``; at least ``min_compared`` tokens are compared."""
    compared = 0
    for rid, prompt, n in _TRACE:
        state = model.decode_state(1, 64)
        tok, gaps = None, []
        for i in range(len(prompt) + n - 1):
            t = torch.tensor([prompt[i] if i < len(prompt) else tok],
                             dtype=torch.int32)
            logits, state = model.decode_step(state, t, i)
            top = torch.topk(logits[0], 2)
            tok = int(top.indices[0])
            if i >= len(prompt) - 1:
                gaps.append(float(top.values[0] - top.values[1]))
                if forced:
                    tok = want[rid][len(gaps) - 1]
        m = next((i for i, g in enumerate(gaps) if g < _CARD_MIN_GAP), n)
        assert len(got[rid]) == n
        assert got[rid][:m] == want[rid][:m], (rid, got[rid], want[rid])
        compared += m
    assert compared >= min_compared


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_speculative_serving_on_card_equals_cpu(cuda, quantized, paged):
    """The reduced config's speculative run (k = 4, the default one-layer
    draft) on the card gives its CPU run's tokens, and launches qmatmul
    4 x (1 + 1) + 3 times per micro-run when quantized."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config("yi-6b").with_(n_layers=2, vocab=64)
    weights = build_model(cfg, device="cpu").init_params(0).state_dict()
    cpu_b, want = _continuous("cpu", quantized, paged, weights, 4)
    before = ops.launches
    card_b, got = _continuous("cuda", quantized, paged, weights, 4)
    torch.cuda.synchronize()
    st = card_b.scheduler.stats()
    assert ops.launches - before == (11 * st["micro_runs"] if quantized
                                     else 0)
    assert st["spec"]["verifies"] > 0
    _hold_to_cpu_run(cpu_b.plan.model, got, want, forced=True)
    if paged:
        s = card_b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


@pytest.mark.parametrize("K,N,dt_a,dt_b", _LM_SHAPES)
@pytest.mark.parametrize("plan", ["auto", "one", "split"])
def test_qmatmul_m32_verify_shapes_equal_plain(cuda, K, N, dt_a, dt_b, plan):
    """M = 32 (the speculative verify: 8 slots x 4 positions) at both LM
    shapes, over the full int16 range, under the auto plan, with one split
    of K and with several."""
    M = 32
    rng = np.random.default_rng(K + N + M)
    lo = -(2 ** 15) if dt_a == "int16" else -128
    x = torch.from_numpy(rng.integers(lo, -lo, (M, K)).astype(dt_a)).to(cuda)
    w = _rand(rng, (K, N), dt_b, cuda)
    auto = ops.plan(M, K, N, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    p = {"auto": auto, "one": ops.Plan(auto.block_m, 1, K),
         "split": ops.Plan(auto.block_m, 4, K // 4)}[plan]
    for shift in (2, 7, 10):
        kw = dict(shift=shift, out_dtype="int16")
        assert torch.equal(ops.qlinear_planned(x, w, None, p, **kw),
                           qlinear_ref(x, w, None, **kw))


# ---------------------------------------------------------------------------
# qwen1.5-4b, the MoE family and RWKV on the card
# ---------------------------------------------------------------------------


def test_flash_at_the_qwen_prefill_shape(cuda):
    """[2 x 20 heads, 2048, 128] bf16 causal, qwen1.5-4b's prefill."""
    q, k, v = _qkv(np.random.default_rng(40), 40, 2048, 2048, 128,
                   torch.bfloat16, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=0.0)


_FAMILIES = ["qwen1.5-4b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
             "seamless-m4t-large-v2", "llama-3.2-vision-90b"]


def _family_weights(cfg):
    """``init_params(0)`` on the CPU, with the leaves the reference starts
    at zero in the cross-attention families drawn at random (biases
    N(0, 0.5^2), the vision LM's gates uniform in [0.5, 1]), so that the
    card runs them."""
    from repro_torch.models import build_model

    model = build_model(cfg, device="cpu").init_params(0)
    if cfg.family in ("encdec", "vlm"):
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for name, p in model.named_parameters():
                leaf = name.rsplit(".", 1)[-1]
                if leaf == "gate":
                    p.copy_(torch.rand(p.shape, generator=gen) * 0.5 + 0.5)
                elif leaf in ("b", "bias"):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    return model.state_dict()


def _family_batch(cfg):
    """The family's prefill inputs on the CPU: tokens [2, 40], and frames
    [2, 64, d] (the encoder's non-causal flash; 40 decoder queries over 64
    frames run the plain cross-attention) or vision [2, n_image, d]."""
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 40)))}
    memory = {"encdec": ("frames", 64), "vlm": ("vision",
                                                cfg.n_image_tokens)}
    if cfg.family in memory:
        name, rows = memory[cfg.family]
        batch[name] = torch.from_numpy(rng.standard_normal(
            (2, rows, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    return batch


def _flash_sites(cfg):
    """Flash launches per prefill: every attention layer, every encoder
    and decoder layer, every self block; none in RWKV."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every * (
            cfg.cross_attn_every - 1)
    return cfg.n_layers


@pytest.mark.parametrize("arch", _FAMILIES)
def test_reduced_family_forward_on_card_equals_cpu(cuda, arch):
    """The reduced config's prefill of [2, 40] tokens (with its frames or
    patch embeddings) on the card: flash once per attention layer (none in
    RWKV), logits within mean 0.05 of the CPU run, and its argmax where
    the CPU's top-2 gap exceeds 0.2."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    cfg = reduced_config(arch)
    weights = _family_weights(cfg)
    models = {}
    for dev in ("cpu", "cuda"):
        models[dev] = build_model(cfg, device=dev)
        models[dev].load_state_dict(weights)
    batch = _family_batch(cfg)
    want = models["cpu"](batch)
    before = flash_ops.launches
    got = models["cuda"]({k: t.to(cuda) for k, t in batch.items()})
    torch.cuda.synchronize()
    assert flash_ops.launches == before + _flash_sites(cfg)
    assert torch.isfinite(got).all()
    got = got.cpu()
    top2 = torch.topk(want, 2, dim=-1).values
    robust = (top2[..., 0] - top2[..., 1]) > 0.2
    assert robust.sum() >= 20
    assert torch.equal(got.argmax(-1)[robust], want.argmax(-1)[robust])
    assert (got - want).abs().mean() < 0.05


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
@pytest.mark.parametrize("arch", _FAMILIES)
def test_family_serving_on_card_equals_cpu(cuda, arch, quantized, paged):
    """The reduced config served continuous (k = 4) on the card gives its
    CPU run's tokens, and launches qmatmul per decode step once for the
    head (not in the encoder-decoder and the vision LM, whose heads stay
    float) plus once per quantized down-projection (qwen's layers, the
    vision LM's self blocks). The random reduced qwen and phi3.5-moe keep
    fewer steps above the card's gap than yi-6b's, so 10 tokens is the
    least compared."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(arch)
    weights = _family_weights(cfg)
    cpu_b, want = _continuous("cpu", quantized, paged, weights, arch=arch)
    before = ops.launches
    card_b, got = _continuous("cuda", quantized, paged, weights, arch=arch)
    torch.cuda.synchronize()
    runs = card_b.scheduler.stats()["micro_runs"]
    per_step = ({"dense": 1 + cfg.n_layers, "vlm": _flash_sites(cfg),
                 "encdec": 0}.get(cfg.family, 1))
    assert ops.launches - before == (per_step * 4 * runs if quantized
                                     else 0)
    _hold_to_cpu_run(cpu_b.plan.model, got, want, min_compared=10)
    if paged:
        s = card_b.stats()["paged"]
        assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"]


# ---------------------------------------------------------------------------
# the cross-attention families' kernel shapes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_qmatmul_at_the_vlm_down_shape(cuda, split):
    """8 x 28672 x 8192 a16w8, llama-3.2-vision's self-block
    down-projection at the continuous bucket's batch, over the full int16
    range, with one split of K and with four."""
    M, K, N = 8, 28672, 8192
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(-(2 ** 15), 2 ** 15, (M, K)).astype(
        np.int16)).to(cuda)
    w = _rand(rng, (K, N), "int8", cuda)
    auto = ops.plan(M, K, N, torch.cuda.get_device_properties(0)
                    .multi_processor_count)
    p = (ops.Plan(auto.block_m, 4, K // 4) if split
         else ops.Plan(auto.block_m, 1, K))
    for shift in (2, 7, 10):
        kw = dict(shift=shift, out_dtype="int16")
        assert torch.equal(ops.qlinear_planned(x, w, None, p, **kw),
                           qlinear_ref(x, w, None, **kw))


@pytest.mark.parametrize("BH,S,hd,causal", [
    (32, 2048, 64, False), (32, 512, 64, True), (128, 2048, 128, True)],
    ids=["seamless-encoder", "seamless-decoder", "vlm-self"])
def test_flash_at_the_cross_family_prefill_shapes(cuda, BH, S, hd, causal):
    """bf16 at seamless's encoder (non-causal) and decoder shapes and at
    llama-3.2-vision's self-attention shape, within 2e-2 of the plain
    version."""
    q, k, v = _qkv(np.random.default_rng(BH + S), BH, S, S, hd,
                   torch.bfloat16, cuda)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=0.0)


# ---------------------------------------------------------------------------
# training on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape_a,shape_b", [((300, 96), (96, 80)),
                                             ((4, 64, 96), (4, 96, 80))])
def test_matmul_f32_backward_on_card(cuda, shape_a, shape_b):
    """The card's fp32-output GEMM (``torch.mm``/``torch.bmm`` with
    ``out_dtype``) has no derivative in torch; ``matmul_f32`` and
    ``bmm_f32`` give it one (``layers.linear._MatmulF32``): the forward
    is the upcast product's up to summation order; each gradient is its
    formula (the incoming gradient rounded to bf16, fp32 sums) rounded
    once to bf16, so within one bf16 step of the formula in fp32 (1e-5 of
    the largest near zero, where summation orders differ), and
    within 2% of the largest gradient of the CPU's upcast products."""
    from repro_torch.layers.linear import bmm_f32, matmul_f32

    fn = matmul_f32 if len(shape_a) == 2 else bmm_f32
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(shape_a, generator=gen).bfloat16()
    b = torch.randn(shape_b, generator=gen).bfloat16()
    gy = torch.randn(*shape_a[:-1], shape_b[-1], generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        x = a.to(dev).clone().requires_grad_()
        w = b.to(dev).clone().requires_grad_()
        y = fn(x, w)
        assert y.dtype == torch.float32
        y.backward(gy.to(dev))
        assert x.grad.dtype == w.grad.dtype == torch.bfloat16
        out[dev] = [t.detach().float().cpu() for t in (y, x.grad, w.grad)]
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5,
                               atol=1e-4)
    g16 = gy.bfloat16().float()
    formula = (g16 @ b.float().transpose(-1, -2),
               a.float().transpose(-1, -2) @ g16)
    for got, want, cpu in zip(out["cuda"][1:], formula, out["cpu"][1:]):
        # one bf16 step of each value; near zero, where the fp32 sums of
        # two summation orders differ by more, 1e-5 of the largest
        step = torch.maximum(2.0 ** (torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7), 1e-5 * want.abs().max())
        assert ((got - want).abs() <= step).all()
        assert (got - cpu).abs().max() <= 0.02 * cpu.abs().max()


def test_kernel_wrappers_raise_on_recorded_cuda_inputs(cuda):
    from repro_torch.layers.linear import quantized_linear

    q, k, v = (torch.randn(4, 64, 64, device=cuda, dtype=torch.bfloat16,
                           requires_grad=True) for _ in range(3))
    before = flash_ops.launches
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        flash_ops.flash_attention(q, k, v)
    w = torch.randn(64, 32, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="qmatmul has no backward"):
        quantized_linear({"w": w}, torch.randn(8, 64, device=cuda))
    assert flash_ops.launches == before
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v)
        quantized_linear({"w": w}, torch.randn(8, 64, device=cuda))
    assert flash_ops.launches == before + 1


_TRAIN_ARCHS = ["yi-6b"] + _FAMILIES[:2] + ["zamba2-2.7b"] + _FAMILIES[2:]


def _train_batch(cfg):
    from repro_torch.data import SyntheticTokens

    b = SyntheticTokens(cfg.vocab, 64, 2, seed=3).batch(0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    memory = {"encdec": ("frames", 64), "vlm": ("vision",
                                                cfg.n_image_tokens)}
    if cfg.family in memory:
        name, rows = memory[cfg.family]
        rng = np.random.default_rng(5)
        batch[name] = torch.from_numpy(rng.standard_normal(
            (2, rows, cfg.d_model)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", _TRAIN_ARCHS)
def test_reduced_family_loss_and_grads_on_card_equal_cpu(cuda, arch):
    """Each family's reduced loss and its gradients on the card (bf16
    tensor-core products, flash never launched) against the CPU run on the
    same weights: the loss within rtol 5e-3; all gradients together within
    0.05 of the CPU's norm, and every leaf within ``max(0.15 |cpu|, 3
    |cpu_bf16 - cpu_fp32|)``, the CPU's own bf16 rounding noise as the
    yardstick. The card rounds the fp32 gradient of the attention's
    products and of the head to bf16 before its backward GEMMs, which the
    CPU's upcast products do not: that moves a sum with cancellation, like
    the vision LM's scalar gate, by up to 11% (measured; 7% at most
    elsewhere, 3% for all leaves together)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.train.trainer import model_loss, value_and_grad

    cfg = reduced_config(arch)
    weights = _family_weights(cfg)
    batch = _train_batch(cfg)
    runs = {}
    for dev, dtype in (("cpu", torch.float32), ("cpu", torch.bfloat16),
                       ("cuda", torch.bfloat16)):
        model = build_model(cfg, device=dev, dtype=dtype)
        model.load_state_dict(weights)
        b = {k: t.to(dev, dtype) if t.is_floating_point() else t.to(dev)
             for k, t in batch.items()}
        before = flash_ops.launches
        loss, grads = value_and_grad(model_loss, model, b)
        assert flash_ops.launches == before
        assert not any(p.requires_grad for p in model.parameters())
        runs[(dev, dtype)] = (float(loss), {n: g.float().cpu()
                                            for n, g in grads.items()})
    (l32, g32), (l16, g16) = runs[("cpu", torch.float32)], runs[
        ("cpu", torch.bfloat16)]
    loss, grads = runs[("cuda", torch.bfloat16)]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, l16, rtol=5e-3)
    total_err = total_ref = 0.0
    for name, g in grads.items():
        noise = float(torch.linalg.vector_norm(g16[name] - g32[name]))
        err = float(torch.linalg.vector_norm(g - g16[name]))
        ref = float(torch.linalg.vector_norm(g16[name]))
        assert err <= max(0.15 * ref, 3 * noise), (name, err, ref, noise)
        total_err, total_ref = total_err + err ** 2, total_ref + ref ** 2
    assert total_err <= 0.05 ** 2 * total_ref


def _restart_is_bit_exact(cfg, tmp_path, monkeypatch):
    """8 steps of ``cfg`` straight vs a crash at step 5 resumed from the
    step-4 checkpoint, on the card: the parameters are ``torch.equal``.
    Every warning that ``torch.use_deterministic_algorithms`` raises inside
    a step (an op without a deterministic implementation, or cuBLAS
    without its workspace setting, which callers set as the train CLI
    does) is an error."""
    import warnings

    from repro_torch.bridge import leaf_groups
    from repro_torch.data import make_train_iterator
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import FailureInjector, Trainer, TrainerConfig
    from repro_torch.train.fault import InjectedFailure
    from repro_torch.train.trainer import model_loss

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    opt = adamw(lr=1e-3)

    def fresh():
        model = build_model(cfg, device="cuda").init_params(0)
        return model, opt.init(dict(model.named_parameters()),
                               leaf_groups(model))

    def stream(start):
        return make_train_iterator(cfg.vocab, 16, 4, seed=7,
                                   start_step=start)

    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*deterministic")
        pa, _, _ = Trainer(model_loss, opt, TrainerConfig(
            steps=8, ckpt_every=100, log_every=100,
            ckpt_dir=str(tmp_path / "a"))).fit(*fresh(), stream,
                                               resume=False)
        cfg_b = TrainerConfig(steps=8, ckpt_every=4, log_every=100,
                              ckpt_dir=str(tmp_path / "b"))
        tb = Trainer(model_loss, opt, cfg_b)
        tb.injector = FailureInjector(fail_at_steps=(5,))
        with pytest.raises(InjectedFailure):
            tb.fit(*fresh(), stream)
        pb, _, hist = Trainer(model_loss, opt, cfg_b).fit(*fresh(), stream)
    assert hist[0]["step"] == 4
    want = dict(pa.named_parameters())
    for name, p in pb.named_parameters():
        assert p.is_cuda and torch.equal(p, want[name]), name


def test_dense_restart_is_bit_exact_on_card(cuda, tmp_path, monkeypatch):
    from repro_torch.configs import reduced_config

    _restart_is_bit_exact(
        reduced_config("yi_6b").with_(vocab=64, n_layers=2, remat=True),
        tmp_path, monkeypatch)


def test_moe_restart_is_bit_exact_on_card(cuda, tmp_path, monkeypatch):
    """The reduced phi3.5-moe (routing, the sorted dispatch, the expert
    products and the ``index_add_`` combine, which the deterministic mode
    runs in a fixed order) restarts bit for bit."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config("phi3_5_moe_42b")
    assert cfg.family == "moe" and cfg.n_experts > cfg.top_k
    _restart_is_bit_exact(cfg.with_(vocab=64, n_layers=2, remat=True),
                          tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# the plan's 1x1 mesh on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["cascade", "megatron", "megatron_sp"])
def test_shard_params_on_the_card_mesh(cuda, mode):
    """Every parameter of the reduced yi-6b placed on the plan's 1x1
    ``cuda`` DeviceMesh (a world-1 nccl group) is ``torch.equal`` to
    itself; a mesh larger than the world raises."""
    import torch.distributed as dist

    from repro_torch.models.base import build_model
    from repro_torch.plan import MeshSpec, build_plan

    plan = build_plan("yi-6b", None, debug=True, mode=mode)
    model = build_model(plan.cfg).init_params(0)
    params = dict(model.named_parameters())
    placed = plan.shard_params(model)
    assert set(placed) == set(params)
    for name, t in placed.items():
        assert t.device_mesh.device_type == "cuda"
        assert torch.equal(t.to_local(), params[name]), name
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    with pytest.raises(RuntimeError, match="need 8 devices, have 1"):
        build_plan("yi-6b", None, debug=True, mesh_spec=MeshSpec.debug(2, 4))


def test_sharded_model_through_both_kernels_on_the_card_mesh(cuda):
    """The reduced yi-6b's megatron_sp DTensors on the 1x1 nccl mesh:
    ``forward`` (flash) and four quantized ``decode_step``s (qmatmul) under
    ``plan.activate()`` launch each kernel on the gathered DTensor
    operands as often as the unsharded run does, and equal it."""
    from torch.distributed.tensor import DTensor

    from repro_torch.plan import build_plan

    plan = build_plan("yi-6b", None, debug=True, mode="megatron_sp",
                      quantized=True)
    model = plan.init_params(0)
    tokens = torch.arange(2 * 64, device="cuda",
                          dtype=torch.int32).view(2, 64) % plan.cfg.vocab

    def run():
        flash_ops.launches = ops.launches = 0
        fwd = model.forward({"tokens": tokens})
        n_flash = flash_ops.launches
        state = plan.fresh_decode_state(2, 16)
        steps = [model.decode_step(state, tokens[:, i], i)[0]
                 for i in range(4)]
        torch.cuda.synchronize()
        return fwd, steps, n_flash, ops.launches

    fwd, steps, n_flash, n_q = run()
    L = plan.cfg.n_layers      # the forward runs the a16w8 MLP too
    assert (n_flash, n_q) == (L, L + 4 * (L + 1))
    plan.shard_model(model)
    with plan.activate():
        got, got_steps, g_flash, g_q = run()
    assert isinstance(got, DTensor) and all(isinstance(s, DTensor)
                                            for s in got_steps)
    assert (g_flash, g_q) == (n_flash, n_q)
    assert torch.equal(got.full_tensor(), fwd)
    for a, b in zip(got_steps, steps):
        assert torch.equal(a.full_tensor(), b)


# ---------------------------------------------------------------------------
# the wgmma body (int8 w, M <= 64, aligned rows): ops.qlinear routes M 17-64
# to it; these tests force it at every M with its own WgPlan
# ---------------------------------------------------------------------------

# (K, N, x dtype): the LM shapes, ragged N (151,936; 32,064), K that is not
# a multiple of the body's 128-deep units, and the vlm's down-projection,
# whose 108-unit segments let the two consumer warpgroups drift furthest
# apart (an odd ring of stages once gave wrong sums there at M = 33)
_WGMMA_SHAPES = [(4096, 64000, "int8"), (11008, 4096, "int16"),
                 (2560, 151936, "int8"), (4096, 32064, "int8"),
                 (6912, 2560, "int16"), (11000, 2560, "int16"),
                 (4112, 4096, "int8"), (28672, 8192, "int16")]
_WGMMA_M = (1, 4, 8, 17, 24, 32, 33, 64)


def _wgmma(x, w, b, **kw):
    """The wgmma body, forced under its own plan."""
    M, K = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return ops.qlinear_planned(x, w, b, ops.wgmma_plan(M, K, w.shape[1], sms),
                               **kw)


def _qmatmul_events(fn):
    """Device functions and memsets that ``fn`` runs, by name and count
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    return ({k: n for k, n in kernels.items() if "qmatmul" in k},
            sum(n for k, n in kernels.items() if "memset" in k.lower()))


@pytest.mark.parametrize("K,N,dt_x", _WGMMA_SHAPES)
def test_qmatmul_wgmma_m_sweep_equals_plain(cuda, K, N, dt_x):
    """M 1-64 at the LM shapes on the wgmma body (forced) and through the
    router (the wgmma body above M = 16, mma.sync below), full int16 range,
    torch.equal to the plain version, one launch each."""
    rng = np.random.default_rng(K + N)
    w = _rand(rng, (K, N), "int8", cuda)
    lo = -(2 ** 15) if dt_x == "int16" else -128
    for M in _WGMMA_M:
        body = "wgmma" if M > ops.SMALL_M else "mma"
        assert ops.route(M, K, N, getattr(torch, dt_x), torch.int8) == body
        x = torch.from_numpy(rng.integers(lo, -lo, (M, K)).astype(dt_x)).to(
            cuda)
        kw = dict(shift=9, out_dtype="int16")
        want = qlinear_ref(x, w, None, **kw)
        for call in (_wgmma, ops.qlinear):
            before = ops.launches
            got = call(x, w, None, **kw)
            assert ops.launches == before + 1
            assert torch.equal(got, want), (M, call.__name__)


def test_qmatmul_wgmma_int16_sum_wraps(cuda):
    """int16 x near +-32767 against int8 w near +-127 at K = 11008: the
    int32 sum wraps, and the wgmma body's two byte planes keep its bits."""
    rng = np.random.default_rng(3)
    M, K, N = 32, 11008, 4096
    x = (rng.choice([-1, 1], (M, 1))
         * rng.integers(32700, 32768, (M, K))).astype(np.int16)
    w = (rng.choice([-1, 1], (1, N))
         * rng.integers(120, 128, (K, N))).astype(np.int8)
    assert np.abs(x[:1].astype(np.float64) @ w.astype(np.float64)).max() \
        > 2 ** 31
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    for shift in (0, 7, 12):
        kw = dict(shift=shift, out_dtype="int16")
        assert torch.equal(ops.qlinear(xt, wt, None, **kw),
                           qlinear_ref(xt, wt, None, **kw))


@pytest.mark.parametrize("dt_x", ["int8", "int16"])
def test_qmatmul_wgmma_bias_relu_outputs_roundings(cuda, dt_x):
    """Bias near the int32 limits, ReLU on and off, int8 and int16
    outputs and all three roundings, on the wgmma body."""
    rng = np.random.default_rng(11)
    M, K, N = 8, 4096, 4096
    lo = -(2 ** 15) if dt_x == "int16" else -128
    x = torch.from_numpy(rng.integers(lo, -lo, (M, K)).astype(dt_x)).to(cuda)
    w = _rand(rng, (K, N), "int8", cuda)
    b = torch.from_numpy(rng.integers(-(2 ** 31), 2 ** 31, (N,)).astype(
        np.int32)).to(cuda)
    for out in ("int8", "int16"):
        for rounding in ("floor", "half_up", "half_even"):
            for relu in (False, True):
                kw = dict(shift=11, relu=relu, out_dtype=out,
                          rounding=rounding)
                assert torch.equal(_wgmma(x, w, b, **kw),
                                   qlinear_ref(x, w, b, **kw)), kw


def test_qmatmul_wgmma_one_device_function_per_call(cuda):
    """A routed call at M = 32, and a forced WgPlan at M = 8, counts one
    launch and runs one device function, the wgmma body, with no reduce
    kernel and no memset (the workspace stays zero between calls); a forced
    Plan still runs the mma.sync body."""
    rng = np.random.default_rng(5)
    x = _rand(rng, (32, 11008), "int16", cuda)
    w = _rand(rng, (11008, 4096), "int8", cuda)
    kw = dict(shift=7, out_dtype="int16")
    before = ops.launches
    kernels, memsets = _qmatmul_events(
        lambda: [ops.qlinear(x, w, None, **kw) for _ in range(3)])
    assert ops.launches == before + 6      # 3 warm-up calls, 3 profiled
    assert memsets == 0
    assert len(kernels) == 1
    (name, count), = kernels.items()
    assert "qmatmul_kernel_wgmma" in name and count == 3
    x8 = x[:8].contiguous()
    kernels, memsets = _qmatmul_events(lambda: _wgmma(x8, w, None, **kw))
    assert memsets == 0 and len(kernels) == 1
    (name, count), = kernels.items()
    assert "qmatmul_kernel_wgmma" in name and count == 1
    p = ops.plan(32, 11008, 4096, torch.cuda.get_device_properties(0)
                 .multi_processor_count)
    kernels, _ = _qmatmul_events(
        lambda: ops.qlinear_planned(x, w, None, p, **kw))
    assert kernels and not any("wgmma" in k for k in kernels)
    assert any("qmatmul_kernel_reduce" in k for k in kernels)


def test_qmatmul_wgmma_plan_refuses_what_the_body_cannot_serve(cuda):
    """A WgPlan forced on a call the wgmma body cannot take (int16 w, rows
    that break TMA's 16-byte rule) raises before any launch."""
    rng = np.random.default_rng(4)
    p = ops.wgmma_plan(8, 4096, 4096, 132)
    for x, w in ((_rand(rng, (8, 4096), "int16", cuda),
                  _rand(rng, (4096, 4096), "int16", cuda)),
                 (_rand(rng, (8, 4100), "int8", cuda),
                  _rand(rng, (4100, 4096), "int8", cuda))):
        before = ops.launches
        with pytest.raises(ValueError, match="wgmma body cannot serve"):
            ops.qlinear_planned(x, w, None, p, shift=7)
        assert ops.launches == before


def test_qmatmul_wgmma_workspace_reuse_and_two_streams(cuda):
    """Back-to-back calls of different shapes reuse one cached workspace
    per (device, stream) and leave it zero; calls on two streams at once
    use a workspace each and stay exact."""
    rng = np.random.default_rng(9)
    shapes = [(32, 11008, 4096, "int16"), (8, 4096, 32064, "int8"),
              (4, 6912, 2560, "int16"), (64, 2560, 4096, "int8")]
    cases = []
    for M, K, N, dt_x in shapes:
        lo = -(2 ** 15) if dt_x == "int16" else -128
        x = torch.from_numpy(rng.integers(lo, -lo, (M, K)).astype(dt_x)).to(
            cuda)
        cases.append((x, _rand(rng, (K, N), "int8", cuda)))
    kw = dict(shift=8, out_dtype="int16")
    want = [qlinear_ref(x, w, None, **kw) for x, w in cases]
    for _ in range(3):
        got = [_wgmma(x, w, None, **kw) for x, w in cases]
        assert all(torch.equal(g, e) for g, e in zip(got, want))
    key = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    ws = ops._workspaces[key]
    torch.cuda.synchronize()
    assert not ws.any()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = [[], []]
    for s, out in zip(streams, outs):
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(4):
        for s, out in zip(streams, outs):
            with torch.cuda.stream(s):
                out.append([_wgmma(x, w, None, **kw) for x, w in cases])
    torch.cuda.synchronize()
    for s in streams:
        assert (torch.cuda.current_device(), s.cuda_stream) in ops._workspaces
        assert not ops._workspaces[(torch.cuda.current_device(),
                                    s.cuda_stream)].any()
    for out in outs:
        for got in out:
            assert all(torch.equal(g, e) for g, e in zip(got, want))
