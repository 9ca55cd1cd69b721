"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one. They import nothing of
JAX, so they also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

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


@pytest.mark.parametrize("K,N,dt_a,dt_b", _LM_SHAPES + _HYBRID_SHAPES)
@pytest.mark.parametrize("split", [False, True], ids=["one", "split"])
def test_qmatmul_m8_lm_shapes_equal_plain(cuda, K, N, dt_a, dt_b, split):
    """M = 8 (the continuous bucket's batch) at the yi-6b and zamba2 LM
    shapes, over the full int16 range, with one split of K and with
    several."""
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


def _hold_to_cpu_run(model, got, want, forced=False):
    """Every card stream has its length and equals the CPU run's up to the
    first step whose gap, in a CPU greedy loop from position 0 per request
    (teacher-forced along the CPU run's streams with ``forced``), is under
    ``_CARD_MIN_GAP``."""
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
    assert compared >= 20


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
