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


@pytest.mark.parametrize("hd", [8, 16, 32, 64, 128])
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
