"""The port's flash attention against the JAX package's, on the CPU.

On a CPU tensor the port's wrapper runs the kernel's plain version; the
JAX wrapper runs its Pallas kernel in interpret mode. Same inputs, made
from numpy seeds. Tolerances are the reference tests': 2e-5 in fp32, 2e-2
in bf16. The CUDA kernel itself is held against the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import ops


def _qkv(BH, Sq, Sk, hd, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((BH, S, hd)) * scale).astype(np.float32)
            for S in (Sq, Sk, Sk)]


def _both(arrays, dtype):
    j = [jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
         for a in arrays]
    t = [torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16"
                                else torch.float32) for a in arrays]
    return j, t


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x) else
                      np.asarray(x, np.float32))


@pytest.mark.parametrize("Sq,Sk,hd", [
    (32, 32, 16), (64, 64, 8), (128, 128, 32), (96, 96, 16),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_reference(Sq, Sk, hd, causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, Sq, Sk, hd), "fp32")
    want = jax_flash(jq, jk, jv, causal=causal)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float32 and got.shape == (2, Sq, hd)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_flash_q_start_offset():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 32, 64, 16, seed=1), "fp32")
    want = jax_flash(jq, jk, jv, causal=True, q_start=32)
    got = flash_attention(tq, tk, tv, causal=True, q_start=32)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("bq,bk", [(8, 8), (16, 32), (32, 16), (64, 64)])
def test_flash_block_sweep(bq, bk):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 64, 64, 16, seed=2), "fp32")
    want = jax_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk)
    got = flash_attention(tq, tk, tv, causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


def test_flash_bf16():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 64, 64, 16, seed=3), "bf16")
    want = jax_flash(jq, jk, jv, causal=True)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


def test_flash_online_softmax_stability():
    """Scores scaled x100: the result stays finite and equal."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 32, 32, 16, seed=4), "fp32")
    want = jax_flash(jq * 100, jk * 100, jv, causal=False,
                     block_q=8, block_k=8)
    got = flash_attention(tq * 100, tk * 100, tv, causal=False,
                          block_q=8, block_k=8)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_reference_oracle(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(3, 24, 40, 32, seed=5), "fp32")
    want = jax_attention_ref(jq, jk, jv, causal=causal, q_start=16)
    got = attention_ref(tq, tk, tv, causal=causal, q_start=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kw,Sq,Sk,match", [
    (dict(causal=False), 20, 20, "non-causal"),
    (dict(causal=False, block_k=16), 40, 40, "non-causal"),
    (dict(causal=True, block_k=32), 20, 40, "Sq == Sk"),
])
def test_wrapper_raises_the_reference_errors(kw, Sq, Sk, match):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, Sq, Sk, 16), "fp32")
    with pytest.raises(ValueError, match=match):
        jax_flash(jq, jk, jv, **kw)
    with pytest.raises(ValueError, match=match):
        flash_attention(tq, tk, tv, **kw)


def test_reference_padding_fault_is_not_carried_over():
    """A known divergence: with Sq == Sk off the block and q_start > 0 the
    reference wrapper lets its zero-padded keys into the softmax, so its
    flash differs from its own oracle. The port's flash (plain version on
    the CPU; the kernel masks kpos >= Sk the same way) equals the oracle."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 20, 20, 16, seed=6), "fp32")
    oracle = _np(jax_attention_ref(jq, jk, jv, causal=True, q_start=8))
    ref_flash = _np(jax_flash(jq, jk, jv, causal=True, q_start=8))
    assert np.abs(ref_flash - oracle).max() > 0.05
    got = flash_attention(tq, tk, tv, causal=True, q_start=8)
    np.testing.assert_allclose(_np(got), oracle, atol=2e-5, rtol=2e-5)


def test_plain_version_launches_nothing():
    before = ops.launches
    _, (tq, tk, tv) = _both(_qkv(1, 8, 8, 8), "fp32")
    flash_attention(tq, tk, tv)
    assert ops.launches == before


# --- the arithmetic of the bf16 tensor-core kernel ------------------------

def _mma_kernel_emulation(q, k, v, *, causal, q_start, split_p, bk=64):
    """The bf16 kernel's arithmetic on the CPU: scores in fp32 in the log2
    domain (scale hd**-0.5 * log2 e), key tiles of 64 with an online
    softmax in fp32, P rounded to bf16 before the PV product (with
    ``split_p``, P = hi + lo in two bf16 parts, as the kernel does), fp32
    accumulation, o = acc / max(l, 1e-30) rounded once to bf16."""
    BH, Sq, hd = q.shape
    Sk = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    scale_log2 = torch.tensor(1.4426950408889634 / hd ** 0.5,
                              dtype=torch.float32)
    m = torch.full((BH, Sq, 1), -1e30)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, hd))
    qpos = q_start + torch.arange(Sq)[:, None]
    for k0 in range(0, Sk, bk):
        s = qf @ kf[:, k0:k0 + bk].transpose(1, 2) * scale_log2
        if causal:
            kpos = k0 + torch.arange(s.shape[-1])[None, :]
            s = s.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p_hi = p.bfloat16().float()
        pv = p_hi @ vf[:, k0:k0 + bk]
        if split_p:
            pv = pv + (p - p_hi).bfloat16().float() @ vf[:, k0:k0 + bk]
        acc = acc * alpha + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("BH,Sq,Sk,hd,causal,q_start", [
    (2, 32, 32, 16, True, 0), (2, 64, 64, 8, True, 0),
    (2, 128, 128, 32, True, 0), (2, 96, 96, 16, True, 0),
    (2, 32, 32, 16, False, 0), (2, 64, 64, 8, False, 0),
    (2, 128, 128, 32, False, 0), (2, 96, 96, 16, False, 0),
    (1, 32, 64, 16, True, 32), (2, 20, 20, 16, True, 0),
    (2, 100, 100, 64, True, 0), (1, 130, 130, 128, True, 0),
])
@pytest.mark.parametrize("split_p", [False, True])
def test_bf16_probabilities_stay_within_tolerance(BH, Sq, Sk, hd, causal,
                                                  q_start, split_p):
    """P rounded to bf16 before PV (the plain chunked attention's
    rounding), and P split into bf16 hi + lo (the tensor-core kernel's),
    both stay within 2e-2 of the plain version and of the JAX kernel
    (interpret mode), at the reference grid's shapes in bf16."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(BH, Sq, Sk, hd, seed=Sq + hd),
                                       "bf16")
    got = _mma_kernel_emulation(tq, tk, tv, causal=causal, q_start=q_start,
                                split_p=split_p)
    oracle = attention_ref(tq, tk, tv, causal=causal, q_start=q_start)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=2e-2)
    want = jax_flash(jq, jk, jv, causal=causal, q_start=q_start)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


@pytest.mark.parametrize("split_p", [False, True])
def test_bf16_probabilities_ragged_q_start(split_p):
    """Ragged Sk with q_start > 0: the kernel masks the keys past Sk, so it
    is held to the plain version only (the reference wrapper pads them into
    the softmax there; see the padding-fault test above)."""
    _, (tq, tk, tv) = _both(_qkv(2, 20, 20, 8, seed=7), "bf16")
    got = _mma_kernel_emulation(tq, tk, tv, causal=True, q_start=8,
                                split_p=split_p)
    want = attention_ref(tq, tk, tv, causal=True, q_start=8)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)
