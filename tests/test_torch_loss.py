"""The port's training objective against the JAX package's, on the CPU,
for the decoder LMs (dense and MoE): the loss and its gradients in fp32
and bf16, checkpointing (remat) and the loss curve of 10 adamw steps (the
checks and their tolerances: ``tests/_torch_train_ref.py``); the mirror
of the reference's smoke test; and the rule that keeps the kernels off
the gradient path (``mha`` never sends a recorded call to flash, both
kernel wrappers raise on grad-requiring inputs, the card's fp32-output
GEMM has a backward).
"""

import pytest
import torch
from _torch_train_ref import (
    check_adamw_curve,
    check_bf16_grads,
    check_fp32_grads,
    check_remat,
)

import repro_torch.layers.attention as tattn
from repro_torch.bridge import leaf_groups
from repro_torch.configs import reduced_config
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.trainer import train_step


ARCHS = ["yi_6b", "qwen1_5_4b", "mistral_large_123b", "qwen1_5_110b",
         "phi3_5_moe_42b", "kimi_k2_1t"]


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_loss_and_grads_match_reference(arch):
    check_fp32_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_match_reference(arch):
    check_bf16_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_equal(arch):
    check_remat(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_loss_curve_matches_reference(arch):
    check_adamw_curve(arch)


def test_decoder_lm_loss_decreases_quickly():
    """The mirror of the reference's smoke test: a tiny decoder learns the
    synthetic motif structure (30 adamw steps, lr 3e-3, by at least 0.3)."""
    cfg = reduced_config("yi_6b").with_(vocab=64, n_layers=2)
    model = build_model(cfg, device="cpu").init_params(0)
    opt = adamw(lr=3e-3)
    groups = leaf_groups(model)
    state = opt.init(dict(model.named_parameters()), groups)
    ds = SyntheticTokens(vocab=64, seq_len=32, global_batch=8, seed=1)
    losses = []
    for i in range(30):
        batch = {k: torch.from_numpy(v) for k, v in ds.batch(i).items()}
        losses.append(float(train_step(model, opt, state, batch,
                                       groups=groups)["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::10]
    assert not any(p.requires_grad for p in model.parameters())


def _qkv(requires_grad):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(2, 16, 4, 16, generator=g,
                        requires_grad=requires_grad) for _ in range(3)]


@pytest.mark.parametrize("records", [False, True])
def test_mha_never_sends_a_recorded_call_to_flash(monkeypatch, records):
    """With the switch on, ``mha`` routes a self-attention prefill to the
    flash wrapper only when autograd does not record through it; a
    grad-requiring call runs the plain path and gets its gradients."""
    calls = []

    def spy(q, k, v, **kw):
        calls.append(q.shape)
        return flash_ops.attention_ref(q, k, v, causal=kw["causal"],
                                       q_start=kw["q_start"])

    monkeypatch.setattr(tattn, "USE_FLASH_KERNEL", True)
    monkeypatch.setattr(tattn, "flash_attention", spy)
    q, k, v = _qkv(records)
    out = tattn.mha(q, k, v, causal=True, q_chunk=8)
    assert len(calls) == (0 if records else 1)
    if records:
        out.sum().backward()
        assert all(t.grad is not None and t.grad.abs().sum() > 0
                   for t in (q, k, v))
    with torch.no_grad():
        tattn.mha(q, k, v, causal=True, q_chunk=8)
    assert len(calls) == (1 if records else 2)


def test_kernel_wrappers_raise_on_recorded_inputs(monkeypatch):
    """Both kernel wrappers (and the quantized linear in front of qmatmul)
    raise for an input that requires grad while grad is enabled; a ctypes
    launch would return a tensor with no gradient. The CUDA branch is
    never reached: the check comes first, so a CPU stand-in shows it."""
    from repro_torch.kernels.qmatmul import ops as qops
    from repro_torch.layers.linear import quantized_linear

    q, k, v = (t.flatten(0, 1).transpose(0, 1).contiguous()
               for t in _qkv(True))
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        flash_ops.flash_attention(q, k, v)
    w = torch.randn(16, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="qmatmul has no backward"):
        quantized_linear({"w": w}, torch.randn(4, 16))
    with pytest.raises(RuntimeError, match="qmatmul has no backward"):
        quantized_linear({"w": w.detach()}, torch.randn(4, 16,
                                                        requires_grad=True))
    xq = torch.ones(4, 16, dtype=torch.int8)
    wq = torch.ones(16, 8, dtype=torch.int8)
    stand_in = torch.ones(8, requires_grad=True)
    with pytest.raises(RuntimeError, match="qmatmul has no backward"):
        qops.qlinear(xq, wq, stand_in, shift=0)
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v)
        quantized_linear({"w": w}, torch.randn(4, 16))


def test_matmul_f32_backward_is_two_gemms_at_forward_precision(monkeypatch):
    """The card's fp32-output GEMM has no derivative in torch; the port's
    ``_MatmulF32`` supplies one: bf16 operands (the gradient rounded to
    bf16), fp32 accumulation. Here the cuBLAS product is stood in for by
    the upcast one, so the backward formula runs on the CPU."""
    from repro_torch.layers import linear as lin

    monkeypatch.setattr(lin, "_mm_f32", lambda a, b: torch.matmul(
        a.float(), b.float()))
    g = torch.Generator().manual_seed(1)
    for shape_a, shape_b in (((6, 8), (8, 5)), ((3, 6, 8), (3, 8, 5))):
        a = torch.randn(shape_a, generator=g).bfloat16().requires_grad_()
        b = torch.randn(shape_b, generator=g).bfloat16().requires_grad_()
        gy = torch.randn(*shape_a[:-1], shape_b[-1], generator=g)
        y = lin._MatmulF32.apply(a, b)
        assert y.dtype == torch.float32
        y.backward(gy)
        gyb = gy.bfloat16()
        assert a.grad.dtype == b.grad.dtype == torch.bfloat16
        assert torch.equal(a.grad, torch.matmul(gyb, b.detach().transpose(
            -1, -2)))
        assert torch.equal(b.grad, torch.matmul(a.detach().transpose(-1, -2),
                                                gyb))
