"""The port's training objective against the JAX package's, on the CPU,
for the families beside the decoder LMs (RWKV6, the hybrid, the
encoder-decoder, the vision LM): the loss and its gradients in fp32 and
bf16, checkpointing (remat) and the loss curve of 10 adamw steps. The
checks and their tolerances are ``tests/_torch_train_ref.py``'s.
"""

import pytest
from _torch_train_ref import (
    check_adamw_curve,
    check_bf16_grads,
    check_fp32_grads,
    check_remat,
)

ARCHS = ["rwkv6_7b", "zamba2_2_7b", "seamless_m4t_large_v2",
         "llama_3_2_vision_90b"]


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
