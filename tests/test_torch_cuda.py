"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card and skip without one. They import nothing of
JAX, so they also run where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
