"""The port's quant substrate vs the JAX reference: bit-exact SRS, shifts,
quantize/dequantize/requantize on the same numpy inputs."""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the packages re-export the function ``srs``, which shadows the module
jsrs = importlib.import_module("repro.quant.srs")
tsrs = importlib.import_module("repro_torch.quant.srs")
jq = importlib.import_module("repro.quant.qtensor")
tq = importlib.import_module("repro_torch.quant.qtensor")

I32_MIN, I32_MAX = -(2**31), 2**31 - 1


def _acc_values(seed: int) -> np.ndarray:
    """Random int32 accumulators plus values at and near the int32 limits."""
    rng = np.random.default_rng(seed)
    edges = np.concatenate([
        I32_MAX - np.arange(0, 4200), I32_MIN + np.arange(0, 4200),
        np.arange(-4200, 4200),
    ])
    rand = rng.integers(I32_MIN, I32_MAX, 4000, endpoint=True)
    return np.concatenate([edges, rand]).astype(np.int32)


@pytest.mark.parametrize("out_dtype", ["int8", "int16", "int32"])
@pytest.mark.parametrize("rounding", ["floor", "half_up", "half_even"])
def test_srs_bit_exact(rounding, out_dtype):
    acc = _acc_values(seed=len(rounding) * 7 + len(out_dtype))
    for shift in range(13):
        want = np.asarray(jsrs.srs(jnp.asarray(acc), shift, out_dtype, rounding))
        got = tsrs.srs(torch.from_numpy(acc), shift, out_dtype, rounding)
        assert str(got.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("out_dtype", ["int8", "int16", "int32"])
def test_saturate_bit_exact(out_dtype):
    acc = _acc_values(seed=3)
    want = np.asarray(jsrs.saturate(jnp.asarray(acc), out_dtype))
    got = tsrs.saturate(torch.from_numpy(acc), out_dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_srs_rejects_what_the_reference_rejects():
    acc = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tsrs.srs(acc, -1)
    with pytest.raises(ValueError):
        tsrs.srs(acc, 3, rounding="nearest")
    assert tsrs.requant_shift(7, 6, 5) == jsrs.requant_shift(7, 6, 5) == 8
    with pytest.raises(ValueError):
        tsrs.requant_shift(1, 1, 5)


@pytest.mark.parametrize("dtype", ["int8", "int16", "int32"])
@pytest.mark.parametrize("rounding", ["floor", "half_up", "half_even"])
def test_quantize_bit_exact(dtype, rounding):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((33, 17)) * 3.0
    # exact ties exercise the rounding modes
    x[0, :8] = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.25, -0.75])
    for shift in (None, 0, 3, 9):
        want = jq.quantize(x, dtype, shift, rounding)
        got = tq.quantize(x, dtype, shift, rounding)
        assert got.shift == want.shift
        assert got.dtype == str(want.data.dtype)
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
        np.testing.assert_array_equal(got.dequantize().numpy(),
                                      np.asarray(jq.dequantize(want)))


def test_choose_shift_matches():
    rng = np.random.default_rng(5)
    for scale in (1e-9, 1e-3, 0.3, 1.0, 7.0, 300.0):
        x = rng.standard_normal(64) * scale
        for dtype in ("int8", "int16", "int32"):
            for margin in (0, 2):
                assert tq.choose_shift(x, dtype, margin) == \
                    jq.choose_shift(x, dtype, margin)
    assert tq.choose_shift(np.zeros(3)) == jq.choose_shift(np.zeros(3)) == 0


def test_requantize_bit_exact():
    rng = np.random.default_rng(9)
    data = rng.integers(-32768, 32768, 500).astype(np.int16)
    jt = jq.QTensor(jnp.asarray(data), 12)
    tt = tq.QTensor(torch.from_numpy(data), 12)
    for new_shift in (12, 9, 4, 0):
        for out in ("int8", "int16"):
            want = jq.requantize(jt, new_shift, out)
            got = tq.requantize(tt, new_shift, out)
            assert got.shift == want.shift
            np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    with pytest.raises(ValueError):
        tq.requantize(tt, 13)
