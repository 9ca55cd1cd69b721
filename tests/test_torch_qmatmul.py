"""The port's qmatmul (plain version, and the wrapper on CPU tensors) vs the
JAX reference, over the grid of tests/test_qmatmul_kernel.py plus every
rounding mode and a forced int32-wraparound case. Every comparison is
array_equal: all paths are integer."""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import hypothesis_or_skip_stub

from repro.kernels.qmatmul.ops import qlinear as jax_qlinear
from repro.kernels.qmatmul.ref import qlinear_ref as jax_ref
from repro_torch.kernels.qmatmul import ops
from repro_torch.kernels.qmatmul.ref import qlinear_ref

given, settings, st = hypothesis_or_skip_stub()

SHAPES = [
    (1, 8, 8),
    (4, 8, 8),
    (8, 128, 128),
    (128, 128, 128),
    (33, 70, 50),
    (256, 64, 96),
    (5, 1, 3),
]


def _rand(rng, shape, dtype):
    lo, hi = (-128, 128) if dtype == "int8" else (-1024, 1024)
    return rng.integers(lo, hi, shape).astype(dtype)


def _assert_matches(x, w, b, **kw):
    """Port plain version and port qlinear (CPU) == JAX qlinear_ref."""
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w),
                              None if b is None else jnp.asarray(b), **kw))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    for fn in (qlinear_ref, ops.qlinear):
        got = fn(tx, tw, tb, **kw)
        assert str(got.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("use_bias", [False, True])
def test_i8_bit_exact(M, K, N, relu, use_bias):
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    x = _rand(rng, (M, K), "int8")
    w = _rand(rng, (K, N), "int8")
    b = rng.integers(-(2**16), 2**16, (N,)).astype(np.int32) if use_bias else None
    for shift in (0, 5, 9):
        _assert_matches(x, w, b, shift=shift, relu=relu)


@pytest.mark.parametrize("M,K,N", [(8, 16, 24), (64, 64, 64)])
@pytest.mark.parametrize("dt_a,dt_b,out_dtype", [
    ("int16", "int8", "int8"),
    ("int16", "int8", "int16"),
    ("int16", "int16", "int16"),
])
def test_mixed_precision_bit_exact(M, K, N, dt_a, dt_b, out_dtype):
    rng = np.random.default_rng(M + K + N)
    x = _rand(rng, (M, K), dt_a)
    w = _rand(rng, (K, N), dt_b)
    _assert_matches(x, w, None, shift=8, out_dtype=out_dtype)


@pytest.mark.parametrize("rounding", ["floor", "half_up", "half_even"])
def test_rounding_modes_bit_exact(rounding):
    rng = np.random.default_rng(6)
    x = _rand(rng, (16, 32), "int8")
    w = _rand(rng, (32, 16), "int8")
    b = rng.integers(-(2**12), 2**12, (16,)).astype(np.int32)
    for shift in range(13):
        _assert_matches(x, w, b, shift=shift, rounding=rounding)
        _assert_matches(x, w, None, shift=shift, rounding=rounding,
                        out_dtype="int16", relu=True)


@pytest.mark.parametrize("out_dtype", ["int8", "int16"])
def test_int32_wraparound_bit_exact(out_dtype):
    """int16 x int16 at K=4096 near +-32767 with a bias near the int32
    limits: the accumulator wraps, and half_up's addend wraps too."""
    rng = np.random.default_rng(3)
    M, K, N = 6, 4096, 10
    x = (rng.choice([-1, 1], (M, 1))
         * rng.integers(32700, 32768, (M, K))).astype(np.int16)
    w = (rng.choice([-1, 1], (1, N))
         * rng.integers(32700, 32768, (K, N))).astype(np.int16)
    b = np.where(rng.random(N) < 0.5, 2**31 - 1 - rng.integers(0, 64, N),
                 -(2**31) + rng.integers(0, 64, N)).astype(np.int32)
    assert np.abs(x.astype(np.float64) @ w.astype(np.float64)).max() > 2**31
    for shift in range(13):
        _assert_matches(x, w, b, shift=shift, out_dtype=out_dtype,
                        rounding="half_up")


def test_interpret_mode_kernel_agrees():
    """The JAX Pallas kernel (interpret mode) == the port on one case."""
    rng = np.random.default_rng(1)
    x = _rand(rng, (33, 70), "int8")
    w = _rand(rng, (70, 50), "int8")
    b = rng.integers(-(2**16), 2**16, (50,)).astype(np.int32)
    want = np.asarray(jax_qlinear(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), shift=7, relu=True,
                                  interpret=True))
    got = ops.qlinear(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), shift=7, relu=True)
    np.testing.assert_array_equal(got.numpy(), want)


@given(
    m=st.integers(1, 40), k=st.integers(1, 48), n=st.integers(1, 40),
    shift=st.integers(0, 12), relu=st.booleans(), seed=st.integers(0, 2**31),
)
@settings(max_examples=10, deadline=None)
def test_property_random_shapes(m, k, n, shift, relu, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    b = rng.integers(-(2**12), 2**12, (n,)).astype(np.int32)
    _assert_matches(x, w, b, shift=shift, relu=relu)


def test_relu_clamps_after_srs():
    x = torch.full((4, 8), -10, dtype=torch.int8)
    w = torch.full((8, 4), 10, dtype=torch.int8)
    assert int(ops.qlinear(x, w, None, shift=0, relu=True).min()) == 0


def test_cpu_tensors_launch_no_kernel():
    before = ops.launches
    x = torch.ones((4, 8), dtype=torch.int8)
    w = torch.ones((8, 4), dtype=torch.int8)
    ops.qlinear(x, w, None, shift=1, block=(8, 8, 8), acc_blocks=(2, 2))
    assert ops.launches == before


def test_plain_version_rejects_inexact_contraction():
    """K * 2^15 * 2^15 >= 2^53 could round in float64: refuse, not guess."""
    x = torch.empty((1, 2**23), dtype=torch.int16)
    w = torch.empty((2**23, 1), dtype=torch.int16)
    with pytest.raises(ValueError, match="2\\^53"):
        qlinear_ref(x, w, shift=0)
    with pytest.raises(TypeError):
        qlinear_ref(x.float()[:, :8], w.float()[:8], shift=0)


# --- the arithmetic the CUDA kernel relies on -----------------------------

def _mod32(v):
    return v & 0xFFFFFFFF


def _byte_parts(t):
    """(part, shift) pairs with t == sum(part << shift): an int16 splits
    into its signed high byte and unsigned low byte, an int8 stays whole."""
    t = t.to(torch.int64)
    return [(t >> 8, 8), (t & 0xFF, 0)]


def _byte_split_product(x, w):
    """x @ w modulo 2^32 as the kernel forms it: each int16 operand split
    into a signed high byte and an unsigned low byte, one int8 product per
    pair of parts, each summed modulo 2^32 (the MMA's wrapping s32
    accumulator), recombined with shifts 16, 8 and 0 modulo 2^32."""
    xs = _byte_parts(x) if x.dtype == torch.int16 else [(x.to(torch.int64), 0)]
    ws = _byte_parts(w) if w.dtype == torch.int16 else [(w.to(torch.int64), 0)]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64)
    for xp, sx in xs:
        for wp, sw in ws:
            for part in (xp, wp):   # every MMA operand fits s8 or u8
                assert part.numel() == 0 or (-128 <= int(part.min())
                                             and int(part.max()) <= 255)
            acc = _mod32(acc + (_mod32(xp @ wp) << (sx + sw)))
    return acc


def _emulate_kernel(x, w, b, *, shift, relu=False, out_dtype="int8",
                    rounding="half_up"):
    from repro_torch.quant.srs import srs

    acc = _byte_split_product(x, w)
    if b is not None:
        acc = _mod32(acc + b.to(torch.int64)[None, :])
    acc = torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)
    y = srs(acc, shift, out_dtype, rounding)
    return torch.clamp(y, min=0) if relu else y


def _assert_emulation_matches(x, w, b, **kw):
    want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w),
                              None if b is None else jnp.asarray(b), **kw))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b)
    got = _emulate_kernel(tx, tw, tb, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, qlinear_ref(tx, tw, tb, **kw))


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dt_a,dt_b", [("int8", "int8"), ("int16", "int8"),
                                       ("int16", "int16")])
def test_byte_split_product_is_bit_exact(M, K, N, dt_a, dt_b):
    """The kernel's byte-split int8 products == both plain versions over
    the reference's test grid, full int16 range included."""
    rng = np.random.default_rng(M * 7 + K * 3 + N)
    lo, hi = (-128, 128) if dt_a == "int8" else (-32768, 32768)
    x = rng.integers(lo, hi, (M, K)).astype(dt_a)
    lo, hi = (-128, 128) if dt_b == "int8" else (-32768, 32768)
    w = rng.integers(lo, hi, (K, N)).astype(dt_b)
    b = rng.integers(-(2**31), 2**31, (N,)).astype(np.int32)
    for out_dtype in ("int8", "int16"):
        for rounding in ("floor", "half_up", "half_even"):
            _assert_emulation_matches(x, w, b, shift=11, relu=True,
                                      out_dtype=out_dtype, rounding=rounding)
            _assert_emulation_matches(x, w, None, shift=3,
                                      out_dtype=out_dtype, rounding=rounding)


@pytest.mark.parametrize("dt_b", ["int8", "int16"])
def test_byte_split_product_wraps_like_int32(dt_b):
    """int16 x int16 (and int16 x int8) near the limits at K=4096: the
    int32 sum wraps, and the per-part wrapping sums still give its bits."""
    rng = np.random.default_rng(3)
    M, K, N = 6, 4096, 10
    x = (rng.choice([-1, 1], (M, 1))
         * rng.integers(32700, 32768, (M, K))).astype(np.int16)
    top = 32768 if dt_b == "int16" else 128
    w = (rng.choice([-1, 1], (1, N))
         * rng.integers(top - 60, top, (K, N))).astype(dt_b)
    b = rng.integers(-(2**31), 2**31, (N,)).astype(np.int32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(exact).max() > 2**31
    for shift in (0, 5, 12):
        _assert_emulation_matches(x, w, b, shift=shift, out_dtype="int16")


@pytest.mark.parametrize("M", [1, 4, 16, 17, 1024])
@pytest.mark.parametrize("K", [0, 1, 70, 512, 2048, 11008])
@pytest.mark.parametrize("N", [3, 50, 4096, 64000])
@pytest.mark.parametrize("sms", [132, 8])
def test_split_k_plan_tiles_k(M, K, N, sms):
    """Every split of the plan covers [0, K) exactly once, on boundaries
    that are multiples of 32 (of the kernel's 64-deep stages)."""
    p = ops.plan(M, K, N, sms)
    assert p.block_m == (16 if M <= 16 else 64)
    ranges = ops.split_ranges(p, K)
    assert len(ranges) == p.splits >= 1
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2 and lo < hi and hi % 32 == 0 and hi % ops.BLOCK_K == 0
    if p.splits > 1:
        assert p.k_per_split >= ops.MIN_K_PER_SPLIT
        tiles = -(-M // p.block_m) * -(-N // ops.BLOCK_N)
        assert tiles < ops.WAVES * sms


def test_split_k_plan_of_the_lm_shapes():
    """The decode shapes on an H100 (132 SMs): the down-projection's 32
    column tiles get 9 splits, the head's 500 tiles none."""
    assert ops.plan(4, 11008, 4096, 132) == ops.Plan(16, 9, 1280)
    assert ops.plan(4, 4096, 64000, 132) == ops.Plan(16, 1, 4096)
    assert ops.plan(1, 512, 512, 132).splits == 1


@pytest.mark.parametrize("M,K,N", [(4, 11008, 40), (17, 2048, 9), (1, 70, 5)])
def test_split_k_partials_sum_to_the_whole(M, K, N):
    """Partial sums over the plan's splits, added modulo 2^32, equal the
    unsplit sum: the bits do not depend on the split."""
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.integers(-32768, 32768, (M, K)).astype(np.int16))
    w = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    p = ops.plan(M, K, N, sms=132)
    assert (p.splits > 1) == (K >= 2 * ops.MIN_K_PER_SPLIT)
    whole = _byte_split_product(x, w)
    acc = torch.zeros_like(whole)
    for lo, hi in ops.split_ranges(p, K):
        acc = _mod32(acc + _byte_split_product(x[:, lo:hi], w[lo:hi]))
    assert torch.equal(acc, whole)
