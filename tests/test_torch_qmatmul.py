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


# --- the wgmma body: its data layout and its stream-K walk ----------------

def _swz(r, b):
    """Byte offset of (row, byte) in a tile of 128-byte rows under the
    TMA's 128-byte swizzle (the kernel's ``swz``)."""
    return r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15)


def _tma_box(rows_bytes, r0, c0, n_rows):
    """A TMA box of ``n_rows`` x 128 bytes at (row r0, byte c0) of a 2-D
    uint8 array, zero past its edges, as it lands in shared memory."""
    box = np.zeros((n_rows, 128), np.uint8)
    part = rows_bytes[r0:r0 + n_rows, c0:c0 + 128]
    box[:part.shape[0], :part.shape[1]] = part
    smem = np.zeros(n_rows * 128, np.uint8)
    r, b = np.meshgrid(np.arange(n_rows), np.arange(128), indexing="ij")
    smem[_swz(r, b)] = box
    return smem


def _split_planes(raw, nt):
    """The kernel's ``split_planes``: an int16 x tile (two boxes of 64
    columns) into its high and low byte planes, both swizzled."""
    hi = np.zeros(nt * 128, np.uint8)
    lo = np.zeros(nt * 128, np.uint8)
    for it in range(nt * 8):
        m, c = it >> 3, it & 7
        row = (c >> 2) * nt * 128
        src = np.concatenate([raw[row + _swz(m, 32 * (c & 3) + h * 16):][:16]
                              for h in (0, 1)])
        hi[_swz(m, 16 * c):][:16] = src[1::2]
        lo[_swz(m, 16 * c):][:16] = src[0::2]
    return hi, lo


def _unit_product(w_smem, b_plane, b_signed, nt):
    """One unit's two m64 x nt x k128 products as the consumer warpgroup
    forms them, mapped back to (token, column) by the epilogue's inverse of
    the transpose's permutation; int64, not yet reduced modulo 2^32.

    Thread (warp, g, t) reads rows 32s + 16q + 4t + i of columns
    32 warp + 4g .. + 3, transposes, and holds column 4g + 2p + h as row
    g + 8h (warp's 16-row slab) of product p, k 4t + 16q + i of step s."""
    warp, g, t, s, q, i = np.meshgrid(*(np.arange(n) for n in
                                        (4, 8, 4, 4, 2, 4)), indexing="ij")
    out = np.zeros((nt, 128), np.int64)
    # B: x^T, K-major from the plane, k32 step s at byte 32 s of each row
    m, k = np.meshgrid(np.arange(nt), np.arange(128), indexing="ij")
    bmat = b_plane[_swz(m, k)].astype(np.int64)
    if b_signed:
        bmat = np.where(bmat >= 128, bmat - 256, bmat)
    for p in range(2):
        for h in range(2):
            a = np.zeros((64, 128), np.int64)
            byte = w_smem[_swz(32 * s + 16 * q + 4 * t + i,
                               32 * warp + 4 * g) + 2 * p + h]
            val = np.where(byte >= 128, byte.astype(np.int64) - 256, byte)
            a[16 * warp + g + 8 * h, 32 * s + 4 * t + 16 * q + i] = val
            d = a @ bmat.T                        # [64 rows, nt tokens]
            rows = np.arange(64).reshape(4, 2, 8)[:, h, :].reshape(-1)
            cols = (32 * np.arange(4)[:, None] + 4 * np.arange(8)[None, :]
                    + 2 * p + h).reshape(-1)
            out[:, cols] = d[rows].T
    return out


def _segments(walk):
    """A block's walk as runs of one tile: (tile, [(position, k block)])."""
    segs = []
    for pos, (tile, kb) in enumerate(walk):
        if not segs or segs[-1][0] != tile:
            segs.append((tile, []))
        segs[-1][1].append((pos, kb))
    return segs


def _emulate_wgmma(x, w, b, sms, *, shift, relu=False, out_dtype="int8",
                   rounding="half_up", seed=0):
    """The wgmma body, unit by unit: TMA boxes, the byte planes of an int16
    x, the swap-AB products, each block's walk (``ops.wgmma_walk``) with
    its two consumer warpgroups taking alternate positions and adding
    their parts at each segment's end, and the fixup of split tiles: every
    part is added to its slot in a shuffled order modulo 2^32, and the
    part that brings the slot's counter to the tile's k blocks finishes
    the tile and leaves the slot zero."""
    from repro_torch.quant.srs import srs

    M, K = x.shape
    N = w.shape[1]
    p = ops.wgmma_plan(M, K, N, sms)
    nt, k = p.nt, p.k_blocks
    xb = x.numpy().view(np.uint8).reshape(M, -1)
    wb = w.numpy().view(np.uint8)
    wide = x.dtype == torch.int16

    def product(tile, kb):
        w_smem = _tma_box(wb, kb * 128, tile * 128, 128)
        if wide:
            raw = np.concatenate([_tma_box(xb, 0, kb * 256 + 128 * h, nt)
                                  for h in (0, 1)])
            hi, lo = _split_planes(raw, nt)
            return ((_unit_product(w_smem, hi, True, nt) << 8)
                    + _unit_product(w_smem, lo, False, nt))
        return _unit_product(w_smem, _tma_box(xb, 0, kb * 128, nt), True, nt)

    sk_base = p.tiles // p.grid * p.grid
    sk_units = p.units - sk_base * k
    ws = np.zeros((p.grid, nt, 128), np.int64)
    counters = np.zeros(p.grid, np.int64)
    acc = np.zeros((M, p.tiles * 128), np.int64)
    parts = []                                     # (tile, slot, kbs, sum)
    for blk in range(p.grid):
        segs = _segments(ops.wgmma_walk(p, blk))
        for j, (tile, units) in enumerate(segs):
            kbs = [kb for _, kb in units]
            assert kbs == list(range(kbs[0], kbs[0] + len(kbs)))
            consumer = [np.zeros((nt, 128), np.int64) for _ in (0, 1)]
            for pos, kb in units:
                consumer[pos % 2] = (consumer[pos % 2]
                                     + product(tile, kb)) & 0xFFFFFFFF
            seg = (consumer[1] + consumer[0]) & 0xFFFFFFFF
            if len(kbs) == k:
                acc[:, tile * 128:][:, :128] = seg[:M]
                continue
            # only stream-K parts are split, and a block walks them first
            assert tile >= sk_base and j <= 1
            slot = ((tile - sk_base) * k + 1) * p.grid - 1
            slot //= sk_units
            assert slot <= blk
            parts.append((tile, slot, len(kbs), seg))
    rng = np.random.default_rng(seed)
    finished = []
    for j in rng.permutation(len(parts)):
        tile, slot, kbs, part = parts[j]
        ws[slot] = (ws[slot] + part) & 0xFFFFFFFF
        counters[slot] += kbs
        if counters[slot] == k:                   # the last part finishes
            acc[:, tile * 128:][:, :128] = ws[slot][:M]
            ws[slot] = 0
            counters[slot] = 0
            finished.append(tile)
    assert len(finished) == len(set(finished))
    assert not ws.any() and not counters.any()   # the workspace stays zero
    acc = acc[:, :N]
    if b is not None:
        acc = (acc + b.numpy().astype(np.int64)[None, :]) & 0xFFFFFFFF
    acc = torch.from_numpy(np.where(acc >= 2**31, acc - 2**32, acc)
                           .astype(np.int32))
    y = srs(acc, shift, out_dtype, rounding)
    return torch.clamp(y, min=0) if relu else y


_WG_CASES = [  # M, K, N, x dtype, SMs: ragged N and K, split tiles and
    # round-robin whole tiles
    (1, 128, 128, "int8", 1),
    (4, 304, 160, "int8", 3),
    (8, 512, 256, "int16", 5),
    (17, 256, 384, "int8", 4),
    (24, 136, 144, "int16", 2),
    (32, 640, 128, "int16", 3),
    (33, 384, 272, "int8", 7),
    (64, 200, 48, "int16", 2),
    (8, 384, 1008, "int8", 3),
    (16, 256, 1280, "int16", 4),
]


@pytest.mark.parametrize("M,K,N,dt_a,sms", _WG_CASES)
def test_wgmma_body_emulation_is_bit_exact(M, K, N, dt_a, sms):
    """The wgmma body's layout and walk == both plain versions, full int16
    range (so the int32 sum wraps), bias near the int32 limits, every
    rounding and both outputs."""
    assert ops.wgmma_takes(M, K, N, getattr(torch, dt_a), torch.int8)
    rng = np.random.default_rng(M * 31 + K + N)
    lo = -(2**15) if dt_a == "int16" else -128
    x = rng.integers(lo, -lo, (M, K)).astype(dt_a)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    b = rng.integers(-(2**31), 2**31, (N,)).astype(np.int32)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    for out_dtype, rounding, shift, bias in (
            ("int8", "half_up", 9, tb), ("int16", "floor", 3, None),
            ("int16", "half_even", 12, tb)):
        kw = dict(shift=shift, relu=out_dtype == "int8", out_dtype=out_dtype,
                  rounding=rounding)
        got = _emulate_wgmma(tx, tw, bias, sms, seed=M + shift, **kw)
        want = np.asarray(jax_ref(jnp.asarray(x), jnp.asarray(w),
                                  None if bias is None else jnp.asarray(b),
                                  **kw))
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, qlinear_ref(tx, tw, bias, **kw))


def test_wgmma_body_emulation_agrees_with_interpret_mode():
    """The emulated wgmma body == the JAX Pallas kernel (interpret mode)
    on a split walk with ragged N."""
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, (17, 256)).astype(np.int8)
    w = rng.integers(-128, 128, (256, 144)).astype(np.int8)
    b = rng.integers(-(2**16), 2**16, (144,)).astype(np.int32)
    want = np.asarray(jax_qlinear(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b), shift=7, relu=True,
                                  interpret=True))
    got = _emulate_wgmma(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), 3, shift=7, relu=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M", [1, 4, 8, 9, 17, 24, 25, 32, 33, 48, 49, 64])
def test_wgmma_plan_takes_the_narrowest_width(M):
    p = ops.wgmma_plan(M, 4096, 4096, 132)
    assert p.nt in ops.WG_WIDTHS and p.nt >= M
    assert all(n < M for n in ops.WG_WIDTHS if n < p.nt)


@pytest.mark.parametrize("K,N", [(128, 128), (11008, 4096), (4096, 64000),
                                 (2560, 151936), (4096, 32064), (136, 16),
                                 (384, 1008), (28672, 8192)])
@pytest.mark.parametrize("sms", [132, 7, 1])
def test_wgmma_walk_takes_every_unit_once(K, N, sms):
    """Every unit belongs to exactly one block's walk, the walks differ by
    at most one unit, the grid is at most the SM count, only a block's
    first two segments are parts of split tiles, and a split tile's slot
    (its first block) belongs to no other split tile."""
    p = ops.wgmma_plan(8, K, N, sms)
    assert p.k_blocks == -(-K // ops.WG_BLOCK_K)
    assert p.tiles == -(-N // ops.WG_BLOCK_N)
    assert p.units == p.k_blocks * p.tiles
    assert 1 <= p.grid <= sms and p.grid <= p.units
    walks = [ops.wgmma_walk(p, b) for b in range(p.grid)]
    units = [u for walk in walks for u in walk]
    assert len(units) == p.units == len(set(units))
    assert set(units) == {(t, kb) for t in range(p.tiles)
                          for kb in range(p.k_blocks)}
    sizes = [len(walk) for walk in walks]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    owners = {}
    for b, walk in enumerate(walks):
        for j, (tile, seg) in enumerate(_segments(walk)):
            if len(seg) < p.k_blocks:
                assert j <= 1
            owners.setdefault(tile, []).append(b)
    sk_base = p.tiles // p.grid * p.grid
    sk_units = p.units - sk_base * p.k_blocks
    slots = set()
    for tile, blocks in owners.items():
        assert len(blocks) == len(set(blocks))
        if len(blocks) > 1:
            slot = ((tile - sk_base) * p.k_blocks + 1) * p.grid - 1
            assert slot // sk_units == min(blocks)
            assert min(blocks) not in slots
            slots.add(min(blocks))


def test_wgmma_plan_of_the_lm_shapes():
    """The decode shapes on an H100 (132 SMs): one block per SM, 16 to
    180 units of 16 KB of w each."""
    assert ops.wgmma_plan(32, 11008, 4096, 132) == ops.WgPlan(
        32, 86, 32, 2752, 132)
    assert ops.wgmma_plan(4, 4096, 64000, 132) == ops.WgPlan(
        8, 32, 500, 16000, 132)
    assert ops.wgmma_plan(8, 6912, 2560, 132) == ops.WgPlan(
        8, 54, 20, 1080, 132)
    assert ops.wgmma_plan(1, 128, 128, 132).grid == 1
    with pytest.raises(ValueError):
        ops.wgmma_plan(65, 128, 128, 132)


@pytest.mark.parametrize("M,K,N,dt_x,dt_w,aligned,body", [
    (4, 11008, 4096, torch.int16, torch.int8, True, "mma"),     # M <= 16
    (8, 4096, 64000, torch.int8, torch.int8, True, "mma"),
    (16, 11008, 4096, torch.int16, torch.int8, True, "mma"),
    (17, 11008, 4096, torch.int16, torch.int8, True, "wgmma"),
    (32, 4096, 64000, torch.int8, torch.int8, True, "wgmma"),
    (1, 512, 512, torch.int8, torch.int8, True, "mma"),
    (64, 4096, 32064, torch.int8, torch.int8, True, "wgmma"),
    (65, 4096, 4096, torch.int8, torch.int8, True, "mma"),      # M > 64
    (128, 512, 256, torch.int8, torch.int8, True, "mma"),
    (8, 4096, 4096, torch.int16, torch.int16, True, "mma"),     # int16 w
    (8, 4096, 4096, torch.int8, torch.int8, False, "mma"),      # base
    (8, 70, 4096, torch.int8, torch.int8, True, "mma"),         # x rows
    (8, 4100, 4096, torch.int16, torch.int8, True, "mma"),      # 8200 B
    (8, 4096, 50, torch.int8, torch.int8, True, "mma"),         # w rows
    (8, 0, 64, torch.int8, torch.int8, True, "mma"),            # K = 0
    (4, 8, 16, torch.int16, torch.int8, True, "mma"),
    (24, 8, 16, torch.int16, torch.int8, True, "wgmma"),
])
def test_route_sends_each_call_to_its_body(M, K, N, dt_x, dt_w, aligned,
                                           body):
    """The wgmma body takes M 17-64 of the calls it can serve: the rows the
    mma.sync body pads to its 64-row tile; everything else stays there."""
    assert ops.route(M, K, N, dt_x, dt_w, aligned) == body
    assert ops.wgmma_takes(M, K, N, dt_x, dt_w, aligned) == (
        1 <= M <= ops.WG_MAX_M and K >= 1 and aligned and dt_w == torch.int8
        and K * dt_x.itemsize % 16 == 0 and N % 16 == 0)
    if body == "wgmma":
        assert ops.wgmma_takes(M, K, N, dt_x, dt_w, aligned)


@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 32, 64])
def test_route_follows_the_crossover_row_count(M, monkeypatch):
    """WG_MIN_M moves every call the wgmma body takes between the bodies:
    at 1 all of them go to it, above WG_MAX_M none does."""
    args = (M, 11008, 4096, torch.int16, torch.int8)
    assert ops.route(*args) == ("wgmma" if M > ops.SMALL_M else "mma")
    monkeypatch.setattr(ops, "WG_MIN_M", 1)
    assert ops.route(*args) == "wgmma"
    monkeypatch.setattr(ops, "WG_MIN_M", ops.WG_MAX_M + 1)
    assert ops.route(*args) == "mma"


def test_workspace_cache_is_bounded_and_keeps_the_recent(monkeypatch):
    """One zeroed workspace per (device, stream), reused while it is kept;
    past _MAX_WORKSPACES streams the least recently used is dropped."""
    monkeypatch.setattr(ops, "_workspaces", type(ops._workspaces)())
    dev = torch.device("cpu")
    first = ops._workspace(dev, 1, 1)
    assert first.numel() == ops.WG_SLOT + 1 and not first.any()
    for stream in range(2, ops._MAX_WORKSPACES + 1):
        ops._workspace(dev, stream, 1)
    assert ops._workspace(dev, 1, 1) is first       # used last: kept
    ops._workspace(dev, 100, 1)                     # drops stream 2
    assert len(ops._workspaces) == ops._MAX_WORKSPACES
    assert (None, 2) not in ops._workspaces
    assert ops._workspace(dev, 1, 1) is first
