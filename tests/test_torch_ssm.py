"""The port's Mamba2 layer (``repro_torch.layers.ssm``) against the JAX
package's ``repro.layers.ssm``, on the CPU.

Parameters come from the reference's ``mamba2_spec`` through its
``init_params`` and are carried across as arrays; inputs come from numpy
seeds. The reference runs eagerly (op by op), so both packages round to
the input dtype at the same places.

Tolerances: fp32 atol = rtol = 1e-4; bf16 atol 2e-2 (a bf16 ulp at the
outputs' magnitude of a few units is 2**-7 to 2**-6). The recurrent decode
against the chunked prefill is held at 1e-4 in fp32 and at the
reference's own 0.2 in bf16 (tests/test_layers.py), where the two sum in
different orders before each bf16 rounding. The SSD against the naive
recurrence keeps the reference's 1e-3 (outputs) and 1e-4 (final state).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.layers.ssm as jssm
from repro.dist.sharding import init_params
from repro_torch.layers import ssm

B, S, D = 2, 16, 64
H, P, N = 16, 8, 8          # d_inner = 2 * D = 128 = H * P
TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=0.0)}
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


@pytest.fixture(scope="module")
def jparams(test_seed):
    spec = jssm.mamba2_spec(D, expand=2, head_dim=P, d_state=N,
                            mode="megatron")
    return init_params(jax.random.PRNGKey(test_seed), spec)


def _params(jparams, dtype):
    """(jax tree, port tree of torch tensors) in ``dtype``; both hold the
    same values."""
    jd, td = DT[dtype]
    jp = jax.tree.map(lambda a: a.astype(jd), jparams)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(td), jp)
    return jp, tp


def _x(shape, dtype, seed=0, scale=1.0):
    jd, td = DT[dtype]
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def _ssd_inputs(seed, L):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P)).astype(np.float32)
    dA = (-np.abs(rng.standard_normal((B, L, H))) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, L, N)).astype(np.float32)
    Cm = rng.standard_normal((B, L, N)).astype(np.float32)
    return x, dA, Bm, Cm


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["zeros", "state"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_causal_conv_matches_reference(jparams, dtype, with_state):
    jp, tp = _params(jparams, dtype)
    jx, tx = _x((B, S, 2 * D), dtype, seed=1)
    js = ts = None
    if with_state:
        js, ts = _x((B, ssm.D_CONV - 1, 2 * D), dtype, seed=2)
    jy, jst = jssm._causal_conv(jx, jp["conv_w"], jp["conv_b"], js)
    ty, tst = ssm._causal_conv(tx, tp["conv_w"], tp["conv_b"], ts)
    assert ty.dtype == tx.dtype and tst.shape == (B, ssm.D_CONV - 1, 2 * D)
    _close(ty, jy, TOL[dtype])
    _close(tst, jst, TOL[dtype])


def test_segsum_matches_reference():
    a = np.random.default_rng(3).standard_normal((2, 3, 7)).astype(
        np.float32)
    want = np.asarray(jssm._segsum(jnp.asarray(a)))
    got = ssm._segsum(torch.from_numpy(a)).numpy()
    upper = ~np.tril(np.ones((7, 7), bool))
    assert np.isneginf(got[..., upper]).all()
    assert np.isneginf(want[..., upper]).all()
    np.testing.assert_allclose(got[..., ~upper], want[..., ~upper],
                               **TOL["fp32"])


@pytest.mark.parametrize("chunk", [4, 8, 5], ids=["c4", "c8", "c5_ragged"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ssd_chunked_matches_reference(dtype, chunk, init):
    """The SSD runs in fp32 whatever its input dtype; a chunk of 5 does not
    divide 16 and falls back to one chunk in both packages."""
    jd, td = DT[dtype]
    arrs = _ssd_inputs(4, S)
    js = [jnp.asarray(a, jd) for a in arrs]
    ts = [torch.from_numpy(np.array(a, np.float32)).to(td) for a in js]
    j0 = t0 = None
    if init:
        s0 = np.random.default_rng(5).standard_normal(
            (B, H, P, N)).astype(np.float32)
        j0, t0 = jnp.asarray(s0), torch.from_numpy(s0)
    jy, jfin = jssm.ssd_chunked(*js, chunk=chunk, init_state=j0)
    ty, tfin = ssm.ssd_chunked(*ts, chunk=chunk, init_state=t0)
    assert ty.dtype == tfin.dtype == torch.float32
    _close(ty, jy, TOL["fp32"])
    _close(tfin, jfin, TOL["fp32"])


@pytest.mark.parametrize("chunk", [4, 5], ids=["c4", "c5_ragged"])
def test_ssd_chunked_vs_naive_recurrence(chunk):
    """Mirrors tests/test_layers.py::test_ssd_chunked_vs_naive on the port,
    with a chunk that does not divide the sequence as well."""
    x, dA, Bm, Cm = _ssd_inputs(0, S)
    y, fin = ssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dA, Bm, Cm)),
                             chunk=chunk)
    h = np.zeros((B, H, P, N))
    ys = []
    for t in range(S):
        h = h * np.exp(dA[:, t])[..., None, None] + np.einsum(
            "bhp,bn->bhpn", x[:, t], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, 1), atol=1e-3)
    np.testing.assert_allclose(fin.numpy(), h, atol=1e-4)


# ---------------------------------------------------------------------------
# the block: prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mamba2_matches_reference(jparams, dtype, chunk):
    jp, tp = _params(jparams, dtype)
    jx, tx = _x((B, S, D), dtype, seed=6)
    jy = jssm.mamba2(jp, jx, head_dim=P, d_state=N, chunk=chunk)
    ty = ssm.mamba2(tp, tx, head_dim=P, d_state=N, chunk=chunk)
    assert ty.dtype == tx.dtype and ty.shape == (B, S, D)
    _close(ty, jy, TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mamba2_decode_matches_reference(jparams, dtype):
    """One recurrent step from a random state: the output, the new SSM
    state (fp32) and the new conv state (stored in fp32)."""
    jp, tp = _params(jparams, dtype)
    jx, tx = _x((B, 1, D), dtype, seed=7)
    rng = np.random.default_rng(8)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    c0 = rng.standard_normal((B, ssm.D_CONV - 1, 2 * D)).astype(np.float32)
    jo, js, jc = jssm.mamba2_decode(jp, jx, jnp.asarray(s0),
                                    jnp.asarray(c0), head_dim=P)
    s0_t, c0_t = torch.from_numpy(s0.copy()), torch.from_numpy(c0.copy())
    to, ts, tc = ssm.mamba2_decode(tp, tx, s0_t, c0_t, head_dim=P)
    assert ts.dtype == tc.dtype == torch.float32 and to.dtype == tx.dtype
    assert torch.equal(s0_t, torch.from_numpy(s0))      # inputs untouched
    assert torch.equal(c0_t, torch.from_numpy(c0))
    for got, want in ((to, jo), (ts, js), (tc, jc)):
        _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_mamba2_decode_stepwise_matches_chunked(jparams, dtype):
    """Mirrors tests/test_layers.py::test_mamba2_decode_matches_chunked on
    the port: S decode steps from zero state give the chunked prefill's
    outputs (fp32 1e-4; bf16 the reference's 0.2)."""
    _, tp = _params(jparams, dtype)
    _, tx = _x((B, S, D), dtype, seed=9)
    y_full = ssm.mamba2(tp, tx, head_dim=P, d_state=N, chunk=4)
    shapes = ssm.mamba2_state_spec(B, 1, 2 * D, P, N)
    st = torch.zeros(shapes["ssm"][1:])
    cv = torch.zeros(shapes["conv"][1:])
    outs = []
    for t in range(S):
        o, st, cv = ssm.mamba2_decode(tp, tx[:, t:t + 1], st, cv,
                                      head_dim=P)
        outs.append(o)
    tol = TOL["fp32"] if dtype == "fp32" else dict(atol=0.2, rtol=0.0)
    np.testing.assert_allclose(torch.cat(outs, 1).float().numpy(),
                               y_full.float().numpy(), **tol)


def test_mamba2_state_spec_matches_reference():
    want = jssm.mamba2_state_spec(3, 5, 2 * D, P, N)
    got = ssm.mamba2_state_spec(3, 5, 2 * D, P, N)
    assert got == {k: tuple(v.shape) for k, v in want.items()}
    assert all(v.dtype == jnp.float32 for v in want.values())
