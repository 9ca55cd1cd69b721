"""The port's paged KV against the JAX package's, on the CPU: the page
allocator, the paged decode attention, one paged micro-run, and
continuous serving over the shared page pool.

Reduced yi-6b (2 layers, vocab 64) on the reference's weights. Tolerances:
the paged attention fp32 atol = rtol = 1e-5, bf16 atol 2e-2; token streams
follow the rule of ``_torch_serve_ref`` (equal up to the first step whose
reference top-2 gap is below 0.02). After every run the pool must hold
only scratch pages and prefix-cache entries.
"""

import _torch_threads  # noqa: F401  (one torch thread per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_serve_ref import (
    PARITY_TRACE,
    SHARED_TRACE,
    arrays,
    assert_streams,
    jax_cfg,
    jax_params,
    jax_reference,
    port_batcher,
    serve,
    torch_cfg,
)

from repro_torch.launch.steps import make_masked_decode_step
from repro_torch.layers.attention import paged_decode_self_attention
from repro_torch.models.base import PageView, state_batch_axes
from repro_torch.plan import build_plan
from repro_torch.serve import (
    Bucket,
    BucketPolicy,
    DecodeRequest,
    PageAllocator,
    StatePool,
    auto_paged,
)

PAGED = (64, 16)          # (page_count, page_size), as in the reference
TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=0.0)}
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}


def _reclaimed(b):
    """After a drained run(), only scratch + prefix-cache pages remain."""
    s = b.stats()["paged"]
    assert s["pages_in_use"] == s["scratch_pages"] + s["prefix_entries"], s


def _paged_batcher(seed, k, quantized=False):
    return port_batcher(seed, quantized, schedule="continuous",
                        steps_per_dispatch=k,
                        policy=BucketPolicy([Bucket(64, 2)]), paged=PAGED)


# ---------------------------------------------------------------------------
# the page allocator equals the reference's on the same sequences
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_page_allocator_matches_reference(seed):
    """Seeded admit / publish / release / scratch sequences with a shared
    system prompt, under pool pressure (evictions, refused admissions):
    the same leases, page ids and stats after every operation."""
    from repro.serve.paging import PageAllocator as JaxPageAllocator

    rng = np.random.default_rng(seed)
    allocs = [PageAllocator(24, 4), JaxPageAllocator(24, 4)]
    system = [int(t) for t in rng.integers(1, 50, 9)]
    leases = [[], []]
    trail = [[], []]
    for step in range(120):
        op = rng.random()
        if op < 0.5:
            prompt = ((system if rng.random() < 0.6 else [])
                      + [int(t) for t in rng.integers(1, 50,
                                                      rng.integers(1, 7))])
            need = len(prompt) + int(rng.integers(1, 8))
        fed = int(rng.integers(0, 12))
        pick = int(rng.integers(0, 1 << 30))
        for a, ls, tr in zip(allocs, leases, trail):
            if step == 0:
                tr.append(("scratch", a.scratch(2)))
            if op < 0.5:
                tr.append(("can", a.can_admit(prompt, need)))
                lease = a.admit(prompt, need)
                if lease is not None:
                    ls.append(lease)
                tr.append(("admit", lease and (list(lease.pages),
                                               lease.shared)))
            elif ls and op < 0.75:
                tr.append(("publish", a.publish(ls[pick % len(ls)], fed)))
            elif ls:
                lease = ls.pop(pick % len(ls))
                a.publish(lease, len(lease.prompt))
                a.release(lease)
            tr.append(("stats", a.stats()))
    assert trail[0] == trail[1]
    final = trail[0][-1][1]
    assert final["prefix_hits"] > 0 and final["evictions"] > 0


# ---------------------------------------------------------------------------
# the paged decode attention and one paged micro-run vs the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_paged_decode_self_attention_matches_jax(test_seed, dtype):
    """Four slots over a 12-page pool of 4-token pages: two share page 0
    read-only (a prefix hit), one is an empty lane on its scratch page,
    and one sits past its table (local 20 clipped to 15, written into its
    scratch tail). Output and both pools after the in-place write."""
    from repro.layers.attention import paged_decode_self_attention as jpaged
    from repro.models.base import PageView as JaxPageView

    tcfg = torch_cfg()
    jd, td = DT[dtype]
    jl = jax.tree.map(lambda a: a[0].astype(jd),
                      jax_params(test_seed)["blocks"]["attn"])
    tl = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(td), jl)
    rng = np.random.default_rng(3)
    ps, B = 4, 4
    pool = [rng.standard_normal((12, ps, tcfg.n_kv, tcfg.head_dim))
            .astype(np.float32) for _ in range(2)]
    table = np.array([[0, 1, 2, 8], [0, 3, 4, 9], [10, 10, 10, 10],
                      [5, 6, 11, 11]], np.int32)
    local = np.array([9, 5, 0, 20], np.int32)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    kw = dict(n_heads=tcfg.n_heads, n_kv=tcfg.n_kv, head_dim=tcfg.head_dim,
              rope_theta=tcfg.rope_theta)
    want, wk, wv = jpaged(jl, jnp.asarray(x, jd), jnp.asarray(pool[0], jd),
                          jnp.asarray(pool[1], jd),
                          JaxPageView(jnp.asarray(table), jnp.asarray(local),
                                      ps), **kw)
    tk, tv = (torch.from_numpy(p.copy()).to(td) for p in pool)
    got, gk, gv = paged_decode_self_attention(
        tl, torch.from_numpy(x).to(td), tk, tv,
        PageView(torch.from_numpy(table), torch.from_numpy(local), ps), **kw)
    assert gk is tk and gv is tv                    # written in place
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **TOL[dtype])
    # the shared prefix page was only read; the clipped write hit scratch
    np.testing.assert_array_equal(gk[0].float().numpy(),
                                  torch.from_numpy(pool[0][0]).to(td)
                                  .float().numpy())
    assert not np.array_equal(gk[11, 3].float().numpy(),
                              torch.from_numpy(pool[0][11, 3]).to(td)
                              .float().numpy())


def test_paged_micro_run_matches_jax(test_seed):
    """k = 4 at base 8 over a random 16-page pool: lane 0 is fresh with a
    one-page prefix hit (start backdated by 4, feeding the rest of its
    prompt), lane 1 continues a request begun at 0, lane 2 is empty on its
    scratch page. Tokens and ``last`` equal; the pool equal in layer 0 and
    within two bf16 ulps deeper (|kv| < 4, one ulp 2**-6)."""
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.steps import make_masked_decode_step as jax_masked

    k, B, L, ps, P, pos = 4, 3, 16, 4, 16, 8
    jcfg, tcfg = jax_cfg(), torch_cfg()
    rng = np.random.default_rng(2)
    shape = (tcfg.n_layers, P, ps, tcfg.n_kv, tcfg.head_dim)
    kv = {n: np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5,
                                    jnp.bfloat16), np.float32)
          for n in ("cache_k", "cache_v")}
    table = np.array([[0, 5, 6, 13], [1, 2, 3, 14], [15, 15, 15, 15]],
                     np.int32)
    feed = np.full((k, B), -1, np.int32)
    feed[:2, 0] = [51, 50]
    feed[:, 2] = 0
    start = np.tile(np.arange(pos, pos + k, dtype=np.int32)[:, None], (1, B))
    start[:, :2] = [pos - 4, 0]
    active = np.ones((k, B), bool)
    active[:, 2] = False
    fresh = np.zeros((k, B), bool)
    fresh[0, 0] = True
    prev = np.array([0, 33, 0], np.int32)

    bundle = jax_masked(jcfg, B, L, make_debug_mesh(1, 1),
                        steps_per_dispatch=k, paged=(P, ps))
    jt, jlast, jstate = jax.jit(bundle.fn)(
        jax_params(test_seed),
        {n: jnp.asarray(v, jnp.bfloat16) for n, v in kv.items()},
        jnp.asarray(feed), jnp.asarray(prev), jnp.int32(pos),
        jnp.asarray(start), jnp.asarray(active), jnp.asarray(fresh),
        jnp.asarray(table))

    plan = build_plan(tcfg, None, device="cpu")
    plan.load_params(arrays(test_seed))
    tstate = {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in kv.items()}
    step = make_masked_decode_step(tcfg, B, L, steps_per_dispatch=k,
                                   paged=(P, ps))
    tt, tlast, tstate = step(plan.model, tstate, torch.from_numpy(feed),
                             torch.from_numpy(prev), pos,
                             torch.from_numpy(start), torch.from_numpy(active),
                             torch.from_numpy(fresh), torch.from_numpy(table))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    for n in kv:
        got, want = tstate[n].float().numpy(), np.asarray(jstate[n],
                                                          np.float32)
        assert np.abs(want).max() < 4.0
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, atol=2 * 2.0 ** -6, rtol=0.0)
    # the pool is never wiped: the fresh lane's shared prefix page survives
    np.testing.assert_array_equal(tstate["cache_k"][:, 0].float().numpy(),
                                  kv["cache_k"][:, 0])


# ---------------------------------------------------------------------------
# paged continuous serving == the JAX fifo tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_paged_matches_jax_fifo(test_seed, quantized, k):
    want, gaps = jax_reference(test_seed, quantized, "parity")
    b = _paged_batcher(test_seed, k, quantized)
    got = serve(b, PARITY_TRACE)
    assert b.scheduler.refills > 0
    compared = assert_streams(got, want, gaps, [r for r, _, _ in PARITY_TRACE],
                              (quantized, k))
    assert compared == sum(n for _, _, n in PARITY_TRACE) - 1
    keys = [key for key in b.cache._entries if key.kind == "masked_decode"]
    assert keys and all(key.steps == k and key.paged == PAGED
                        for key in keys)
    _reclaimed(b)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_shared_prefix_trace(test_seed, paged):
    """Two waves sharing an 18-token system prompt: paged, the second wave
    maps the page published by the first (prefill skipped for it); both
    layouts give the reference's tokens."""
    want, gaps = jax_reference(test_seed, False, "shared")
    b = port_batcher(test_seed, schedule="continuous", steps_per_dispatch=4,
                     policy=BucketPolicy([Bucket(64, 2)]),
                     paged=PAGED if paged else None)
    got = serve(b, SHARED_TRACE)
    ids = [rid for wave in SHARED_TRACE for rid, _, _ in wave]
    # s0 opens on a near-tie (reference gap 0.0018): 14 of 20 tokens
    assert assert_streams(got, want, gaps, ids, paged) == 14
    if not paged:
        assert "paged" not in b.stats()
        return
    s = b.stats()["paged"]
    assert s["prefix_hits"] >= len(SHARED_TRACE[1])
    assert s["skipped_prefill_tokens"] >= len(SHARED_TRACE[1]) * 16
    m = b.stats()["buckets"]["b2xl64"]
    assert m["prefix_hits"] == s["prefix_hits"]
    assert m["peak_pages"] == s["peak_pages"]
    _reclaimed(b)


def test_paged_zero_builds_after_warmup_under_churn(test_seed):
    b = _paged_batcher(test_seed, 4)
    serve(b, PARITY_TRACE[:3])
    warm = dict(b.cache.stats())
    assert warm["builds"] == 1
    for wave in range(3):
        trace = [(f"w{wave}-{rid}", p, n) for rid, p, n in PARITY_TRACE]
        if wave % 2:                 # prefix hits and misses alike
            trace += [(f"w{wave}-{rid}", p, n)
                      for rid, p, n in SHARED_TRACE[0]]
        assert len(serve(b, trace)) == len(trace)
    after = b.cache.stats()
    assert after["builds"] == warm["builds"]
    assert after["misses"] == warm["misses"]
    assert after["hits"] > warm["hits"]
    _reclaimed(b)


def test_cancel_returns_pages_and_the_reused_pages_decode_fresh(test_seed):
    """A victim cancelled at a boundary hands its pages back unwiped; the
    successor is leased one of them and still decodes what it decodes
    alone: stale rows stay behind the local-position mask."""
    ref_b = _paged_batcher(test_seed, 4)
    ref_b.submit(DecodeRequest("late", [7, 11, 13], max_new_tokens=4))
    ref = ref_b.run()["late"].tokens

    b = _paged_batcher(test_seed, 4)
    leases = {}

    def hook(pos, slots):
        for s in slots:
            if s is not None:
                leases.setdefault(s.req.request_id, list(s.pages.pages))
        if pos == 8:
            assert b.cancel("victim") is True

    b.scheduler.on_boundary = hook
    b.submit(DecodeRequest("victim", [9, 5, 3], max_new_tokens=40))
    b.submit(DecodeRequest("stays", [63, 51, 50], max_new_tokens=20))
    b.submit(DecodeRequest("late", [7, 11, 13], max_new_tokens=4))
    out = b.run()
    assert set(out) == {"stays", "late"}
    assert b.scheduler.cancellations == 1
    assert set(leases["late"]) & set(leases["victim"])
    assert out["late"].tokens == ref
    _reclaimed(b)


def test_paged_and_dense_steps_key_separately(test_seed):
    dense = port_batcher(test_seed, schedule="continuous",
                         policy=BucketPolicy([Bucket(64, 2)]))
    paged = port_batcher(test_seed, schedule="continuous",
                         policy=BucketPolicy([Bucket(64, 2)]), paged=PAGED)
    toks = [serve(b, [("d", [5, 9], 2)])["d"] for b in (dense, paged)]
    assert toks[0] == toks[1]
    assert {k.paged for k in dense.cache._entries} == {()}
    assert {k.paged for k in paged.cache._entries} == {PAGED}


# ---------------------------------------------------------------------------
# geometry, validation and the paged state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged,want", [
    (True, (2 * 4 + 2 * 16 + 2, 16)), (8, (2 * 8 + 2 * 32 + 2, 8)),
    ((20, 16), (20, 16)), (False, None), (None, None)])
def test_paged_argument_forms(paged, want):
    plan = build_plan(torch_cfg(), None, device="cpu")
    b = plan.make_batcher(schedule="continuous", paged=paged)
    assert b.paged == want
    assert (b.pool.allocator is None) == (want is None)
    if want is not None:
        assert auto_paged(BucketPolicy.debug(), want[1]) == want or \
            paged == (20, 16)


def test_paged_validation():
    plan = build_plan(torch_cfg(), None, device="cpu")
    with pytest.raises(ValueError, match="continuous"):
        plan.make_batcher(schedule="fifo", paged=PAGED)
    with pytest.raises(ValueError, match="multiple of"):
        plan.make_batcher(schedule="continuous",
                          policy=BucketPolicy([Bucket(72, 2)]), paged=(8, 16))
    with pytest.raises(ValueError, match="masked_decode"):
        plan.serve_executable("decode", batch=2, max_len=64, paged=PAGED)


def test_paged_state_pool_layout_and_checkout(test_seed):
    """The pool leaves are [L, pages, page_size, KV, hd], built once and
    shared by every bucket, never zeroed; one dispatch holds them at a
    time; a slot wipe leaves them alone."""
    cfg = torch_cfg()
    plan = build_plan(cfg, None, device="cpu")
    plan.load_params(arrays(test_seed))
    pool = StatePool(plan, paged=(10, 4))
    s = pool.acquire(2, 16)
    assert s["cache_k"].shape == (cfg.n_layers, 10, 4, cfg.n_kv,
                                  cfg.head_dim)
    assert state_batch_axes(s, True) == {"cache_k": -1, "cache_v": -1}
    with pytest.raises(RuntimeError, match="checked out"):
        pool.acquire(2, 32)
    s["cache_k"].fill_(1)
    pool.reset_slots(2, 16, s, [True, False])
    assert s["cache_k"].all()
    pool.release(2, 16, s)
    s2 = pool.acquire(2, 32)                 # another bucket, same pool
    assert s2["cache_k"] is s["cache_k"] and s2["cache_k"].all()
    pool.release(2, 32, s2)
    assert plan.fresh_decode_state(2, 16, paged=(10, 4), only="dense") == {}
    dense = plan.fresh_decode_state(2, 16)
    assert dense["cache_v"].shape[1:3] == (2, 16)
    assert state_batch_axes(dense, False) == {"cache_k": 1, "cache_v": 1}
