"""The port's speculative lanes against the JAX package's, on the CPU: the
block and paged-block decode attention, ``DecoderLM.decode_block``, one
speculative micro-run, speculative serving streams, and the scheduler's
accept/rollback law on a host stand-in.

Reduced yi-6b (2 layers, vocab 64) on the reference's weights, carried
across with ``decoder_lm_from_arrays``. Tolerances: the block attention
fp32 atol = rtol = 1e-5, bf16 atol 2e-2; ``decode_block`` logits in fp32
atol = rtol = 1e-4 float and atol 1e-3 (two int16 steps of the head's
2**-11 output scale) quantized; one micro-run's token lanes equal, its KV
equal in layer 0 and within two bf16 ulps deeper. Speculative streams are
held against the reference's speculative streams in the same mode, up to
the first step whose reference top-2 gap is below 0.02
(``_torch_serve_ref``); where every stream matches in full, so do the
speculative counters.

The host stand-in's verify lane emits LOCAL positional receipts (local
cursor + 1), so whatever mismatches the draft plays, every completed
request must hold exactly ``[P, ..., P + n - 1]``; the reference's own
checkers (``_serve_stubs``) judge the port's scheduler.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _serve_stubs import (
    check_page_invariants,
    check_spec_invariants,
    spec_expected_receipt,
)
from _torch_serve_ref import (
    SPEC_BUCKET,
    SPEC_TRACE,
    arrays,
    assert_streams,
    jax_cfg,
    jax_params,
    jax_spec_reference,
    port_batcher,
    serve,
    torch_cfg,
)
from conftest import hypothesis_or_skip_stub

from repro_torch.bridge import decoder_lm_from_arrays
from repro_torch.launch.steps import make_masked_decode_step
from repro_torch.layers.attention import (
    block_decode_self_attention,
    paged_block_decode_self_attention,
)
from repro_torch.models.base import (
    PageView,
    is_paged_state_key,
    split_spec_state,
    state_batch_axes,
)
from repro_torch.plan import build_plan
from repro_torch.serve import (
    Bucket,
    BucketPolicy,
    ContinuousScheduler,
    DecodeRequest,
)

given, settings, st = hypothesis_or_skip_stub()

TOL = {"fp32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=2e-2, rtol=0.0)}
DT = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                     torch.bfloat16)}
LOGIT_TOL = {False: dict(atol=1e-4, rtol=1e-4), True: dict(atol=1e-3,
                                                           rtol=0.0)}
KV_MAX, KV_TOL = 4.0, dict(atol=2 * 2.0 ** -6, rtol=0.0)
# the reference's trace without g2, whose fourth token is a 0.0009 tie that
# the two packages break apart (g4's 0.0016 tie breaks alike)
WITHOUT_G2 = [t for t in SPEC_TRACE if t[0] != "g2"]


def _heads(cfg):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.head_dim,
                rope_theta=cfg.rope_theta)


def _attn_params(seed, dtype):
    """Block 0's attention: (jax tree, port tree of torch tensors)."""
    jd, td = DT[dtype]
    jl = jax.tree.map(lambda a: a[0].astype(jd),
                      jax_params(seed)["blocks"]["attn"])
    tl = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32))
                      .to(td), jl)
    return jl, tl


def _bf16(rng, shape):
    """bf16 values as float32 numpy, exact in both packages."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5,
                                  jnp.bfloat16), np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------------------
# the block attention variants, dropped writes included
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_block_decode_self_attention_matches_jax(test_seed, dtype):
    """Four slots, blocks of 4 over 16 rows: from row 0, mid-lane, one that
    runs past the lane (rows 16 and 17 dropped) and one wholly past it
    (every write dropped). Output and both caches after the write."""
    from repro.layers.attention import block_decode_self_attention as jblock

    tcfg = torch_cfg()
    jd, td = DT[dtype]
    jl, tl = _attn_params(test_seed, dtype)
    rng = np.random.default_rng(3)
    B, m, S = 4, 4, 16
    cache = [rng.standard_normal((B, S, tcfg.n_kv, tcfg.head_dim))
             .astype(np.float32) for _ in range(2)]
    local = np.array([0, 5, 14, 17], np.int32)
    x = rng.standard_normal((B, m, tcfg.d_model)).astype(np.float32)
    want, wk, wv = jblock(jl, jnp.asarray(x, jd), jnp.asarray(cache[0], jd),
                          jnp.asarray(cache[1], jd), jnp.asarray(local),
                          **_heads(tcfg))
    tk, tv = (torch.from_numpy(c.copy()).to(td) for c in cache)
    got, gk, gv = block_decode_self_attention(
        tl, torch.from_numpy(x).to(td), tk, tv, torch.from_numpy(local),
        **_heads(tcfg))
    assert gk is tk and gv is tv                    # written in place
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, TOL[dtype])
    # the lane wholly past the cache kept every row
    np.testing.assert_array_equal(
        gk[3].float().numpy(),
        torch.from_numpy(cache[0][3]).to(td).float().numpy())


# (table, local) per block length over 4-token pages: m = 4, two slots
# share page 0 read-only (a prefix hit), one crosses a page boundary, one
# runs past its page run (local 16 and 17 dropped), one is an empty lane on
# its scratch page; m = 8, longer than a page, after a one-page prefix, on
# an empty lane and on a slot whose tail repeats its scratch page (those
# two write one row twice, in block order)
_PAGED_BLOCKS = {
    4: ([[0, 1, 2, 8], [0, 3, 4, 9], [10, 10, 10, 10], [5, 6, 7, 11]],
        [6, 13, 0, 14]),
    8: ([[0, 1, 2, 8], [10, 10, 10, 10], [5, 6, 11, 11]], [4, 0, 7]),
}


@pytest.mark.parametrize("m", [4, 8])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_paged_block_decode_self_attention_matches_jax(test_seed, dtype, m):
    """Slots over a 12-page pool of 4-token pages (``_PAGED_BLOCKS``).
    Output and both pools after the in-place write; a shared prefix page
    is only read."""
    from repro.layers.attention import (
        paged_block_decode_self_attention as jpblock,
    )
    from repro.models.base import PageView as JaxPageView

    tcfg = torch_cfg()
    jd, td = DT[dtype]
    jl, tl = _attn_params(test_seed, dtype)
    rng = np.random.default_rng(4)
    ps = 4
    table = np.array(_PAGED_BLOCKS[m][0], np.int32)
    local = np.array(_PAGED_BLOCKS[m][1], np.int32)
    B = len(local)
    pool = [rng.standard_normal((12, ps, tcfg.n_kv, tcfg.head_dim))
            .astype(np.float32) for _ in range(2)]
    x = rng.standard_normal((B, m, tcfg.d_model)).astype(np.float32)
    want, wk, wv = jpblock(jl, jnp.asarray(x, jd), jnp.asarray(pool[0], jd),
                           jnp.asarray(pool[1], jd),
                           JaxPageView(jnp.asarray(table),
                                       jnp.asarray(local), ps),
                           **_heads(tcfg))
    tk, tv = (torch.from_numpy(p.copy()).to(td) for p in pool)
    got, gk, gv = paged_block_decode_self_attention(
        tl, torch.from_numpy(x).to(td), tk, tv,
        PageView(torch.from_numpy(table), torch.from_numpy(local), ps),
        **_heads(tcfg))
    assert gk is tk and gv is tv
    for g, w in ((got, want), (gk, wk), (gv, wv)):
        _close(g, w, TOL[dtype])
    # the shared prefix page was only read
    np.testing.assert_array_equal(
        gk[0].float().numpy(),
        torch.from_numpy(pool[0][0]).to(td).float().numpy())


# ---------------------------------------------------------------------------
# decode_block, and the state helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [1, 4])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_decode_block_matches_jax(test_seed, quantized, paged, m):
    """fp32 weights and KV: three slots at local positions 6, 13 and 0 (the
    second crosses into the last page; the third is an empty lane on its
    scratch page when paged). Logits and the written KV."""
    from repro.models import build_model as jax_build_model
    from repro.models.base import PageView as JaxPageView

    q = dict(quantized=quantized, quantized_mlp=quantized)
    jcfg, tcfg = jax_cfg().with_(**q), torch_cfg().with_(**q)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jax_params(test_seed))
    model = decoder_lm_from_arrays(
        tcfg, jax.tree.map(lambda a: np.asarray(a, np.float32), p32), "cpu")
    rng = np.random.default_rng(5)
    B, ps = 3, 4
    per = (12, ps) if paged else (B, 16)
    kv = {n: rng.standard_normal((tcfg.n_layers, *per, tcfg.n_kv,
                                  tcfg.head_dim)).astype(np.float32) * 0.5
          for n in ("cache_k", "cache_v")}
    table = np.array([[0, 1, 2, 8], [0, 3, 4, 9], [10, 10, 10, 10]],
                     np.int32)
    local = np.array([6, 13, 0], np.int32)
    toks = rng.integers(0, tcfg.vocab, (B, m)).astype(np.int32)
    jpages = (JaxPageView(jnp.asarray(table), jnp.asarray(local), ps)
              if paged else None)
    want, jstate = jax_build_model(jcfg).decode_block(
        p32, {n: jnp.asarray(v) for n, v in kv.items()}, jnp.asarray(toks),
        jnp.asarray(local), pages=jpages)
    tpages = (PageView(torch.from_numpy(table), torch.from_numpy(local), ps)
              if paged else None)
    tstate = {n: torch.from_numpy(v.copy()) for n, v in kv.items()}
    got, out = model.decode_block(tstate, torch.from_numpy(toks),
                                  torch.from_numpy(local), pages=tpages)
    assert out is tstate and got.shape == (B, m, tcfg.vocab)
    assert got.dtype == torch.float32
    _close(got, want, LOGIT_TOL[quantized])
    for n in kv:
        _close(tstate[n], jstate[n], dict(atol=1e-3, rtol=0.0))


def test_decode_block_draft_prefix_and_state_helpers(test_seed):
    """``n_layers`` runs the first N blocks on a state of N layers (the
    draft half of a merged state, split without a copy); a state of the
    wrong depth is refused. The draft twins are paged keys: the paged
    batch axes skip them, the dense ones wipe them."""
    model = decoder_lm_from_arrays(torch_cfg(), arrays(test_seed), "cpu")
    state = model.decode_state(2, 16, draft_layers=1)
    assert sorted(state) == ["cache_k", "cache_v", "draft_cache_k",
                             "draft_cache_v"]
    assert state["draft_cache_k"].shape[0] == 1
    target, draft = split_spec_state(state)
    assert sorted(draft) == ["cache_k", "cache_v"]
    assert draft["cache_k"] is state["draft_cache_k"]
    assert target["cache_v"] is state["cache_v"]
    toks = torch.tensor([[5], [9]], dtype=torch.int32)
    local = torch.tensor([0, 3], dtype=torch.int32)
    logits, _ = model.decode_block(draft, toks, local, n_layers=1)
    assert logits.shape == (2, 1, 64) and state["draft_cache_k"][0, 1, 3].any()
    assert not state["cache_k"].any()          # the target half untouched
    with pytest.raises(ValueError, match="layers"):
        model.decode_block(draft, toks, local)
    assert all(is_paged_state_key(n) for n in state)
    assert set(state_batch_axes(state, paged=True).values()) == {-1}
    assert set(state_batch_axes(state, paged=False).values()) == {1}
    pool = model.decode_state(2, 16, paged=(6, 4), only="pool",
                              draft_layers=1)
    assert pool["draft_cache_v"].shape == (1, 6, 4, 2, 16)
    assert model.decode_state(2, 16, paged=(6, 4), only="dense",
                              draft_layers=1) == {}


# ---------------------------------------------------------------------------
# one speculative micro-run vs the JAX spec step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_spec_micro_run_matches_jax(test_seed, quantized, paged):
    """k = 4 at base 8 over a random merged state (target and 1-layer draft
    twins): lane 0 is fresh (wiped) and feeds a 3-token prompt, lane 1
    continues a request begun at 0, lane 2 self-masks after 2 steps, lane
    3 is empty. The verify and draft lanes equal; the KV equal in layer 0
    and within two bf16 ulps deeper."""
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.steps import make_masked_decode_step as jax_masked

    k, B, L, pos, ps, P = 4, 4, 16, 8, 4, 16
    q = dict(quantized=quantized, quantized_mlp=quantized)
    jcfg, tcfg = jax_cfg().with_(**q), torch_cfg().with_(**q)
    rng = np.random.default_rng(1)
    per = (P, ps) if paged else (B, L)
    kv = {n: _bf16(rng, (layers, *per, tcfg.n_kv, tcfg.head_dim))
          for n, layers in (("cache_k", 2), ("cache_v", 2),
                            ("draft_cache_k", 1), ("draft_cache_v", 1))}
    feed = np.full((k, B), -1, np.int32)
    feed[:3, 0] = [63, 51, 50]
    feed[:, 3] = 0
    start = np.tile(np.arange(pos, pos + k, dtype=np.int32)[:, None], (1, B))
    start[:, :3] = [pos, 0, 2]
    active = np.ones((k, B), bool)
    active[2:, 2] = False
    active[:, 3] = False
    fresh = np.zeros((k, B), bool)
    fresh[0, 0] = True
    prev = np.array([0, 33, 17, 0], np.int32)
    table = np.array([[0, 5, 6, 13], [1, 2, 3, 14], [7, 8, 9, 12],
                      [15, 15, 15, 15]], np.int32)
    extra = [table] if paged else []
    geometry = (P, ps) if paged else None

    bundle = jax_masked(jcfg, B, L, make_debug_mesh(1, 1),
                        steps_per_dispatch=k, spec=(k, 1), paged=geometry)
    jv, jd, jstate = jax.jit(bundle.fn)(
        jax_params(test_seed),
        {n: jnp.asarray(v, jnp.bfloat16) for n, v in kv.items()},
        jnp.asarray(feed), jnp.asarray(prev), jnp.int32(pos),
        jnp.asarray(start), jnp.asarray(active), jnp.asarray(fresh),
        *map(jnp.asarray, extra))

    plan = build_plan(tcfg, None, device="cpu")
    plan.load_params(arrays(test_seed))
    tstate = {n: torch.from_numpy(v).to(torch.bfloat16) for n, v in kv.items()}
    step = make_masked_decode_step(plan.cfg, B, L, steps_per_dispatch=k,
                                   spec=(k, 1), paged=geometry)
    tv, td, tstate = step(plan.model, tstate, torch.from_numpy(feed),
                          torch.from_numpy(prev), pos, torch.from_numpy(start),
                          torch.from_numpy(active), torch.from_numpy(fresh),
                          *map(torch.from_numpy, extra))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert (tv.numpy()[:, 3] == 0).all() and (tv.numpy()[2:, 2] == 0).all()
    for n in kv:
        got, want = tstate[n].float().numpy(), np.asarray(jstate[n],
                                                          np.float32)
        assert np.abs(want).max() < KV_MAX
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, **KV_TOL)
    if not paged:
        # the fresh lane was wiped before the run, the draft twins included:
        # its block wrote local rows 0..k-1 only
        assert not tstate["draft_cache_k"][:, 0, k:].any()


def test_spec_step_rejects_a_bad_geometry():
    for spec, msg in (((2, 1), "must equal"), ((4, 3), "draft_layers")):
        with pytest.raises(ValueError, match=msg):
            make_masked_decode_step(torch_cfg(), 2, 16, steps_per_dispatch=4,
                                    spec=spec)


# ---------------------------------------------------------------------------
# speculative streams == the reference's speculative streams, mode by mode
# ---------------------------------------------------------------------------

_MODES = [(k, quantized, paged, None) for k in (1, 4)
          for quantized in (False, True) for paged in (False, True)]
_MODES.append((4, False, False, "prefix:1"))


@pytest.mark.parametrize("trace", ["reference", "without_g2"])
@pytest.mark.parametrize(
    "k,quantized,paged,draft", _MODES,
    ids=[f"k{k}-{'q' if q else 'f'}-{'paged' if p else 'dense'}"
         f"{'-' + d if d else ''}" for k, q, p, d in _MODES])
def test_spec_streams_match_reference(test_seed, k, quantized, paged, draft,
                                      trace):
    """The reference's speculative trace, and the same without g2, through
    one 32 x 2 bucket (pages of 4 tokens, so draft leases extend and roll
    back mid-trace): every stream equals the reference's speculative
    stream up to the first step whose gap is below 0.02. Without g2 the
    streams match in full, and then the verifies, draft and accepted
    tokens, rollbacks and continuations equal the reference's."""
    reqs = SPEC_TRACE if trace == "reference" else WITHOUT_G2
    want, want_stats, gaps = jax_spec_reference(
        test_seed, quantized, k, paged, draft,
        tuple((rid, tuple(p), n) for rid, p, n in reqs))
    max_len, batch = SPEC_BUCKET
    b = port_batcher(test_seed, quantized, schedule="continuous",
                     policy=BucketPolicy([Bucket(max_len, batch)]),
                     steps_per_dispatch=k, paged=4 if paged else None,
                     speculative=k, draft=draft)
    got = serve(b, reqs)
    assert assert_streams(got, want, gaps, [rid for rid, _, _ in reqs],
                          (k, quantized, paged, draft)) > 0
    s = b.scheduler.stats()["spec"]
    assert s["spec_k"] == k and s["verifies"] > 0
    assert 0 < s["accepted_tokens"] <= s["draft_tokens"]
    assert b.scheduler.refills > 0 and b.scheduler._spec_carry == {}
    if trace == "without_g2":
        assert got == want
    if got == want:
        keys = ("verifies", "draft_tokens", "accepted_tokens", "rollbacks",
                "continuations", "partial_results")
        assert {key: s[key] for key in keys} == \
            {key: want_stats[key] for key in keys}
    if paged:
        p = b.stats()["paged"]
        assert p["pages_in_use"] == p["scratch_pages"] + p["prefix_entries"]
        assert p["draft_pages_committed"] + p["draft_pages_rolled_back"] > 0


def test_spec_zero_builds_after_warmup(test_seed):
    """A second wave of other lengths runs on the one warm speculative
    step, keyed with its spec."""
    max_len, batch = SPEC_BUCKET
    b = port_batcher(test_seed, schedule="continuous",
                     policy=BucketPolicy([Bucket(max_len, batch)]),
                     steps_per_dispatch=4, speculative=4)
    serve(b, SPEC_TRACE)
    warm = dict(b.cache.stats())
    assert warm["builds"] == 1
    out = serve(b, [("w" + rid, p[::-1], n + 1) for rid, p, n in SPEC_TRACE])
    assert all(len(out["w" + rid]) == n + 1 for rid, _, n in SPEC_TRACE)
    after = b.cache.stats()
    assert after["builds"] == warm["builds"] and after["hits"] > warm["hits"]
    keys = [key for key in b.cache._entries if key.kind == "masked_decode"]
    assert keys and all(key.spec == (4, 1) for key in keys)


# ---------------------------------------------------------------------------
# the accept/rollback law on a port-side host stand-in
# ---------------------------------------------------------------------------


class SpecHostStep:
    """Stand-in speculative step: ``verify = local cursor + 1`` on active
    lane-steps, and drafts that disagree where the cursor is in
    ``mismatch``. Paged, every active write must lie inside the table."""

    def __init__(self, mismatch, page_size=0):
        self.mismatch = frozenset(mismatch)
        self.page_size = page_size

    def fn(self, model, state, feed, prev, pos, start, active, fresh,
           table=None):
        act = active.numpy()
        k = act.shape[0]
        local = pos + np.arange(k)[:, None] - start.numpy()
        if table is not None:
            assert table.dtype == torch.int32
            pages = local[act] // self.page_size
            assert ((pages >= 0) & (pages < table.shape[1])).all()
        verify = ((local + 1) * act).astype(np.int32)
        drafts = verify.copy()
        if self.mismatch:
            drafts[np.isin(local, list(self.mismatch)) & act] += 997
        return torch.from_numpy(verify), torch.from_numpy(drafts), state


class SpecHostPlan:
    device = torch.device("cpu")

    def __init__(self, mismatch, page_size=0):
        self.steps = {}
        self.mismatch, self.page_size = mismatch, page_size

    def serve_executable(self, kind, *, batch, max_len, steps_per_dispatch=1,
                         paged=None, spec=None):
        assert kind == "masked_decode" and spec is not None
        key = (batch, max_len, steps_per_dispatch, paged, spec)
        if key not in self.steps:
            self.steps[key] = SpecHostStep(self.mismatch, self.page_size)
        return self.steps[key]


class HostPool:
    """No device state; a real PageAllocator when paged."""

    def __init__(self, paged=None):
        from repro_torch.serve.paging import PageAllocator

        self.paged = paged
        self.allocator = PageAllocator(*paged) if paged else None
        self.slot_resets = 0

    def acquire(self, batch, max_len):
        return {}

    def release(self, batch, max_len, state):
        pass

    def reset_slots(self, batch, max_len, state, slot_mask):
        self.slot_resets += 1
        return state


def _spec_trace(lengths, k, batch, max_len=64, mismatch=(), cancel_at=None,
                paged=False, page_size=4):
    """The port's scheduler in speculative mode over the stand-ins. Paged,
    the page invariants hold at every boundary and only scratch and prefix
    pages are in use after the drain. Returns (sched, reqs, results,
    canceled)."""
    geometry = None
    if paged:
        geometry = (batch * (max_len // page_size) + batch
                    + -(-k // page_size) + 1, page_size)
    pool = HostPool(geometry)
    sched = ContinuousScheduler(
        SpecHostPlan(mismatch, page_size), BucketPolicy([Bucket(max_len,
                                                                batch)]),
        pool, steps_per_dispatch=k, spec=(k, 1))
    reqs = [DecodeRequest(f"s{i}", [1 + (i + j) % 7 for j in range(p)],
                          max_new_tokens=n)
            for i, (p, n) in enumerate(lengths)]
    canceled = []
    rid = None
    if cancel_at is not None:
        boundary, idx = cancel_at
        rid = reqs[idx % len(reqs)].request_id

    def hook(pos, slots):
        if rid is not None and pos >= boundary and rid not in canceled \
                and any(s is not None and s.req.request_id == rid
                        for s in slots):
            sched.cancel(rid)
            canceled.append(rid)
        if paged:
            check_page_invariants(pool.allocator, slots)

    sched.on_boundary = hook
    results = sched.run(collections.deque(reqs), None, {})
    if paged:
        alloc = pool.allocator
        assert alloc.pages_in_use == len(alloc._scratch) + len(alloc._prefix)
    return sched, reqs, results, canceled


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_spec_invariants_seeded_streams(seed, k, paged):
    """Seeded streams x mismatch schedules x an optional cancel mid-
    speculation: exact local receipts, conservation, no leaked carry."""
    rng = np.random.default_rng(seed)
    lengths = [(int(rng.integers(1, 7)), int(rng.integers(1, 13)))
               for _ in range(int(rng.integers(1, 24)))]
    mismatch = {int(p) for p in rng.integers(0, 40,
                                             size=int(rng.integers(0, 12)))}
    cancel_at = ((int(rng.integers(0, 24)), int(rng.integers(0, 64)))
                 if rng.random() < 0.5 else None)
    sched, reqs, results, canceled = _spec_trace(
        lengths, k, batch=int(rng.integers(1, 4)), mismatch=mismatch,
        cancel_at=cancel_at, paged=paged)
    check_spec_invariants(sched, reqs, results, canceled)
    assert sched.cancellations == len(canceled)


@given(st.lists(st.tuples(st.integers(min_value=1, max_value=6),
                          st.integers(min_value=1, max_value=12)),
                min_size=1, max_size=16),
       st.sampled_from([2, 4, 8]),
       st.integers(min_value=1, max_value=3),
       st.sets(st.integers(min_value=0, max_value=40), max_size=16),
       st.booleans())
@settings(max_examples=40, deadline=None)
def test_accept_prefix_law_property(lengths, k, batch, mismatch, paged):
    """The committed stream does not depend on the draft's mistakes: they
    only stretch the schedule (rollbacks, requeues)."""
    sched, reqs, results, _ = _spec_trace(lengths, k, batch,
                                          mismatch=mismatch, paged=paged)
    check_spec_invariants(sched, reqs, results)
    if not mismatch:
        assert sched.spec_rollbacks == 0


@given(st.lists(st.tuples(st.integers(min_value=1, max_value=6),
                          st.integers(min_value=1, max_value=12)),
                min_size=2, max_size=12),
       st.sampled_from([2, 4]),
       st.integers(min_value=0, max_value=20),
       st.integers(min_value=0, max_value=23),
       st.sets(st.integers(min_value=0, max_value=40), max_size=12))
@settings(max_examples=30, deadline=None)
def test_spec_conservation_under_cancellation(lengths, k, boundary, idx,
                                              mismatch):
    """A cancel mid-speculation (possibly mid-rollback) completes the
    request zero times and leaks no carry; the others keep exact receipts."""
    sched, reqs, results, canceled = _spec_trace(
        lengths, k, batch=2, mismatch=mismatch,
        cancel_at=(boundary * k, idx))
    check_spec_invariants(sched, reqs, results, canceled)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_meets_speculation(paged):
    """A 40-token prompt feeds in 8-token chunks (feeds never roll back),
    then decodes through a hostile mismatch schedule."""
    sched, reqs, results, _ = _spec_trace(
        [(40, 6)], 8, batch=1, max_len=128, mismatch=set(range(0, 60, 3)),
        paged=paged)
    check_spec_invariants(sched, reqs, results)
    assert results["s0"].tokens == spec_expected_receipt(40, 6)
    assert sched.spec_rollbacks > 0 and sched.micro_runs < 40


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_rollbacks_requeue_as_continuations(paged):
    """A draft wrong everywhere exhausts the bucket: the request requeues
    as a continuation (prompt + committed), its stream stays exact, and a
    paged lease is released."""
    sched, reqs, results, _ = _spec_trace(
        [(2, 12)], 8, batch=1, max_len=32, mismatch=set(range(64)),
        paged=paged)
    check_spec_invariants(sched, reqs, results)
    assert sched.spec_continuations >= 1 and sched.spec_rollbacks >= 3
    assert results["s0"].tokens == spec_expected_receipt(2, 12)
    assert any(e.kind == "requeue" for e in sched.events)


def test_continuation_outgrowing_bucket_delivers_partial():
    sched, reqs, results, _ = _spec_trace(
        [(2, 20)], 8, batch=1, max_len=32, mismatch=set(range(64)))
    check_spec_invariants(sched, reqs, results)
    assert sched.spec_partial_results >= 1
    toks = results["s0"].tokens
    assert toks == spec_expected_receipt(2, len(toks))


def test_paged_spec_cancel_mid_speculation_reclaims_pages():
    """A cancel while the lane holds draft pages reclaims the whole lease
    (the harness checks that only scratch and prefix pages remain)."""
    sched, reqs, results, canceled = _spec_trace(
        [(3, 10), (2, 8), (4, 6)], 4, batch=2,
        mismatch=set(range(0, 40, 2)), cancel_at=(4, 0), paged=True)
    check_spec_invariants(sched, reqs, results, canceled)
    assert canceled


def test_spec_counters_and_stats_shape():
    """A perfect draft accepts every drafted token; feeds are not draft
    work."""
    sched, reqs, results, _ = _spec_trace([(2, 9), (3, 7)], 4, batch=2)
    check_spec_invariants(sched, reqs, results)
    s = sched.stats()["spec"]
    assert s["spec_k"] == 4 and s["draft_layers"] == 1
    assert s["rollbacks"] == 0 and s["continuations"] == 0
    assert s["draft_tokens"] == s["accepted_tokens"] > 0
    assert s["accepted_tokens_per_dispatch"] > 1
