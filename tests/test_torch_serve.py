"""The port's continuous-batching serve path against the JAX package's, on
the CPU: the masked micro-run, the continuous scheduler, cancellation,
admission policies, the async streaming server and the serve CLI.

Reduced yi-6b (2 layers, vocab 64) on the reference's weights, carried
across with ``decoder_lm_from_arrays``. Token streams are compared with
the rule of ``_torch_serve_ref`` (equal up to the first step whose
reference top-2 gap is below 0.02); the KV written by one micro-run is
equal in layer 0 and within two bf16 ulps (atol 2**-5) deeper.
Scheduling facts (slot non-overlap, FIFO order, refill gap, conservation)
are checked on a host stand-in executable with positional-receipt tokens,
through the reference's own invariant checker.
"""

import asyncio
import collections
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _serve_stubs import check_invariants
from _torch_serve_ref import (
    PARITY_TRACE,
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
from repro_torch.plan import build_plan
from repro_torch.serve import (
    AsyncServeServer,
    Bucket,
    BucketPolicy,
    ContinuousScheduler,
    DecodeRequest,
    RequestShed,
    make_policy,
)
from repro_torch.serve.validation import resolve_speculative

# KV written by one micro-run: layer 0 projects the same bf16 embeddings in
# both packages and is equal; deeper layers see a hidden state that went
# through bf16 layers summed in other orders, and are held to two bf16
# ulps at the cache's magnitude (|kv| < 4, where one ulp is 2**-6)
KV_MAX, KV_TOL = 4.0, dict(atol=2 * 2.0 ** -6, rtol=0.0)


def _staggered(tag, lengths, prompt_len=2):
    return [DecodeRequest(f"{tag}{i}", [1 + (i + j) % 7
                                        for j in range(prompt_len)],
                          max_new_tokens=n)
            for i, n in enumerate(lengths)]


def _bf16(rng, shape):
    """bf16 values as float32 numpy, exact in both packages."""
    return np.asarray(jnp.asarray(rng.standard_normal(shape) * 0.5,
                                  jnp.bfloat16), np.float32)


# ---------------------------------------------------------------------------
# one masked micro-run: port vs the JAX step, fresh/feed/inactive lanes
# ---------------------------------------------------------------------------


def test_masked_micro_run_matches_jax(test_seed):
    """k = 4 at base position 8 over a random KV state: lane 0 is fresh
    (wiped, then fed a 3-token prompt and decoding), lane 1 continues a
    request begun at 0, lane 2 self-masks after 2 steps, lane 3 is empty.
    Tokens and ``last`` equal, the KV within the bf16 tolerance."""
    from repro.launch.mesh import make_debug_mesh
    from repro.launch.steps import make_masked_decode_step as jax_masked

    k, B, L, pos = 4, 4, 16, 8
    jcfg, tcfg = jax_cfg(), torch_cfg()
    rng = np.random.default_rng(1)
    shape = (tcfg.n_layers, B, L, tcfg.n_kv, tcfg.head_dim)
    kv = {name: _bf16(rng, shape) for name in ("cache_k", "cache_v")}
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

    bundle = jax_masked(jcfg, B, L, make_debug_mesh(1, 1),
                        steps_per_dispatch=k)
    jstate = {n: jnp.asarray(v, jnp.bfloat16) for n, v in kv.items()}
    jt, jlast, jstate = jax.jit(bundle.fn)(
        jax_params(test_seed), jstate, jnp.asarray(feed), jnp.asarray(prev),
        jnp.int32(pos), jnp.asarray(start), jnp.asarray(active),
        jnp.asarray(fresh))

    plan = build_plan(tcfg, None, device="cpu")
    plan.load_params(arrays(test_seed))
    model = plan.model
    tstate = {n: torch.from_numpy(v).to(torch.bfloat16)
              for n, v in kv.items()}
    step = make_masked_decode_step(tcfg, B, L, steps_per_dispatch=k)
    tt, tlast, tstate = step(model, tstate, torch.from_numpy(feed),
                             torch.from_numpy(prev), pos,
                             torch.from_numpy(start), torch.from_numpy(active),
                             torch.from_numpy(fresh))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    assert (tt.numpy()[:, 3] == 0).all() and (tt.numpy()[2:, 2] == 0).all()
    for n in kv:
        got, want = tstate[n].float().numpy(), np.asarray(jstate[n],
                                                          np.float32)
        assert np.abs(want).max() < KV_MAX
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got, want, **KV_TOL)
    # the fresh lane was wiped before the run: untouched positions are 0
    assert not tstate["cache_k"][:, 0, :pos].any()


# ---------------------------------------------------------------------------
# continuous tokens == the JAX fifo tokens, k in {1, 2, 4}
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_continuous_matches_jax_fifo(test_seed, quantized, k):
    want, gaps = jax_reference(test_seed, quantized, "parity")
    b = port_batcher(test_seed, quantized, schedule="continuous",
                     steps_per_dispatch=k)
    got = serve(b, PARITY_TRACE)
    assert b.scheduler.refills > 0          # parity held ACROSS slot reuse
    compared = assert_streams(got, want, gaps, [r for r, _, _ in PARITY_TRACE],
                              (quantized, k))
    assert compared == sum(n for _, _, n in PARITY_TRACE) - 1
    keys = [key for key in b.cache._entries if key.kind == "masked_decode"]
    assert keys and all(key.steps == k and key.paged == () for key in keys)
    assert all(key.quantized == quantized for key in keys)


def test_chunked_prefill_matches_eager_on_long_prompt(test_seed):
    """A 40-token prompt fed in k = 4 chunks gives k = 1's tokens in about
    a quarter of the micro-runs."""
    long_prompt = [1 + (i * 7) % 61 for i in range(40)]
    res, runs = {}, {}
    for k in (1, 4):
        b = port_batcher(test_seed, schedule="continuous",
                         policy=BucketPolicy([Bucket(128, 2)]),
                         steps_per_dispatch=k)
        b.submit(DecodeRequest("long", long_prompt, max_new_tokens=4))
        b.submit(DecodeRequest("rider", [9, 5], max_new_tokens=3))
        res[k] = {r: v.tokens for r, v in b.run().items()}
        runs[k] = b.scheduler.micro_runs
    assert res[1] == res[4] and len(res[4]["long"]) == 4
    assert runs[4] <= (runs[1] + 3) // 4 + 1


@pytest.mark.parametrize("k", [1, 4])
def test_zero_builds_after_warmup_under_churn(test_seed, k):
    b = port_batcher(test_seed, schedule="continuous",
                     policy=BucketPolicy([Bucket(64, 2)]),
                     steps_per_dispatch=k)
    b.warmup(Bucket(64, 2))
    assert b.cache.stats()["builds"] == 1   # ONE step for the bucket
    for r in _staggered("warm", [2, 6, 3]):
        b.submit(r)
    b.run()
    warm = dict(b.cache.stats())
    assert warm["builds"] == 1
    for wave, lengths in enumerate([[8, 2, 5, 2], [3, 9, 2],
                                    [12, 2, 2, 4, 2]]):
        for r in _staggered(f"churn{wave}-", lengths, prompt_len=3):
            b.submit(r)
        assert len(b.run()) == len(lengths)
    after = b.cache.stats()
    assert after["builds"] == warm["builds"]
    assert after["misses"] == warm["misses"]
    assert after["hits"] > warm["hits"]
    assert b.scheduler.refills > 0


def test_scheduler_stats_and_metrics_shape(test_seed):
    b = port_batcher(test_seed, schedule="continuous")
    for r in _staggered("s", [2, 5]):
        b.submit(r)
    b.run()
    stats = b.stats()
    s = stats["scheduler"]
    assert 0 < s["busy_slot_fraction"] <= 1
    assert s["steps_per_dispatch"] == 1 and s["micro_runs"] == s["steps"]
    assert s["cancellations"] == 0 and s["policy"] == "fifo"
    assert "paged" not in stats
    (label, m), = stats["buckets"].items()
    assert m["requests"] == 2 and m["slot_steps"] > 0
    assert 0 < m["busy_slot_fraction"] <= 1
    assert m["prefill_seconds"] == 0.0 and m["pages_in_use"] == 0


# ---------------------------------------------------------------------------
# cancellation: queued, in flight (wiped, reused), mid chunked prefill
# ---------------------------------------------------------------------------


def _alone(seed, prompt, n, bucket, k):
    b = port_batcher(seed, schedule="continuous",
                     policy=BucketPolicy([bucket]), steps_per_dispatch=k)
    b.submit(DecodeRequest("late", prompt, max_new_tokens=n))
    return b.run()["late"].tokens


@pytest.mark.parametrize("where", ["queued", "in_flight", "mid_prefill"])
def test_cancel(test_seed, where):
    """A queued request never runs and frees its id; an in-flight one frees
    its slot at the next boundary, where the successor is admitted and
    decodes what it decodes alone (its lanes were wiped); the same when the
    cancel lands while the victim's prompt is still being chunk-fed."""
    if where == "queued":
        b = port_batcher(test_seed, schedule="continuous")
        b.submit(DecodeRequest("keep", [5, 9], max_new_tokens=3))
        b.submit(DecodeRequest("drop", [7, 11], max_new_tokens=3))
        assert b.cancel("drop") is True and b.cancel("drop") is False
        assert set(b.run()) == {"keep"}
        assert "drop" not in {e.request_id for e in b.scheduler.events}
        b.submit(DecodeRequest("drop", [7, 11], max_new_tokens=3))
        assert len(b.run()["drop"].tokens) == 3
        return
    k, bucket = (2, Bucket(64, 2)) if where == "in_flight" else \
        (4, Bucket(128, 2))
    victim = ([5, 9] if where == "in_flight"
              else [1 + (i * 7) % 61 for i in range(24)])
    cancel_at = 6 if where == "in_flight" else 8
    ref = _alone(test_seed, [7, 11, 13], 4, bucket, k)
    b = port_batcher(test_seed, schedule="continuous",
                     policy=BucketPolicy([bucket]), steps_per_dispatch=k)
    b.submit(DecodeRequest("victim", victim, max_new_tokens=30))
    b.submit(DecodeRequest("other", [3, 4], max_new_tokens=30))
    b.submit(DecodeRequest("late", [7, 11, 13], max_new_tokens=4))
    sched = b.scheduler
    fed = []

    def hook(pos, slots):
        if pos == cancel_at:
            fed.extend(s.fed for s in slots
                       if s is not None and s.req.request_id == "victim")
            assert b.cancel("victim") is True

    sched.on_boundary = hook
    out = b.run()
    assert set(out) == {"other", "late"} and sched.cancellations == 1
    if where == "mid_prefill":
        assert 0 < fed[0] < len(victim)
    cancel_ev, = [e for e in sched.events if e.kind == "cancel"]
    admit_late, = [e for e in sched.events
                   if e.kind == "admit" and e.request_id == "late"]
    assert (admit_late.slot, admit_late.step) == (cancel_ev.slot, cancel_at)
    assert out["late"].tokens == ref
    assert len(out["other"].tokens) == 30 and b.pool.slot_resets == 1


def test_cancel_racing_completion_drops_tokens_and_frees_id(test_seed):
    b = port_batcher(test_seed, schedule="continuous",
                     policy=BucketPolicy([Bucket(64, 2)]))
    b.submit(DecodeRequest("short", [5, 9], max_new_tokens=2))
    b.submit(DecodeRequest("rider", [3, 4], max_new_tokens=16))
    sched = b.scheduler
    resubmitted = []

    def hook(pos, slots):
        live = {s.req.request_id for s in slots if s is not None}
        if pos == 8 and "short" not in live:
            assert b.cancel("short") is True
        if pos == 10 and not resubmitted:
            b.submit(DecodeRequest("short", [5, 9], max_new_tokens=3))
            resubmitted.append(True)

    sched.on_boundary = hook
    out = b.run()
    assert set(out) == {"rider", "short"}
    assert len(out["short"].tokens) == 3     # the RESUBMITTED request
    assert sched.cancellations == 1
    assert not sched._canceled and not sched._stale_cancels


# ---------------------------------------------------------------------------
# scheduler invariants on a port-side host stand-in (positional receipts)
# ---------------------------------------------------------------------------


class HostStep:
    """Stand-in masked step: token ``pos + i + 1`` on every active lane-step,
    so a request's result slice is a receipt of the steps its slot held."""

    def __init__(self):
        self.calls = 0

    def fn(self, model, state, feed, prev, pos, start, active, fresh,
           table=None):
        self.calls += 1
        act = active.numpy()
        k = act.shape[0]
        toks = (np.arange(pos + 1, pos + k + 1, dtype=np.int32)[:, None]
                * act).astype(np.int32)
        if table is not None:
            # every active write lands inside the lane's table
            local = pos + np.arange(k)[:, None] - start.numpy()
            assert ((local[act] >= 0)
                    & (local[act] < table.shape[1] * self.page_size)).all()
        t = torch.from_numpy(toks)
        return t, t[-1], state


class HostPlan:
    device = torch.device("cpu")

    def __init__(self, page_size=0):
        self.steps = {}
        self.page_size = page_size

    def serve_executable(self, kind, *, batch, max_len,
                         steps_per_dispatch=1, paged=None):
        assert kind == "masked_decode"
        key = (batch, max_len, steps_per_dispatch, paged)
        if key not in self.steps:
            self.steps[key] = HostStep()
            self.steps[key].page_size = self.page_size
        return self.steps[key]


class HostPool:
    """State-pool stand-in: no device state, a real PageAllocator when
    paged, and a count of per-slot wipes."""

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


def _host_trace(lengths, k, batch, max_len=64, cancel_at=None, paged=False,
                admission=None, reqs=None):
    # pages of 8 tokens: the prompts (<= 6 tokens) fill none, so no prefix
    # hit backdates a start and the receipts stay global positions
    geometry = (batch * (max_len // 8) + batch, 8) if paged else None
    sched = ContinuousScheduler(HostPlan(8), BucketPolicy([Bucket(max_len,
                                                                  batch)]),
                                HostPool(geometry), steps_per_dispatch=k,
                                admission=admission)
    if reqs is None:
        reqs = [DecodeRequest(f"h{i}", [1 + (i + j) % 7 for j in range(p)],
                              max_new_tokens=n)
                for i, (p, n) in enumerate(lengths)]
    canceled = []
    if cancel_at is not None:
        boundary, idx = cancel_at
        rid = reqs[idx % len(reqs)].request_id

        def hook(pos, slots):
            if pos >= boundary and rid not in canceled and any(
                    s is not None and s.req.request_id == rid
                    for s in slots):
                sched.cancel(rid)
                canceled.append(rid)

        sched.on_boundary = hook
    results = sched.run(collections.deque(reqs), None, {})
    if paged:
        alloc = sched.pool.allocator
        assert alloc.pages_in_use == len(alloc._scratch) + len(alloc._prefix)
    return sched, reqs, results, canceled


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_scheduler_invariants_seeded_streams(seed, k, paged):
    """Seeded arrival/length streams, with a cancel in half of them: slot
    non-overlap, FIFO-or-skip admission, refill gap <= k, conservation
    and positional receipts; paged, every page comes back."""
    rng = np.random.default_rng(seed)
    lengths = [(int(rng.integers(1, 7)), int(rng.integers(1, 13)))
               for _ in range(int(rng.integers(1, 32)))]
    cancel_at = ((int(rng.integers(0, 24)), int(rng.integers(0, 64)))
                 if rng.random() < 0.5 else None)
    sched, reqs, results, canceled = _host_trace(
        lengths, k, batch=int(rng.integers(1, 4)), cancel_at=cancel_at,
        paged=paged)
    check_invariants(sched, reqs, results, k, canceled)
    assert sched.cancellations == len(canceled)
    admits = [e.request_id for e in sched.events if e.kind == "admit"]
    assert len(admits) == len(set(admits))


def test_scheduler_needs_the_plan_device():
    """The lane schedules go to the plan's device; a plan that names none
    is refused, never run on a default device."""
    class NoDevicePlan(HostPlan):
        device = None

    with pytest.raises(ValueError, match="no device"):
        ContinuousScheduler(NoDevicePlan(), BucketPolicy([Bucket(64, 2)]),
                            HostPool(), steps_per_dispatch=2)


def test_fifo_order_preserved_for_capacity_skips():
    lengths = [(8, 24), (2, 3), (2, 3), (8, 24)]
    sched, reqs, results, _ = _host_trace(lengths, 2, batch=2, max_len=32)
    check_invariants(sched, reqs, results, 2)
    admits = [e.request_id for e in sched.events if e.kind == "admit"]
    assert admits.index("h1") < admits.index("h3")
    assert admits.index("h2") < admits.index("h3")


@pytest.mark.parametrize("policy", ["priority", "edf"])
def test_admission_policy_orders_and_sheds(policy):
    """Priority admits the urgent class first; EDF admits by deadline and
    sheds the request whose deadline has passed (it never runs)."""
    reqs = [DecodeRequest(f"q{i}", [1, 2], max_new_tokens=4, priority=p,
                          deadline=d)
            for i, (p, d) in enumerate([(2, 30.0), (0, 20.0), (1, 0.0),
                                        (0, 10.0)])]
    sched, reqs, results, _ = _host_trace(
        None, 1, batch=1, admission=make_policy(policy), reqs=reqs)
    admits = [e.request_id for e in sched.events if e.kind == "admit"]
    if policy == "priority":
        assert admits == ["q1", "q3", "q2", "q0"]
        check_invariants(sched, reqs, results, 1)
    else:
        assert admits == ["q3", "q1", "q0"] and sched.drain_shed() == {"q2"}
        check_invariants(sched, reqs, results, 1, shed={"q2"})


# ---------------------------------------------------------------------------
# the stdlib copies: policies and traffic equal the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["fifo", "priority", "edf"])
def test_policy_selection_matches_reference(name, seed):
    """Both packages' policies over the same seeded queue, clock and fits
    predicates: the same sheds, peeks and selections, in the same order."""
    from repro.serve import DecodeRequest as JaxDecodeRequest
    from repro.serve.policy import make_policy as jax_make_policy

    rng = np.random.default_rng(seed)
    fields = [dict(request_id=f"q{i}",
                   prompt=[1] * int(rng.integers(1, 6)),
                   max_new_tokens=int(rng.integers(1, 9)),
                   priority=int(rng.integers(0, 3)),
                   tenant=f"t{int(rng.integers(0, 3))}",
                   deadline=(float(rng.integers(0, 40))
                             if rng.random() < 0.8 else None))
              for i in range(24)]
    queues = [collections.deque(cls(**f) for f in fields)
              for cls in (DecodeRequest, JaxDecodeRequest)]
    policies = [make_policy(name), jax_make_policy(name)]
    orders = [[], []]
    for now in range(0, 60, 3):
        cap = int(rng.integers(3, 12))
        for q, pol, order in zip(queues, policies, orders):
            order.append(("shed", [r.request_id
                                   for r in pol.shed(q, float(now))]))
            if q:
                order.append(("peek", pol.peek(q, float(now)).request_id))
            for _ in range(2):
                pick = pol.select(
                    q, lambda r: len(r.prompt) + r.max_new_tokens <= cap,
                    float(now))
                order.append(("select", pick and pick.request_id))
    assert orders[0] == orders[1]
    assert sum(kind == "select" and rid is not None
               for kind, rid in orders[0]) > 10


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_traffic_matches_reference(seed):
    from repro.serve.traffic import TrafficSpec as JaxTrafficSpec
    from repro.serve.traffic import generate_traffic as jax_generate
    from repro.serve.traffic import summarize as jax_summarize
    from repro_torch.serve.traffic import (
        TrafficSpec,
        generate_traffic,
        summarize,
    )

    kw = dict(rate=0.8, shared_prefix_len=16, shared_prefix_prob=0.5,
              abandon_prob=0.3, deadline_prob=0.7)
    got = generate_traffic(TrafficSpec(**kw), 40, seed)
    want = jax_generate(JaxTrafficSpec(**kw), 40, seed)
    assert [(t.at, t.patience, vars(t.request)) for t in got] == \
        [(t.at, t.patience, vars(t.request)) for t in want]
    assert summarize(got) == jax_summarize(want)


# ---------------------------------------------------------------------------
# validation: the speculative lanes build, and fail as the reference does
# ---------------------------------------------------------------------------


def test_speculative_raises_naming_the_next_slice():
    """Every speculative entry point builds (batcher, plan step, masked
    step, scheduler, dense and paged) and resolves ``(spec_k,
    draft_layers)``; invalid combinations fail with the reference's
    messages, the batcher's, the scheduler's and the resolver's alike."""
    plan = build_plan(torch_cfg(), None, device="cpu")
    b = plan.make_batcher(schedule="continuous", steps_per_dispatch=4,
                          speculative=4, draft="prefix:1")
    assert b.spec == (4, 1) and b.scheduler.spec == (4, 1)
    assert plan.serve_executable("masked_decode", batch=2, max_len=64,
                                 steps_per_dispatch=4,
                                 spec=(4, 1)).key.spec == (4, 1)
    assert callable(make_masked_decode_step(torch_cfg(), 2, 64,
                                            steps_per_dispatch=4,
                                            spec=(4, 1)))
    policy = BucketPolicy([Bucket(64, 2)])
    sched = ContinuousScheduler(HostPlan(), policy, HostPool((20, 16)),
                                steps_per_dispatch=4, spec=(4, 1))
    assert sched.stats()["spec"]["draft_layers"] == 1
    with pytest.raises(ValueError, match="must equal"):
        ContinuousScheduler(HostPlan(), policy, HostPool(),
                            steps_per_dispatch=4, spec=(2, 1))
    with pytest.raises(ValueError, match="draft_layers must be >= 1"):
        ContinuousScheduler(HostPlan(), policy, HostPool(),
                            steps_per_dispatch=4, spec=(4, 0))
    with pytest.raises(ValueError, match="page_count"):
        ContinuousScheduler(HostPlan(), policy, HostPool((7, 16)),
                            steps_per_dispatch=4, spec=(4, 1))
    with pytest.raises(ValueError, match="page_count"):
        plan.make_batcher(schedule="continuous", steps_per_dispatch=2,
                          speculative=2, paged=(2, 8))
    # the reference's checks still come first
    for kw, msg in ((dict(schedule="fifo"), "continuous"),
                    (dict(steps_per_dispatch=2), "must equal"),
                    (dict(draft="suffix:1"), "prefix:N"),
                    (dict(draft="prefix:9"), "draft depth")):
        args = dict(schedule="continuous", steps_per_dispatch=4,
                    draft=None, n_layers=2, family="dense")
        args.update(kw)
        with pytest.raises(ValueError, match=msg):
            resolve_speculative(4, **args)
    with pytest.raises(ValueError, match="draft only applies"):
        resolve_speculative(0, "prefix:1", schedule="continuous",
                            steps_per_dispatch=4, n_layers=2,
                            family="dense")
    assert resolve_speculative(0, None, schedule="continuous",
                               steps_per_dispatch=4, n_layers=2,
                               family="dense") is None
    for draft, layers in ((None, 1), ("prefix:2", 2)):
        assert resolve_speculative(4, draft, schedule="continuous",
                                   steps_per_dispatch=4, n_layers=2,
                                   family="dense") == (4, layers)
    for kw, msg in ((dict(steps_per_dispatch=4), "continuous"),
                    (dict(admission=make_policy("edf")), "continuous"),
                    (dict(schedule="continuous", steps_per_dispatch=0),
                     "steps_per_dispatch"),
                    (dict(schedule="continuous", steps_per_dispatch=4,
                          policy=BucketPolicy([Bucket(30, 2)])), "multiple"),
                    (dict(schedule="lifo"), "schedule")):
        with pytest.raises(ValueError, match=msg):
            plan.make_batcher(**kw)


# ---------------------------------------------------------------------------
# the async streaming server
# ---------------------------------------------------------------------------

K = 2


def _server_batcher(seed, admission=None):
    return port_batcher(seed, schedule="continuous",
                        policy=BucketPolicy([Bucket(64, 2)]),
                        steps_per_dispatch=K, admission=admission)


@pytest.mark.parametrize("mode", ["generate", "stream"])
@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float", "quantized"])
def test_async_server_matches_reference(test_seed, mode, quantized):
    """Concurrent submissions through the server, collected as results or
    as concatenated stream deltas, give the reference's tokens, on the one
    warm step."""
    want, gaps = jax_reference(test_seed, quantized, "parity")
    b = port_batcher(test_seed, quantized, schedule="continuous",
                     policy=BucketPolicy([Bucket(64, 2)]),
                     steps_per_dispatch=K)

    async def one(server, rid, p, n):
        req = DecodeRequest(rid, p, max_new_tokens=n)
        if mode == "generate":
            return rid, (await server.generate(req)).tokens
        return rid, [t async for t in server.stream(req)]

    async def drive():
        async with AsyncServeServer(b) as server:
            got = await asyncio.gather(*[one(server, *r)
                                         for r in PARITY_TRACE])
            return dict(got), server.stats()

    got, stats = asyncio.run(drive())
    assert_streams(got, want, gaps, [r for r, _, _ in PARITY_TRACE], mode)
    assert stats["outcomes"] == {"done": len(PARITY_TRACE)}
    assert stats["open_streams"] == 0 and stats["p50_ttft_s"] > 0
    assert b.cache.stats()["builds"] == 1 and b.scheduler.refills > 0


def test_async_disconnect_cancels_and_wipes_the_slot(test_seed):
    ref = _alone(test_seed, [7, 11, 13], 4, Bucket(64, 2), K)
    b = _server_batcher(test_seed)
    sched = b.scheduler
    gate = threading.Event()

    async def drive():
        async with AsyncServeServer(b) as server:
            orig = sched.on_tokens

            def gated(deltas):
                orig(deltas)
                if "victim" in deltas:
                    gate.wait(timeout=30)

            sched.on_tokens = gated
            gen = server.stream(DecodeRequest("victim", [5, 9],
                                              max_new_tokens=30))
            first = await gen.__anext__()
            await gen.aclose()           # disconnect: cancel hits intake
            gate.set()
            late = await server.generate(
                DecodeRequest("late", [7, 11, 13], max_new_tokens=4))
            return first, late, server.stats()

    first, late, stats = asyncio.run(drive())
    assert isinstance(first, int)
    assert sched.cancellations == 1 and b.pool.slot_resets >= 1
    assert stats["outcomes"] == {"cancelled": 1, "done": 1}
    assert late.tokens == ref


def test_async_edf_shed_raises_request_shed(test_seed):
    b = _server_batcher(test_seed, admission=make_policy("edf"))

    async def drive():
        async with AsyncServeServer(b) as server:
            with pytest.raises(RequestShed):
                await server.generate(DecodeRequest(
                    "doomed", [1, 2], max_new_tokens=4, deadline=0.001))
            ok = await server.generate(DecodeRequest(
                "ok", [5, 9], max_new_tokens=3,
                deadline=time.monotonic() + 300.0))
            return ok, server.stats()

    ok, stats = asyncio.run(drive())
    assert len(ok.tokens) == 3 and b.scheduler.sheds == 1
    assert stats["outcomes"] == {"shed": 1, "done": 1}
    assert "doomed" not in b._pending_ids   # the shed id is reusable


def test_async_worker_exception_reaches_every_caller(test_seed, monkeypatch):
    """A failure inside the dispatch loop fails every waiting call with
    that exception, and later submissions with it as the cause."""
    b = _server_batcher(test_seed)
    boom = RuntimeError("dispatch failed")

    def fail():
        raise boom

    monkeypatch.setattr(b, "run", fail)

    async def drive():
        async with AsyncServeServer(b) as server:
            got = await asyncio.gather(
                *[server.generate(DecodeRequest(f"r{i}", [1, 2],
                                                max_new_tokens=2))
                  for i in range(3)], return_exceptions=True)
            with pytest.raises(RuntimeError, match="worker failed") as exc:
                await server.generate(DecodeRequest("late", [1],
                                                    max_new_tokens=1))
            return got, exc.value.__cause__

    got, cause = asyncio.run(drive())
    # a call registered after the failure raises with it as the cause
    assert any(g is boom for g in got) and cause is boom
    assert all(g is boom or g.__cause__ is boom for g in got)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_continuous_paged_edf_stream(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "yi-6b", "--debug", "--device", "cpu", "--schedule",
          "continuous", "--steps-per-dispatch", "4", "--paged", "--policy",
          "edf", "--stream", "--tokens", "6", "--rounds", "2"])
    out = capsys.readouterr().out
    waves = [ln for ln in out.splitlines() if ln.startswith("wave ")]
    assert len(waves) == 2 and all("(streamed)" in w for w in waves)
    # the second wave builds nothing new
    assert "'builds': 1," in waves[0] and "'builds': 1," in waves[1]
    assert "outcomes {'done': 8}" in out and "policy edf" in out
    hits = re.search(r"(\d+) prefix hits", out)
    assert hits and int(hits.group(1)) > 0
    assert re.search(r"hits=[1-9]\d* misses=1 builds=1$", out.rstrip())
    main(["--arch", "yi-6b", "--debug", "--device", "cpu", "--schedule",
          "continuous", "--steps-per-dispatch", "4", "--speculative", "4",
          "--draft", "prefix:1", "--tokens", "6", "--rounds", "3"])
    out = capsys.readouterr().out
    waves = [ln for ln in out.splitlines() if ln.startswith("wave ")]
    assert len(waves) == 3 and all("'builds': 1," in w for w in waves)
    assert len({w.split("-> ")[1].split(";")[0] for w in waves}) == 1
    acc = re.search(r"speculative: k=4 draft_layers=1, (\d+)/(\d+) draft "
                    r"tokens accepted", out)
    assert acc and 0 < int(acc.group(1)) <= int(acc.group(2))
