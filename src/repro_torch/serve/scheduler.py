"""Continuous-batching scheduler: slot reuse inside an in-flight dispatch.

The fifo batcher dispatches fixed groups: every slot of a bucket runs
until the LONGEST request of its group finishes, so a short request's
slot idles for the rest of the group. :class:`ContinuousScheduler`
refills freed slots inside the dispatch, over ONE step per (bucket, k)
(``make_masked_decode_step``):

* every batch lane ("slot") carries its own request's life — teacher-
  forced chunked prefill, greedy decode, finished — steered by per-slot
  lane schedules (``feed``/``start``/``active``/``fresh``, shape
  ``[k, slots]``) that are plain inputs, so the step's shapes never
  change and a churning request mix builds nothing after warm-up;
* the event horizon is a **micro-run** of ``steps_per_dispatch`` (k)
  masked steps in one step call: admission, refill, cancellation and
  completion land on micro-run boundaries, and the host precomputes the
  whole ``[k, slots]`` schedule ahead of each call (finish steps are
  known at admission, so nothing is read back mid-run). A long prompt
  enters as successive k-token feed chunks;
* a freed slot is refilled at the NEXT boundary (refill gap <= k steps):
  the ``fresh`` lane zeroes the slot's dense state in the step, and the
  attention window ``[start, pos]`` keeps the newcomer from seeing its
  predecessor's cache;
* admission is capacity-checked: a request needing ``n`` positions joins
  an in-flight dispatch only while ``pos + n <= bucket.max_len``; when
  the bucket's positions run out, the dispatch drains and a new one
  starts at position 0 on a freshly reset pooled state.

The host never reads tokens back inside a dispatch: the per-micro-run
token blocks stay on the device and are fetched once when the dispatch
drains, or once per boundary when ``on_tokens`` is set.

:meth:`ContinuousScheduler.cancel` marks an in-flight request; its slot
is freed (its state lanes wiped through ``StatePool.reset_slots``) at the
next boundary, and it never appears in the results.

Boundary seams (host-side; none changes the step):

* ``admission`` — an :class:`~repro_torch.serve.policy.AdmissionPolicy`
  that picks which queued request takes each freed slot (FIFO by
  default). Requests it sheds are reported through ``on_shed`` /
  :meth:`drain_shed` and never run.
* ``on_boundary`` — a hook run at every boundary before frees and
  admission (the async server drains its intake there; tests cancel).
* ``on_tokens`` — streaming: each micro-run's tokens are fetched at the
  boundary and handed over as ``{request_id: [tokens]}`` deltas.
* ``clock`` — the admission policy's time source: ``None`` means the
  global step counter; the async server installs ``time.monotonic``.

Paged mode (a pool with an ``allocator``): each admitted slot leases
pages from the :class:`~repro_torch.serve.paging.PageAllocator`; a
prefix-cache hit backdates the slot's ``start`` by the shared span, and
empty or self-masked lanes write into their own pinned scratch pages.
Speculative lanes are not ported (``spec`` raises).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Set

import numpy as np
import torch

from repro_torch.serve.batcher import (
    Bucket,
    BucketMetrics,
    BucketPolicy,
    DecodeRequest,
    RequestResult,
)
from repro_torch.serve.state_pool import StatePool

_EVENT_WINDOW = 4096      # bounded: a resident server must not grow per-req


@dataclasses.dataclass(frozen=True)
class SlotEvent:
    """One admission, free, cancellation or shed, for tests and traces."""

    kind: str             # "admit" | "free" | "cancel" | "shed"
    step: int             # global position at which it happened
    slot: int
    request_id: str


@dataclasses.dataclass
class _Slot:
    """One in-flight request bound to a batch lane.

    Paged mode: ``pages`` is the lane's
    :class:`~repro_torch.serve.paging.SlotPages` lease, and a prefix-cache
    hit of ``shared_len`` tokens backdates ``start`` to ``pos -
    shared_len`` (possibly negative) with ``fed`` starting at
    ``shared_len``: the lane behaves as if it had already teacher-forced
    the shared prefix, so ``end_step`` and result slicing hold unchanged.
    """

    req: DecodeRequest
    start: int            # global position of the request's first token
    fed: int = 0          # prompt tokens teacher-forced so far
    pages: Optional[object] = None   # SlotPages lease (paged mode only)

    @property
    def end_step(self) -> int:
        # the step that produces the request's last generated token
        return self.start + len(self.req.prompt) + self.req.max_new_tokens - 2


class ContinuousScheduler:
    """Admit queued requests into in-flight buckets as sequences finish.

    A thin state machine over the plan's ``masked_decode`` step: the plan
    owns the step, the :class:`StatePool` the resident state, and the
    scheduler decides, per micro-run, which slot runs which request.
    ``steps_per_dispatch`` (k) is the micro-run length: every bucket's
    ``max_len`` must be a multiple of k so micro-runs tile the positions.
    """

    def __init__(self, plan, policy: BucketPolicy, pool: StatePool,
                 steps_per_dispatch: int = 1, admission=None,
                 clock: Optional[Callable[[], float]] = None,
                 spec: Optional[tuple] = None):
        from repro_torch.serve.policy import FifoPolicy

        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        for b in policy.buckets:
            if b.max_len % steps_per_dispatch:
                raise ValueError(
                    f"bucket {b.label}: max_len must be a multiple of "
                    f"steps_per_dispatch={steps_per_dispatch} so micro-runs "
                    "tile the position space")
        paged = getattr(pool, "paged", None)
        if paged is not None:
            for b in policy.buckets:
                if b.max_len % paged[1]:
                    raise ValueError(
                        f"bucket {b.label}: max_len must be a multiple of "
                        f"page_size={paged[1]} so page tables tile the "
                        "position space")
        if spec:
            from repro_torch.serve.validation import (
                SPEC_NOT_PORTED,
                validate_paged_spec,
                validate_spec_geometry,
            )

            validate_spec_geometry(tuple(spec), steps_per_dispatch)
            if paged is not None:
                validate_paged_spec(tuple(spec), paged, policy.buckets)
            raise NotImplementedError(SPEC_NOT_PORTED)
        self.plan = plan
        self.policy = policy
        self.pool = pool
        self.steps_per_dispatch = steps_per_dispatch
        self.admission = admission if admission is not None else FifoPolicy()
        self.clock = clock
        # counters: slot_steps counts every lane-step of every dispatch,
        # idle_slot_steps the lanes that ran inert
        self.dispatches = 0
        self.micro_runs = 0
        self.steps = 0
        self.admissions = 0
        self.cancellations = 0
        self.sheds = 0
        self.slot_steps = 0
        self.idle_slot_steps = 0
        self.refills = 0
        self.refill_gap_total = 0
        self.max_refill_gap = 0
        self.events: Deque[SlotEvent] = collections.deque(
            maxlen=_EVENT_WINDOW)
        # per-dispatch [B] idle-step vectors
        self.dispatch_idle: Deque[List[int]] = collections.deque(maxlen=256)
        # requests to drop at the next boundary (see cancel()); marks never
        # survive a boundary, so a later request reusing a cancelled id
        # cannot be swallowed by a stale mark
        self._canceled: Set[str] = set()
        # cancels that arrived after their request completed in an EARLIER
        # dispatch of the current run(); run() drops those results
        self._stale_cancels: Set[str] = set()
        # ids the admission policy shed; the batcher drains them after run()
        self._shed_ids: Set[str] = set()
        self.on_boundary: Optional[Callable[[int, List[Optional[_Slot]]],
                                            None]] = None
        self.on_tokens: Optional[Callable[[Dict[str, List[int]]],
                                          None]] = None
        self.on_shed: Optional[Callable[[str], None]] = None

    # -- cancellation ---------------------------------------------------------

    def cancel(self, request_id: str) -> None:
        """Drop an in-flight request at the next micro-run boundary.

        The current micro-run finishes undisturbed; at the boundary the
        slot is freed, its state lanes are wiped, and the request never
        appears in the results, also when the cancel races its completion.
        Call from the dispatching thread (e.g. the ``on_boundary`` hook).
        Queued requests are the batcher's job (``ServeBatcher.cancel``).
        """
        self._canceled.add(request_id)

    # -- shedding -------------------------------------------------------------

    def drain_shed(self) -> Set[str]:
        """Ids the admission policy shed since the last drain."""
        shed, self._shed_ids = self._shed_ids, set()
        return shed

    # -- admission ------------------------------------------------------------

    def _now(self) -> float:
        """The admission policy's clock: global steps unless overridden."""
        return self.clock() if self.clock is not None else float(self.steps)

    def _admit(self, pending: Deque[DecodeRequest], bucket: Bucket,
               slots: List[Optional[_Slot]], pos: int,
               freed_at: List[int]) -> List[int]:
        """Fill free slots from the queue; returns the admitted lanes."""
        now = self._now()
        for req in self.admission.shed(pending, now):
            self.sheds += 1
            self._shed_ids.add(req.request_id)
            self.events.append(SlotEvent("shed", pos, -1, req.request_id))
            if self.on_shed is not None:
                self.on_shed(req.request_id)

        alloc = getattr(self.pool, "allocator", None)

        def fits(req: DecodeRequest) -> bool:
            need = len(req.prompt) + req.max_new_tokens - 1
            if req.need_len > bucket.max_len:
                return False
            if alloc is None:
                return pos + need <= bucket.max_len
            # a prefix-cache hit shrinks the positions the request uses
            # (its start is backdated by the shared span); the page budget
            # must also cover its private pages
            shared = alloc.probe(req.prompt)
            return (pos + (need - shared) <= bucket.max_len
                    and alloc.can_admit(req.prompt, need))

        admitted: List[int] = []
        for b in range(bucket.batch):
            if slots[b] is not None or not pending:
                continue
            chosen = self.admission.select(pending, fits, now)
            if chosen is None:
                break
            if alloc is not None:
                need = len(chosen.prompt) + chosen.max_new_tokens - 1
                lease = alloc.admit(chosen.prompt, need)
                if lease is None:
                    # the page budget moved between fits and admit (an
                    # eviction edge): requeue at the head, stop filling
                    pending.appendleft(chosen)
                    break
                slots[b] = _Slot(chosen, start=pos - lease.shared_len,
                                 fed=lease.shared_len, pages=lease)
            else:
                slots[b] = _Slot(chosen, start=pos)
            admitted.append(b)
            self.admissions += 1
            self.events.append(SlotEvent("admit", pos, b, chosen.request_id))
            if freed_at[b] >= 0:
                gap = pos - freed_at[b]
                self.refills += 1
                self.refill_gap_total += gap
                self.max_refill_gap = max(self.max_refill_gap, gap)
        return admitted

    # -- dispatch -------------------------------------------------------------

    def run(self, pending: Deque[DecodeRequest], model,
            metrics: Dict[str, BucketMetrics]) -> Dict[str, RequestResult]:
        """Drain the queue through successive continuous dispatches."""
        results: Dict[str, RequestResult] = {}
        while pending:
            res = self._dispatch(pending, model, metrics)
            # cancels that raced a completion of an EARLIER dispatch: drop
            # the old tokens BEFORE merging this dispatch's results, so a
            # request resubmitted under the same id keeps its tokens
            for rid in self._stale_cancels:
                if results.pop(rid, None) is not None:
                    self.cancellations += 1
            self._stale_cancels.clear()
            results.update(res)
        return results

    def _free(self, slots, b, pos, freed_at, done=None):
        """Release lane ``b`` at boundary ``pos`` (finish or cancel)."""
        slot = slots[b]
        alloc = getattr(self.pool, "allocator", None)
        if alloc is not None and slot.pages is not None:
            if done is not None:
                # a finished request has fed its whole prompt: publish its
                # full prompt pages so a follower with the prefix skips them
                alloc.publish(slot.pages, slot.fed)
            alloc.release(slot.pages)
        if done is not None:
            done.append((slot.req, b, slot.start))
            # the free happened when the request produced its last token
            self.events.append(
                SlotEvent("free", slot.end_step, b, slot.req.request_id))
            freed_at[b] = slot.end_step
        else:
            self.events.append(
                SlotEvent("cancel", pos, b, slot.req.request_id))
            # the lane was occupied through the previous micro-run's end
            freed_at[b] = pos - 1
        slots[b] = None

    def _dispatch(self, pending: Deque[DecodeRequest], model,
                  metrics: Dict[str, BucketMetrics]
                  ) -> Dict[str, RequestResult]:
        t0 = time.perf_counter()
        k = self.steps_per_dispatch
        # the policy's top pick sizes the dispatch bucket
        head = self.admission.peek(pending, self._now())
        bucket = self.policy.bucket_for(head.need_len)
        B, L = bucket.batch, bucket.max_len
        paged = getattr(self.pool, "paged", None)
        alloc = getattr(self.pool, "allocator", None)
        kw = {"paged": paged} if paged is not None else {}
        exe = self.plan.serve_executable("masked_decode", batch=B, max_len=L,
                                         steps_per_dispatch=k, **kw)
        device = getattr(self.plan, "device", torch.device("cpu"))
        if paged is not None:
            n_tables = L // paged[1]
            # pinned per-lane scratch pages: empty and self-masked lanes
            # still run the step, and their (masked, never read) writes
            # must land somewhere harmless and distinct per lane
            scratch = alloc.scratch(B)

        state = self.pool.acquire(B, L)
        slots: List[Optional[_Slot]] = [None] * B
        freed_at = [-1] * B
        idle_steps = [0] * B
        ever_used = [False] * B
        done: List[tuple] = []        # (req, slot idx, start)
        outs: List[object] = []       # per-micro-run token blocks [k, B]
        prev = torch.zeros((B,), dtype=torch.int32, device=device)
        pos = 0
        runs = 0                      # micro-runs this dispatch executed

        # the lane schedules change only on admission, free and prefill
        # events; in steady decode the resident device copies are reused.
        # A cached device tensor is never written: a change copies anew,
        # synchronously, so no host array is read after the call returns
        lane_cache: Dict[str, tuple] = {}

        def lane(name, host):
            cached = lane_cache.get(name)
            if cached is not None and np.array_equal(cached[0], host):
                return cached[1]
            dev = torch.from_numpy(host).to(device)
            lane_cache[name] = (host, dev)
            return dev

        def drain_cancels():
            """Resolve every pending cancel mark against this dispatch's
            finished-but-unreturned requests; the rest completed in an
            earlier dispatch (or was bogus) and goes to run()."""
            for rid in list(self._canceled):
                self._canceled.discard(rid)
                idx = next((i for i, (req, _, _) in enumerate(done)
                            if req.request_id == rid), None)
                if idx is not None:
                    del done[idx]             # finished: drop the tokens
                    self.cancellations += 1
                else:
                    self._stale_cancels.add(rid)

        while pos + k <= L:
            # ---- micro-run boundary: hook, cancels, frees, admission ----
            if self.on_boundary is not None:
                self.on_boundary(pos, slots)
            cancel_mask = np.zeros((B,), bool)
            for b, slot in enumerate(slots):
                if slot is None:
                    continue
                if slot.req.request_id in self._canceled:
                    self._canceled.discard(slot.req.request_id)
                    self.cancellations += 1
                    cancel_mask[b] = True
                    self._free(slots, b, pos, freed_at)
                elif slot.end_step < pos:
                    self._free(slots, b, pos, freed_at, done)
            if cancel_mask.any():
                # wipe the cancelled lanes NOW: the state must not carry a
                # dead request's KV past the boundary, successor or not
                state = self.pool.reset_slots(B, L, state, cancel_mask)
            drain_cancels()
            if alloc is not None:
                # incremental publish: every fully fed prompt page of a
                # running request becomes a prefix-cache entry now, so a
                # follower admitted at this boundary can share it
                for slot in slots:
                    if slot is not None and slot.pages is not None:
                        alloc.publish(slot.pages, slot.fed)

            fresh = np.zeros((k, B), bool)
            for b in self._admit(pending, bucket, slots, pos, freed_at):
                fresh[0, b] = True
                ever_used[b] = True
            if all(s is None for s in slots):
                break                  # drained, or out of positions

            # ---- precompute the [k, B] schedule for this micro-run ----
            feed = np.zeros((k, B), np.int32)
            # empty lanes window to their own single position: harmless
            start = np.broadcast_to(
                np.arange(pos, pos + k, dtype=np.int32)[:, None],
                (k, B)).copy()
            active = np.zeros((k, B), bool)
            for b, slot in enumerate(slots):
                if slot is None:
                    idle_steps[b] += k
                    self.idle_slot_steps += k
                    continue
                # steps this request still runs inside the micro-run;
                # beyond them the slot self-masks (active False)
                live = min(k, slot.end_step - pos + 1)
                active[:live, b] = True
                start[:, b] = slot.start
                idle_steps[b] += k - live
                self.idle_slot_steps += k - live
                for i in range(live):
                    if slot.fed < len(slot.req.prompt):
                        feed[i, b] = slot.req.prompt[slot.fed]
                        slot.fed += 1
                    else:
                        feed[i, b] = -1   # continue from the slot's argmax

            extra = ()
            if paged is not None:
                # [B, n_tables] page table: the lease's pages first, the
                # lane's scratch page everywhere else (tail entries absorb
                # post-end writes; their reads are masked)
                table = np.empty((B, n_tables), np.int32)
                for b, slot in enumerate(slots):
                    table[b, :] = scratch[b]
                    if slot is not None and slot.pages is not None:
                        pg = slot.pages.pages
                        table[b, :len(pg)] = pg
                extra = (lane("table", table),)
            toks, prev, state = exe.fn(
                model, state, lane("feed", feed), prev, pos,
                lane("start", start), lane("active", active),
                lane("fresh", fresh), *extra)
            if self.on_tokens is not None:
                # streaming: fetch this micro-run's block at the boundary
                # and hand each live request its newly GENERATED tokens
                # (prompt-echo steps belong to no stream); the fetched
                # array replaces the device block in `outs`
                toks = toks.cpu().numpy()
                deltas: Dict[str, List[int]] = {}
                for b, slot in enumerate(slots):
                    if slot is None:
                        continue
                    first = slot.start + len(slot.req.prompt) - 1
                    lo = max(pos, first)
                    hi = min(pos + k - 1, slot.end_step)
                    if lo <= hi:
                        deltas[slot.req.request_id] = [
                            int(t) for t in toks[lo - pos:hi - pos + 1, b]]
                if deltas:
                    self.on_tokens(deltas)
            outs.append(toks)
            self.micro_runs += 1
            self.steps += k
            self.slot_steps += k * B
            pos += k
            runs += 1

        # every admitted request ends inside the loop (admission bounds
        # end_step < L and micro-runs tile [0, L)): drain the rest
        for b, slot in enumerate(slots):
            if slot is not None:
                self._free(slots, b, pos, freed_at, done)
        drain_cancels()   # marks set during the final micro-run

        # one fetch of the dispatch's tokens (waits for the device)
        toks = (np.concatenate([t if isinstance(t, np.ndarray)
                                else t.cpu().numpy() for t in outs], axis=0)
                if outs else np.zeros((0, B), np.int32))      # [steps, B]
        self.pool.release(B, L, state)
        t_total = time.perf_counter() - t0
        self.dispatches += 1
        self.dispatch_idle.append(idle_steps)

        results: Dict[str, RequestResult] = {}
        for req, b, s in done:
            first = s + len(req.prompt) - 1
            results[req.request_id] = RequestResult(
                request_id=req.request_id,
                tokens=[int(t) for t in
                        toks[first:first + req.max_new_tokens, b]],
                bucket=bucket.label,
                prefill_seconds=0.0,   # prefill is folded into the steps
                total_seconds=t_total,
            )

        m = metrics.setdefault(bucket.label, BucketMetrics())
        m.dispatches += 1
        m.requests += len(results)
        # same unit as the fifo path: slots this dispatch never filled
        m.padded_slots += B - sum(ever_used)
        m.new_tokens += sum(len(r.tokens) for r in results.values())
        m.decode_seconds += t_total
        m.latencies.extend([t_total] * len(results))
        span = runs * k
        m.slot_steps += span * B
        for b in range(B):
            m.busy_slot_steps += span - idle_steps[b]
            m.slot_idle.append(idle_steps[b])
        if alloc is not None:
            # gauges, not sums: the page pool is shared by every bucket
            m.pages_in_use = alloc.pages_in_use
            m.peak_pages = alloc.peak_pages
            m.prefix_hits = alloc.prefix_hits
        return results

    # -- observability --------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        busy = self.slot_steps - self.idle_slot_steps
        return {
            "dispatches": self.dispatches,
            "micro_runs": self.micro_runs,
            "steps_per_dispatch": self.steps_per_dispatch,
            "steps": self.steps,
            "policy": self.admission.name,
            "admissions": self.admissions,
            "cancellations": self.cancellations,
            "sheds": self.sheds,
            "slot_steps": self.slot_steps,
            "idle_slot_steps": self.idle_slot_steps,
            "busy_slot_fraction": round(busy / self.slot_steps, 4)
            if self.slot_steps else 0.0,
            "refills": self.refills,
            "mean_refill_gap": round(
                self.refill_gap_total / self.refills, 3)
            if self.refills else 0.0,
            "max_refill_gap": self.max_refill_gap,
        }
