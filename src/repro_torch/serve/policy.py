"""Admission policies for the continuous scheduler's boundary seam.

Every micro-run boundary the :class:`~repro_torch.serve.scheduler.
ContinuousScheduler` asks its admission policy which queued request
takes each freed slot. The policy sees the pending deque, a ``fits``
predicate (bucket + remaining-position capacity for this dispatch), and
the scheduler's clock, and answers by REMOVING its pick from the deque —
the queue itself is the only request store, so a policy can never leak
or duplicate a request. The paper's trigger-system framing is exactly
this decision made under a microsecond deadline: which event gets the
fabric next, decided ahead of the dispatch so the compiled step never
changes shape.

Three policies ship:

* :class:`FifoPolicy` — arrival order with capacity skips (the default);
* :class:`PriorityPolicy` — strict priority classes (lower value wins),
  per-tenant fairness inside a class (least-recently-admitted tenant
  first), and aging so sustained high-priority load cannot starve the
  lower classes;
* :class:`DeadlinePolicy` — earliest-deadline-first with shedding: a
  request whose deadline has already passed is never admitted (it is
  dropped at the boundary and reported through the scheduler's shed
  channel) — capacity goes to requests that can still meet their SLO.

Clock domain: ``now`` is whatever the scheduler's clock yields — the
global step counter by default (deterministic, what the property tests
and the virtual-time traffic benchmark use) or wall-clock seconds when
the async server installs ``time.monotonic``. ``DecodeRequest.deadline``
must be expressed in the same domain.
"""

from __future__ import annotations

import collections
from typing import Callable, Deque, Dict, List, Optional

from repro_torch.serve.batcher import DecodeRequest

Fits = Callable[[DecodeRequest], bool]


class AdmissionPolicy:
    """Boundary-time request selection (see module docstring).

    Subclasses override :meth:`select`; :meth:`shed` and :meth:`peek`
    have neutral defaults. Policies are stateful per batcher (fairness
    stamps, first-seen times) but hold NO requests — the pending deque
    stays the single source of truth.
    """

    name = "base"

    def peek(self, pending: Deque[DecodeRequest],
             now: float) -> DecodeRequest:
        """The request the policy would serve next, capacity aside.

        The scheduler sizes a new dispatch's bucket from this pick, so a
        priority/deadline policy steers bucket choice too, not just slot
        fills.
        """
        return pending[0]

    def shed(self, pending: Deque[DecodeRequest],
             now: float) -> List[DecodeRequest]:
        """Remove and return queued requests that must not be admitted."""
        return []

    def select(self, pending: Deque[DecodeRequest], fits: Fits,
               now: float) -> Optional[DecodeRequest]:
        """Remove and return the next request for a free slot, or None."""
        raise NotImplementedError


class FifoPolicy(AdmissionPolicy):
    """Arrival order with capacity skips — the scheduler's historical
    behavior, kept as the default. A request skipped for lack of
    remaining positions keeps its queue rank."""

    name = "fifo"

    def select(self, pending, fits, now):
        kept: Deque[DecodeRequest] = collections.deque()
        chosen = None
        while pending:
            req = pending.popleft()
            if fits(req):
                chosen = req
                break
            kept.append(req)
        # splice the skipped prefix back in front, order intact
        pending.extendleft(reversed(kept))
        return chosen


class PriorityPolicy(AdmissionPolicy):
    """Strict priority with per-tenant fairness and aging.

    ``DecodeRequest.priority`` is the class (0 = most urgent; default 0).
    Selection key, most significant first:

    1. **effective priority** — ``priority - waited // aging_steps``:
       every ``aging_steps`` of queue wait promotes a request one class,
       so a class-2 request under a sustained class-0 flood is admitted
       within a bounded number of boundaries (``aging_steps * 2`` wait,
       plus one slot turnover). ``aging_steps=0`` disables aging and
       makes starvation possible — strict priority in its pure form;
    2. **tenant fairness** (``fairness=True``) — among the surviving
       class, the tenant admitted longest ago wins, so one chatty tenant
       cannot monopolize a class;
    3. **queue order** — FIFO among equals.

    Wait times are measured from the first boundary a request is seen at
    (the policy stamps them; the scheduler's clock is the domain).
    """

    name = "priority"

    def __init__(self, fairness: bool = True, aging_steps: int = 64):
        if aging_steps < 0:
            raise ValueError(f"aging_steps must be >= 0, got {aging_steps}")
        self.fairness = fairness
        self.aging_steps = aging_steps
        self._seen: Dict[str, float] = {}       # request id -> first seen
        self._last_admit: Dict[str, float] = {}  # tenant -> admit stamp
        self._admit_seq = 0

    def _key(self, idx: int, req: DecodeRequest, now: float):
        seen = self._seen.setdefault(req.request_id, now)
        eff = req.priority
        if self.aging_steps:
            eff -= int((now - seen) // self.aging_steps)
        lru = self._last_admit.get(req.tenant, float("-inf")) \
            if self.fairness else 0.0
        return (eff, lru, idx)

    def _prune(self, pending):
        # _seen must not grow with request history, only with queue depth
        if len(self._seen) > 2 * len(pending) + 64:
            live = {r.request_id for r in pending}
            self._seen = {k: v for k, v in self._seen.items() if k in live}

    def peek(self, pending, now):
        idx, _ = min(enumerate(pending),
                     key=lambda e: self._key(e[0], e[1], now))
        return pending[idx]

    def select(self, pending, fits, now):
        self._prune(pending)
        best = None
        for idx, req in enumerate(pending):
            key = self._key(idx, req, now)
            if fits(req) and (best is None or key < best[0]):
                best = (key, idx, req)
        if best is None:
            return None
        _, idx, req = best
        del pending[idx]
        self._seen.pop(req.request_id, None)
        self._admit_seq += 1
        # the sequence number (not `now`) breaks ties between tenants
        # admitted inside one boundary, where the clock does not move
        self._last_admit[req.tenant] = self._admit_seq
        return req


class DeadlinePolicy(AdmissionPolicy):
    """Earliest-deadline-first with expired-request shedding.

    ``DecodeRequest.deadline`` is an absolute time in the scheduler's
    clock domain (global steps by default, ``time.monotonic`` seconds
    under the async server) by which the request's LAST token must be
    out. Selection is by earliest deadline (deadline-less requests rank
    last, FIFO among themselves). A request whose deadline has already
    passed is never admitted: :meth:`shed` removes it at the boundary and
    the scheduler reports it through its shed channel — spending slot
    steps on a request that already missed its SLO only adds misses
    (goodput-under-deadline is the benchmark headline this defends).
    """

    name = "edf"

    @staticmethod
    def _deadline(req: DecodeRequest) -> float:
        return float("inf") if req.deadline is None else req.deadline

    def peek(self, pending, now):
        idx, _ = min(enumerate(pending),
                     key=lambda e: (self._deadline(e[1]), e[0]))
        return pending[idx]

    def shed(self, pending, now):
        expired = [req for req in pending
                   if req.deadline is not None and req.deadline <= now]
        for req in expired:
            pending.remove(req)
        return expired

    def select(self, pending, fits, now):
        best = None
        for idx, req in enumerate(pending):
            if req.deadline is not None and req.deadline <= now:
                continue                    # expired: shed's job, never admit
            key = (self._deadline(req), idx)
            if fits(req) and (best is None or key < best[0]):
                best = (key, idx, req)
        if best is None:
            return None
        _, idx, req = best
        del pending[idx]
        return req


_POLICIES = {
    "fifo": FifoPolicy,
    "priority": PriorityPolicy,
    "edf": DeadlinePolicy,
}


def make_policy(name: str) -> AdmissionPolicy:
    """CLI/benchmark factory: ``fifo`` | ``priority`` | ``edf``."""
    if name not in _POLICIES:
        raise ValueError(
            f"unknown admission policy {name!r}; "
            f"choose from {sorted(_POLICIES)}")
    return _POLICIES[name]()
