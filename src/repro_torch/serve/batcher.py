"""Request batcher: shape buckets, cached steps, fifo groups or continuous
slot reuse.

The batcher quantizes every request group onto a small closed set of
declared shape buckets:

* a ``Bucket(batch, max_len)`` fixes the decode step's shapes: requests
  are padded up to the bucket batch with inert slots and their KV capacity
  to ``max_len``;
* the prompt block is padded to a power-of-two ``prefill_len`` (>= 8), so
  each bucket owns at most log2(max_len) prefill steps.

``schedule="fifo"`` (the default) runs two cached steps per group: one
``make_prefill_decode_step`` loop that teacher-forces prompts straight
into the resident KV cache while already generating for short sequences,
and one ``make_serve_step`` single-token step looped for the remaining
tokens. ``schedule="continuous"`` hands the queue to the
:class:`~repro_torch.serve.scheduler.ContinuousScheduler`, which refills
freed slots INSIDE an in-flight dispatch over one
``make_masked_decode_step`` per (bucket, ``steps_per_dispatch``), with
admission policies and optionally the paged KV pool (``paged=``). Both
take their steps from the plan's :class:`ExecutableCache` and their state
from the :class:`StatePool`; after warm-up a dispatch builds nothing new,
and the cache counters show it.

``speculative=k`` (continuous only, k = ``steps_per_dispatch``) turns each
micro-run into a draft of k tokens by a layer prefix of the model
(``draft="prefix:N"``, default half the stack) and one block verify by the
whole model; the host commits the prefix the model agrees with.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist.sharding import serving
from repro_torch.models.base import ArchConfig
from repro_torch.serve.cache import CachedExecutable, ExecutableCache
from repro_torch.serve.state_pool import StatePool

_MIN_PREFILL = 8
_LATENCY_WINDOW = 4096     # p50/p99 over the most recent N requests
_DEFAULT_PAGE_SIZE = 16


def _pow2ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


def quantile(vals: Sequence[float], p: float) -> float:
    """Nearest-rank quantile of an (unsorted) sample; 0.0 when empty: the
    index is ``ceil(p * n) - 1`` clamped to ``[0, n - 1]``."""
    if not vals:
        return 0.0
    v = sorted(vals)
    n = len(v)
    return v[max(0, min(n - 1, math.ceil(p * n) - 1))]


@dataclasses.dataclass
class DecodeRequest:
    """One sequence to continue: prompt token ids + how many to generate.

    The scheduling fields are read by the continuous scheduler's admission
    policy (``repro_torch.serve.policy``) and ignored everywhere else:
    ``priority`` is the strict-priority class (0 = most urgent), ``tenant``
    the fairness bucket inside a class, and ``deadline`` an absolute time
    in the scheduler's clock domain (global steps by default, wall-clock
    seconds under the async server) by which the last token must be out.
    """

    request_id: str
    prompt: Sequence[int]
    max_new_tokens: int = 8
    priority: int = 0
    tenant: str = "default"
    deadline: Optional[float] = None

    def __post_init__(self):
        self.prompt = [int(t) for t in self.prompt]
        if not self.prompt:
            raise ValueError(f"{self.request_id}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"{self.request_id}: max_new_tokens must be >= 1")

    @property
    def need_len(self) -> int:
        """KV positions this request can consume under bucket padding."""
        return _pow2ceil(len(self.prompt)) + self.max_new_tokens


@dataclasses.dataclass
class RequestResult:
    request_id: str
    tokens: List[int]
    bucket: str
    prefill_seconds: float
    total_seconds: float


@dataclasses.dataclass(frozen=True, order=True)
class Bucket:
    """One declared decode shape: padded batch x padded state capacity."""

    max_len: int
    batch: int

    @property
    def label(self) -> str:
        return f"b{self.batch}xl{self.max_len}"


class BucketPolicy:
    """Smallest-fit over a closed, sorted set of buckets."""

    def __init__(self, buckets: Sequence[Bucket]):
        if not buckets:
            raise ValueError("need at least one bucket")
        for b in buckets:
            # the prompt block is padded to >= _MIN_PREFILL positions, so
            # a smaller capacity could overrun the KV cache
            if b.max_len <= _MIN_PREFILL:
                raise ValueError(
                    f"bucket {b.label}: max_len must exceed {_MIN_PREFILL}")
            if b.batch < 1:
                raise ValueError(f"bucket {b.label}: batch must be >= 1")
        self.buckets = sorted(buckets)

    @classmethod
    def debug(cls) -> "BucketPolicy":
        return cls([Bucket(64, 2), Bucket(256, 2)])

    @classmethod
    def production(cls, batch: int = 128, max_len: int = 32768
                   ) -> "BucketPolicy":
        # one decile of short-context buckets under the headline shape
        return cls([Bucket(max_len // 8, batch), Bucket(max_len, batch)])

    def bucket_for(self, need_len: int) -> Bucket:
        for b in self.buckets:
            if need_len <= b.max_len:
                return b
        raise ValueError(
            f"request needs {need_len} positions; largest bucket holds "
            f"{self.buckets[-1].max_len}")


def auto_paged(policy: BucketPolicy,
               page_size: int = _DEFAULT_PAGE_SIZE) -> Tuple[int, int]:
    """A ``(page_count, page_size)`` geometry under which paged mode is
    never less capable than dense: pages to back every slot of every
    bucket at full length, plus one pinned scratch page per lane of the
    widest bucket."""
    pages = sum(b.batch * (b.max_len // page_size) for b in policy.buckets)
    scratch = max(b.batch for b in policy.buckets)
    return (pages + scratch, page_size)


@dataclasses.dataclass
class BucketMetrics:
    dispatches: int = 0
    requests: int = 0
    padded_slots: int = 0
    new_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    # slot occupancy: every (slot, step) of every dispatch is a lane-step;
    # busy lane-steps carried a request's prompt or generated token
    slot_steps: int = 0
    busy_slot_steps: int = 0
    latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_LATENCY_WINDOW))
    slot_idle: Deque[int] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_LATENCY_WINDOW))
    # paged-KV gauges: the shared PageAllocator after the bucket's latest
    # dispatch (all zero in dense mode)
    pages_in_use: int = 0
    peak_pages: int = 0
    prefix_hits: int = 0

    def summary(self) -> Dict[str, float]:
        lat = list(self.latencies)
        idle = list(self.slot_idle)
        busy = self.prefill_seconds + self.decode_seconds
        return {
            "dispatches": self.dispatches,
            "requests": self.requests,
            "padded_slots": self.padded_slots,
            "new_tokens": self.new_tokens,
            "prefill_seconds": round(self.prefill_seconds, 4),
            "decode_seconds": round(self.decode_seconds, 4),
            "p50_latency_s": round(quantile(lat, 0.50), 4),
            "p99_latency_s": round(quantile(lat, 0.99), 4),
            "tokens_per_second": round(self.new_tokens / busy, 2)
            if busy else 0.0,
            "slot_steps": self.slot_steps,
            "busy_slot_fraction": round(
                self.busy_slot_steps / self.slot_steps, 4)
            if self.slot_steps else 0.0,
            "p50_slot_idle_steps": quantile(idle, 0.50),
            "p99_slot_idle_steps": quantile(idle, 0.99),
            "pages_in_use": self.pages_in_use,
            "peak_pages": self.peak_pages,
            "prefix_hits": self.prefix_hits,
        }


class ServeBatcher:
    """Admit DecodeRequests, dispatch bucketed groups on cached steps.

    A thin consumer of :class:`repro_torch.plan.ExecutionPlan` (build one
    with ``plan.make_batcher(...)``): the plan owns the device, the model,
    the quantization decisions and every step; the batcher only groups
    requests into buckets and drives the dispatch loop. A plan built with
    ``quantized=True`` routes the decode LM head and the MLP
    down-projection through the qmatmul kernel, on every step of either
    schedule.

    ``paged`` (continuous only): ``True`` for :func:`auto_paged`, an int
    for ``auto_paged`` with that page size, ``(page_count, page_size)``
    as given, ``False``/``None`` for dense KV.

    ``speculative`` (continuous only): the draft length per micro-run,
    equal to ``steps_per_dispatch``; ``draft`` names the draft,
    ``"prefix:N"`` for the first N layers (default half the stack). Every
    check lives in :mod:`repro_torch.serve.validation`.
    """

    def __init__(self, plan, *, policy: Optional[BucketPolicy] = None,
                 schedule: str = "fifo", steps_per_dispatch: int = 1,
                 admission=None, paged=None, speculative: int = 0,
                 draft: Optional[str] = None):
        if schedule not in ("fifo", "continuous"):
            raise ValueError(
                f"schedule must be 'fifo' or 'continuous', got {schedule!r}")
        if steps_per_dispatch < 1:
            raise ValueError(
                f"steps_per_dispatch must be >= 1, got {steps_per_dispatch}")
        if steps_per_dispatch > 1 and schedule != "continuous":
            raise ValueError(
                "steps_per_dispatch > 1 needs schedule='continuous' — the "
                "fifo path amortizes prompts through its prefill loop")
        if admission is not None and schedule != "continuous":
            raise ValueError(
                "admission policies need schedule='continuous' — the "
                "fixed-group fifo path has no boundary seam to apply them")
        self.plan = plan
        self.schedule = schedule
        self.steps_per_dispatch = steps_per_dispatch
        self.policy = policy or BucketPolicy.debug()
        # bool is an int subclass: False must mean dense, not page size 0
        if paged is True:
            paged = auto_paged(self.policy)
        elif paged is False:
            paged = None
        elif isinstance(paged, int):
            paged = auto_paged(self.policy, page_size=paged)
        elif paged is not None:
            paged = tuple(paged)
        if paged is not None:
            if schedule != "continuous":
                raise ValueError(
                    "paged KV needs schedule='continuous' — only the "
                    "masked-decode path threads page tables")
            for b in self.policy.buckets:
                if b.max_len % paged[1]:
                    raise ValueError(
                        f"bucket {b.label}: max_len must be a multiple of "
                        f"page_size={paged[1]}")
        self.paged = paged
        from repro_torch.serve.validation import (
            resolve_speculative,
            validate_paged_spec,
        )

        spec = resolve_speculative(speculative, draft, schedule=schedule,
                                   steps_per_dispatch=steps_per_dispatch,
                                   n_layers=plan.cfg.n_layers,
                                   family=plan.cfg.family)
        if spec is not None and paged is not None:
            validate_paged_spec(spec, paged, self.policy.buckets)
        self.spec = spec
        self.pool = StatePool(plan, paged=paged, spec=spec)
        self.metrics: Dict[str, BucketMetrics] = {}
        self._pending: Deque[DecodeRequest] = collections.deque()
        self._pending_ids: set = set()
        # ids the admission policy shed during the last run() (deadline
        # misses): completed zero times, ids reusable
        self.last_shed: set = set()
        self._scheduler = None
        if schedule == "continuous":
            from repro_torch.serve.scheduler import ContinuousScheduler

            self._scheduler = ContinuousScheduler(
                plan, self.policy, self.pool,
                steps_per_dispatch=steps_per_dispatch, admission=admission,
                spec=spec)

    @property
    def scheduler(self):
        """The ContinuousScheduler (None under schedule="fifo")."""
        return self._scheduler

    # plan views
    @property
    def cfg(self) -> ArchConfig:
        return self.plan.cfg

    @property
    def device(self) -> torch.device:
        return self.plan.device

    @property
    def cache(self) -> ExecutableCache:
        return self.plan.cache

    # -- parameters -----------------------------------------------------------

    def load_params(self, params) -> "ServeBatcher":
        """Install a model or the reference's arrays (calibrates first)."""
        self.plan.load_params(params)
        return self

    def init_demo_params(self, seed: int = 0) -> "ServeBatcher":
        """Random parameters (CLI demos, benchmarks, tests)."""
        self.plan.init_params(seed)
        return self

    # -- admission ------------------------------------------------------------

    def submit(self, request: DecodeRequest) -> str:
        self.policy.bucket_for(request.need_len)   # reject unservable now
        if request.request_id in self._pending_ids:
            raise ValueError(
                f"duplicate request id {request.request_id!r}: a request "
                "with this id is already queued")
        self._pending_ids.add(request.request_id)
        self._pending.append(request)
        return request.request_id

    def cancel(self, request_id: str) -> bool:
        """Cancel a queued or in-flight request; returns True if known.

        A queued request leaves the queue at once. An in-flight request
        (``schedule="continuous"`` only) is marked for the scheduler, which
        frees its slot and wipes its state lanes at the next micro-run
        boundary; it never appears in the results. The id is reusable as
        soon as this returns True. Under ``schedule="fifo"`` a request
        inside a dispatch group cannot be cancelled (returns False).

        Call from the dispatching thread only: between ``run()`` calls or
        from the scheduler's ``on_boundary`` hook.
        """
        if request_id not in self._pending_ids:
            return False
        for i, req in enumerate(self._pending):
            if req.request_id == request_id:
                del self._pending[i]
                self._pending_ids.discard(request_id)
                return True
        if self._scheduler is not None:
            self._scheduler.cancel(request_id)
            self._pending_ids.discard(request_id)
            return True
        return False

    def warmup(self, bucket: Bucket, prompt_len: int = 1) -> None:
        """Build a bucket's steps ahead of traffic."""
        if self.schedule == "continuous":
            self._executable("masked_decode", bucket, 0)
        else:
            self._executable("prefill", bucket,
                             self._prefill_len(prompt_len))
            self._executable("decode", bucket, 0)

    # -- dispatch -------------------------------------------------------------

    @serving
    def run(self) -> Dict[str, RequestResult]:
        """Drain the queue: group -> dispatch until empty, or hand the
        whole queue to the continuous scheduler."""
        model = self.plan.model          # raises when nothing is loaded
        results: Dict[str, RequestResult] = {}
        if self._scheduler is not None:
            results = self._scheduler.run(self._pending, model, self.metrics)
            self.last_shed = self._scheduler.drain_shed()
            self._pending_ids.difference_update(self.last_shed)
        else:
            while self._pending:
                group, bucket = self._form_group()
                for res in self._dispatch(model, group, bucket):
                    results[res.request_id] = res
        self._pending_ids.difference_update(results)
        return results

    def _form_group(self):
        """FIFO head picks the bucket; fill with queued requests that fit."""
        first = self._pending.popleft()
        bucket = self.policy.bucket_for(first.need_len)
        group = [first]
        kept: Deque[DecodeRequest] = collections.deque()
        while self._pending and len(group) < bucket.batch:
            req = self._pending.popleft()
            if req.need_len <= bucket.max_len:
                group.append(req)
            else:
                kept.append(req)
        kept.extend(self._pending)
        self._pending = kept
        return group, bucket

    def _prefill_len(self, max_prompt: int) -> int:
        return max(_MIN_PREFILL, _pow2ceil(max_prompt))

    def _executable(self, kind: str, bucket: Bucket,
                    prefill_len: int) -> CachedExecutable:
        kw = {}
        if kind == "masked_decode":
            kw["steps_per_dispatch"] = self.steps_per_dispatch
            if self.paged is not None:
                kw["paged"] = self.paged
            if self.spec is not None:
                kw["spec"] = self.spec
        return self.plan.serve_executable(
            kind, batch=bucket.batch, max_len=bucket.max_len,
            prefill_len=prefill_len, **kw)

    def _dispatch(self, model, group: List[DecodeRequest],
                  bucket: Bucket) -> List[RequestResult]:
        t0 = time.perf_counter()
        B, P = bucket.batch, self._prefill_len(
            max(len(r.prompt) for r in group))
        prefill = self._executable("prefill", bucket, P)
        decode = self._executable("decode", bucket, 0)

        prompt = np.zeros((B, P), np.int32)
        lengths = np.ones((B,), np.int32)       # inert slots: 1-token prompt
        for slot, req in enumerate(group):
            prompt[slot, :len(req.prompt)] = req.prompt
            lengths[slot] = len(req.prompt)

        dev = self.device
        state = self.pool.acquire(B, bucket.max_len)
        tok_out, state = prefill.fn(model, state,
                                    torch.from_numpy(prompt).to(dev),
                                    torch.from_numpy(lengths).to(dev))
        prefill_np = tok_out.cpu().numpy()       # [B, P]; waits for the card
        t_prefill = time.perf_counter() - t0

        # decode loop: everyone continues from position P in lockstep
        steps = max((r.max_new_tokens - (P - len(r.prompt) + 1)
                     for r in group), default=0)
        steps = max(steps, 0)
        last = tok_out[:, -1]
        decoded = []
        for t in range(steps):
            logits, state = decode.fn(model, state, last, P + t)
            last = self.plan.token_argmax(logits)
            decoded.append(last)
        decoded_np = (torch.stack(decoded, dim=1).cpu().numpy()
                      if decoded else np.zeros((B, 0), np.int32))
        self.pool.release(B, bucket.max_len, state)
        t_total = time.perf_counter() - t0

        results = []
        for slot, req in enumerate(group):
            li = len(req.prompt)
            gen = np.concatenate(
                [prefill_np[slot, li - 1:], decoded_np[slot]])
            results.append(RequestResult(
                request_id=req.request_id,
                tokens=[int(t) for t in gen[:req.max_new_tokens]],
                bucket=bucket.label,
                prefill_seconds=t_prefill,
                total_seconds=t_total,
            ))

        m = self.metrics.setdefault(bucket.label, BucketMetrics())
        m.dispatches += 1
        m.requests += len(group)
        m.padded_slots += B - len(group)
        m.new_tokens += sum(len(r.tokens) for r in results)
        m.prefill_seconds += t_prefill
        m.decode_seconds += t_total - t_prefill
        m.latencies.extend([t_total] * len(group))
        # the group runs P prefill + `steps` decode positions in lockstep;
        # a slot is busy while it still carries prompt or requested tokens
        span = P + steps
        m.slot_steps += span * B
        for slot in range(B):
            busy_slot = 0
            if slot < len(group):
                req, res = group[slot], results[slot]
                busy_slot = min(span, len(req.prompt) + len(res.tokens) - 1)
            m.busy_slot_steps += busy_slot
            m.slot_idle.append(span - busy_slot)
        return results

    # -- observability --------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        out = {
            "cache": self.cache.stats(),
            "pool": self.pool.stats(),
            "buckets": {k: m.summary() for k, m in self.metrics.items()},
        }
        if self._scheduler is not None:
            out["scheduler"] = self._scheduler.stats()
        if self.pool.allocator is not None:
            out["paged"] = self.pool.allocator.stats()
        return out
