"""Request batcher: shape buckets, cached steps, prefill->decode handoff.

The batcher quantizes every request group onto a small closed set of
declared shape buckets:

* a ``Bucket(batch, max_len)`` fixes the decode step's shapes: requests
  are padded up to the bucket batch with inert slots and their KV capacity
  to ``max_len``;
* the prompt block is padded to a power-of-two ``prefill_len`` (>= 8), so
  each bucket owns at most log2(max_len) prefill steps.

A dispatch runs two cached steps per group: one
``make_prefill_decode_step`` loop that teacher-forces prompts straight
into the resident KV cache while already generating for short sequences,
and one ``make_serve_step`` single-token step looped for the remaining
tokens, both from the plan's :class:`ExecutableCache` and fed from the
per-bucket :class:`StatePool`. After warmup a dispatch performs zero new
builds; the cache counters show it.

Only this fixed-group ``schedule="fifo"`` path is ported. The continuous
scheduler, paged KV, speculative lanes and admission policies raise
``NotImplementedError`` (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.base import ArchConfig
from repro_torch.serve.cache import CachedExecutable, ExecutableCache
from repro_torch.serve.state_pool import StatePool

_MIN_PREFILL = 8
_LATENCY_WINDOW = 4096     # p50/p99 over the most recent N requests
_NOT_PORTED = "is not ported yet (ROADMAP Queue 1 item 11: serve modules)"


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
    (The reference's admission-policy fields wait for its scheduler.)"""

    request_id: str
    prompt: Sequence[int]
    max_new_tokens: int = 8

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
        }


class ServeBatcher:
    """Admit DecodeRequests, dispatch bucketed groups on cached steps.

    A thin consumer of :class:`repro_torch.plan.ExecutionPlan` (build one
    with ``plan.make_batcher(...)``): the plan owns the device, the model,
    the quantization decisions and every step; the batcher only groups
    requests into buckets and drives the dispatch loop. A plan built with
    ``quantized=True`` routes the decode LM head and the MLP
    down-projection through the qmatmul kernel.
    """

    def __init__(self, plan, *, policy: Optional[BucketPolicy] = None,
                 schedule: str = "fifo", steps_per_dispatch: int = 1,
                 admission=None, paged=None, speculative: int = 0,
                 draft: Optional[str] = None):
        if schedule == "continuous":
            raise NotImplementedError(f"schedule='continuous' {_NOT_PORTED}")
        if schedule != "fifo":
            raise ValueError(
                f"schedule must be 'fifo' or 'continuous', got {schedule!r}")
        for name, val in (("steps_per_dispatch > 1", steps_per_dispatch > 1),
                          ("admission policies", admission is not None),
                          ("paged KV", paged not in (None, False)),
                          ("speculative decoding", bool(speculative)),
                          ("draft models", draft is not None)):
            if val:
                raise NotImplementedError(f"{name} {_NOT_PORTED}")
        self.plan = plan
        self.policy = policy or BucketPolicy.debug()
        self.pool = StatePool(plan)
        self.metrics: Dict[str, BucketMetrics] = {}
        self._pending: Deque[DecodeRequest] = collections.deque()
        self._pending_ids: set = set()

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

    # -- dispatch -------------------------------------------------------------

    @torch.inference_mode()
    def run(self) -> Dict[str, RequestResult]:
        """Drain the queue: group -> dispatch until empty."""
        model = self.plan.model          # raises when nothing is loaded
        results: Dict[str, RequestResult] = {}
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
        return self.plan.serve_executable(
            kind, batch=bucket.batch, max_len=bucket.max_len,
            prefill_len=prefill_len)

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
        return {
            "cache": self.cache.stats(),
            "pool": self.pool.stats(),
            "buckets": {k: m.summary() for k, m in self.metrics.items()},
        }
