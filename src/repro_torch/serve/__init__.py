"""Serving: shape-bucketed batching over cached step functions.

* :class:`~repro_torch.serve.batcher.ServeBatcher` — admit
  :class:`~repro_torch.serve.batcher.DecodeRequest`s and dispatch bucketed
  groups through the cached prefill/decode steps (``schedule="fifo"``) or
  the continuous slot-reuse scheduler (``schedule="continuous"``).
* :class:`~repro_torch.serve.scheduler.ContinuousScheduler` — iteration-
  level scheduling: freed slots are refilled inside an in-flight dispatch
  through the slot-masked decode step, ``steps_per_dispatch`` masked steps
  per call (chunked prefill, mid-run self-masking, boundary cancellation).
* :class:`~repro_torch.serve.cache.ExecutableCache` — the step cache with
  hit/miss/build counters.
* :class:`~repro_torch.serve.state_pool.StatePool` — per-bucket resident
  KV caches, zeroed in place on reuse and wiped per slot;
  ``StatePool(plan, paged=(page_count, page_size))`` swaps the dense KV
  slabs for one shared physical page pool.
* :class:`~repro_torch.serve.paging.PageAllocator` — host-side page
  accounting for paged KV: refcounts, content-hashed shared-prefix reuse,
  LRU eviction.
* :class:`~repro_torch.serve.server.AsyncServeServer` — asyncio streaming
  front-end: concurrent arrivals, per-micro-run token streams,
  disconnect-driven cancellation, deadline shedding.
* ``repro_torch.serve.policy`` — boundary-time admission policies (fifo,
  priority, edf) selected via ``ServeBatcher(admission=...)``.
* :func:`~repro_torch.serve.traffic.generate_traffic` — seeded synthetic
  many-user load.
"""

from repro_torch.serve.batcher import (
    Bucket,
    BucketMetrics,
    BucketPolicy,
    DecodeRequest,
    RequestResult,
    ServeBatcher,
    auto_paged,
    quantile,
)
from repro_torch.serve.cache import CachedExecutable, CacheKey, ExecutableCache
from repro_torch.serve.paging import PageAllocator, SlotPages, prefix_page_hashes
from repro_torch.serve.policy import (
    AdmissionPolicy,
    DeadlinePolicy,
    FifoPolicy,
    PriorityPolicy,
    make_policy,
)
from repro_torch.serve.scheduler import ContinuousScheduler, SlotEvent
from repro_torch.serve.server import AsyncServeServer, RequestShed
from repro_torch.serve.state_pool import StatePool
from repro_torch.serve.traffic import TrafficRequest, TrafficSpec, generate_traffic

__all__ = [
    "AdmissionPolicy",
    "AsyncServeServer",
    "Bucket",
    "BucketMetrics",
    "BucketPolicy",
    "CacheKey",
    "CachedExecutable",
    "ContinuousScheduler",
    "DeadlinePolicy",
    "DecodeRequest",
    "ExecutableCache",
    "FifoPolicy",
    "PageAllocator",
    "PriorityPolicy",
    "RequestResult",
    "RequestShed",
    "ServeBatcher",
    "SlotEvent",
    "SlotPages",
    "StatePool",
    "TrafficRequest",
    "TrafficSpec",
    "auto_paged",
    "generate_traffic",
    "make_policy",
    "prefix_page_hashes",
    "quantile",
]
