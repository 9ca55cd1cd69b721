"""Serving: shape-bucketed fifo batching over cached step functions.

* :class:`~repro_torch.serve.batcher.ServeBatcher` — admit
  :class:`~repro_torch.serve.batcher.DecodeRequest`s and dispatch bucketed
  groups through the cached prefill/decode steps (``schedule="fifo"``).
* :class:`~repro_torch.serve.cache.ExecutableCache` — the step cache with
  hit/miss/build counters.
* :class:`~repro_torch.serve.state_pool.StatePool` — per-bucket resident
  KV caches, zeroed in place on reuse.
"""

from repro_torch.serve.batcher import (
    Bucket,
    BucketMetrics,
    BucketPolicy,
    DecodeRequest,
    RequestResult,
    ServeBatcher,
    quantile,
)
from repro_torch.serve.cache import CachedExecutable, CacheKey, ExecutableCache
from repro_torch.serve.state_pool import StatePool

__all__ = [
    "Bucket",
    "BucketMetrics",
    "BucketPolicy",
    "CacheKey",
    "CachedExecutable",
    "DecodeRequest",
    "ExecutableCache",
    "RequestResult",
    "ServeBatcher",
    "StatePool",
    "quantile",
]
