"""Per-bucket resident decode-state pools (the KV cache, dense or paged).

Allocating a KV cache per request group costs an allocation of the
largest tensors of the serving path; the pool instead keeps states
resident per bucket and zeroes them in place on reuse.

    state = pool.acquire(batch, max_len)    # zeroed, on the plan's device
    ... the steps write it in place ...
    pool.release(batch, max_len, state)

Paged mode (``StatePool(plan, paged=(page_count, page_size))``) splits
every state in two (see ``docs/memory_model.md``):

* the **pool leaves** (``cache_k``/``cache_v``) are ONE shared physical
  page pool ``[L, page_count, page_size, KV, hd]``, built once, shared by
  every bucket and NEVER zeroed (zeroing would destroy prefix pages other
  requests still reference). A host-side
  :class:`~repro_torch.serve.paging.PageAllocator` hands out page ids;
  stale page contents are harmless because a slot only reads positions
  its own steps (or a shared prefix) wrote;
* the **dense remainder** keeps the per-bucket pooling above (empty for
  the dense decoder LM, whose only state is the KV cache).

``acquire`` merges the pool leaves into the bucket's dense remainder and
``release`` takes them back out, so exactly one dispatch owns the pool at
a time; a second checkout raises.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.base import (
    is_paged_state_key,
    state_batch_axes,
    wipe_state_slots,
)

BucketShape = Tuple[int, int]        # (batch, max_len)


@dataclasses.dataclass
class _BucketPool:
    free: List[Any]
    created: int = 0
    reused: int = 0
    in_use: int = 0
    slot_resets: int = 0     # per-slot wipes
    slots_wiped: int = 0     # lanes zeroed across those wipes


class StatePool:
    """Pools of decode states, one per (batch, max_len) bucket. Fresh
    states come from the plan; the pool only tracks reuse."""

    def __init__(self, plan, paged: Optional[Tuple[int, int]] = None):
        self.plan = plan
        self.paged = tuple(paged) if paged else None
        self.allocator = None
        if self.paged is not None:
            from repro_torch.serve.paging import PageAllocator

            self.allocator = PageAllocator(*self.paged)
        self._lock = threading.Lock()
        self._pools: Dict[BucketShape, _BucketPool] = {}
        self.slot_resets = 0
        # paged mode: the shared page pool (built at first checkout) and
        # its checkout flag
        self._pool_leaves: Optional[Dict[str, torch.Tensor]] = None
        self._pool_out = False

    def _pool(self, bucket: BucketShape) -> _BucketPool:
        if bucket not in self._pools:
            self._pools[bucket] = _BucketPool(free=[])
        return self._pools[bucket]

    def _checkout_pool(self, bucket: BucketShape) -> Dict[str, torch.Tensor]:
        """The shared page-pool leaves, exclusively, for one dispatch."""
        with self._lock:
            if self._pool_out:
                raise RuntimeError(
                    "paged state pool is already checked out: paged mode "
                    "supports one in-flight dispatch at a time")
            self._pool_out = True
            leaves, self._pool_leaves = self._pool_leaves, None
        if leaves is None:
            leaves = self.plan.fresh_decode_state(*bucket, paged=self.paged,
                                                  only="pool")
        return leaves

    def acquire(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """A zeroed state for the bucket, reusing released buffers (paged:
        the zeroed dense remainder plus the never-zeroed pool leaves)."""
        bucket = (batch, max_len)
        with self._lock:
            pool = self._pool(bucket)
            state = pool.free.pop() if pool.free else None
            if state is None:
                pool.created += 1
            else:
                pool.reused += 1
            pool.in_use += 1
        if state is None:
            only = "dense" if self.paged is not None else None
            state = self.plan.fresh_decode_state(batch, max_len,
                                                 paged=self.paged, only=only)
        else:
            with torch.inference_mode():
                for leaf in state.values():
                    leaf.zero_()
        if self.paged is not None:
            state = dict(state, **self._checkout_pool(bucket))
        return state

    def reset_slots(self, batch: int, max_len: int,
                    state: Dict[str, torch.Tensor],
                    slot_mask: Sequence[bool]) -> Dict[str, torch.Tensor]:
        """Zero the masked batch lanes of a live state, in place.

        The continuous scheduler's reset for a request cancelled at a
        micro-run boundary (finish-then-refill relies on the step's
        ``fresh`` lane instead). Only the masked lanes are touched; the
        pool leaves of a paged state are skipped: a cancelled request's
        pages go back to the allocator instead.
        """
        mask = torch.as_tensor(list(slot_mask), dtype=torch.bool)
        if mask.shape != (batch,):
            raise ValueError(f"slot mask of {mask.shape[0]} lanes for a "
                             f"batch of {batch}")
        if state:
            device = next(iter(state.values())).device
            with torch.inference_mode():
                wipe_state_slots(state, mask.to(device),
                                 state_batch_axes(state,
                                                  self.paged is not None))
        with self._lock:
            self.slot_resets += 1
            pool = self._pool((batch, max_len))
            pool.slot_resets += 1
            pool.slots_wiped += int(mask.sum())
        return state

    def release(self, batch: int, max_len: int, state) -> None:
        if self.paged is not None:
            leaves = {k: v for k, v in state.items() if is_paged_state_key(k)}
            state = {k: v for k, v in state.items()
                     if not is_paged_state_key(k)}
            with self._lock:
                self._pool_leaves = leaves
                self._pool_out = False
        with self._lock:
            pool = self._pool((batch, max_len))
            pool.free.append(state)
            pool.in_use = max(0, pool.in_use - 1)

    def stats(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                f"{b}x{m}": {
                    "created": p.created,
                    "reused": p.reused,
                    "in_use": p.in_use,
                    "free": len(p.free),
                    "slot_resets": p.slot_resets,
                    "slots_wiped": p.slots_wiped,
                }
                for (b, m), p in sorted(self._pools.items())
            }
