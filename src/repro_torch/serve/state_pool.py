"""Per-bucket resident decode-state pools (the dense KV cache).

Allocating a KV cache per request group costs an allocation of the
largest tensors of the serving path; the pool instead keeps states
resident per bucket and zeroes them in place on reuse.

    state = pool.acquire(batch, max_len)    # zeroed, on the plan's device
    ... the prefill and decode steps write it in place ...
    pool.release(batch, max_len, state)
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Sequence, Tuple

import torch

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

    def __init__(self, plan):
        self.plan = plan
        self._lock = threading.Lock()
        self._pools: Dict[BucketShape, _BucketPool] = {}
        self.slot_resets = 0

    def _pool(self, bucket: BucketShape) -> _BucketPool:
        if bucket not in self._pools:
            self._pools[bucket] = _BucketPool(free=[])
        return self._pools[bucket]

    def acquire(self, batch: int, max_len: int) -> Dict[str, torch.Tensor]:
        """A zeroed state for the bucket, reusing released buffers."""
        with self._lock:
            pool = self._pool((batch, max_len))
            state = pool.free.pop() if pool.free else None
            if state is None:
                pool.created += 1
            else:
                pool.reused += 1
            pool.in_use += 1
        if state is None:
            return self.plan.fresh_decode_state(batch, max_len)
        with torch.inference_mode():
            for leaf in state.values():
                leaf.zero_()
        return state

    def reset_slots(self, batch: int, max_len: int,
                    state: Dict[str, torch.Tensor],
                    slot_mask: Sequence[bool]) -> Dict[str, torch.Tensor]:
        """Zero the masked batch lanes (axis 1 of every [L, B, ...] leaf)
        of a live state, in place."""
        mask = torch.as_tensor(list(slot_mask), dtype=torch.bool)
        if mask.shape != (batch,):
            raise ValueError(f"slot mask of {mask.shape[0]} lanes for a "
                             f"batch of {batch}")
        with torch.inference_mode():
            for leaf in state.values():
                leaf[:, mask.to(leaf.device)] = 0
        with self._lock:
            self.slot_resets += 1
            pool = self._pool((batch, max_len))
            pool.slot_resets += 1
            pool.slots_wiped += int(mask.sum())
        return state

    def release(self, batch: int, max_len: int, state) -> None:
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
