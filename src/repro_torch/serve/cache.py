"""Cache of bound step functions for the serving layer.

The unit of reuse is a step function bound to its shapes by a builder
from ``repro_torch.launch.steps``. Nothing is traced or compiled (the steps
run eagerly), but the plan still routes every step through one cache
keyed by everything that changes the program:

    (arch, kind, batch, max_len, prefill_len, mode, mesh signature,
     quantized, stages, qsig, steps, paged, spec, on_mesh)

so the ``hits`` / ``misses`` / ``builds`` counters show that a warm
bucket performs zero new builds, as in the reference, where the same
counters counted XLA lowerings and compiles.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Tuple

from repro_torch.dist.sharding import mesh_axis_sizes


@dataclasses.dataclass(frozen=True)
class CacheKey:
    """Identity of one step function.

    The fields are the reference's, and ``on_mesh``. ``mesh_axes`` holds
    the plan's mesh signature (``(("data", 1), ("model", 1))``) and
    ``stages`` its pipeline stages; ``steps`` is the masked micro-run's
    length, ``paged`` its ``(page_count, page_size)`` and ``spec`` its
    ``(spec_k, draft_layers)``. ``on_mesh`` marks a train step bound to
    the plan's mesh, which the port's plan builds only while its model is
    placed there (the reference fixes the mesh when the plan is built and
    needs no such field). A step binds shapes only, not a device, so plans
    on two devices may share an entry.
    """

    arch: str
    kind: str                      # "decode" | "prefill" | "masked_decode"
    batch: int
    max_len: int
    prefill_len: int
    mode: str
    mesh_axes: Tuple[Tuple[str, int], ...]
    quantized: bool = False
    stages: int = 1
    qsig: Tuple[Tuple[Any, ...], ...] = ()
    steps: int = 1
    paged: Tuple[int, ...] = ()
    spec: Tuple[int, ...] = ()
    on_mesh: bool = False

    @staticmethod
    def mesh_signature(mesh) -> Tuple[Tuple[str, int], ...]:
        """``(axis, size)`` pairs of a mesh, a duck-typed mesh or a
        ``{axis: size}`` mapping."""
        return tuple(mesh_axis_sizes(mesh).items())


@dataclasses.dataclass
class CachedExecutable:
    """A built step function and what building it cost."""

    key: CacheKey
    fn: Callable[..., Any]
    build_seconds: float


class ExecutableCache:
    """Thread-safe map CacheKey -> CachedExecutable with reuse counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[CacheKey, CachedExecutable] = {}
        self.hits = 0
        self.misses = 0
        self.builds = 0
        self.build_seconds = 0.0

    def get_or_build(self, key: CacheKey,
                     build: Callable[[], Callable[..., Any]]
                     ) -> CachedExecutable:
        """Return the step for ``key``, building it on first use. Building
        binds shapes only, so it runs under the lock."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self.hits += 1
                return entry
            self.misses += 1
            t0 = time.perf_counter()
            fn = build()
            dt = time.perf_counter() - t0
            entry = CachedExecutable(key, fn, dt)
            self.builds += 1
            self.build_seconds += dt
            self._entries[key] = entry
            return entry

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "builds": self.builds,
            "build_seconds": round(self.build_seconds, 6),
        }
