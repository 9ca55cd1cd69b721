"""The device trace of a traced window, reduced to what metrics read.

``Tracer`` wraps the measured window in ``torch.profiler`` (host and
device activity) when tracing is on, and does nothing when it is off. Its
``summary()`` keeps only sums: the device's busy time (the union of every
device entry's interval: kernels, copies, sets), each device function's
total time and count, the longest idle gaps by the host operation that
ran during them, and the window's length on the host clock. No trace is
written to disk.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.window_s: Optional[float] = None
        self._summary: Optional[dict] = None

    def __enter__(self) -> "Tracer":
        import torch

        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                self._summary = summarize(self._prof.events(), self.window_s)
            self._prof = None

    def summary(self) -> Optional[dict]:
        return self._summary


def _merge(intervals: List[tuple]) -> List[list]:
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events, window_s: float, top: int = 10) -> dict:
    """Sums over the profiler's events (times in microseconds)."""
    from torch.autograd import DeviceType

    device, host = [], []
    kernels: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((start, end))
            k = kernels[e.name]
            k[0] += (end - start) / 1e6
            k[1] += 1
        elif e.cpu_parent is None:
            host.append((start, end, e.name))
    merged = _merge(device)
    busy_s = sum(e - s for s, e in merged) / 1e6
    host.sort()
    starts = [h[0] for h in host]
    idle: Dict[str, float] = collections.defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        label = "no host operation"
        last = bisect.bisect_right(starts, mid) - 1
        # the latest-starting top-level host operation that covers mid,
        # among the 64 that started last before it (one per thread)
        for i in range(last, max(last - 64, -1), -1):
            if host[i][1] >= mid:
                label = host[i][2]
                break
        idle[label] += (b - a) / 1e6
    ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "kernels": {k: {"seconds": v[0], "count": v[1]} for k, v in ops},
        "device_ops": [[k, v[0]] for k, v in ops[:top]],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def kernel_seconds(summary: dict, pattern: str) -> float:
    """Device seconds of every device function whose name holds
    ``pattern``."""
    return sum(v["seconds"] for k, v in summary["kernels"].items()
               if pattern in k)

