"""Fault-tolerance utilities: failure injection and straggler detection
(a copy of the reference's ``repro.train.fault``).

On a real pod these hook into the preemption notice / health-check plane;
here the logic is exercised by unit tests and the fault-injection example
(a training job that is killed mid-run and resumes bit-exactly from the
latest checkpoint).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    """Raises InjectedFailure at the configured steps (once each)."""

    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker: flags steps slower than ``threshold`` x the
    moving average. On hardware this would trigger hot-spare swap /
    re-sharding; here it records events for the trainer log and tests."""

    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3
    ewma: Optional[float] = None
    events: List[dict] = dataclasses.field(default_factory=list)
    _n: int = 0

    def observe(self, step: int, dt: float) -> bool:
        self._n += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        is_straggler = (
            self._n > self.warmup and dt > self.threshold * self.ewma
        )
        if is_straggler:
            # "time" is a wall-clock EVENT TIMESTAMP (log correlation
            # only) — interval math must come in through ``dt``, which
            # the trainer measures with time.perf_counter(): wall-clock
            # deltas jump under NTP slew and once spoofed this monitor
            self.events.append(
                {"step": step, "dt": dt, "ewma": self.ewma, "time": time.time()}
            )
        # stragglers don't poison the average
        if not is_straggler:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler
