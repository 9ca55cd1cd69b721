"""One run of one cell: the driver's set-up, window and check, then the
result line.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics
(its driver's, and ``setup_s``); with ``--trace 1`` its per-layer
metrics, read from the traced window by ``metrics/<name>.py``. The
numbers compared with the reference go last, under ``checks``, each with
its limit.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench.harness import cells

# whole top-level module names that no run may hold once its window has
# closed: JAX and the JAX package the port was made from
BANNED_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""

    bench: Path
    name: str
    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"


@dataclasses.dataclass
class Check:
    """A number compared with the reference; passes at or under its
    limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    metrics: Dict[str, Tuple[float, str]]   # end-to-end: name -> (value, unit)
    attempted: int
    failed: int
    checks: List[Check]
    window_start: float                     # time.perf_counter()
    window_s: float
    memory_peak_bytes: int
    trace: Optional[dict] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunView:
    """What a per-layer metric reads."""

    name: str
    cell: dict
    cfg: dict
    traffic: dict
    window_s: float
    trace: Optional[dict]
    counters: Dict[str, float]
    metrics: Dict[str, Tuple[float, str]]


def banned_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED_MODULES)


def _number(x):
    """A JSON number, or null for what no run measured (NaN)."""
    x = float(x)
    return x if math.isfinite(x) else None


def device_info(device: str, peak: int) -> dict:
    if device == "cuda":
        import torch

        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def execute(bench: Path, name: str, seed: int, seconds: float, trace: bool,
            t0: float, device: str = "cuda") -> Tuple[dict, List[str]]:
    """Run the cell ``name``; returns the result line as a dict (keys in
    print order, ``checks`` last) and the check lines for stderr. ``t0``
    is the process's start on ``time.perf_counter``."""
    cell = cells.workload(name, bench)
    ctx = Ctx(bench, name, cell, cells.config(cell["config"], bench),
              cells.traffic(cell["traffic"], bench), seed, seconds, trace,
              device)
    out: Outcome = cells.driver(cell["driver"], bench).run(ctx)
    if trace:
        metrics = {}
        view = RunView(name, cell, ctx.cfg, ctx.traffic, out.window_s, out.trace,
                       out.counters, out.metrics)
        for mname, mod in cells.metrics_for(name, bench).items():
            value = mod.read(view)
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
    else:
        metrics = {"setup_s": {"value": out.window_start - t0, "unit": "s"}}
        for mname, (value, unit) in out.metrics.items():
            metrics[mname] = {"value": value, "unit": unit}
    failed = out.failed
    correct = failed == 0 and out.attempted > 0 and all(
        c.ok for c in out.checks) and bool(out.checks)
    line = {"correct": correct, "attempted": out.attempted,
            "failed": failed, "metrics": metrics,
            "device": device_info(device, out.memory_peak_bytes)}
    if trace and out.trace is not None:
        line["device"]["busy_s"] = out.trace["busy_s"]
        line["device"]["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit}
                      for c in out.checks}
    for m in line["metrics"].values():
        m["value"] = _number(m["value"])
    lines = [f"correct {correct}: attempted {out.attempted}, "
             f"failed {failed}"]
    lines += [f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}" for c in out.checks]
    return line, lines


class Window:
    """The measured window: ``open`` while now is before its end."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.start = time.perf_counter()
        self.end = self.start + seconds

    @property
    def open(self) -> bool:
        return time.perf_counter() < self.end
