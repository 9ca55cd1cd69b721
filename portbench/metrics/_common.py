"""Arithmetic the per-layer metrics share."""

from portbench.frozen import peaks
from portbench.harness.trace import kernel_seconds


def mfu(run, peak: str = "bf16"):
    """Model FLOPs of the work completed in the window over the window's
    time at the chip's peak, in %."""
    t = run.counters.get("elapsed_s")
    f = run.counters.get("model_flops")
    if not t or not f or t != t:
        return None
    return 100.0 * f / (t * peaks.PEAK[peak])


def idle_share(run):
    """The share of the traced window in which no device operation ran,
    in %."""
    if run.trace is None or not run.trace["window_s"]:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def roofline(run, pattern: str, bound_s: float):
    """``bound_s`` (the least time of every call the window made of the
    kernel whose device functions hold ``pattern``) over those functions'
    device time, in %; None where the trace holds none of them."""
    if run.trace is None:
        return None
    spent = kernel_seconds(run.trace, pattern)
    if spent <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / spent
