"""The share of the traced prefill window in which the card ran no
operation (profiler: the union of device entries' intervals)."""

from portbench.metrics._common import idle_share

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "prefill_tok_s"


def applies(cell: dict) -> bool:
    """Read in every prefill cell."""
    return cell["driver"] == "prefill"


def read(run):
    return idle_share(run)
