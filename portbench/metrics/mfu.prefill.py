"""The prefill step's share of the chip's peak: model FLOPs of the
completed calls (2 N per token and the causal attention products,
``frozen/flops.py``) over the window's time at 989 TFLOP/s (bf16)."""

from portbench.metrics._common import mfu

LAYER = "model"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "prefill_tok_s"


def applies(cell: dict) -> bool:
    """Read in every prefill cell."""
    return cell["driver"] == "prefill"


def read(run):
    return mfu(run)
