"""The flash kernel's share of its roofline in the prefill cells: the
least time of every launch of the window (``frozen/work.py`` at the H100
peaks; one causal self-attention per layer and call, B sequences of H
query and KV key-value heads over S positions) over the device time of
its device functions (``flash_kernel*``)."""

from portbench.frozen import peaks
from portbench.frozen.work import flash_work
from portbench.metrics._common import roofline

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "prefill_tok_s"


def applies(cell: dict) -> bool:
    """Read in every prefill cell."""
    return cell["driver"] == "prefill"


def read(run):
    n = run.counters.get("launches.flash_attention", 0)
    if not n:
        return None
    c, t = run.cfg, run.traffic
    w = flash_work(t["batch"], c["num_attention_heads"],
                   c["num_key_value_heads"], t["seq"], t["seq"],
                   c["head_dim"], "bf16", causal=True)
    return roofline(run, "flash_kernel", n * peaks.bound_s(*w))
