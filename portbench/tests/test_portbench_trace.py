"""The trace's reduction: busy time is the union of device intervals, and
each idle gap is put down to the host operation running through it."""

from types import SimpleNamespace

from torch.autograd import DeviceType

from portbench.harness.trace import kernel_seconds, summarize


def event(name, start, end, device):
    return SimpleNamespace(
        name=name, cpu_parent=None,
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        time_range=SimpleNamespace(start=start, end=end))


def test_busy_time_and_gaps():
    events = [event("k1", 0, 10, True), event("k2", 20, 30, True),
              event("k1", 25, 40, True), event("aten::mm", 5, 25, False),
              event("k3", 100, 110, True), event("sync", 40, 120, False)]
    s = summarize(events, 2.0)
    assert s["busy_s"] == 40e-6 and s["window_s"] == 2.0
    assert s["kernels"]["k1"] == {"seconds": 25e-6, "count": 2}
    assert s["idle_gaps"] == [["sync", 60e-6], ["aten::mm", 10e-6]]
    assert s["device_ops"][0] == ["k1", 25e-6]
    assert kernel_seconds(s, "k") == 45e-6
