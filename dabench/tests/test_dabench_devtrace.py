"""The trace reduction on hand-made profiler events."""

import pytest
from torch.autograd import DeviceType

from dabench import devtrace


class Ev:
    def __init__(self, name, start_us, dur_us, device=DeviceType.CUDA):
        self._n, self._s, self._d, self._t = name, int(start_us * 1e3), int(dur_us * 1e3), device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t


CPU = DeviceType.CPU


def _events():
    return [
        Ev(devtrace.WINDOW, 0, 100, CPU),
        Ev(devtrace.WINDOW, 0, 100),  # the annotation's device-side copy
        Ev("cudaStreamSynchronize", 35, 20, CPU),
        Ev("aten::add", 70, 25, CPU),
        Ev("void (anonymous namespace)::adder_graph_smem_kernel<4>(int const*)", 10, 20),
        Ev("elementwise_kernel", 25, 10),  # overlaps the one before
        Ev("Memcpy HtoD (Pinned -> Device)", 60, 10),
        Ev("elementwise_kernel", 95, 10),  # clipped to the window
        Ev("elementwise_kernel", 200, 10),  # outside
    ]


def test_busy_and_gaps():
    t = devtrace.reduce(_events())
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((25 + 10 + 5) * 1e-6)
    assert t.idle_by_host["cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert t.idle_by_host["aten::add"] == pytest.approx(25e-6)
    assert t.idle_by_host["host: no traced op"] == pytest.approx(10e-6)


def test_ops_by_kind():
    t = devtrace.reduce(_events())
    assert t.count(lambda k, n: k == "kernel") == 3
    assert t.count(lambda k, n: k == "memcpy") == 1
    assert t.op_seconds(lambda k, n: "adder_graph_" in n) == pytest.approx(20e-6)
    b = t.breakdown()
    assert b["device_ops"][0] == ["void (anonymous namespace)::adder_graph_smem_kernel<4>(int const*)",
                                  pytest.approx(20e-6)]
    assert len(b["idle_gaps"]) == 3


def test_nothing_to_read():
    assert devtrace.reduce([]) is None
    assert devtrace.reduce([Ev(devtrace.WINDOW, 0, 10, CPU), Ev("aten::add", 1, 2, CPU)]) is None
