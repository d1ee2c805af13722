"""The reduction of profiler traces to busy time, range device time and idle
gaps, on traces made up by hand."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import tracing


class Event:
    def __init__(self, name, device, start, end, corr=0):
        self._v = (name, device, start, end - start, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


def trace(*events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_busy_is_the_union_over_first_to_last_activity():
    got = tracing.busy(trace(Event("k1", GPU, 100, 110), Event("k2", GPU, 105, 120),
                             Event("k3", GPU, 130, 140), Event("cudaLaunchKernel", CPU, 0, 5),
                             Event("request", GPU, 90, 150)))
    assert got["busy_s"] == pytest.approx(30e-9)
    assert got["window_s"] == pytest.approx(40e-9)


def test_busy_without_device_activity_fails():
    with pytest.raises(RuntimeError):
        tracing.busy(trace(Event("aten::mm", CPU, 0, 10)))


def test_reduce_ranges_and_gaps():
    got = tracing.reduce(trace(
        Event("request", CPU, 0, 100),
        Event("flash_attention", CPU, 10, 20),
        Event("cudaLaunchKernel", CPU, 15, 16, corr=7),
        Event("cudaLaunchKernel", CPU, 25, 26, corr=8),
        Event("flash_fwd", GPU, 30, 50, corr=7),
        Event("gemm", GPU, 60, 70, corr=8),
        Event("gemm", GPU, 120, 130, corr=9)), "request", ("flash_attention",))
    assert got["window_s"] == pytest.approx(100e-9)
    assert got["busy_s"] == pytest.approx(30e-9)
    assert got["range_device_s"] == {"flash_attention": pytest.approx(20e-9)}
    assert dict(got["device_ops"]) == {"flash_fwd": pytest.approx(20e-9),
                                       "gemm": pytest.approx(10e-9)}
    assert dict(got["idle_gaps"]) == {"request (3 gaps)": pytest.approx(70e-9)}
