"""The traced slice's reading from profiler events."""
from __future__ import annotations

import pytest
import torch

from rtbench import trace


class Event:
    def __init__(self, name, on_device, start, dur, tid=1):
        self._name, self._dev, self._start, self._dur = (name, on_device,
                                                         start, dur)
        self._tid = tid

    def name(self):
        return self._name

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._dev
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def start_thread_id(self):
        return self._tid


def test_busy_launches_and_gaps():
    events = [
        Event(trace.STEP, False, 0, 1000), Event(trace.STEP, True, 0, 1000),
        Event("pathtrace.path_trace", False, 5, 900),
        Event("pathtrace.path_trace", True, 5, 900),
        Event("cudaLaunchKernel", False, 10, 5),
        Event("cuLaunchKernel", False, 11, 2),    # inside the runtime call
        Event("cuLaunchKernel", False, 300, 2),   # a driver launch alone
        Event("k1", True, 20, 100), Event("Memcpy DtoH", True, 130, 10),
        Event("aten::sum", False, 150, 100), Event("k2", True, 400, 50)]
    r = trace.read(events)
    assert r["kernels"] == 2 and r["launch_calls"] == 2
    assert r["busy_s"] == pytest.approx(160e-9)
    assert r["window_s"] == pytest.approx(1000e-9)
    assert [n for n, _ in r["device_ops"]] == ["k1", "k2", "Memcpy DtoH"]
    # Gaps 120-130 and 140-400, both inside path_trace and outside
    # aten::sum at their middles.
    [(label, idle)] = r["idle_gaps"]
    assert label == "pathtrace.path_trace" and idle == pytest.approx(270e-9)
