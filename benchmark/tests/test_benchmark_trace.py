"""The profiler's reduction on made-up events: device busy time, kernel
time, launches and idle gaps named by the host phase."""
from __future__ import annotations

from benchmark.trace import PREFIX, reduce_events


class Ev:
    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._t = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType." + self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def test_reduce_events():
    evs = [
        Ev(PREFIX + "profiled", "CPU", 0, 1000),
        Ev(PREFIX + "span:synthesis", "CPU", 0, 400),
        Ev(PREFIX + "span:create_proof", "CPU", 400, 600),
        Ev(PREFIX + "span:create_proof", "CUDA", 400, 600),  # the range's shadow on the device row
        Ev(PREFIX + "mark:advice committed", "CPU", 700, 0),
        Ev("k1", "CUDA", 500, 100),
        Ev("k1", "CUDA", 550, 100),
        Ev("Memcpy HtoD", "CUDA", 800, 50),
        Ev("aten::add", "CPU", 500, 10),
    ]
    r = reduce_events(evs, 2)
    assert r["window_s"] == 1e-6 and r["steps"] == 2
    assert r["busy_s"] == 200e-9 and r["kernel_s"] == 200e-9 and r["launches"] == 2
    gaps = dict(r["idle_gaps"])
    assert gaps["synthesis"] == 400e-9
    assert gaps["create_proof: until advice committed"] == 150e-9
    assert gaps["create_proof: after advice committed"] == 250e-9
    assert r["device_ops"] == [["k1", 200e-9]]
