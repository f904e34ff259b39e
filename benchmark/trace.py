"""The benchmark's spans and its one profiler session.

`HostPhases` names what the host is doing: `span(label)` around a layer
call and `mark(label)`, which the prover calls at the end of each of its
phases when it is passed as `create_proof(timer=)`. Outside a profiled
stretch both cost one attribute test. Inside it they become
`torch.profiler.record_function` ranges, so they land on the profiler's
own clock beside the device's kernels.

`profiled(run_steps)` opens one `torch.profiler` session (CPU and CUDA
activity) over a bounded number of steps and reduces it in memory:
device time by kernel, launches, the union of device activity, and the
idle gaps named by the host phase they fall in. No trace file is written.
"""
from __future__ import annotations

import bisect
import contextlib

PREFIX = "bench:"


class HostPhases:
    def __init__(self):
        self.recording = False

    @contextlib.contextmanager
    def span(self, label: str):
        if not self.recording:
            yield
            return
        from torch.profiler import record_function

        with record_function(f"{PREFIX}span:{label}"):
            yield

    def mark(self, label: str) -> None:
        if self.recording:
            from torch.profiler import record_function

            with record_function(f"{PREFIX}mark:{label}"):
                pass


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _phase_at(t: int, spans, marks) -> str:
    """The host phase at time t: the innermost benchmark span, and inside a
    prover span the prover phase that ends at the next mark."""
    inner = None
    for s, e, name in spans:
        if s <= t <= e and (inner is None or s >= inner[0]):
            inner = (s, e, name)
    if inner is None:
        return "between steps"
    s, e, name = inner
    nxt = [m for m in marks if s <= m[0] <= e and m[0] >= t]
    if nxt:
        return f"{name}: until {min(nxt)[1]}"
    before = [m for m in marks if s <= m[0] < t]
    return f"{name}: after {max(before)[1]}" if before else name


def reduce_events(events, steps: int) -> dict:
    """The profiled stretch as numbers: `window_s`, `busy_s`, `kernel_s`
    (summed kernel time), `launches`, `steps`, `device_ops` and
    `idle_gaps` (the ten largest, in seconds)."""
    window = None
    spans, marks, device, kernels = [], [], [], {}
    launches = 0
    for ev in events:
        name = ev.name()
        on_device = str(ev.device_type()).endswith("CUDA")
        if on_device and name.startswith(PREFIX):  # a host range's shadow on the device row
            continue
        if on_device:
            s = ev.start_ns()
            e = s + ev.duration_ns()
            device.append((s, e))
            if not name.startswith(("Memcpy", "Memset")):
                launches += 1
                kernels[name] = kernels.get(name, 0) + (e - s)
            continue
        if not name.startswith(PREFIX):
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        tag = name[len(PREFIX):]
        if tag == "profiled":
            window = (s, e)
        elif tag.startswith("span:"):
            spans.append((s, e, tag[5:]))
        elif tag.startswith("mark:"):
            marks.append((s, tag[5:]))
    if window is None:
        raise RuntimeError("the profiled stretch left no range in the trace")
    w0, w1 = window
    busy = _union((max(s, w0), min(e, w1)) for s, e in device if e > w0 and s < w1)
    # each idle gap, cut where a host phase begins or ends, is charged to
    # the phase at the middle of each piece
    cuts = sorted({t for s, e, _ in spans for t in (s, e)} | {t for t, _ in marks})
    gaps: dict[str, int] = {}
    cursor = w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            edges = [cursor] + cuts[bisect.bisect_right(cuts, cursor):bisect.bisect_left(cuts, s)] + [s]
            for g0, g1 in zip(edges, edges[1:]):
                label = _phase_at((g0 + g1) // 2, spans, marks)
                gaps[label] = gaps.get(label, 0) + (g1 - g0)
        cursor = max(cursor, e)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {
        "steps": steps,
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernel_s": sum(kernels.values()) / 1e9,
        "launches": launches,
        "device_ops": [[n[:160], t / 1e9] for n, t in top],
        "idle_gaps": [[n[:160], t / 1e9] for n, t in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def profiled(run_steps, steps: int, phases: HostPhases) -> dict:
    """Run `run_steps()` (which makes `steps` steps and synchronizes) under
    one profiler session and reduce it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        phases.recording = True
        try:
            with record_function(f"{PREFIX}profiled"):
                run_steps()
                torch.cuda.synchronize()
        finally:
            phases.recording = False
    return reduce_events(prof.profiler.kineto_results.events(), steps)
