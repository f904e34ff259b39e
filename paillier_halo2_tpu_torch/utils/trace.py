"""Per-phase timing and profiler capture.

Counterpart of `paillier_halo2_tpu/utils/trace.py:18-73`. Arguments stand in
for the JAX package's environment switches: `PhaseTimer(echo=True)` for
PAILLIER_TPU_TRACE=1, `PhaseTimer(json_path=...)` for
PAILLIER_TPU_TRACE_JSON, `profile_section(name, dir)` for
PAILLIER_TPU_PROFILE. A timer also keeps its marks in `marks`.
"""
from __future__ import annotations

import json
import os
import time


class PhaseTimer:
    """Per-section phase marker. `mark(label)` records the time since
    construction and the delta since the previous mark; with `json_path` it
    also appends one JSON object per mark to that file, with the JAX
    package's keys (`section`, `phase`, `t_total_s`, `t_delta_s`, `ts`)."""

    def __init__(self, section: str, echo: bool = False, json_path: str | None = None):
        self.section = section
        self.echo = echo
        self.json_path = json_path
        self.t0 = time.monotonic()
        self._last = self.t0
        self.marks: list[tuple[str, float, float]] = []  # (label, total_s, delta_s)

    def mark(self, label: str) -> None:
        now = time.monotonic()
        total, delta = now - self.t0, now - self._last
        self._last = now
        self.marks.append((label, total, delta))
        if self.echo:
            print(f"[{self.section}] {label}: {total:.2f}s (+{delta:.2f}s)", flush=True)
        if self.json_path:
            with open(self.json_path, "a") as fh:
                fh.write(json.dumps({"section": self.section, "phase": label,
                                     "t_total_s": round(total, 4), "t_delta_s": round(delta, 4),
                                     "ts": time.time()}) + "\n")


class profile_section:
    """`torch.profiler` capture around a section: CPU activity, and CUDA
    activity where a card is present. On exit the trace is written as a
    Chrome trace to `dir/name/trace_<pid>_<ns>.json` (`path`). A no-op
    when `dir` is None."""

    def __init__(self, name: str, dir: str | None = None):
        self.name = name
        self.dir = dir
        self.path = None
        self._prof = None

    def __enter__(self):
        if self.dir:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            out_dir = os.path.join(self.dir, self.name)
            os.makedirs(out_dir, exist_ok=True)
            self.path = os.path.join(out_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
            self._prof.export_chrome_trace(self.path)
        return False
