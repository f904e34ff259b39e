"""Per-phase timing.

Counterpart of `paillier_halo2_tpu/utils/trace.py:18` (`PhaseTimer` only;
the profiler wrapper `profile_section` is not ported). Instead of environment
switches, a timer records its marks in `marks` and prints them when built
with `echo=True`.
"""
from __future__ import annotations

import time


class PhaseTimer:
    """Per-section phase marker. `mark(label)` records the time since
    construction and the delta since the previous mark."""

    def __init__(self, section: str, echo: bool = False):
        self.section = section
        self.echo = echo
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
