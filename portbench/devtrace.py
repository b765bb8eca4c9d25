"""The device's side of a traced window, from ``torch.profiler``.

The profiler's CUDA activity (CUPTI) records every kernel, copy and set
the card ran, whoever launched it: K1 and K2 come from libraries loaded
with ctypes, not from torch operations. From those records this module
takes the busy intervals, the kernels' times by name, each launch of a
named kernel in order, and the idle gaps of the window.

The profiler's clock is the host's wall clock in nanoseconds; the
offset to ``time.perf_counter`` (the clock of the flight recorder's
spans) is read when the window opens.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class DeviceWindow:
    """What the card did between ``t0`` and ``t1`` (perf_counter s)."""

    t0: float
    t1: float
    #: (name, start, end) in perf_counter seconds, kernels and copies alike
    ops: List[Tuple[str, float, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device's operations, clipped to the window."""
        spans = sorted(
            (max(s, self.t0), min(e, self.t1)) for _, s, e in self.ops
            if e > self.t0 and s < self.t1
        )
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps = []
        cursor = self.t0
        for s, e in self.busy_intervals():
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < self.t1:
            gaps.append((cursor, self.t1))
        return gaps

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e in self.ops:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def launches(self, needle: str, after: float = 0.0) -> List[float]:
        """Device seconds of each operation whose name holds ``needle`` and
        that started after ``after`` (perf_counter s), in the order they
        ran."""
        return [e - s for name, s, e in sorted(self.ops, key=lambda o: o[1])
                if needle in name and s >= after]


class DeviceTrace:
    """A ``torch.profiler`` session over the measured window."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._offset_ns: Optional[int] = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        self._prof.start()
        self._offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()

    def stop(self) -> DeviceWindow:
        self._torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.stop()
        window = DeviceWindow(self.t0, self.t1)
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != self._torch.autograd.DeviceType.CUDA:
                continue
            start = (ev.start_ns() - self._offset_ns) / 1e9
            window.ops.append(
                (ev.name(), start, start + ev.duration_ns() / 1e9))
        return window
