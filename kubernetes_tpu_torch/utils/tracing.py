"""utiltrace-style step tracing.

Reference: vendored k8s.io/utils/trace/trace.go:55 -- an in-process span
log; Schedule wraps each cycle and logs any trace exceeding a threshold
with per-step timings (generic_scheduler.go:151-152). The apiserver wraps
REST handlers the same way (endpoints/handlers/get.go:52).

Device-side profiling is jax.profiler's job; this covers the host path.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

logger = logging.getLogger("trace")


class Trace:
    def __init__(self, name: str, **fields) -> None:
        self.name = name
        self.fields = fields
        self.start = time.perf_counter()
        self.steps: List[Tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self.steps.append((time.perf_counter(), msg))

    def total_seconds(self) -> float:
        return time.perf_counter() - self.start

    def log_if_long(self, threshold_seconds: float = 0.1) -> None:
        """trace.go LogIfLong: emit the step table when over threshold."""
        total = self.total_seconds()
        if total < threshold_seconds:
            return
        fields = ",".join(f"{k}={v}" for k, v in self.fields.items())
        lines = [f'Trace "{self.name}" ({fields}): total {total*1000:.1f}ms']
        prev = self.start
        for ts, msg in self.steps:
            lines.append(f"  step {((ts - prev) * 1000):.1f}ms: {msg}")
            prev = ts
        logger.info("\n".join(lines))
