"""Lightweight wall-clock timeline for the burst hot path.

Enabled with KTPU_TIMELINE=1: hot-path stages call ``mark(name)`` /
``span(name)`` and the bench dumps a per-stage summary at exit. Zero
overhead when disabled (marks compile to a no-op lambda).

This is the in-window view the cProfile dump can't give: cumulative
profiles mix setup (5k node creation, warmup compiles) with the measured
window, and thread wait-time attribution drowns the real CPU costs.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, Tuple

ENABLED = os.environ.get("KTPU_TIMELINE") == "1"

#: bounded: a long-lived process with KTPU_TIMELINE=1 must not grow
#: memory monotonically; the bench window is far smaller than this
_events: "deque" = deque(maxlen=500_000)  # (t, name, dur)
_lock = threading.Lock()


if ENABLED:

    def mark(name: str, dur: float = 0.0) -> None:
        with _lock:
            _events.append((time.perf_counter(), name, dur))

else:

    def mark(name: str, dur: float = 0.0) -> None:  # type: ignore[misc]
        pass


class span:
    """Context manager recording the duration of one stage."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if ENABLED:
            mark(self.name, time.perf_counter() - self.t0)


def reset() -> None:
    with _lock:
        _events.clear()


def summary() -> Dict[str, Tuple[int, float]]:
    """name -> (count, total_seconds) for spans; marks have dur 0."""
    out: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    with _lock:
        for _, name, dur in _events:
            rec = out[name]
            rec[0] += 1
            rec[1] += dur
    return {k: (int(v[0]), v[1]) for k, v in out.items()}


def dump(t_origin: float = 0.0) -> str:
    lines = []
    with _lock:
        for t, name, dur in sorted(_events):
            lines.append(
                f"{(t - t_origin) * 1000:9.1f}ms  {name:32s} "
                f"{dur * 1000:8.2f}ms"
            )
    return "\n".join(lines)
