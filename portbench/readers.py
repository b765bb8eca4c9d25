"""Arithmetic the metric readers share. Each reader in ``metrics/`` is
one small file; a reader that finds nothing to read returns None and
the harness leaves its metric out of the line."""

from __future__ import annotations

from typing import Optional


def stage_us_per_pod(run, stage: str) -> Optional[float]:
    """A scheduler stage's seconds in the window over the pods bound in
    it, in microseconds a pod."""
    pods = run.bound_in_window()
    if not pods:
        return None
    return run.stage_delta(stage) / pods * 1e6


def clipped_span_seconds(spans, name: str, intervals) -> float:
    """Seconds of the flight recorder's ``name`` spans that fall inside
    ``intervals`` ((start, end) in perf_counter seconds)."""
    total = 0.0
    for e in spans:
        if e["name"] != name:
            continue
        s, t = e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6
        for a, b in intervals:
            total += max(0.0, min(t, b) - max(s, a))
    return total


def roofline_share(records, device_seconds) -> Optional[float]:
    """The launches' least time over their device time, in percent.
    ``device_seconds`` are the kernel's runs from the capture's start, in
    order: the first ``len(records)`` of them are the captured launches
    (the profiler also holds those made after the capture stopped). A
    launch whose count could not be made (None) is left out, with its
    device time."""
    if not records or len(device_seconds) < len(records):
        return None
    pairs = [(r, s) for r, s in zip(records, device_seconds) if r is not None]
    busy = sum(s for _, s in pairs)
    if busy <= 0:
        return None
    return sum(r["least_s"] for r, _ in pairs) / busy * 100.0


def idle_share(run) -> Optional[float]:
    if run.device is None or run.device.window_s <= 0:
        return None
    w = run.device.window_s
    return (w - run.device.busy_s()) / w * 100.0
