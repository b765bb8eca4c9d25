"""Arrival processes: seeded trace generators + the paced ArrivalEngine.

A *trace* is a sorted float64 array of arrival offsets (seconds from the
trace start). Generators are deterministic in their seed -- the same
``(kind, params, seed)`` tuple always produces the same trace, so an
open-loop run is replayable and two policies compared on "the same
trace" really see identical arrival instants (the trace seed rides in
every record).

The ``ArrivalEngine`` replays a trace against a live apiserver on its
own thread: pods whose offset has come due are created in bounded bulk
chunks, and each pod's ``created_ts`` is stamped with the wall clock at
the moment of the create call -- pod-to-bind latency is measured
end-to-end from the arrival process, not per-drain.

Backpressure is explicit: with ``max_queue_depth`` set, the engine
checks the scheduler-side depth gauge (normally
``queue.active_count``) before every chunk and STALLS -- counted in
``backpressure_stalls``/``stall_seconds`` and the
``scheduler_arrival_backpressure_stalls_total`` metric -- until the
queue drains below the resume watermark, instead of growing the activeQ
heap without bound. A stalled engine is the honest open-loop signal
that the offered rate exceeded capacity: a stall is an SLO failure at
that rate.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from kubernetes_tpu_torch.utils import flightrecorder, metrics

#: pods created per bulk API call when a burst of offsets is due at once
#: (matches the chunked ingest the closed-loop bench uses)
CREATE_CHUNK = 256


def poisson_trace(
    rate: float, duration: float, seed: int = 0
) -> np.ndarray:
    """Homogeneous Poisson arrivals at ``rate`` pods/s for ``duration``
    seconds: i.i.d. exponential inter-arrival gaps, cumulatively
    summed."""
    if rate <= 0 or duration <= 0:
        return np.empty(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    t = 0.0
    # draw in slabs until the horizon is covered (vectorized; the tail
    # slab overshoots and is trimmed)
    while t < duration:
        n = max(64, int(rate * (duration - t) * 1.2) + 32)
        gaps = rng.exponential(1.0 / rate, size=n)
        offs = t + np.cumsum(gaps)
        out.append(offs)
        t = float(offs[-1])
    offsets = np.concatenate(out)
    return offsets[offsets < duration]


def bursty_trace(
    base_rate: float,
    burst_rate: float,
    duration: float,
    seed: int = 0,
    base_dwell: float = 8.0,
    burst_dwell: float = 2.0,
) -> np.ndarray:
    """Two-state MMPP (Markov-modulated Poisson process): exponential
    dwell times alternate a ``base_rate`` state with a ``burst_rate``
    state -- the flash-crowd shape a static batch window can't serve
    well at both ends."""
    if duration <= 0:
        return np.empty(0, dtype=np.float64)
    rng = np.random.default_rng(seed)
    out: List[np.ndarray] = []
    t = 0.0
    in_burst = False
    while t < duration:
        rate = burst_rate if in_burst else base_rate
        dwell = rng.exponential(burst_dwell if in_burst else base_dwell)
        end = min(duration, t + dwell)
        if rate > 0:
            seg = t + np.cumsum(
                rng.exponential(
                    1.0 / rate, size=max(16, int(rate * dwell * 1.2) + 16)
                )
            )
            out.append(seg[seg < end])
        t = end
        in_burst = not in_burst
    if not out:
        return np.empty(0, dtype=np.float64)
    return np.concatenate(out)


def diurnal_trace(
    peak_rate: float,
    duration: float,
    seed: int = 0,
    period: float = 60.0,
    trough_fraction: float = 0.2,
) -> np.ndarray:
    """Non-homogeneous Poisson with a raised-cosine rate ramp between
    ``trough_fraction * peak_rate`` and ``peak_rate`` over ``period``
    seconds (the compressed day/night cycle), sampled by thinning
    against the peak rate."""
    if peak_rate <= 0 or duration <= 0:
        return np.empty(0, dtype=np.float64)
    candidates = poisson_trace(peak_rate, duration, seed)
    if candidates.size == 0:
        return candidates
    rng = np.random.default_rng(seed + 1)
    trough = trough_fraction * peak_rate
    # rate(t) peaks mid-period: trough + (peak-trough) * (1-cos)/2
    lam = trough + (peak_rate - trough) * 0.5 * (
        1.0 - np.cos(2.0 * np.pi * candidates / period)
    )
    keep = rng.random(candidates.size) < lam / peak_rate
    return candidates[keep]


def replay_trace(path: str) -> np.ndarray:
    """Load a recorded trace: a JSON list of offsets, or an object with
    an ``offsets`` key (the shape ``save_trace`` writes)."""
    with open(path) as f:
        raw = json.load(f)
    offsets = raw["offsets"] if isinstance(raw, dict) else raw
    return np.sort(np.asarray(offsets, dtype=np.float64))


def save_trace(path: str, offsets: np.ndarray, **meta) -> None:
    """Persist a trace for replay; extra keys ride alongside so a
    recorded production trace can carry its provenance."""
    with open(path, "w") as f:
        json.dump({"offsets": [float(x) for x in offsets], **meta}, f)


def load_trace(
    kind: str,
    rate: float,
    duration: float,
    seed: int = 0,
    *,
    burst_rate: float = 0.0,
    base_dwell: float = 8.0,
    burst_dwell: float = 2.0,
    period: float = 60.0,
    trough_fraction: float = 0.2,
    replay_path: str = "",
) -> np.ndarray:
    """Dispatch on trace ``kind`` -- the single entry point the config
    wiring and the drivers share."""
    if kind == "poisson":
        return poisson_trace(rate, duration, seed)
    if kind == "bursty":
        return bursty_trace(
            rate, burst_rate or 4.0 * rate, duration, seed,
            base_dwell=base_dwell, burst_dwell=burst_dwell,
        )
    if kind == "diurnal":
        return diurnal_trace(
            rate, duration, seed,
            period=period, trough_fraction=trough_fraction,
        )
    if kind == "replay":
        if not replay_path:
            raise ValueError("trace kind 'replay' needs replay_path")
        return replay_trace(replay_path)
    raise ValueError(
        f"unknown trace kind {kind!r} "
        f"(poisson|bursty|diurnal|replay)"
    )


def trace_from_config(st, duration: Optional[float] = None) -> np.ndarray:
    """Build a trace from a ``StreamingConfiguration`` (the
    ``streaming:`` block's trace half): kind, rate, seed, and the
    per-kind shape knobs. ``duration`` overrides
    ``st.duration_seconds`` (the perf-matrix runner sizes it to the
    workload's pod count)."""
    return load_trace(
        st.trace,
        st.rate_pods_per_sec,
        st.duration_seconds if duration is None else duration,
        st.seed,
        burst_rate=st.burst_rate_pods_per_sec,
        base_dwell=st.base_dwell_seconds,
        burst_dwell=st.burst_dwell_seconds,
        period=st.period_seconds,
        trough_fraction=st.trough_fraction,
        replay_path=st.replay_path,
    )


class ArrivalEngine:
    """Replay a trace of arrival offsets against the apiserver on a
    paced daemon thread.

    ``pod_factory(i)`` builds the i-th pod (the caller owns naming and
    shape -- priority bands, workload specs). ``depth_fn`` +
    ``max_queue_depth`` form the backpressure gate; ``created_ts``
    maps pod name -> ``time.perf_counter()`` at the create call."""

    def __init__(
        self,
        client,
        offsets: np.ndarray,
        pod_factory: Callable[[int], object],
        *,
        depth_fn: Optional[Callable[[], int]] = None,
        max_queue_depth: int = 0,
        resume_fraction: float = 0.8,
        poll_interval: float = 0.005,
    ) -> None:
        self._client = client
        self._offsets = np.asarray(offsets, dtype=np.float64)
        self._factory = pod_factory
        self._depth_fn = depth_fn
        self._max_depth = int(max_queue_depth)
        self._resume_depth = int(max_queue_depth * resume_fraction)
        self._poll = poll_interval
        self.created_ts: Dict[str, float] = {}
        self.created = 0
        self.backpressure_stalls = 0
        self.stall_seconds = 0.0
        self._stop = threading.Event()
        self.done = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="arrival-engine", daemon=True
        )

    def start(self) -> "ArrivalEngine":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def join(self, timeout: Optional[float] = None) -> bool:
        return self.done.wait(timeout)

    # -- internals -----------------------------------------------------------

    def _gate(self) -> None:
        """Backpressure: block while the scheduler-side queue depth sits
        at or above the bound; resume below the low watermark so the
        gate doesn't chatter at the boundary."""
        if not self._max_depth or self._depth_fn is None:
            return
        if self._depth_fn() < self._max_depth:
            return
        self.backpressure_stalls += 1
        metrics.backpressure_stalls.inc()
        t0 = time.perf_counter()
        while not self._stop.is_set():
            if self._depth_fn() <= self._resume_depth:
                break
            self._stop.wait(self._poll)
        stalled = time.perf_counter() - t0
        self.stall_seconds += stalled
        metrics.backpressure_stall_seconds.inc(stalled)
        flightrecorder.mark(
            "arrival_stall", seconds=round(stalled, 4),
            stalls=self.backpressure_stalls,
        )
        # the --trace timeline gets the stall as a span on the
        # arrival-engine track (a stalled engine means the offered rate
        # did not actually enter the system -- that must be visible
        # next to the solve spans it starves)
        flightrecorder.trace_span(
            "backpressure_stall", t0, stalled, track="arrival-engine",
        )

    def _run(self) -> None:
        offsets = self._offsets
        n = offsets.size
        base = time.perf_counter()
        i = 0
        try:
            while i < n and not self._stop.is_set():
                now = time.perf_counter() - base
                due = offsets[i]
                if now < due:
                    self._stop.wait(min(due - now, 0.05))
                    continue
                self._gate()
                if self._stop.is_set():
                    return
                # everything due by the post-gate clock goes out in
                # bounded bulk chunks (a stall releases as one burst --
                # exactly what the backlog it waited out looks like)
                now = time.perf_counter() - base
                j = i
                while (
                    j < n and offsets[j] <= now and j - i < CREATE_CHUNK
                ):
                    j += 1
                pods = [self._factory(k) for k in range(i, j)]
                ts = time.perf_counter()
                for p in pods:
                    self.created_ts[p.metadata.name] = ts
                self._client.create_pods_bulk(pods)
                self.created += len(pods)
                i = j
        finally:
            self.done.set()
