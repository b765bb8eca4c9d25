"""Cyclic-GC tuning for the scheduling hot path.

A synced control plane holds a large, long-lived object graph (nodes,
cached pods, informer stores). Scheduling bursts allocate heavily, and
CPython's generational collector rescans that whole graph every few
hundred net allocations: measured ~1.2s of GC pause across ~1500
collections during one 10k-pod burst (roughly 2x wall clock). Freezing
the steady-state graph into the permanent generation and stretching the
thresholds removes those rescans -- the standard long-lived-graph
mitigation for CPython services.
"""

from __future__ import annotations

import gc
import threading
from typing import Optional
import time as _time

from kubernetes_tpu_torch.utils import flightrecorder, metrics


def freeze_steady_state_graph(
    gen0: int = 100_000, gen1: int = 50, gen2: int = 50
) -> None:
    """Call once the long-lived state is built (after informer sync /
    before the measured burst)."""
    gc.collect()
    gc.freeze()
    gc.set_threshold(gen0, gen1, gen2)


class GCBatchGuard:
    """Collect-at-idle policy for the batch dispatcher.

    Even with the steady-state graph frozen and thresholds stretched, a
    10k-pod burst allocates enough (clones, watch events, queue entries,
    solver bookkeeping) to trigger several young-generation collections
    INSIDE the measured window; each scans the whole unfrozen young set
    (measured ~7us/pod of the commit path -- 4x the actual object work).
    The scheduler knows its own idle points (queue drained, nothing in
    flight), so cyclic collection is disabled while batches are being
    scheduled and runs once at the active->idle transition. Plain
    refcounting still reclaims the (acyclic) burst garbage immediately;
    the deferred pass only exists to catch stray cycles (tracebacks,
    closures)."""

    #: under SUSTAINED load (the queue never drains) a bounded young-
    #: generation collect runs at most this often, so stray cycles from a
    #: long active phase cannot grow RSS without bound
    ACTIVE_COLLECT_INTERVAL_S = 10.0
    #: every Nth in-flight collect runs the FULL collector: gen-1-only
    #: passes promote surviving cycles to gen 2, which would otherwise
    #: wait for an idle transition that sustained load never reaches
    FULL_COLLECT_EVERY = 6

    def __init__(self) -> None:
        self._active = False
        self._last_collect = 0.0
        self._active_collects = 0

    def active(self) -> None:
        if not self._active:
            gc.disable()
            self._active = True
            self._last_collect = _time.monotonic()
            self._active_collects = 0
            return
        now = _time.monotonic()
        if now - self._last_collect >= self.ACTIVE_COLLECT_INTERVAL_S:
            # explicit collect works while the collector is disabled;
            # gen-1 keeps the pause bounded (young objects only), with a
            # periodic full pass to drain gen-2 promotions
            self._active_collects += 1
            if self._active_collects % self.FULL_COLLECT_EVERY == 0:
                gc.collect()
            else:
                gc.collect(1)
            self._last_collect = now

    def idle(self) -> None:
        if self._active:
            gc.enable()
            gc.collect()
            self._active = False

    def close(self) -> None:
        self.idle()


class _PauseHook:
    """The ``gc.callbacks`` hook that times every collection, on any
    thread: ``scheduler_tpu_gc_pause_seconds_total{generation}`` always,
    and a ``gc`` span on the collecting thread's track while the flight
    recorder's trace is armed. One hook serves every scheduler of the
    process: ``install`` and ``remove`` count their callers."""

    def __init__(self) -> None:
        self._users = 0
        self._lock = threading.Lock()
        self._t0: Optional[float] = None

    def __call__(self, phase: str, info: dict) -> None:
        # collections never overlap (the interpreter holds one at a time),
        # so one start slot serves every thread
        if phase == "start":
            self._t0 = _time.perf_counter()
            return
        t0, self._t0 = self._t0, None
        if t0 is None:
            return  # installed while this collection ran
        seconds = _time.perf_counter() - t0
        generation = info.get("generation", -1)
        metrics.gc_pause_seconds.inc(seconds, generation=str(generation))
        flightrecorder.gc_pause(
            threading.current_thread().name, t0, seconds, generation,
            info.get("collected", 0),
        )

    def install(self) -> None:
        with self._lock:
            self._users += 1
            if self._users == 1:
                gc.callbacks.append(self)

    def remove(self) -> None:
        with self._lock:
            self._users = max(0, self._users - 1)
            if self._users == 0 and self in gc.callbacks:
                gc.callbacks.remove(self)


PAUSE_HOOK = _PauseHook()
