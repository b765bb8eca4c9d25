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
import time as _time


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
