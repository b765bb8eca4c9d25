"""PriorityQueue: activeQ / podBackoffQ / unschedulableQ with cycle counters.

Reference: /root/reference/pkg/scheduler/internal/queue/scheduling_queue.go
(PriorityQueue :118, Pop :372, AddUnschedulableIfNotPresent :290,
MoveAllToActiveOrBackoffQueue :494, backoff calc :643, flush loops
:234-237, nominatedPodMap :720).

TPU extension: ``pop_batch(max_size)`` drains up to B pods per solver step
instead of one -- the activeQ drain *is* the batch (SURVEY.md section 2.1).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch import native as _native
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.interface import PodInfo
from kubernetes_tpu_torch.queue import events
from kubernetes_tpu_torch.queue.heap import Heap
from kubernetes_tpu_torch.utils import flightrecorder, metrics

DEFAULT_POD_INITIAL_BACKOFF = 1.0  # seconds
DEFAULT_POD_MAX_BACKOFF = 10.0
UNSCHEDULABLE_Q_TIME_INTERVAL = 60.0  # scheduling_queue.go:62


def _pod_key(pod: Pod) -> str:
    return pod.key()


def _is_pod_updated(old: Optional[Pod], new: Pod) -> bool:
    """Reference scheduling_queue.go isPodUpdated: compare ignoring
    resourceVersion and status, so the scheduler's own PodScheduled
    condition writes don't wake parked unschedulable pods."""
    if old is None:
        return True
    return not (
        old.spec == new.spec
        and old.metadata.labels == new.metadata.labels
        and old.metadata.annotations == new.metadata.annotations
        and old.metadata.deletion_timestamp == new.metadata.deletion_timestamp
        and old.metadata.owner_references == new.metadata.owner_references
    )


def _info_key(pi: PodInfo) -> str:
    return _pod_key(pi.pod)


def _queue_shape_py(pods: List[Pod]):
    """Pure-Python twin of native ``queue_shape`` (identical semantics;
    tests/test_native_ingest.py fuzzes the two): one pass shaping a
    create burst for the bulk activeQ add -- heap key strings,
    spec.priority (the PrioritySort sort-key component), and
    status.nominated_node_name per pod."""
    keys = []
    prios = []
    noms = []
    for pod in pods:
        meta = pod.metadata
        keys.append(f"{meta.namespace}/{meta.name}")
        prios.append(pod.spec.priority)
        noms.append(pod.status.nominated_node_name)
    return keys, prios, noms


def _band_priority(pod: Pod) -> int:
    """The pod's effective priority for band selection: the admission
    classifier stamps ``_band_priority`` once at ingest (resolving a
    bare priorityClassName through the PriorityClass object); pods that
    entered without classification fall back to the raw spec field."""
    p = pod.__dict__.get("_band_priority")
    return p if p is not None else pod.spec.priority


class _NominatedPodMap:
    """Reference scheduling_queue.go:720.

    Transition accounting lives HERE, at the single point every entry
    path (explicit nomination, requeue re-install from status, bind
    clear, node-delete clear) goes through, so
    ``nominations_set - nominations_cleared`` tracks LIVE nominations:
    a move X->Y books one clear and one set, a removal books a clear,
    an idempotent same-node re-install books nothing."""

    def __init__(self) -> None:
        self.nominated_pods: Dict[str, List[Pod]] = {}  # node -> pods
        self.nominated_pod_to_node: Dict[str, str] = {}  # uid -> node

    def add(self, pod: Pod, node_name: str) -> Optional[str]:
        """Returns the PREVIOUS nomination's node (None if there was
        none)."""
        prev = self._remove(pod)
        node = node_name or pod.status.nominated_node_name
        if node != (prev or ""):
            if prev:
                metrics.nominations_cleared.inc()
            if node:
                metrics.nominations_set.inc()
        if not node:
            return prev
        self.nominated_pod_to_node[pod.metadata.uid] = node
        self.nominated_pods.setdefault(node, []).append(pod)
        return prev

    def delete(self, pod: Pod) -> Optional[str]:
        """Returns the node the pod WAS nominated to (None when it held
        no nomination)."""
        node = self._remove(pod)
        if node is not None:
            metrics.nominations_cleared.inc()
        return node

    def _remove(self, pod: Pod) -> Optional[str]:
        node = self.nominated_pod_to_node.pop(pod.metadata.uid, None)
        if node is None:
            return None
        pods = self.nominated_pods.get(node, [])
        self.nominated_pods[node] = [
            p for p in pods if p.metadata.uid != pod.metadata.uid
        ]
        if not self.nominated_pods[node]:
            del self.nominated_pods[node]
        return node

    def pods_for_node(self, node_name: str) -> List[Pod]:
        return list(self.nominated_pods.get(node_name, []))


class PriorityQueue:
    def __init__(
        self,
        less_func: Callable[[PodInfo, PodInfo], bool],
        pod_initial_backoff: float = DEFAULT_POD_INITIAL_BACKOFF,
        pod_max_backoff: float = DEFAULT_POD_MAX_BACKOFF,
        now: Callable[[], float] = time.monotonic,
        sort_key_func=None,
    ) -> None:
        self._now = now
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._initial_backoff = pod_initial_backoff
        self._max_backoff = pod_max_backoff

        # sort_key_func (when the QueueSort plugin provides a total-order
        # key) lets both heaps compare natively; backoff order is keyed by
        # the expiry time, snapshotted at insert (timestamp/attempts are
        # only mutated before re-adding, so the snapshot stays valid)
        self.active_q = Heap(_info_key, less_func, sort_key=sort_key_func)
        self.pod_backoff_q = Heap(_info_key, sort_key=self._backoff_time)
        # bulk-add fast path: when the queue-sort key is the stock
        # PrioritySort tuple ((-priority, timestamp)), add_many can
        # derive every sort key from the shaped priorities instead of
        # calling the key func per pod; any custom plugin key keeps the
        # per-entry call
        from kubernetes_tpu_torch.plugins.queuesort import PrioritySort

        self._prio_sort_keys = (
            sort_key_func is not None
            and getattr(sort_key_func, "__func__", None)
            is PrioritySort.queue_sort_key
        )
        self.unschedulable_q: Dict[str, PodInfo] = {}
        # blast-radius containment (robustness/containment.py): pods
        # isolated by poison bisection. HELD pods sit out an escalating
        # hold, released back to the activeQ by the flush loop; PARKED
        # pods exhausted their retry budget and stay until deleted or a
        # REAL spec update (cluster events never wake them -- that is
        # the point: a poison pod must stop re-entering batches).
        self._quarantine_held: Dict[str, PodInfo] = {}
        self._quarantine_release: Dict[str, float] = {}  # key -> due
        self._quarantine_parked: Dict[str, PodInfo] = {}
        # multi-tenant hard-quota parking (controllers/quota.py): pods
        # denied admission by an exhausted ResourceQuota. Parked OUT of
        # every queue and released by quota/usage EVENTS only (the
        # QuotaController's headroom recheck) -- cluster events, move
        # requests, and the flush loops never wake them, because no
        # node/volume/affinity change can create quota headroom.
        self._quota_parked: Dict[str, PodInfo] = {}
        self._quota_parked_ns: Dict[str, set] = {}  # namespace -> keys
        self._quota_seen = False
        # once quarantine has been used, num_pending keeps emitting the
        # quarantine keys even at zero (a scrape-driven pending_pods
        # gauge must be refreshed DOWN, not left at its last nonzero
        # sample); a queue that never quarantined keeps the stock
        # three-key shape
        self._quarantine_seen = False
        # optional hook: called (outside the queue lock commitment --
        # the callback must be non-blocking or thread-spawning) with
        # the pod when a PARKED entry is released by a real spec
        # update, so the owner can clear the PodQuarantined condition
        self.on_quarantine_release = None
        self.nominated_pods = _NominatedPodMap()

        self.scheduling_cycle = 0
        self.move_request_cycle = 0
        self._closed = False
        self.last_pop_wait_seconds = 0.0
        # the part of it spent inside the batch window with pods in hand,
        # and the active queue's length the drain left behind
        self.last_pop_window_wait_seconds = 0.0
        self.last_pop_queue_depth = 0
        # priority-band queue jumping (streaming subsystem): pods with
        # spec.priority >= band_threshold form the HIGH band. The heap
        # already sorts them first; the band additionally cuts the batch
        # window short whenever a high-band pod is in (or joins) the
        # draining batch, so a latency-critical pod never waits out a
        # throughput-mode window behind a bulk backlog. None = off
        # (zero cost on the drain path).
        self.band_threshold: Optional[int] = None

    # -- backoff ------------------------------------------------------------

    def _backoff_duration(self, pi: PodInfo) -> float:
        """Exponential: initial * 2^attempts capped at max
        (reference :643 calculateBackoffDuration)."""
        duration = self._initial_backoff
        for _ in range(1, pi.attempts):
            duration *= 2
            if duration >= self._max_backoff:
                return self._max_backoff
        return duration

    def _backoff_time(self, pi: PodInfo) -> float:
        return pi.timestamp + self._backoff_duration(pi)

    def _is_backing_off(self, pi: PodInfo) -> bool:
        return self._backoff_time(pi) > self._now()

    # -- add paths ----------------------------------------------------------

    def _add_locked(self, pod: Pod, now: float) -> None:
        key = _pod_key(pod)
        qp = self._quota_parked.get(key)
        if qp is not None:
            if qp.pod.metadata.uid == pod.metadata.uid:
                # a re-delivered add (relist echo) for a quota-parked
                # incarnation must not resurrect it into the activeQ --
                # only a quota/usage event releases it
                qp.pod = pod
                return
            # a NEW incarnation under the same key: the parked object
            # is gone; the replacement re-runs the admission gate
            self._drop_quota_parked_locked(key)
        held = self._quarantine_held.get(key)
        parked = held or self._quarantine_parked.get(key)
        if parked is not None:
            if parked.pod.metadata.uid == pod.metadata.uid:
                # a re-delivered add (relist echo) for a quarantined
                # incarnation must not resurrect it into the activeQ
                parked.pod = pod
                return
            # a NEW incarnation under the same key: the quarantined
            # object is gone; the replacement starts clean
            self._quarantine_held.pop(key, None)
            self._quarantine_release.pop(key, None)
            if self._quarantine_parked.pop(key, None) is not None:
                metrics.quarantine_parked.set(
                    len(self._quarantine_parked)
                )
        self.active_q.add(PodInfo(pod, now))
        self.unschedulable_q.pop(key, None)
        self.pod_backoff_q.delete_by_key(key)
        self.nominated_pods.add(pod, "")

    def _delete_locked(self, pod: Pod) -> None:
        key = _pod_key(pod)
        self.nominated_pods.delete(pod)
        self.active_q.delete_by_key(key)
        self.pod_backoff_q.delete_by_key(key)
        self.unschedulable_q.pop(key, None)
        self._quarantine_held.pop(key, None)
        self._quarantine_release.pop(key, None)
        if self._quarantine_parked.pop(key, None) is not None:
            metrics.quarantine_parked.set(len(self._quarantine_parked))
        if self._quota_parked:
            self._drop_quota_parked_locked(key)

    def _drop_quota_parked_locked(self, key: str) -> None:
        pi = self._quota_parked.pop(key, None)
        if pi is None:
            return
        ns = pi.pod.metadata.namespace
        keys = self._quota_parked_ns.get(ns)
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._quota_parked_ns[ns]
        metrics.quota_parked.set(len(self._quota_parked))

    def add(self, pod: Pod) -> None:
        """New pending pod (reference :246 Add)."""
        with self._cond:
            self._add_locked(pod, self._now())
            self._cond.notify()

    def add_many(self, pods: List[Pod]) -> None:
        """Bulk add under one lock hold + one wakeup (a watch frame's
        worth of new pending pods).

        The bulk apiserver->queue ingest path: one native pass
        (``queue_shape``; Python twin ``_queue_shape_py`` behind
        KTPU_NATIVE_INGEST=0) shapes the burst into heap keys,
        priorities, and nominations, and ``Heap.add_bulk`` lands the
        entries with one C-level heapify instead of per-pod pushes --
        ``pop_bulk`` then drains exactly what ingest already shaped.
        Per-pod semantics are ``_add_locked``'s, differentially pinned
        in tests/test_native_ingest.py."""
        if not pods:
            return
        pods_l = pods if isinstance(pods, list) else list(pods)
        fn, expected = _native.ingest_fn("queue_shape")
        if fn is not None:
            keys, prios, noms = fn(pods_l)
        else:
            if expected:
                metrics.ingest_native_fallbacks.inc(site="queue-shape")
            keys, prios, noms = _queue_shape_py(pods_l)
        with self._cond:
            now = self._now()
            infos = [PodInfo(pod, now) for pod in pods_l]
            sort_keys = (
                [(-p, now) for p in prios]
                if self._prio_sort_keys
                else None
            )
            self.active_q.add_bulk(infos, keys, sort_keys)
            usq = self.unschedulable_q
            if usq:
                for key in keys:
                    usq.pop(key, None)
            bq = self.pod_backoff_q
            if len(bq):
                for key in keys:
                    bq.delete_by_key(key)
            # nomination re-install only when any pod carries one (or
            # the map holds entries to clear) -- the burst common case
            # skips the per-pod map walk entirely
            nmap = self.nominated_pods
            if nmap.nominated_pod_to_node or any(noms):
                for pod in pods_l:
                    nmap.add(pod, "")
            self._cond.notify()

    def delete_many(self, pods: List[Pod]) -> None:
        """Bulk delete under one lock hold (bound-pod echo frames)."""
        if not pods:
            return
        with self._cond:
            for pod in pods:
                self._delete_locked(pod)

    def add_unschedulable_if_not_present(
        self, pi: PodInfo, pod_scheduling_cycle: int,
        skip_backoff: bool = False,
    ) -> None:
        """Failed pod back into the queue (reference :290). A move request
        during this pod's scheduling attempt sends it to backoff instead of
        unschedulableQ -- the lost-wakeup guard.

        ``skip_backoff`` requeues straight to the activeQ: the batched
        preemption path uses it for pods whose blocking victims were
        evicted in the same wave (see Scheduler.record_scheduling_failure)."""
        with self._cond:
            key = _info_key(pi)
            if key in self.unschedulable_q:
                raise KeyError(f"pod {key} is already in the unschedulable queue")
            if key in self.active_q or key in self.pod_backoff_q:
                raise KeyError(f"pod {key} is already queued")
            if skip_backoff:
                # keep the original enqueue timestamp: the nominee must
                # sort BEFORE later burst arrivals so it reclaims the
                # capacity its own wave freed (the batch analogue of
                # addNominatedPods shielding nominees from other pods,
                # generic_scheduler.go:535). Do NOT touch nominated_pods
                # here: the wave just registered the nomination via
                # update_nominated_pod_for_node, and the pod object's
                # STATUS write is deferred -- add(pod, "") would fall
                # back to the empty status and delete the entry
                self.active_q.add(pi)
                self._cond.notify()
                return
            pi.timestamp = self._now()
            if self.move_request_cycle >= pod_scheduling_cycle:
                self.pod_backoff_q.add(pi)
            else:
                self.unschedulable_q[key] = pi
            self.nominated_pods.add(pi.pod, "")
            self._cond.notify()

    def update(self, old_pod: Optional[Pod], new_pod: Pod) -> None:
        """Reference :417: in active/backoff -> update in place; in
        unschedulableQ -> move to activeQ if the update may make it
        schedulable (we conservatively always move, matching
        isPodUpdated=true paths)."""
        with self._cond:
            key = _pod_key(new_pod)
            existing = self.active_q.get_by_key(key)
            if existing is not None:
                self.nominated_pods.add(new_pod, "")
                existing.pod = new_pod
                self.active_q.update(existing)
                self._cond.notify()
                return
            existing = self.pod_backoff_q.get_by_key(key)
            if existing is not None:
                self.nominated_pods.add(new_pod, "")
                existing.pod = new_pod
                self.pod_backoff_q.update(existing)
                return
            pi = self.unschedulable_q.get(key)
            if pi is not None:
                self.nominated_pods.add(new_pod, "")
                updated = _is_pod_updated(old_pod, new_pod)
                pi.pod = new_pod
                if not updated:
                    # status-only change: stay parked (isPodUpdated guard)
                    return
                if self._is_backing_off(pi):
                    del self.unschedulable_q[key]
                    self.pod_backoff_q.add(pi)
                else:
                    del self.unschedulable_q[key]
                    self.active_q.add(pi)
                    self._cond.notify()
                return
            pi = self._quota_parked.get(key)
            if pi is not None:
                updated = _is_pod_updated(old_pod, new_pod)
                pi.pod = new_pod
                if not updated:
                    # status-only change (incl. the controller's own
                    # QuotaExceeded condition write): stay parked
                    return
                # a REAL spec/label change is operator intervention
                # (e.g. the requests were shrunk to fit): release for a
                # fresh admission attempt at pop. Fresh timestamp, same
                # as the controller's release path -- park time is not
                # queue wait
                self._drop_quota_parked_locked(key)
                pi.timestamp = self._now()
                self.active_q.add(pi)
                self._cond.notify()
                return
            pi = self._quarantine_held.get(key) or (
                self._quarantine_parked.get(key)
            )
            if pi is not None:
                updated = _is_pod_updated(old_pod, new_pod)
                pi.pod = new_pod
                if not updated:
                    # status-only change (incl. our own PodQuarantined
                    # condition write): stay quarantined
                    return
                # a REAL spec/label change is operator intervention:
                # release for a fresh attempt (the strike ledger in the
                # QuarantineManager survives; a still-poisoned pod
                # re-parks on its next isolation)
                self._quarantine_held.pop(key, None)
                self._quarantine_release.pop(key, None)
                was_parked = (
                    self._quarantine_parked.pop(key, None) is not None
                )
                if was_parked:
                    metrics.quarantine_parked.set(
                        len(self._quarantine_parked)
                    )
                self.active_q.add(pi)
                self._cond.notify()
                if was_parked and self.on_quarantine_release is not None:
                    # the typed PodQuarantined condition must not
                    # outlive the park (callback is thread-spawning /
                    # non-blocking by contract)
                    try:
                        self.on_quarantine_release(pi.pod)
                    except Exception:
                        pass  # releasing must never fail on bookkeeping
                return
            self.add(new_pod)

    def delete(self, pod: Pod) -> None:
        with self._cond:
            self._delete_locked(pod)

    # -- pop ----------------------------------------------------------------

    def pop(self, timeout: Optional[float] = None) -> Optional[PodInfo]:
        """Blocking pop from activeQ (reference :372). Increments the
        scheduling cycle; returns None on close/timeout."""
        deadline = None if timeout is None else self._now() + timeout
        with self._cond:
            while len(self.active_q) == 0:
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    wait = deadline - self._now()
                    if wait <= 0.0:
                        return None
                    self._cond.wait(wait)
                    if self._now() >= deadline and len(self.active_q) == 0:
                        return None
            pi: PodInfo = self.active_q.pop()
            pi.attempts += 1
            self.scheduling_cycle += 1
            return pi

    def pop_batch(
        self,
        max_size: int,
        timeout: Optional[float] = None,
        window=0.0,
    ) -> List[PodInfo]:
        """TPU batch drain: block for the first pod, then take up to
        ``max_size``. With ``window > 0``, wait up to that long for more
        arrivals before returning a partial batch -- amortizes the fixed
        per-solve cost (device transfer + dispatch) during a burst at the
        price of a bounded latency add for the first pods.

        ``window`` may be a CALLABLE returning the current window (the
        SLO-adaptive controller mutates it while a drain is waiting).
        The window deadline is re-read at every wakeup but can only
        move EARLIER: a mid-window controller shrink applies
        immediately, while a grow never extends an already-armed
        deadline -- the pods already in the batch were promised the
        window in force when they were drained.

        Priority bands (``band_threshold``): when the batch holds a pod
        at or above the threshold -- drained on entry or arriving during
        a window wait -- the window is cut short and the batch
        dispatches now. High-band pods already sort first in the heap;
        the cut means a bulk backlog's throughput-mode window can never
        add latency in front of them. Band queue-wait histograms
        (``scheduler_queue_band_wait_seconds``) are recorded per drain
        when bands are on.

        The drain is BULK: one lock hold pulls every available pod
        through ``Heap.pop_bulk`` (a single native sort) instead of one
        heap pop -- with its own lock acquisition and O(log n) sift --
        per pod. Batch order is exactly the per-pod pop order
        (differentially tested in tests/test_queue_bulk.py), and every
        popped pod bumps ``scheduling_cycle``, so the
        ``move_request_cycle`` lost-wakeup gate sees batch pops the same
        way it sees single pops (pods 2..N used to skip the bump).

        ``last_pop_wait_seconds`` holds the wall clock THIS call spent
        blocked waiting for arrivals (first pod + window waits), so the
        caller's stage timers can report drain WORK separately from
        idle wait (single dispatcher thread; stats only). Window waits
        cut short by a band arrival still count only the time actually
        waited -- the split stays honest under band-aware drains.
        ``last_pop_window_wait_seconds`` is the part of it spent inside
        the batch window, after the first arrival, and
        ``last_pop_queue_depth`` the active queue's length after the
        drain (also a ``queue_depth`` counter sample in an armed trace)."""
        deadline = None if timeout is None else self._now() + timeout
        window_fn = window if callable(window) else None
        band = self.band_threshold
        batch: List[PodInfo] = []
        waited = 0.0
        window_waited = 0.0
        depth = len(self.active_q)
        has_high = False
        try:
            with self._cond:
                # block for the first arrival (pop()'s wait loop, inlined
                # so the drain shares its lock hold)
                while len(self.active_q) == 0:
                    if self._closed:
                        return batch
                    if deadline is None:
                        t0 = time.perf_counter()
                        self._cond.wait()
                        waited += time.perf_counter() - t0
                    else:
                        wait = deadline - self._now()
                        if wait <= 0.0:
                            return batch
                        t0 = time.perf_counter()
                        self._cond.wait(wait)
                        waited += time.perf_counter() - t0
                        if (
                            self._now() >= deadline
                            and len(self.active_q) == 0
                        ):
                            return batch
                window_start = self._now()
                window_deadline = window_start + (
                    window_fn() if window_fn is not None else window
                )
                while True:
                    drained = self.active_q.pop_bulk(max_size - len(batch))
                    if drained:
                        now = self._now()
                        for pi in drained:
                            pi.attempts += 1
                        self.scheduling_cycle += len(drained)
                        batch.extend(drained)
                        if band is not None:
                            has_high = has_high or any(
                                _band_priority(pi.pod) >= band
                                for pi in drained
                            )
                            self._observe_band_waits(drained, band, now)
                    if len(batch) >= max_size or self._closed:
                        break
                    if has_high:
                        # a high-band pod is aboard: dispatch now; the
                        # window exists to amortize bulk work, not to
                        # tax the latency band
                        break
                    if window_fn is not None:
                        # adaptive window: shrink applies mid-wait, a
                        # grow never extends the armed deadline
                        window_deadline = min(
                            window_deadline, window_start + window_fn()
                        )
                    remaining = window_deadline - self._now()
                    if remaining <= 0:
                        break
                    t0 = time.perf_counter()
                    self._cond.wait(remaining)
                    window_waited += time.perf_counter() - t0
                depth = len(self.active_q)
            flightrecorder.trace_counter("queue_depth", depth)
            return batch
        finally:
            self.last_pop_wait_seconds = waited + window_waited
            self.last_pop_window_wait_seconds = window_waited
            self.last_pop_queue_depth = depth

    @staticmethod
    def _observe_band_waits(
        drained: List[PodInfo], band: int, now: float
    ) -> None:
        """Per-band queue-wait histograms (only when bands are on):
        enqueue-to-drain wall clock, split high vs bulk."""
        from kubernetes_tpu_torch.utils import metrics

        high = []
        bulk = []
        for pi in drained:
            wait = max(0.0, now - pi.timestamp)
            if _band_priority(pi.pod) >= band:
                high.append(wait)
            else:
                bulk.append(wait)
        if high:
            metrics.queue_band_wait.observe_many(high, band="high")
        if bulk:
            metrics.queue_band_wait.observe_many(bulk, band="bulk")

    # -- move machinery -----------------------------------------------------

    def move_all_to_active_or_backoff_queue(self, event: str) -> None:
        """Reference :494: wake everything in unschedulableQ."""
        with self._cond:
            for key, pi in list(self.unschedulable_q.items()):
                if self._is_backing_off(pi):
                    self.pod_backoff_q.add(pi)
                else:
                    self.active_q.add(pi)
                del self.unschedulable_q[key]
            self.move_request_cycle = self.scheduling_cycle
            self._cond.notify_all()

    def move_pods_to_active_or_backoff_queue(
        self, pod_infos: List[PodInfo], event: str
    ) -> None:
        """Reference :527 movePodsToActiveOrBackoffQueue (targeted wake,
        e.g. pods with matching affinity terms on AssignedPodAdd)."""
        with self._cond:
            for pi in pod_infos:
                key = _info_key(pi)
                if key not in self.unschedulable_q:
                    continue
                if self._is_backing_off(pi):
                    self.pod_backoff_q.add(pi)
                else:
                    self.active_q.add(pi)
                del self.unschedulable_q[key]
            self.move_request_cycle = self.scheduling_cycle
            self._cond.notify_all()

    def unschedulable_pods(self) -> List[PodInfo]:
        with self._lock:
            return list(self.unschedulable_q.values())

    # -- targeted assigned-pod wakeups (reference :508-:525) ----------------

    def _pods_with_matching_affinity_term(self, pod: Pod) -> List[PodInfo]:
        """getUnschedulablePodsWithMatchingAffinityTerm
        (scheduling_queue.go:560): unschedulable pods whose pod-AFFINITY
        terms match the newly assigned pod -- only those can become
        schedulable because of it."""
        from kubernetes_tpu_torch.api.selectors import labels_match_selector

        out = []
        with self._lock:
            for pi in self.unschedulable_q.values():
                a = pi.pod.spec.affinity
                if a is None or a.pod_affinity is None:
                    continue
                terms = list(a.pod_affinity.required_during_scheduling) + [
                    w.pod_affinity_term
                    for w in a.pod_affinity.preferred_during_scheduling
                ]
                for term in terms:
                    namespaces = term.namespaces or [pi.pod.metadata.namespace]
                    if pod.metadata.namespace in namespaces and (
                        labels_match_selector(
                            pod.metadata.labels, term.label_selector
                        )
                    ):
                        out.append(pi)
                        break
        return out

    def assigned_pod_added(self, pod: Pod) -> None:
        """Reference :508 AssignedPodAdded: an added pod can only help
        parked pods whose affinity terms it matches. The move runs even
        with an empty match list: it bumps move_request_cycle, which is
        the lost-wakeup guard for pods mid-attempt right now (they requeue
        to backoff instead of parking unschedulable)."""
        self.move_pods_to_active_or_backoff_queue(
            self._pods_with_matching_affinity_term(pod), events.AssignedPodAdd
        )

    def assigned_pods_added_many(self, pods: List[Pod]) -> None:
        """Frame variant of assigned_pod_added: one move request (one
        lock hold, one move_request_cycle bump, one wakeup) covering the
        union of affinity-matched parked pods.

        Fast path: when no parked pod carries a pod-affinity term (the
        10k-burst steady state), the per-assigned-pod match scan is pure
        overhead -- skip straight to the empty move, which still bumps
        move_request_cycle (the lost-wakeup guard for pods mid-attempt)."""
        with self._lock:
            any_affinity_parked = any(
                pi.pod.spec.affinity is not None
                and pi.pod.spec.affinity.pod_affinity is not None
                for pi in self.unschedulable_q.values()
            )
        matched: List[PodInfo] = []
        if any_affinity_parked:
            seen = set()
            for pod in pods:
                for pi in self._pods_with_matching_affinity_term(pod):
                    key = _info_key(pi)
                    if key not in seen:
                        seen.add(key)
                        matched.append(pi)
        self.move_pods_to_active_or_backoff_queue(
            matched, events.AssignedPodAdd
        )

    def assigned_pod_updated(self, pod: Pod) -> None:
        """Reference :516 AssignedPodUpdated."""
        self.move_pods_to_active_or_backoff_queue(
            self._pods_with_matching_affinity_term(pod),
            events.AssignedPodUpdate,
        )

    # -- quarantine (blast-radius containment, robustness/containment.py) ---

    def quarantine_pod(self, pi: PodInfo, hold_seconds: float) -> None:
        """Hold an isolated (already popped) pod OUT of every queue for
        ``hold_seconds``; the flush loop releases it to the activeQ for
        its next bounded retry. Cluster events never shorten the hold
        (unlike unschedulableQ parking, where any move request wakes
        the pod -- a poison pod must not surf wakeups back into
        batches)."""
        with self._cond:
            key = _info_key(pi)
            self._quarantine_seen = True
            self._delete_from_queues_locked(key)
            self._quarantine_held[key] = pi
            self._quarantine_release[key] = self._now() + max(
                0.0, hold_seconds
            )

    def park_quarantined(self, pi: PodInfo) -> None:
        """Terminal quarantine: the pod stays parked until it is
        deleted or an operator lands a real spec update (queue.update
        releases it then). Never flushed, never woken by move
        requests."""
        with self._cond:
            key = _info_key(pi)
            self._quarantine_seen = True
            self._delete_from_queues_locked(key)
            self._quarantine_held.pop(key, None)
            self._quarantine_release.pop(key, None)
            self._quarantine_parked[key] = pi
            # the gauge tracks THIS map at every mutation (park,
            # delete, new-incarnation purge, spec-update release), so
            # a dashboard alert clears when the last parked pod goes
            metrics.quarantine_parked.set(len(self._quarantine_parked))

    def park_quarantined_recovered(self, pod: Pod) -> None:
        """Startup-recovery park (ROADMAP item 6c): a relisted PENDING
        pod still carrying the persisted ``PodQuarantined`` condition
        goes straight back to the terminal park instead of the activeQ
        -- a restarted scheduler (whose in-memory strike ledger died
        with the old incarnation) must not re-admit a known poison pod
        into batches until an operator intervenes. The existing release
        paths (real spec update via ``update``, delete, new
        incarnation) apply unchanged."""
        self.park_quarantined(PodInfo(pod, self._now()))

    def _delete_from_queues_locked(self, key: str) -> None:
        self.active_q.delete_by_key(key)
        self.pod_backoff_q.delete_by_key(key)
        self.unschedulable_q.pop(key, None)

    # -- quota parking (multi-tenant fairness plane, controllers/quota.py) ---

    def park_quota_exceeded(self, pi: PodInfo) -> None:
        """Park an (already popped) pod whose namespace has no quota
        headroom OUT of every queue. Unlike unschedulableQ parking,
        cluster events never wake it -- no node/volume change can
        create quota headroom; the QuotaController releases it on
        quota-update or usage-drop events (and only when it would
        actually fit, so releases never churn)."""
        with self._cond:
            key = _info_key(pi)
            self._quota_seen = True
            self._delete_from_queues_locked(key)
            self._quota_parked[key] = pi
            self._quota_parked_ns.setdefault(
                pi.pod.metadata.namespace, set()
            ).add(key)
            metrics.quota_parked.set(len(self._quota_parked))

    def release_quota_parked(self, pis: List[PodInfo]) -> int:
        """Move the given parked pods back to the activeQ (the
        controller's headroom release). Returns the number released."""
        released = 0
        with self._cond:
            now = self._now()
            for pi in pis:
                key = _info_key(pi)
                if key not in self._quota_parked:
                    continue  # deleted / already released
                self._drop_quota_parked_locked(key)
                pi.timestamp = now
                self.active_q.add(pi)
                released += 1
            if released:
                self._cond.notify_all()
        return released

    def quota_parked_infos(self, namespace: Optional[str] = None) -> List[PodInfo]:
        """Parked pods (of one namespace, or all), in park order."""
        with self._lock:
            if namespace is None:
                return list(self._quota_parked.values())
            keys = self._quota_parked_ns.get(namespace)
            if not keys:
                return []
            return [
                pi for key, pi in self._quota_parked.items()
                if key in keys
            ]

    def quota_parked_count(self) -> int:
        with self._lock:
            return len(self._quota_parked)

    def flush_quarantine_released(self) -> int:
        """Move held pods whose hold expired back to the activeQ (run
        alongside the backoff flush). Returns the number released."""
        released = 0
        with self._cond:
            if not self._quarantine_held:
                return 0
            now = self._now()
            due = [
                key for key, t in self._quarantine_release.items()
                if t <= now
            ]
            for key in due:
                pi = self._quarantine_held.pop(key, None)
                self._quarantine_release.pop(key, None)
                if pi is None:
                    continue
                pi.timestamp = now
                self.active_q.add(pi)
                released += 1
            if released:
                metrics.quarantine_releases.inc(released)
                self._cond.notify_all()
        return released

    def quarantine_held_count(self) -> int:
        with self._lock:
            return len(self._quarantine_held)

    def quarantine_parked_count(self) -> int:
        with self._lock:
            return len(self._quarantine_parked)

    def quarantined_pods(self) -> List[PodInfo]:
        """Held + parked, held first (introspection/tests)."""
        with self._lock:
            return list(self._quarantine_held.values()) + list(
                self._quarantine_parked.values()
            )

    # -- flush loops (reference :234-237 run goroutines) --------------------

    def flush_backoff_q_completed(self) -> None:
        """Move pods whose backoff expired from backoffQ to activeQ
        (run every 1s by the reference)."""
        with self._cond:
            moved = False
            while len(self.pod_backoff_q) > 0:
                pi = self.pod_backoff_q.peek()
                if self._backoff_time(pi) > self._now():
                    break
                self.active_q.add(self.pod_backoff_q.pop())
                moved = True
            if moved:
                self._cond.notify_all()

    def flush_unschedulable_q_leftover(self) -> None:
        """Pods stuck in unschedulableQ longer than 60s move back
        (run every 30s by the reference)."""
        now = self._now()
        with self._cond:
            to_move = [
                pi
                for pi in self.unschedulable_q.values()
                if now - pi.timestamp > UNSCHEDULABLE_Q_TIME_INTERVAL
            ]
        if to_move:
            self.move_pods_to_active_or_backoff_queue(
                to_move, events.UnschedulableTimeout
            )

    def run(self) -> List[threading.Thread]:
        """Start the two flush loops as daemon threads. Idempotent: a
        second call (Scheduler.run calls this too) is a no-op so the first
        pair of flush threads is never orphaned."""
        if getattr(self, "_flush_threads", None):
            return self._flush_threads
        stop = threading.Event()
        self._stop_flush = stop

        def loop(fn, interval):
            while not stop.is_set():
                stop.wait(interval)
                if stop.is_set():
                    return
                fn()

        threads = [
            threading.Thread(
                target=loop, args=(self.flush_backoff_q_completed, 1.0), daemon=True
            ),
            threading.Thread(
                target=loop,
                args=(self.flush_unschedulable_q_leftover, 30.0),
                daemon=True,
            ),
            # quarantine holds are sub-second at strike 1; a 1s cadence
            # would round every hold up to the flush tick
            threading.Thread(
                target=loop,
                args=(self.flush_quarantine_released, 0.2),
                daemon=True,
            ),
        ]
        for t in threads:
            t.start()
        self._flush_threads = threads
        return threads

    def close(self) -> None:
        with self._cond:
            self._closed = True
            if hasattr(self, "_stop_flush"):
                self._stop_flush.set()
            self._cond.notify_all()

    # -- nominated pods (interface :95-:110) --------------------------------

    def update_nominated_pod_for_node(self, pod: Pod, node_name: str) -> None:
        with self._lock:
            self.nominated_pods.add(pod, node_name)

    def delete_nominated_pod_if_exists(self, pod: Pod) -> None:
        with self._lock:
            self.nominated_pods.delete(pod)

    def delete_nominated_pods_if_exist(self, pods: List[Pod]) -> None:
        """Bulk variant for the batch commit: one lock hold, and an O(1)
        exit when nothing is nominated (the common case -- a freshly
        popped batch has no nominations)."""
        with self._lock:
            if not self.nominated_pods.nominated_pod_to_node:
                return
            for pod in pods:
                self.nominated_pods.delete(pod)

    def clear_nominations_for_node(self, node_name: str) -> List[Pod]:
        """Clear every nomination pointing at ``node_name`` -- the node
        was deleted, so its reservations are claims on capacity that no
        longer exists (the next batch's overlay and the host oracle's
        _add_nominated_pods must stop seeing them). Returns the affected
        pods; the caller re-arms them (moves them to active/backoff) so
        they re-plan instead of waiting out their backoff against a
        phantom nomination."""
        with self._lock:
            pods = self.nominated_pods.pods_for_node(node_name)
            for p in pods:
                self.nominated_pods.delete(p)
        return pods

    def all_nominated_pods_by_node(self) -> Dict[str, List[Pod]]:
        """Locked snapshot of the nominated map (node -> pods); the batch
        solver's capacity-overlay input."""
        with self._lock:
            return {
                node: list(pods)
                for node, pods in self.nominated_pods.nominated_pods.items()
                if node
            }

    def nominated_pods_for_node(self, node_name: str) -> List[Pod]:
        with self._lock:
            return self.nominated_pods.pods_for_node(node_name)

    # -- introspection ------------------------------------------------------

    def active_count(self) -> int:
        """Pods ready in the activeQ right now (cheap peek; the batch
        scheduler's preemption deferral uses it to detect a burst still
        streaming in)."""
        with self._cond:
            return len(self.active_q)

    def pending_pods(self) -> List[Pod]:
        with self._lock:
            return (
                [pi.pod for pi in self.active_q.list()]
                + [pi.pod for pi in self.pod_backoff_q.list()]
                + [pi.pod for pi in self.unschedulable_q.values()]
                + [pi.pod for pi in self._quarantine_held.values()]
                + [pi.pod for pi in self._quarantine_parked.values()]
                + [pi.pod for pi in self._quota_parked.values()]
            )

    def num_pending(self) -> Dict[str, int]:
        with self._lock:
            counts = {
                "active": len(self.active_q),
                "backoff": len(self.pod_backoff_q),
                "unschedulable": len(self.unschedulable_q),
            }
            # containment states appear once quarantine has ever been
            # used -- and then STAY, even at zero, so a scrape-driven
            # gauge refreshes down; a queue that never quarantined
            # keeps the stock three-queue shape
            if self._quarantine_seen:
                counts["quarantined"] = len(self._quarantine_held)
                counts["quarantine_parked"] = len(self._quarantine_parked)
            # same refresh-down contract as the quarantine keys
            if self._quota_seen:
                counts["quota_parked"] = len(self._quota_parked)
            return counts
