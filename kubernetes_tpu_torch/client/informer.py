"""Informer machinery: list+watch replication into a local indexed cache.

Reference: client-go Reflector (tools/cache/reflector.go:49,
ListAndWatch :207) + SharedIndexInformer (tools/cache/shared_informer.go).

Two drive modes:
- ``start()``: a daemon thread pumps watch events continuously (the
  production shape).
- ``pump()``: synchronously drain pending events on the caller's thread --
  deterministic for tests and for the batched bench loop, where the solver
  wants snapshot updates at batch boundaries anyway.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch import native as _native
from kubernetes_tpu_torch.robustness.faults import FaultPoint, get_injector
from kubernetes_tpu_torch.utils import flightrecorder, metrics

from kubernetes_tpu_torch.apiserver.server import (
    ADDED,
    APIServer,
    DELETED,
    Gone,
    MODIFIED,
    Watch,
    WatchEvent,
)

logger = logging.getLogger(__name__)


def _apply_events_py(store: Dict, evs: List[WatchEvent]) -> List:
    """Pure-Python twin of native ``ingest_apply`` (identical semantics,
    differentially fuzzed in tests/test_native_ingest.py): apply a frame
    of events to the informer store and build the handler dispatch list.
    The (namespace, name) key record is decoded ONCE per event and
    memoized on ``ev.decoded`` -- sibling informer sets draining the
    same shared per-kind event log reuse it instead of re-walking
    ``obj.metadata``."""
    dispatch = []
    for ev in evs:
        obj = ev.object
        key = ev.decoded
        if key is None:
            key = (obj.metadata.namespace, obj.metadata.name)
            ev.decoded = key
        if ev.type == ADDED:
            store[key] = obj
            dispatch.append((ADDED, None, obj))
        elif ev.type == MODIFIED:
            old = store.get(key)
            store[key] = obj
            dispatch.append((MODIFIED, old, obj))
        elif ev.type == DELETED:
            store.pop(key, None)
            dispatch.append((DELETED, None, obj))
    return dispatch


class WatchDropped(Exception):
    """The watch stream broke (server-side compaction, network, injected
    drop); the informer must relist."""


class ResourceEventHandler:
    """Reference cache.ResourceEventHandlerFuncs."""

    def __init__(
        self,
        on_add: Optional[Callable[[Any], None]] = None,
        on_update: Optional[Callable[[Any, Any], None]] = None,
        on_delete: Optional[Callable[[Any], None]] = None,
        filter_func: Optional[Callable[[Any], bool]] = None,
        on_batch: Optional[Callable[[List], None]] = None,
    ):
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete
        self.filter_func = filter_func
        # optional whole-frame handler: receives [(type, old, new)] raw
        # (unfiltered) and replaces the per-event dispatch -- lets hot
        # consumers (cache/queue bridges) amortize their locks over a
        # watch frame; the handler applies filter semantics itself
        self.on_batch = on_batch

    def _passes(self, obj: Any) -> bool:
        return self.filter_func is None or self.filter_func(obj)

    def handle(self, event_type: str, old: Any, new: Any) -> None:
        """FilteringResourceEventHandler semantics
        (shared_informer.go): filter transitions produce add/delete."""
        if event_type == ADDED:
            if self._passes(new) and self.on_add:
                self.on_add(new)
        elif event_type == MODIFIED:
            old_ok = old is not None and self._passes(old)
            new_ok = self._passes(new)
            if old_ok and new_ok:
                if self.on_update:
                    self.on_update(old, new)
            elif not old_ok and new_ok:
                if self.on_add:
                    self.on_add(new)
            elif old_ok and not new_ok:
                if self.on_delete:
                    self.on_delete(old)
        elif event_type == DELETED:
            if self._passes(new) and self.on_delete:
                self.on_delete(new)


class Informer:
    def __init__(self, server: APIServer, kind: str):
        self._server = server
        self.kind = kind
        self._handlers: List[ResourceEventHandler] = []
        self._store: Dict[Tuple[str, str], Any] = {}
        self._lock = threading.RLock()
        self._watch: Optional[Watch] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._needs_relist = False
        self.synced = False

    def add_event_handler(self, handler: ResourceEventHandler) -> None:
        self._handlers.append(handler)

    # -- lister surface -----------------------------------------------------

    def list(self) -> List[Any]:
        with self._lock:
            return list(self._store.values())

    def get(self, namespace: str, name: str) -> Optional[Any]:
        with self._lock:
            return self._store.get((namespace, name))

    def has_synced(self) -> bool:
        return self.synced

    # -- replication --------------------------------------------------------

    def _list_watch_pair(self) -> Tuple[List[Any], int]:
        """list + open a watch from the listed RV, with the 410 Gone
        analogue handled: when the replay window was truncated past rv
        (a write burst between list and watch, or the injected
        watch_history_truncated point), list again from fresh state --
        the reference Reflector's relist-on-410 (reflector.go:302)."""
        last: Optional[Exception] = None
        for _attempt in range(3):
            objs, rv = self._server.list(self.kind)
            try:
                self._watch = self._server.watch(self.kind, since_rv=rv)
                return objs, rv
            except Gone as e:
                metrics.watch_gone.inc(kind=self.kind)
                logger.warning(
                    "watch for %s got 410 Gone at rv %d; relisting",
                    self.kind, rv,
                )
                last = e
        raise last  # persistent Gone: caller's retry machinery takes over

    def _list_and_start_watch(self) -> None:
        objs, rv = self._list_watch_pair()
        with self._lock:
            for obj in objs:
                self._store[(obj.metadata.namespace, obj.metadata.name)] = obj
        self._dispatch([(ADDED, None, obj) for obj in objs])
        self.synced = True

    def _apply(self, ev: WatchEvent) -> None:
        self._apply_batch([ev])

    def _apply_batch(self, evs: List[WatchEvent]) -> None:
        """Apply a frame of events: store updates under one lock hold,
        handler dispatch outside it (handlers take their own locks --
        cache, queue -- and must not nest inside the store lock)."""
        if not evs:
            return
        if not flightrecorder.trace_active():
            self._apply_batch_inner(evs)
            return
        # the informer thread's work per frame (apply, handlers, the
        # queue's add), an ``ingest`` span on its track
        t0 = time.perf_counter()
        self._apply_batch_inner(evs)
        flightrecorder.trace_span(
            "ingest", t0, time.perf_counter() - t0,
            args={"kind": self.kind, "events": len(evs)},
        )

    def _apply_batch_inner(self, evs: List[WatchEvent]) -> None:
        fn, expected = _native.ingest_fn("ingest_apply")
        with self._lock:
            if fn is not None:
                dispatch = fn(self._store, evs)
            else:
                if expected:
                    metrics.ingest_native_fallbacks.inc(
                        site="informer-apply"
                    )
                dispatch = _apply_events_py(self._store, evs)
        self._dispatch(dispatch)

    def _dispatch(self, dispatch: List) -> None:
        for h in self._handlers:
            if h.on_batch is not None:
                h.on_batch(dispatch)
            else:
                for etype, old, obj in dispatch:
                    h.handle(etype, old, obj)

    def _relist(self) -> None:
        """Relist-on-watch-error (reference Reflector ListAndWatch
        :207 relist semantics): re-list the kind, open a fresh watch
        from the listed RV, diff the fresh state against the local
        store, and dispatch synthetic ADDED/MODIFIED/DELETED events so
        every handler (cache, queue) converges -- no event is silently
        lost across the gap."""
        metrics.watch_relists.inc(kind=self.kind)
        logger.warning("watch for %s broke; relisting", self.kind)
        if self._watch is not None:
            try:
                self._watch.stop()
            except Exception:  # noqa: BLE001 - old stream is already dead
                pass
        objs, rv = self._list_watch_pair()
        dispatch = []
        with self._lock:
            fresh = {
                (o.metadata.namespace, o.metadata.name): o for o in objs
            }
            for key, old in self._store.items():
                if key not in fresh:
                    dispatch.append((DELETED, None, old))
            for key, obj in fresh.items():
                old = self._store.get(key)
                if old is None:
                    dispatch.append((ADDED, None, obj))
                elif (
                    old.metadata.resource_version
                    != obj.metadata.resource_version
                ):
                    dispatch.append((MODIFIED, old, obj))
            self._store = fresh
        self._dispatch(dispatch)
        # a relist that replaced a failed INITIAL sync leaves the
        # informer fully caught up -- it is synced from here
        self.synced = True

    def _next_events(self, timeout: Optional[float]) -> List[WatchEvent]:
        """One read from the watch stream, with the injected-drop seam
        and real stream errors both converted into a relist."""
        if self._needs_relist:
            # a previous relist failed (server down mid-recovery); the
            # old watch is already stopped and returns [] without
            # raising, so the retry must happen HERE or the informer
            # would be silently stranded forever
            if not self._try_relist(timeout):
                return []
        inj = get_injector()
        try:
            if inj is not None and inj.should_fire(FaultPoint.WATCH_DROP):
                raise WatchDropped(self.kind)
            if timeout is None:
                return self._watch.pending()
            return self._watch.next_batch(timeout=timeout)
        except Exception:  # noqa: BLE001 - any stream failure => relist
            self._try_relist(timeout)
            return []

    def _try_relist(self, timeout: Optional[float]) -> bool:
        """Attempt a relist; on failure arm the retry flag (and, on the
        threaded path, back off briefly so a dead server isn't
        busy-spun)."""
        try:
            self._relist()
        except Exception:  # noqa: BLE001 - server also down: retry later
            logger.exception("relist for %s failed; will retry", self.kind)
            self._needs_relist = True
            if timeout is not None:
                time.sleep(min(timeout, 0.1))
            return False
        self._needs_relist = False
        return True

    def _initial_sync(self) -> None:
        """First list+watch, resilient to a server that's briefly
        unavailable (injected api_unavailable): arm the relist-retry flag
        instead of letting the factory's start/pump crash."""
        try:
            self._list_and_start_watch()
        except Exception:  # noqa: BLE001 - server down at startup
            logger.exception(
                "initial list+watch for %s failed; will retry", self.kind
            )
            self._needs_relist = True

    def pump(self) -> int:
        """Synchronously process pending events; returns count."""
        if self._watch is None:
            self._initial_sync()
        evs = self._next_events(None)
        self._apply_batch(evs)
        return len(evs)

    def start(self) -> None:
        if self._thread is not None:
            return
        if self._watch is None:
            self._initial_sync()

        def run() -> None:
            while not self._stop.is_set():
                evs = self._next_events(0.1)
                if evs:
                    self._apply_batch(evs)

        self._thread = threading.Thread(
            target=run, name=f"informer-{self.kind}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class InformerFactory:
    """SharedInformerFactory: one informer per kind, shared."""

    def __init__(self, server: APIServer):
        self._server = server
        self._informers: Dict[str, Informer] = {}
        self._started = False

    def informer(self, kind: str) -> Informer:
        inf = self._informers.get(kind)
        if inf is None:
            inf = Informer(self._server, kind)
            self._informers[kind] = inf
            # informers requested after Start (e.g. lazily by a plugin's
            # first Filter call) must sync too -- the reference starts
            # late informers on the next factory.Start; here we start
            # them immediately so listers are never silently empty
            if self._started:
                inf.start()
        return inf

    def pods(self) -> Informer:
        return self.informer("Pod")

    def nodes(self) -> Informer:
        return self.informer("Node")

    def pdbs(self) -> Informer:
        return self.informer("PodDisruptionBudget")

    def pod_groups(self) -> Informer:
        return self.informer("PodGroup")

    def services(self) -> Informer:
        return self.informer("Service")

    def replication_controllers(self) -> Informer:
        return self.informer("ReplicationController")

    def replica_sets(self) -> Informer:
        return self.informer("ReplicaSet")

    def stateful_sets(self) -> Informer:
        return self.informer("StatefulSet")

    def persistent_volumes(self) -> Informer:
        return self.informer("PersistentVolume")

    def persistent_volume_claims(self) -> Informer:
        return self.informer("PersistentVolumeClaim")

    def storage_classes(self) -> Informer:
        return self.informer("StorageClass")

    def csi_nodes(self) -> Informer:
        return self.informer("CSINode")

    def priority_classes(self) -> Informer:
        return self.informer("PriorityClass")

    def resource_quotas(self) -> Informer:
        return self.informer("ResourceQuota")

    def start(self) -> None:
        self._started = True
        for inf in list(self._informers.values()):
            inf.start()

    def pump(self) -> int:
        return sum(inf.pump() for inf in self._informers.values())

    def wait_for_cache_sync(self, timeout: float = 30.0) -> bool:
        """Block until every informer's initial sync completed (the
        reference WaitForCacheSync contract). A failed initial
        list+watch (server briefly unavailable) is retried here for
        pump-mode informers and by the pump thread for threaded ones;
        on timeout, log loudly and return False -- callers must not
        assume a synced cache past a False return."""
        deadline = time.time() + timeout
        while True:
            pending = [
                inf for inf in self._informers.values() if not inf.synced
            ]
            if not pending:
                return True
            for inf in pending:
                if inf._thread is None:
                    inf.pump()
            if all(inf.synced for inf in pending):
                continue  # this round's pumps finished the job
            if time.time() >= deadline:
                logger.error(
                    "caches never synced within %.0fs: %s",
                    timeout, [inf.kind for inf in pending],
                )
                return False
            time.sleep(0.01)

    def stop(self) -> None:
        for inf in self._informers.values():
            inf.stop()
