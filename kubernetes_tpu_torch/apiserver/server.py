"""The in-process API server.

Semantics modeled on the reference storage layer:

- monotonically increasing resourceVersion per write
  (etcd3/store.go: ModRevision)
- create is txn-if-absent (store.go:144); update uses optimistic
  concurrency on resourceVersion (store.go:220 GuaranteedUpdate)
- watch(since_rv) replays buffered events after rv, then streams live
  (storage/cacher/cacher.go:238 watchCache fan-out)
- the pods/binding subresource sets spec.nodeName under a guaranteed
  update and refuses to re-bind a bound pod
  (pkg/registry/core/pod/storage/storage.go:159-229 assignPod)

Objects returned by get/list and carried in watch events are shared
references: callers must treat them as read-only and deep-copy before
mutating (the same contract client-go informer caches impose).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import POD_PENDING, POD_RUNNING, Binding, Node, Pod
from kubernetes_tpu_torch.robustness.faults import FaultPoint, get_injector

try:
    from kubernetes_tpu_torch.native import cow_clone as _cow_clone
    from kubernetes_tpu_torch.native import bind_assumed_bulk as _bind_assumed_bulk
except Exception:  # noqa: BLE001 - pure-Python fallback
    _cow_clone = None
    _bind_assumed_bulk = None

_POD_COW_ATTRS = ("metadata", "spec", "status")

#: scheduler-side memo keys that ride object __dict__ copies. The bind
#: path only writes spec.node_name, which invalidates just the static-
#: mask signature; arbitrary updates (guaranteed_update's mutate, a
#: client update) may change anything, so every memo must go.
_SIG_MEMO = "_sig_memo"
_ALL_MEMOS = ("_sig_memo", "_hot_memo", "_req_memo", "_nzr_memo", "_packrow")


def _strip_memos(obj: Any) -> None:
    d = obj.__dict__
    for k in _ALL_MEMOS:
        d.pop(k, None)

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


class NotFound(KeyError):
    pass


class Conflict(ValueError):
    pass


class BindConflict(Conflict):
    """A typed bind conflict: the optimistic-concurrency answer of the
    multi-active control plane, NOT a transport failure. ``kind`` names
    the shape so the committer can absorb it through the requeue path
    (and the conflict ledger can account for it):

    - ``already-bound``: the pod is bound to a different node (a sibling
      stack won the race, or a takeover re-bind raced the original);
    - ``uid-mismatch``: the pod was deleted and recreated under the same
      key (a new incarnation -- the binding targeted the old one);
    - ``foreign-partition``: the binder's partition lease over the
      target node is held live by another stack (the server-side half of
      the commit fence, checked under the store lock)."""

    def __init__(self, message: str, kind: str = "already-bound",
                 current_node: str = "") -> None:
        super().__init__(message)
        self.kind = kind
        self.current_node = current_node


class Gone(Exception):
    """410 Gone analogue (apiserver storage.NewTooLargeResourceVersionError
    inverse): the requested since_rv predates the oldest retained watch
    event, so replay would silently miss events. The watcher must relist
    and diff instead. Deliberately NOT a KeyError/ValueError subclass --
    callers that treat those as not-found/conflict must not swallow it."""


def _api_unavailable_maybe() -> None:
    """Injected whole-transaction failure (the api_unavailable point):
    list/bind/guaranteed_update raise as if the server were unreachable;
    retry policies and informer relists are expected to absorb it."""
    inj = get_injector()
    if inj is not None:
        inj.raise_maybe(FaultPoint.API_UNAVAILABLE)


@dataclass(slots=True)
class WatchEvent:
    type: str  # ADDED | MODIFIED | DELETED
    object: Any
    resource_version: int
    #: decode-once ingest record (the (namespace, name) key), filled
    #: lazily by the FIRST consumer that walks obj.metadata (native
    #: ingest_decode/ingest_apply or their Python twins) and shared by
    #: every later cursor draining the same per-kind event log -- N
    #: partitioned informer sets decode each apiserver transaction once
    decoded: Any = None


class Watch:
    """One client watch stream: a CURSOR into the kind's shared event
    log, not a private mailbox.

    The original design delivered every event into a per-watch deque --
    one lock round trip and one copy per event PER WATCHER, so N active
    scheduler stacks multiplied the in-process fan-out cost of every
    store transaction by N (the event loop cost ROADMAP item 4 calls
    out). Here producers append to the kind's bounded history ONCE
    (which replay already required) and notify a per-kind condition;
    each watcher drains ``history[cursor:]`` in batches on its own
    schedule. Broadcast is O(events), independent of watcher count
    (tools/bench_hotpath.py ``watch_fanout_*`` pins this).

    A watcher that lags so far that the history trim passes its cursor
    raises ``Gone`` on the next read -- exactly the 410 semantics a
    reconnecting watcher already handles (informers relist+diff).
    """

    __slots__ = ("_server", "kind", "_cursor", "stopped")

    def __init__(self, server: "APIServer", kind: str, cursor: int):
        self._server = server
        self.kind = kind
        #: absolute event ordinal (monotone per kind, survives trims)
        self._cursor = cursor
        self.stopped = False

    def _drain_locked(self) -> List[WatchEvent]:
        """Caller holds the kind condition."""
        srv = self._server
        base = srv._history_base[self.kind]
        hist = srv._history[self.kind]
        if self._cursor < base:
            raise Gone(
                f"{self.kind} watch lagged past the history trim "
                f"(cursor {self._cursor} < base {base}); relist"
            )
        idx = self._cursor - base
        out = hist[idx:] if idx < len(hist) else []
        self._cursor = base + len(hist)
        return list(out)

    def _has_pending_locked(self) -> bool:
        srv = self._server
        return (
            self._cursor
            < srv._history_base[self.kind] + len(srv._history[self.kind])
        )

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """Next event, or None on stop/timeout."""
        cond = self._server._kind_conds[self.kind]
        with cond:
            if not self._has_pending_locked() and not self.stopped:
                cond.wait(timeout)
            srv = self._server
            base = srv._history_base[self.kind]
            hist = srv._history[self.kind]
            if self._cursor < base:
                raise Gone(
                    f"{self.kind} watch lagged past the history trim"
                )
            idx = self._cursor - base
            if idx >= len(hist):
                return None
            self._cursor += 1
            return hist[idx]

    def next_batch(
        self, timeout: Optional[float] = None
    ) -> List[WatchEvent]:
        """Block for at least one event (or stop/timeout), then drain
        everything pending."""
        cond = self._server._kind_conds[self.kind]
        with cond:
            if not self._has_pending_locked() and not self.stopped:
                cond.wait(timeout)
            return self._drain_locked()

    def pending(self) -> List[WatchEvent]:
        """Drain without blocking (used by the synchronous pump mode)."""
        cond = self._server._kind_conds[self.kind]
        with cond:
            return self._drain_locked()

    def stop(self) -> None:
        self._server._remove_watch(self)
        cond = self._server._kind_conds.get(self.kind)
        self.stopped = True
        if cond is not None:
            with cond:
                cond.notify_all()


def _obj_key(obj: Any) -> Tuple[str, str]:
    meta = obj.metadata
    return (meta.namespace, meta.name)


def _route_key(kind: str, obj: Any) -> str:
    """The per-host routing key of an event: which single consumer (if
    any) a routed watcher set would want it delivered to. Pods route by
    the node they are bound to (a kubelet's spec.nodeName-filtered
    watch); everything else routes by object name (node-lease renewals
    and NodeStatus writes route to that node's watcher)."""
    if kind == "Pod":
        return obj.spec.node_name or ""
    return obj.metadata.name


class RoutedWatch:
    """A route-filtered watch cursor with a PRIVATE buffer.

    Unlike ``Watch`` (a cursor into the kind's shared log, where every
    watcher drains every event), a RoutedWatch registers the route keys
    it wants (node names) and the broadcast path delivers each event to
    the interested watchers ONLY -- one dict probe per event, zero work
    per uninterested watcher. This is what keeps fleet-scale heartbeat
    traffic O(interested) instead of O(watchers): ten thousand hollow
    kubelets sharing a kind do not each rescan every sibling's Lease
    renewals (tools/bench_hotpath.py ``heartbeat_fanout_*`` pins this).

    Events that never had a route (an unbound pod) are invisible here by
    design -- a kubelet only cares once spec.nodeName points at it. A
    consumer that stalls past the server's history limit overflows its
    buffer and gets ``Gone`` on the next read (relist, same 410 contract
    as a lagged shared-log cursor).
    """

    __slots__ = ("_server", "kind", "routes", "_events", "_overflowed",
                 "stopped")

    def __init__(self, server: "APIServer", kind: str, routes) -> None:
        self._server = server
        self.kind = kind
        self.routes = frozenset(routes)
        self._events: List[WatchEvent] = []
        self._overflowed = False
        self.stopped = False

    def _deliver_locked(self, ev: WatchEvent) -> None:
        """Caller holds the kind condition (the broadcast path)."""
        if self._overflowed:
            return
        if len(self._events) >= self._server._history_limit:
            self._overflowed = True
            self._events = []
            return
        self._events.append(ev)

    def _drain_locked(self) -> List[WatchEvent]:
        if self._overflowed:
            self._overflowed = False
            raise Gone(
                f"{self.kind} routed watch overflowed its buffer; relist"
            )
        out = self._events
        self._events = []
        return out

    def next_batch(
        self, timeout: Optional[float] = None
    ) -> List[WatchEvent]:
        cond = self._server._kind_conds[self.kind]
        with cond:
            if not self._events and not self._overflowed \
                    and not self.stopped:
                cond.wait(timeout)
            return self._drain_locked()

    def pending(self) -> List[WatchEvent]:
        cond = self._server._kind_conds[self.kind]
        with cond:
            return self._drain_locked()

    def stop(self) -> None:
        self._server._remove_watch(self)
        cond = self._server._kind_conds.get(self.kind)
        self.stopped = True
        if cond is not None:
            with cond:
                cond.notify_all()


class APIServer:
    """Multi-kind object store with watch fan-out."""

    #: pre-registered kinds; any other kind gets a store on first use
    #: (the REST-registry analogue: pkg/registry/ storage per resource)
    KINDS = (
        "Pod", "Node", "PodDisruptionBudget", "PodGroup", "Lease", "Service",
        "PersistentVolume", "PersistentVolumeClaim", "StorageClass",
        "CSINode", "ReplicationController", "ReplicaSet", "StatefulSet",
        "Secret", "PriorityClass", "ResourceQuota",
    )

    def __init__(self, watch_history_limit: int = 200_000) -> None:
        self._lock = threading.RLock()
        self._rv = 0
        self._stores: Dict[str, Dict[Tuple[str, str], Any]] = {
            k: {} for k in self.KINDS
        }
        # the shared per-kind event log IS the watch fan-out: watchers
        # hold cursors into it (see Watch), so broadcast is O(events)
        # regardless of watcher count. `_history_base[kind]` is the
        # absolute ordinal of history[0] (bumped by trims, so cursors
        # survive them); `_kind_conds` serializes log mutation against
        # watcher reads without the store lock.
        self._history: Dict[str, List[WatchEvent]] = {k: [] for k in self.KINDS}
        self._history_base: Dict[str, int] = {k: 0 for k in self.KINDS}
        self._kind_conds: Dict[str, threading.Condition] = {
            k: threading.Condition() for k in self.KINDS
        }
        self._history_limit = watch_history_limit
        # highest rv ever trimmed out of a kind's history: a watch asking
        # to replay from below this would silently miss events -> Gone
        self._history_trunc_rv: Dict[str, int] = {k: 0 for k in self.KINDS}
        # per-host routed delivery: kind -> route key -> interested
        # RoutedWatch list (guarded by the kind condition). Empty unless
        # someone opened a routed watch, so the broadcast fast path pays
        # one falsy dict probe per transaction.
        self._route_watchers: Dict[str, Dict[str, List[RoutedWatch]]] = {}
        # multi-active partitioned scheduling (scheduler/partition.py):
        # when installed, bulk binds carrying a binder identity are
        # checked against the live partition leases under the store lock
        self._partition_authority = None

    def _ensure_kind(self, kind: str) -> None:
        if kind not in self._stores:
            self._stores[kind] = {}
            self._history[kind] = []
            self._history_base[kind] = 0
            self._kind_conds[kind] = threading.Condition()
            self._history_trunc_rv[kind] = 0

    def install_partition_authority(self, authority) -> None:
        """Install the server-side partition bind fence (an object with
        ``check(binder, node_name) -> Optional[str]``); None clears."""
        with self._lock:
            self._partition_authority = authority

    # -- core ---------------------------------------------------------------

    def _next_rv(self) -> int:
        self._rv += 1
        return self._rv

    def _trim_history_locked(self, kind: str, hist: List[WatchEvent]) -> None:
        """Caller holds the kind condition."""
        if len(hist) > self._history_limit:
            cut = len(hist) // 2
            # record the highest discarded rv so watch(since_rv) can
            # detect a replay gap instead of silently skipping it, and
            # advance the base so live cursors keep their meaning (a
            # cursor below the new base is Gone on its next read)
            self._history_trunc_rv[kind] = hist[cut - 1].resource_version
            self._history_base[kind] += cut
            del hist[:cut]

    def _route_locked(self, kind: str, event: WatchEvent) -> None:
        """Deliver one event to the routed watchers interested in its
        route key (caller holds the kind condition). One dict probe per
        event when the routing index is armed; nothing otherwise."""
        idx = self._route_watchers.get(kind)
        if not idx:
            return
        route = _route_key(kind, event.object)
        if not route:
            return
        watchers = idx.get(route)
        if watchers:
            for w in watchers:
                w._deliver_locked(event)

    def _broadcast(self, kind: str, event: WatchEvent) -> None:
        cond = self._kind_conds[kind]
        with cond:
            hist = self._history[kind]
            hist.append(event)
            self._trim_history_locked(kind, hist)
            self._route_locked(kind, event)
            cond.notify_all()

    def _broadcast_many(self, kind: str, events: List[WatchEvent]) -> None:
        """One log extend + ONE wakeup for a whole transaction's worth
        of events: watchers drain the log in batches, so the per-event
        cost no longer scales with the watcher count (the bulk-bind
        fan-out path under N active stacks)."""
        if not events:
            return
        cond = self._kind_conds[kind]
        with cond:
            hist = self._history[kind]
            hist.extend(events)
            self._trim_history_locked(kind, hist)
            if self._route_watchers.get(kind):
                for ev in events:
                    self._route_locked(kind, ev)
            cond.notify_all()

    def current_rv(self) -> int:
        with self._lock:
            return self._rv

    # -- CRUD ---------------------------------------------------------------

    def create(self, obj: Any) -> Any:
        kind = obj.kind
        with self._lock:
            self._ensure_kind(kind)
            store = self._stores[kind]
            key = _obj_key(obj)
            if key in store:
                raise Conflict(f"{kind} {key} already exists")
            obj.metadata.resource_version = self._next_rv()
            store[key] = obj
            self._broadcast(kind, WatchEvent(ADDED, obj, obj.metadata.resource_version))
            return obj

    def create_bulk(self, objs: List[Any]) -> List[Any]:
        """Create many objects of one kind in a single store transaction
        with one bulk watch fan-out -- the ingestion analogue of
        bind_bulk. All-or-nothing per object (a conflict raises after none
        of the later objects are applied), matching N sequential creates
        that stop at the first failure."""
        if not objs:
            return objs
        kind = objs[0].kind
        events: List[WatchEvent] = []
        with self._lock:
            self._ensure_kind(kind)
            store = self._stores[kind]
            for obj in objs:
                if obj.kind != kind:
                    raise ValueError("create_bulk objects must share a kind")
                key = _obj_key(obj)
                if key in store:
                    self._broadcast_many(kind, events)
                    raise Conflict(f"{kind} {key} already exists")
                obj.metadata.resource_version = self._next_rv()
                store[key] = obj
                events.append(
                    WatchEvent(ADDED, obj, obj.metadata.resource_version)
                )
            self._broadcast_many(kind, events)
        return objs

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            self._ensure_kind(kind)
            obj = self._stores[kind].get((namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return obj

    def list(self, kind: str) -> Tuple[List[Any], int]:
        """Returns (objects, resourceVersion) -- the list+watch handshake."""
        _api_unavailable_maybe()
        with self._lock:
            self._ensure_kind(kind)
            return list(self._stores[kind].values()), self._rv

    def update(self, obj: Any, expect_rv: Optional[int] = None) -> Any:
        """Replace; optimistic-concurrency check when expect_rv given."""
        kind = obj.kind
        with self._lock:
            self._ensure_kind(kind)
            store = self._stores[kind]
            key = _obj_key(obj)
            current = store.get(key)
            if current is None:
                raise NotFound(f"{kind} {key} not found")
            if expect_rv is not None and current.metadata.resource_version != expect_rv:
                raise Conflict(
                    f"{kind} {key}: resourceVersion {expect_rv} is stale "
                    f"(current {current.metadata.resource_version})"
                )
            # the replacement may be a clone carrying scheduler memos
            # computed against the OLD spec
            _strip_memos(obj)
            obj.metadata.resource_version = self._next_rv()
            store[key] = obj
            self._broadcast(
                kind, WatchEvent(MODIFIED, obj, obj.metadata.resource_version)
            )
            return obj

    def guaranteed_update(
        self, kind: str, namespace: str, name: str, mutate: Callable[[Any], None]
    ) -> Any:
        """Atomic read-modify-write (etcd3 store.go:220 GuaranteedUpdate).

        Copy-on-write: the previously stored object stays intact so informer
        caches can hand handlers a distinct (old, new) pair -- the reference
        gets this for free from serialization; mutators must not mutate
        nested collections in place.
        """
        import copy as _copy

        _api_unavailable_maybe()
        with self._lock:
            old = self.get(kind, namespace, name)
            cow_attrs = tuple(
                a for a in _POD_COW_ATTRS if hasattr(old, a)
            )
            if _cow_clone is not None:
                obj = _cow_clone(old, cow_attrs)
            else:
                obj = _copy.copy(old)
                for attr in cow_attrs:
                    setattr(obj, attr, _copy.copy(getattr(old, attr)))
            _strip_memos(obj)
            mutate(obj)
            obj.metadata.resource_version = self._next_rv()
            self._stores[kind][(namespace, name)] = obj
            self._broadcast(
                kind, WatchEvent(MODIFIED, obj, obj.metadata.resource_version)
            )
            return obj

    def delete(
        self, kind: str, namespace: str, name: str,
        expect_uid: Optional[str] = None,
    ) -> Any:
        """``expect_uid``: uid-preconditioned delete (the Kubernetes
        delete-options Preconditions.UID analogue), checked atomically
        under the store lock -- a delayed eviction can fence itself
        against a respawned same-name incarnation without a racy
        read-then-delete."""
        with self._lock:
            self._ensure_kind(kind)
            obj = self._stores[kind].get((namespace, name))
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            if expect_uid is not None and obj.metadata.uid != expect_uid:
                raise Conflict(
                    f"{kind} {namespace}/{name}: uid "
                    f"{obj.metadata.uid} does not match precondition "
                    f"{expect_uid}"
                )
            self._stores[kind].pop((namespace, name))
            rv = self._next_rv()
            self._broadcast(kind, WatchEvent(DELETED, obj, rv))
            return obj

    def delete_bulk(
        self, kind: str, keys: List[Tuple[str, str]],
        missing_out: Optional[List[Tuple[str, str]]] = None,
    ) -> int:
        """Delete many objects of one kind in a single transaction with
        one bulk watch fan-out (the eviction analogue of bind_bulk);
        missing keys are skipped (and appended to ``missing_out`` when
        given, so an evictor that pre-spent a disruption budget can
        refund the units whose delete evicted nothing). Returns the
        number deleted."""
        events: List[WatchEvent] = []
        with self._lock:
            self._ensure_kind(kind)
            store = self._stores[kind]
            for namespace, name in keys:
                obj = store.pop((namespace, name), None)
                if obj is None:
                    if missing_out is not None:
                        missing_out.append((namespace, name))
                    continue
                events.append(WatchEvent(DELETED, obj, self._next_rv()))
            self._broadcast_many(kind, events)
        return len(events)

    # -- watch --------------------------------------------------------------

    def watch(self, kind: str, since_rv: int = 0) -> Watch:
        with self._lock:
            self._ensure_kind(kind)
            inj = get_injector()
            if inj is not None and inj.should_fire(
                FaultPoint.WATCH_HISTORY_TRUNCATED
            ):
                raise Gone(
                    f"{kind} watch history truncated (injected 410)"
                )
            if since_rv < self._history_trunc_rv.get(kind, 0):
                # events in (since_rv, trunc_rv] were trimmed: replaying
                # only what's retained would silently skip them
                raise Gone(
                    f"{kind} watch history truncated past rv "
                    f"{self._history_trunc_rv[kind]}; cannot replay from "
                    f"{since_rv}"
                )
            # cursor = first retained event with rv > since_rv (the
            # kind's rv sequence is monotone, so bisect positions the
            # replay start without scanning)
            cond = self._kind_conds[kind]
            with cond:
                hist = self._history[kind]
                rvs = [ev.resource_version for ev in hist]
                idx = bisect_right(rvs, since_rv)
                cursor = self._history_base[kind] + idx
            return Watch(self, kind, cursor)

    def watch_routes(
        self, kind: str, routes, since_rv: int = 0
    ) -> RoutedWatch:
        """Open a route-filtered watch: only events whose route key
        (Pod -> spec.nodeName, else metadata.name) is in ``routes`` are
        delivered. Retained history after ``since_rv`` is replayed
        (filtered) into the buffer at registration, so the list+watch
        handshake works exactly like the shared-log cursor; a since_rv
        below the trim raises Gone."""
        with self._lock:
            self._ensure_kind(kind)
            if since_rv < self._history_trunc_rv.get(kind, 0):
                raise Gone(
                    f"{kind} watch history truncated past rv "
                    f"{self._history_trunc_rv[kind]}; cannot replay from "
                    f"{since_rv}"
                )
            cond = self._kind_conds[kind]
            with cond:
                w = RoutedWatch(self, kind, routes)
                hist = self._history[kind]
                rvs = [ev.resource_version for ev in hist]
                idx = bisect_right(rvs, since_rv)
                for ev in hist[idx:]:
                    if _route_key(kind, ev.object) in w.routes:
                        w._deliver_locked(ev)
                index = self._route_watchers.setdefault(kind, {})
                for route in w.routes:
                    index.setdefault(route, []).append(w)
            return w

    def _remove_watch(self, w) -> None:
        # shared-log cursors hold no server-side state; routed watchers
        # unregister from the delivery index
        if not isinstance(w, RoutedWatch):
            return
        cond = self._kind_conds.get(w.kind)
        if cond is None:
            return
        with cond:
            index = self._route_watchers.get(w.kind)
            if not index:
                return
            for route in w.routes:
                watchers = index.get(route)
                if watchers and w in watchers:
                    watchers.remove(w)
                    if not watchers:
                        del index[route]
            if not index:
                self._route_watchers.pop(w.kind, None)

    # -- pods/binding subresource (storage.go:159 BindingREST.Create) -------

    def _bind_locked(
        self, binding: Binding, binder: Optional[str] = None
    ) -> Tuple[Pod, bool]:
        """Validate + apply one binding; caller holds the store lock.
        Returns (pod, changed) and appends nothing -- the caller decides
        how to fan out the watch event (single vs bulk delivery).
        ``changed`` is False when the pod was ALREADY bound to the same
        node: a retried commit whose first attempt actually landed (or a
        restarted scheduler re-driving a recovered placement) is
        idempotent success, not a conflict -- no write, no event.
        Conflicts raise TYPED ``BindConflict``s so a multi-active
        committer can absorb them through the requeue path instead of
        treating them as scheduler errors."""
        store = self._stores["Pod"]
        old: Optional[Pod] = store.get(
            (binding.pod_namespace, binding.pod_name)
        )
        if old is None:
            raise NotFound(
                f"Pod {binding.pod_namespace}/{binding.pod_name} not found"
            )
        if binding.pod_uid and old.metadata.uid != binding.pod_uid:
            raise BindConflict(
                f"pod {old.key()} uid mismatch: binding has "
                f"{binding.pod_uid}, pod has {old.metadata.uid}",
                kind="uid-mismatch",
            )
        if old.spec.node_name:
            if old.spec.node_name == binding.target_node:
                return old, False
            raise BindConflict(
                f"pod {old.key()} is already bound to {old.spec.node_name}",
                kind="already-bound",
                current_node=old.spec.node_name,
            )
        if not binding.target_node:
            raise ValueError("binding.target_node is required")
        auth = self._partition_authority
        if auth is not None and binder is not None:
            reason = auth.check(binder, binding.target_node)
            if reason:
                raise BindConflict(
                    f"pod {old.key()}: binder {binder!r} does not own "
                    f"the partition of node {binding.target_node!r}",
                    kind=reason,
                )
        # copy-on-write update (guaranteed_update semantics); the native
        # clone replaces a 4-deep copy.copy chain on the burst's hottest
        # store transaction (10k binds per measured window)
        if _cow_clone is not None:
            pod = _cow_clone(old, _POD_COW_ATTRS)
        else:
            import copy as _copy

            pod = _copy.copy(old)
            pod.metadata = _copy.copy(old.metadata)
            pod.spec = _copy.copy(old.spec)
            pod.status = _copy.copy(old.status)
        pod.spec.node_name = binding.target_node
        pod.__dict__.pop(_SIG_MEMO, None)
        pod.metadata.resource_version = self._next_rv()
        store[(binding.pod_namespace, binding.pod_name)] = pod
        return pod, True

    def bind(self, binding: Binding, binder: Optional[str] = None) -> Pod:
        _api_unavailable_maybe()
        with self._lock:
            pod, changed = self._bind_locked(binding, binder=binder)
            if changed:
                self._broadcast(
                    "Pod",
                    WatchEvent(MODIFIED, pod, pod.metadata.resource_version),
                )
            return pod

    def unbind(
        self, namespace: str, name: str,
        expect_uid: Optional[str] = None,
        expect_node: Optional[str] = None,
    ) -> Pod:
        """Atomically release a binding: clear spec.nodeName, reset the
        phase to Pending, drop start_time. The rebind-after-timeout
        primitive of the closed bind loop -- a bound-but-never-acked pod
        goes back to unbound UNDER THE STORE LOCK, fenced three ways:

        - ``expect_uid``: the incarnation the ack deadline was armed for
          (a respawn under the same key must not be unbound);
        - ``expect_node``: the node the bind targeted (a racing rebind
          that already moved the pod must not be undone);
        - the pod must not be ``Running`` yet: a kubelet ack that lands
          first WINS and the unbind comes back as a typed ``acked``
          conflict (the tracker treats that as the ack it was waiting
          for). The store lock is the serialization point, so exactly
          one of {ack, unbind} takes effect.

        The MODIFIED bound->unbound event re-enters the pod into the
        scheduling queue and releases the zombie node's capacity through
        the ordinary cache-removal/slot-scatter path -- no scheduler
        side channel."""
        _api_unavailable_maybe()
        with self._lock:
            store = self._stores["Pod"]
            old: Optional[Pod] = store.get((namespace, name))
            if old is None:
                raise NotFound(f"Pod {namespace}/{name} not found")
            if expect_uid is not None and old.metadata.uid != expect_uid:
                raise BindConflict(
                    f"pod {old.key()} uid mismatch: unbind targeted "
                    f"{expect_uid}, pod has {old.metadata.uid}",
                    kind="uid-mismatch",
                )
            if not old.spec.node_name:
                return old  # already unbound: idempotent success
            if (
                expect_node is not None
                and old.spec.node_name != expect_node
            ):
                raise BindConflict(
                    f"pod {old.key()} is bound to {old.spec.node_name}, "
                    f"not {expect_node}",
                    kind="already-bound",
                    current_node=old.spec.node_name,
                )
            if old.status.phase == POD_RUNNING:
                raise BindConflict(
                    f"pod {old.key()} was acked Running on "
                    f"{old.spec.node_name}; binding stands",
                    kind="acked",
                    current_node=old.spec.node_name,
                )
            if _cow_clone is not None:
                pod = _cow_clone(old, _POD_COW_ATTRS)
            else:
                import copy as _copy

                pod = _copy.copy(old)
                pod.metadata = _copy.copy(old.metadata)
                pod.spec = _copy.copy(old.spec)
                pod.status = _copy.copy(old.status)
            pod.spec.node_name = ""
            pod.status.phase = POD_PENDING
            pod.status.start_time = None
            _strip_memos(pod)
            pod.metadata.resource_version = self._next_rv()
            store[(namespace, name)] = pod
            self._broadcast(
                "Pod",
                WatchEvent(MODIFIED, pod, pod.metadata.resource_version),
            )
            return pod

    def bind_bulk(
        self, bindings: List[Binding], binder: Optional[str] = None
    ) -> List[Tuple[Optional[Pod], Optional[Exception]]]:
        """Pipelined bulk commit: all bindings validated and applied under
        ONE store transaction (the batch analogue of per-pod
        BindingREST.Create, storage.go:159). Per-binding failures don't
        abort the rest -- each slot returns (pod, None) or (None, error),
        mirroring N independent API calls minus N-1 lock round trips.
        Watch events for the whole transaction fan out in one bulk
        delivery per watcher. ``binder`` identifies the committing stack
        for the partition authority's server-side fence."""
        _api_unavailable_maybe()
        out: List[Tuple[Optional[Pod], Optional[Exception]]] = []
        events: List[WatchEvent] = []
        with self._lock:
            for binding in bindings:
                try:
                    pod, changed = self._bind_locked(binding, binder=binder)
                    if changed:
                        events.append(
                            WatchEvent(
                                MODIFIED, pod, pod.metadata.resource_version
                            )
                        )
                    out.append((pod, None))
                except Exception as e:  # noqa: BLE001 - per-slot result
                    out.append((None, e))
            self._broadcast_many("Pod", events)
        return out

    def bind_assumed_bulk(
        self, assumed_pods: List[Pod], binder: Optional[str] = None
    ) -> List[Tuple[int, Exception]]:
        """Bulk bind commit driven directly by the scheduler's assumed
        clones (metadata carries namespace/name/uid, spec.node_name the
        target) -- the allocation-free fast path of ``bind_bulk``: no
        Binding objects, no per-slot result tuples. Returns only the
        failed slots as (index, error); an empty list means every pod
        bound. The whole transaction runs under one store lock with one
        bulk watch fan-out, through the native C loop when available
        (native/_hotpath.c bind_assumed_bulk).

        ``binder`` arms the partition authority's server-side fence:
        pods targeting a node whose partition lease is held live by a
        DIFFERENT stack come back as typed ``foreign-partition``
        conflicts. The check runs in Python BEFORE the native loop (the
        loop stays partition-blind); surviving slots remap through
        ``idx_map`` so error indexes stay caller-relative."""
        _api_unavailable_maybe()
        with self._lock:
            pods = assumed_pods
            idx_map: Optional[List[int]] = None
            pre: List[Tuple[int, Exception]] = []
            auth = self._partition_authority
            if auth is not None and binder is not None:
                allowed: List[Pod] = []
                idx_map = []
                verdict: Dict[str, Optional[str]] = {}
                for i, a in enumerate(assumed_pods):
                    node = a.spec.node_name
                    reason = verdict.get(node, "")
                    if reason == "":
                        reason = auth.check(binder, node)
                        verdict[node] = reason
                    if reason:
                        pre.append((i, BindConflict(
                            f"pod {a.key()}: binder {binder!r} does not "
                            f"own the partition of node {node!r}",
                            kind=reason,
                        )))
                    else:
                        allowed.append(a)
                        idx_map.append(i)
                pods = allowed

            def caller_idx(i: int) -> int:
                return idx_map[i] if idx_map is not None else i

            if _bind_assumed_bulk is not None:
                errors, events, new_rv = _bind_assumed_bulk(
                    self._stores["Pod"], pods, self._rv, WatchEvent
                )
                self._rv = new_rv
                self._broadcast_many("Pod", events)
                if not errors:
                    return pre
                store = self._stores["Pod"]
                out: List[Tuple[int, Exception]] = list(pre)
                for idx, code, msg in errors:
                    exc: Exception
                    if code == 0:
                        exc = NotFound(msg)
                    elif code == 1:
                        # idempotent same-node re-bind (a retried commit
                        # whose first attempt landed, or a restarted
                        # scheduler re-driving a recovered placement):
                        # the C loop reports it as a conflict, but the
                        # store already holds exactly the requested state
                        a = pods[idx]
                        cur = store.get(
                            (a.metadata.namespace, a.metadata.name)
                        )
                        if (
                            cur is not None
                            and cur.spec.node_name == a.spec.node_name
                            and cur.metadata.uid == a.metadata.uid
                        ):
                            continue
                        kind = (
                            "uid-mismatch"
                            if cur is not None
                            and cur.metadata.uid != a.metadata.uid
                            else "already-bound"
                        )
                        exc = BindConflict(
                            msg, kind=kind,
                            current_node=(
                                cur.spec.node_name if cur is not None else ""
                            ),
                        )
                    elif code == 2:
                        exc = ValueError(msg)
                    else:
                        exc = RuntimeError(msg)
                    out.append((caller_idx(idx), exc))
                return out
            # pure-Python fallback: delegate to the shared bind_bulk
            # transaction (one loop to maintain) and convert its per-slot
            # results to the failures-only shape (the authority already
            # ran above; don't pass binder down and double-check)
            results = self.bind_bulk(
                [
                    Binding(
                        pod_namespace=a.metadata.namespace,
                        pod_name=a.metadata.name,
                        pod_uid=a.metadata.uid,
                        target_node=a.spec.node_name,
                    )
                    for a in pods
                ]
            )
            return pre + [
                (caller_idx(i), err)
                for i, (_pod, err) in enumerate(results)
                if err is not None
            ]

    # -- pod status subresource ---------------------------------------------

    def update_pod_status(
        self, namespace: str, name: str, mutate: Callable[[Pod], None]
    ) -> Pod:
        def wrap(p: Pod) -> None:
            mutate(p)

        return self.guaranteed_update("Pod", namespace, name, wrap)
