"""Bind-ack tracking: rebind-after-timeout for zombie kubelets.

Reference: the kubelet layer contract (kubelet.go:1820 syncLoop) -- a
bind is only DONE when the node agent acks it into pod status. A node
that keeps heartbeating but silently stops running its sync loop (the
zombie kubelet) passes every lease check the nodelifecycle monitor can
make, so the only detector is scheduler-side: track every bind we
commit, and when the Running ack never arrives within the ack timeout,
unbind the pod back to Pending so it re-enters the queue and rebinds
elsewhere.

Exactly-once per incarnation (the slow-death fence, uid-keyed): a
pod uid that has been rebound once is never unbound again -- if the
SECOND node also never acks, the pod stays bound and the timeout is
surfaced as a counter, because unbind loops are how a control plane
shreds itself. A respawned pod (same spec, new uid) gets a fresh
allowance.

Races are settled at the store, not here:

- the unbind carries expect_uid + expect_node, and the apiserver refuses
  with a typed ``acked`` conflict when the pod is already Running -- an
  ack that lands between our sweep decision and the unbind simply wins,
  and the tracker books it as ``acked-late``;
- a late ack AFTER the unbind is refused inside the fleet's own status
  mutate (node/uid fence under the store lock), so a requeued pod can
  never be marked Running by its old node.

Capacity release and requeue need no side channel: the unbind's
MODIFIED bound->unbound echo walks the normal informer bridge -- the
cache removes the pod (slot-scatter frees the zombie node's row) and the
queue re-admits it.

The suspect-node taint closes the "lands elsewhere" guarantee: after
``node_suspect_threshold`` ack timeouts a node is tainted
``ktpu.dev/bind-ack-timeout:NoSchedule``, so the rebind cannot re-pick
the zombie; the taint lifts the moment the node acks anything again.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api.types import (
    Node,
    Pod,
    POD_RUNNING,
    TAINT_EFFECT_NO_SCHEDULE,
    Taint,
)
from kubernetes_tpu_torch.apiserver.server import Conflict as ApiConflict
from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)

TAINT_BIND_ACK_TIMEOUT = "ktpu.dev/bind-ack-timeout"


class BindAckTracker:
    """The scheduler's ack ledger: every committed bind is pending until
    its Running ack arrives over the watch; overdue pods are unbound
    (exactly once per uid) and suspect nodes tainted."""

    def __init__(
        self,
        client,
        ack_timeout_seconds: float = 5.0,
        sweep_interval_seconds: float = 0.5,
        node_suspect_threshold: int = 1,
        taint_suspect_nodes: bool = True,
    ) -> None:
        self.client = client
        self.ack_timeout = ack_timeout_seconds
        self.sweep_interval = sweep_interval_seconds
        self.node_suspect_threshold = max(1, int(node_suspect_threshold))
        self.taint_suspect_nodes = taint_suspect_nodes
        self._lock = threading.Lock()
        #: uid -> (namespace, name, node, bound_at_monotonic)
        self._pending: Dict[str, Tuple[str, str, str, float]] = {}
        #: uids already rebound once -- the per-incarnation fence
        self._rebound: Set[str] = set()
        #: uids whose timeout was already surfaced (rebound pods that
        #: time out AGAIN book one timeout, then leave the ledger)
        self._node_timeouts: Dict[str, int] = {}
        self._tainted: Set[str] = set()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # test/inspection counters (metrics carry the same story)
        self.acks = 0
        self.acks_late = 0
        self.timeouts = 0
        self.rebinds = 0

    # -- commit side (called from the bind cycle) ----------------------------

    def track_bound(self, bound: List[Tuple[str, str, str, str]]) -> None:
        """Arm the ledger for freshly committed binds:
        ``(namespace, name, uid, node)`` per pod."""
        now = time.monotonic()
        with self._lock:
            for namespace, name, uid, node in bound:
                self._pending[uid] = (namespace, name, node, now)
            metrics.bind_ack_pending.set(len(self._pending))

    # -- watch side (called from the informer bridge) ------------------------

    def observe_pod(self, old: Optional[Pod], new: Pod) -> None:
        """A cache-side pod frame: the Running transition is the ack."""
        if new.status.phase != POD_RUNNING:
            return
        if old is not None and old.status.phase == POD_RUNNING:
            return
        self._observe_ack(new.metadata.uid, new.spec.node_name)

    def observe_gone(self, uid: str) -> None:
        """The pod left the cache (deleted, or unbound by our own
        sweep): nothing to await any more."""
        with self._lock:
            if self._pending.pop(uid, None) is not None:
                metrics.bind_ack_pending.set(len(self._pending))

    def _observe_ack(self, uid: str, node: str, late: bool = False) -> None:
        with self._lock:
            rec = self._pending.pop(uid, None)
            metrics.bind_ack_pending.set(len(self._pending))
            # any ack from a node clears its suspect record: the sync
            # loop is alive again
            self._node_timeouts.pop(node, None)
            untaint = node in self._tainted
            if untaint:
                self._tainted.discard(node)
        if rec is not None:
            if late:
                self.acks_late += 1
                metrics.bind_acks_observed.inc(how="acked-late")
            else:
                self.acks += 1
                metrics.bind_acks_observed.inc(how="acked")
                metrics.bind_ack_latency.observe(time.monotonic() - rec[3])
        if untaint and self.taint_suspect_nodes:
            self._untaint_node(node)

    # -- sweep side ----------------------------------------------------------

    def sweep(self) -> int:
        """Unbind every overdue pod (at most once per incarnation);
        returns how many rebinds were issued."""
        now = time.monotonic()
        with self._lock:
            overdue = [
                (uid, rec) for uid, rec in self._pending.items()
                if now - rec[3] > self.ack_timeout
            ]
        issued = 0
        for uid, (namespace, name, node, _bound_at) in overdue:
            self.timeouts += 1
            metrics.bind_ack_timeouts.inc()
            if uid in self._rebound:
                # second strike on the same incarnation: the fence. The
                # pod stays where it is -- surfaced, never looped.
                logger.warning(
                    "pod %s/%s (uid %s) timed out its ack AGAIN after a "
                    "rebind; leaving it bound to %s",
                    namespace, name, uid, node,
                )
                self.observe_gone(uid)
                continue
            self._suspect_node(node)
            try:
                self.client.unbind_pod(
                    namespace, name, expect_uid=uid, expect_node=node
                )
            except ApiConflict as err:
                if getattr(err, "kind", "") == "acked":
                    # the ack won the race at the store: book it
                    self._observe_ack(uid, node, late=True)
                else:
                    # uid-mismatch (respawned) or already-bound elsewhere
                    # (another actor moved it): nothing left to recover
                    self.observe_gone(uid)
                continue
            except KeyError:
                self.observe_gone(uid)
                continue
            except Exception:
                logger.exception(
                    "unbinding overdue pod %s/%s", namespace, name
                )
                continue
            with self._lock:
                self._rebound.add(uid)
                self._pending.pop(uid, None)
                metrics.bind_ack_pending.set(len(self._pending))
            self.rebinds += 1
            issued += 1
            metrics.rebinds.inc()
            flightrecorder.mark(
                "rebind", pod=uid, namespace=namespace, name=name,
                from_node=node,
            )
            logger.warning(
                "pod %s/%s never acked on %s within %.2fs; unbound for "
                "rebind", namespace, name, node, self.ack_timeout,
            )
        return issued

    def _suspect_node(self, node: str) -> None:
        with self._lock:
            count = self._node_timeouts.get(node, 0) + 1
            self._node_timeouts[node] = count
            if (
                not self.taint_suspect_nodes
                or count < self.node_suspect_threshold
                or node in self._tainted
            ):
                return
            self._tainted.add(node)
        metrics.suspect_nodes_tainted.inc()
        flightrecorder.mark("node_suspect", node=node)

        def mutate(n: Node) -> None:
            if any(t.key == TAINT_BIND_ACK_TIMEOUT for t in n.spec.taints):
                return
            n.spec.taints = list(n.spec.taints) + [
                Taint(
                    key=TAINT_BIND_ACK_TIMEOUT,
                    effect=TAINT_EFFECT_NO_SCHEDULE,
                )
            ]

        try:
            self.client.server.guaranteed_update("Node", "", node, mutate)
        except KeyError:
            with self._lock:
                self._tainted.discard(node)

    def _untaint_node(self, node: str) -> None:
        def mutate(n: Node) -> None:
            n.spec.taints = [
                t for t in n.spec.taints
                if t.key != TAINT_BIND_ACK_TIMEOUT
            ]

        try:
            self.client.server.guaranteed_update("Node", "", node, mutate)
        except KeyError:
            pass

    # -- lifecycle -----------------------------------------------------------

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.sweep()
            except Exception:
                logger.exception("bind-ack sweep")
            self._stop.wait(self.sweep_interval)

    def start(self) -> threading.Thread:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self.run, name="bind-ack-sweep", daemon=True
        )
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
