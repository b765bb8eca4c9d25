"""Hollow kubelet: a fake node agent that acks bindings and heartbeats.

Reference: the reference Kubernetes tree,
pkg/kubemark/hollow_kubelet.go:64 (kubelet with a fake container
runtime) + the kubelet's own status loop
(pkg/kubelet/kubelet.go:885: NodeStatus + coordination.k8s.io Lease
heartbeats). One HollowKubelet:

- watches pods bound to its node (the kubelet's spec.nodeName-filtered
  watch) and marks them Running with a start time -- the control loop's
  final ack (SURVEY.md section 1 control flow: "kubelet observes (7)")
- heartbeats a Lease and a Ready NodeCondition, the signals a node
  lifecycle controller consumes for failure detection

A HollowNodePool runs many of them off ONE shared pod watch (per-node
watches would be N streams against the in-proc server), the same
economy kubemark gets from running hollow nodes as pods.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import (
    Lease,
    Node,
    NodeCondition,
    ObjectMeta,
    POD_RUNNING,
    Pod,
)

logger = logging.getLogger(__name__)

LEASE_NAMESPACE = "kube-node-lease"  # the reference's node-lease namespace


class HollowKubelet:
    """One fake node agent (single-node convenience wrapper; benches use
    HollowNodePool)."""

    def __init__(
        self,
        client,
        node_name: str,
        lease_duration: float = 40.0,
        now=time.time,
    ) -> None:
        self.client = client
        self.node_name = node_name
        self.lease_duration = lease_duration
        self._pool = HollowNodePool(
            client, [node_name], lease_duration=lease_duration, now=now
        )

    def start(self) -> None:
        self._pool.start()

    def stop(self) -> None:
        self._pool.stop()

    def sync_once(self) -> int:
        return self._pool.sync_once()

    def heartbeat_once(self) -> None:
        self._pool.heartbeat_once()


class HollowNodePool:
    """N hollow kubelets sharing one pod watch + one heartbeat loop."""

    def __init__(
        self,
        client,
        node_names: List[str],
        lease_duration: float = 40.0,
        heartbeat_interval: float = 10.0,
        now=time.time,
    ) -> None:
        self.client = client
        self.node_names = set(node_names)
        self.lease_duration = lease_duration
        self.heartbeat_interval = heartbeat_interval
        self._now = now
        self._watch = None
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self.pods_started = 0

    # -- pod ack loop (syncLoop analogue, kubelet.go:1820) -------------------

    def _ack_pod(self, pod: Pod) -> bool:
        """Mark a freshly bound pod Running (the fake runtime 'starts' it
        instantly, hollow_kubelet.go:64's none-runtime)."""
        if pod.spec.node_name not in self.node_names:
            return False
        if pod.status.phase == POD_RUNNING:
            return False

        def set_running(p: Pod) -> None:
            p.status.phase = POD_RUNNING
            if p.status.start_time is None:
                p.status.start_time = time.time()

        try:
            self.client.update_pod_status(
                pod.metadata.namespace, pod.metadata.name, set_running
            )
            self.pods_started += 1
            return True
        except KeyError:
            return False  # deleted before the ack landed
        except Exception:
            logger.exception("acking pod %s", pod.key())
            return False

    def sync_once(self) -> int:
        """Deterministic catch-up over the list (tests); the run loop is
        watch-driven."""
        n = 0
        pods, _ = self.client.list_pods()
        for pod in pods:
            if pod.spec.node_name and self._ack_pod(pod):
                n += 1
        return n

    def _pod_loop(self) -> None:
        server = self.client.server
        self._watch = server.watch("Pod", since_rv=0)
        while not self._stop.is_set():
            try:
                evs = self._watch.next_batch(timeout=0.2)
            except Exception:  # noqa: BLE001 - lagged past the history
                # trim (410 Gone): relist-and-diff like an informer --
                # every bound pod still gets acked, never a dead thread
                pods, rv = server.list("Pod")
                self._watch = server.watch("Pod", since_rv=rv)
                for pod in pods:
                    if pod.spec.node_name:
                        self._ack_pod(pod)
                continue
            for ev in evs:
                if ev.type in ("ADDED", "MODIFIED"):
                    pod = ev.object
                    if pod.spec.node_name:
                        self._ack_pod(pod)

    # -- heartbeats (kubelet.go:885) -----------------------------------------

    def heartbeat_once(self) -> None:
        now = self._now()
        server = self.client.server
        for name in self.node_names:
            # Lease renew (create-or-update, lease_controller semantics)
            try:
                server.guaranteed_update(
                    "Lease", LEASE_NAMESPACE, name,
                    lambda le: setattr(le, "renew_time", now),
                )
            except KeyError:
                try:
                    server.create(
                        Lease(
                            metadata=ObjectMeta(
                                name=name, namespace=LEASE_NAMESPACE
                            ),
                            holder_identity=name,
                            lease_duration_seconds=self.lease_duration,
                            acquire_time=now,
                            renew_time=now,
                        )
                    )
                except Exception:
                    pass
            # Ready condition on NodeStatus -- written only when it
            # actually changes: the reference kubelet introduced Leases
            # precisely so steady-state heartbeats don't rewrite the
            # Node object (an unconditional write here would fan out
            # O(nodes) MODIFIED events per interval into the scheduler's
            # informer/cache/tensor-diff path)
            try:
                node = server.get("Node", "", name)
                if not any(
                    c.type == "Ready" and c.status == "True"
                    for c in node.status.conditions
                ):
                    def set_ready(n: Node) -> None:
                        n.status.conditions = [
                            c for c in n.status.conditions
                            if c.type != "Ready"
                        ] + [NodeCondition(type="Ready", status="True")]

                    server.guaranteed_update("Node", "", name, set_ready)
            except KeyError:
                pass

    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.heartbeat_once()
            except Exception:
                logger.exception("hollow heartbeat")
            self._stop.wait(self.heartbeat_interval)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        for target, name in (
            (self._pod_loop, "hollow-pods"),
            (self._heartbeat_loop, "hollow-heartbeat"),
        ):
            t = threading.Thread(target=target, name=name, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
