"""Cluster-lifecycle chaos: node flaps, spot-reclamation storms, and the
pod-respawn controller that makes them survivable.

The fault injector (robustness/faults.py) decides WHEN a lifecycle event
happens -- ``NODE_FLAP`` and ``RECLAIM_STORM`` are ordinary seeded
injection points, so a chaos run is reproducible -- and this module
performs the actual control-plane surgery against the apiserver:

- ``ClusterLifecycleDriver``: a ticking thread that, on a firing point,
  deletes the victim node(s) (the spot kill), kills the pods that were
  running on them, respawns those pods as fresh pending clones, and
  re-adds COLD replacement nodes after a configurable down time. Cold
  means a brand-new Node object (new uid, clean status): the scheduler's
  slot-based tensor cache must absorb it as an O(changed rows) scatter,
  never a full repack.
- ``PodRespawner``: the ReplicaSet-controller analogue this API surface
  lacks -- a watch-driven loop that recreates deleted pods as pending
  clones so drain waves and storms converge to full placement instead of
  shrinking the workload. Used by the drain waves, where the deleter
  (NodeDrainer) is not the driver above.

Everything is counted (flaps/storms/nodes reclaimed/pods respawned) so a
chaos bench can pin the numbers, and ``stop()`` restores any node still
down so the harness always hands back a full-capacity cluster.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Node, Pod, PodStatus, new_uid
from kubernetes_tpu_torch.apiserver.server import Conflict
from kubernetes_tpu_torch.robustness.faults import FaultInjector, FaultPoint

logger = logging.getLogger(__name__)


def respawn_clone(pod: Pod) -> Pod:
    """A fresh PENDING clone of a killed pod: same name/namespace/spec,
    new uid, no binding, clean status -- what a ReplicaSet controller
    would create after an eviction. Scheduler-side memo stamps
    (admission/volume-count caches keyed on the old incarnation) are
    dropped with the rest of the non-field state."""
    new = copy.deepcopy(pod)
    # dataclass fields live in __dict__ next to memo stamps; keep only
    # the real fields so no stale per-incarnation cache rides along
    new.__dict__ = {
        f.name: getattr(new, f.name) for f in dataclasses.fields(Pod)
    }
    new.status = PodStatus()
    new.metadata.uid = new_uid()
    new.metadata.resource_version = 0
    new.metadata.deletion_timestamp = None
    new.spec.node_name = ""
    return new


def cold_replacement(node: Node) -> Node:
    """A brand-new Node with the dead node's name/labels/capacity: the
    autoscaler's replacement instance. New uid + clean conditions, so
    every consumer treats it as a cold join, not a resurrection."""
    new = copy.deepcopy(node)
    new.metadata.uid = new_uid()
    new.metadata.resource_version = 0
    new.metadata.deletion_timestamp = None
    new.status.conditions = []
    new.spec.unschedulable = False
    new.spec.taints = []
    return new


class PodRespawner:
    """Watch-driven pod respawner: every DELETED pod accepted by
    ``should_respawn`` is recreated as a fresh pending clone."""

    def __init__(
        self,
        client,
        should_respawn: Optional[Callable[[Pod], bool]] = None,
    ) -> None:
        self.client = client
        self.should_respawn = should_respawn or (lambda pod: True)
        self.respawned = 0
        self._watch = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _run(self) -> None:
        server = self.client.server
        self._watch = server.watch("Pod", since_rv=server.current_rv())
        while not self._stop.is_set():
            try:
                evs = self._watch.next_batch(timeout=0.2)
            except Exception:  # noqa: BLE001 - lagged past the history
                # trim (410 Gone): reopen from now. Deletes that landed
                # in the gap are missed respawns -- degraded, never a
                # dead thread.
                logger.warning("respawner watch lagged; reopening")
                self._watch = server.watch(
                    "Pod", since_rv=server.current_rv()
                )
                continue
            for ev in evs:
                if ev.type != "DELETED":
                    continue
                pod = ev.object
                if not self.should_respawn(pod):
                    continue
                try:
                    self.client.create_pod(respawn_clone(pod))
                    self.respawned += 1
                except Conflict:
                    pass  # another respawner won the race: pod is back
                except Exception:
                    logger.exception("respawning pod %s", pod.key())

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="pod-respawner", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.stop()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class ClusterLifecycleDriver:
    """Injector-driven node churn against a live apiserver.

    Each ``tick()`` evaluates the ``NODE_FLAP`` and ``RECLAIM_STORM``
    points once (their seeded streams make the whole run reproducible
    for a given profile seed) and re-adds cold replacements whose down
    time has passed. Victim choice comes from the driver's OWN seeded
    RNG so it is deterministic too, and never targets a node that is
    already down."""

    def __init__(
        self,
        client,
        injector: Optional[FaultInjector] = None,
        tick_interval: float = 0.2,
        flap_down_seconds: float = 0.5,
        storm_fraction: float = 0.1,
        storm_down_seconds: float = 1.5,
        respawn_pods: bool = True,
        node_filter: Optional[Callable[[Node], bool]] = None,
        seed: Optional[int] = None,
    ) -> None:
        self.client = client
        self.injector = injector
        self.tick_interval = tick_interval
        self.flap_down_seconds = flap_down_seconds
        self.storm_fraction = storm_fraction
        self.storm_down_seconds = storm_down_seconds
        self.respawn_pods = respawn_pods
        self.node_filter = node_filter or (lambda node: True)
        if seed is None:
            seed = injector.profile.seed if injector is not None else 0
        self._rng = random.Random(seed * 7919 + 101)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # name -> (restore_at_monotonic, cold Node to re-create)
        self._down: Dict[str, Tuple[float, Node]] = {}
        self._lock = threading.Lock()
        self.flaps = 0
        self.storms = 0
        self.nodes_reclaimed = 0
        self.pods_killed = 0
        self.pods_respawned = 0

    # -- surgery -------------------------------------------------------------

    def _live_victims(self) -> List[Node]:
        nodes, _ = self.client.list_nodes()
        with self._lock:
            down = set(self._down)
        return sorted(
            (
                n for n in nodes
                if n.metadata.name not in down and self.node_filter(n)
            ),
            key=lambda n: n.metadata.name,
        )

    def _kill_nodes(self, victims: List[Node], down_seconds: float) -> None:
        if not victims:
            return
        restore_at = time.monotonic() + down_seconds
        pods, _ = self.client.list_pods()
        by_node: Dict[str, List[Pod]] = {}
        for p in pods:
            if p.spec.node_name:
                by_node.setdefault(p.spec.node_name, []).append(p)
        for node in victims:
            name = node.metadata.name
            try:
                self.client.delete_node(name)
            except KeyError:
                continue  # raced another deleter
            with self._lock:
                self._down[name] = (restore_at, cold_replacement(node))
            self.nodes_reclaimed += 1
            # the spot kill takes the pods with it; respawn clones so
            # the workload re-places instead of shrinking
            for pod in by_node.get(name, ()):
                try:
                    self.client.delete_pod(
                        pod.metadata.namespace, pod.metadata.name
                    )
                    self.pods_killed += 1
                except KeyError:
                    continue
                except Exception:
                    logger.exception("spot-killing pod %s", pod.key())
                    continue
                if self.respawn_pods:
                    try:
                        self.client.create_pod(respawn_clone(pod))
                        self.pods_respawned += 1
                    except Conflict:
                        pass  # a PodRespawner won the race: pod is back
                    except Exception:
                        logger.exception("respawning pod %s", pod.key())

    def _restore_due(self, now: Optional[float] = None) -> int:
        if now is None:
            now = time.monotonic()
        with self._lock:
            due = [
                (name, node) for name, (at, node) in self._down.items()
                if now >= at
            ]
        restored = 0
        for name, node in sorted(due):
            try:
                self.client.create_node(node)
            except Exception:
                # a node of that name may already be back (another
                # restorer / the harness): treat as restored
                try:
                    self.client.get_node(name)
                except KeyError:
                    logger.exception("restoring node %s", name)
                    continue
            with self._lock:
                self._down.pop(name, None)
            restored += 1
        return restored

    # -- the tick ------------------------------------------------------------

    def tick(self) -> None:
        """One chaos evaluation: restore due nodes, then maybe flap one
        node, then maybe fire a reclamation storm."""
        self._restore_due()
        inj = self.injector
        if inj is None:
            return
        if inj.should_fire(FaultPoint.NODE_FLAP):
            victims = self._live_victims()
            if victims:
                victim = self._rng.choice(victims)
                logger.warning("node flap: %s", victim.metadata.name)
                self._kill_nodes([victim], self.flap_down_seconds)
                self.flaps += 1
        if inj.should_fire(FaultPoint.RECLAIM_STORM):
            victims = self._live_victims()
            k = max(1, int(len(victims) * self.storm_fraction))
            if victims:
                chosen = self._rng.sample(victims, min(k, len(victims)))
                logger.warning(
                    "reclamation storm: %d node(s)", len(chosen)
                )
                self._kill_nodes(chosen, self.storm_down_seconds)
                self.storms += 1

    def _run(self) -> None:
        # first tick immediately: a caller that starts the driver
        # mid-burst wants the chaos DURING the burst, and a fast burst
        # can finish inside one tick interval
        while True:
            try:
                self.tick()
            except Exception:
                logger.exception("lifecycle chaos tick")
            if self._stop.wait(self.tick_interval):
                return

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="lifecycle-chaos", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        """Stop ticking and restore every node still down: the harness
        always hands back a full-capacity cluster so the workload can
        converge."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._lock:
                if not self._down:
                    return
            self._restore_due(now=float("inf"))
            with self._lock:
                if not self._down:
                    return
            # a node refused to come back (apiserver down mid-teardown):
            # retry paced, not in a hot loop
            time.sleep(0.05)

    def down_count(self) -> int:
        with self._lock:
            return len(self._down)
