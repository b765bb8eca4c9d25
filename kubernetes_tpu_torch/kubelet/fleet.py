"""HollowNodeFleet: the sharded hollow-kubelet plane.

Reference: pkg/kubemark/hollow_kubelet.go:64 (fake node agents around a
none-runtime) scaled the way kubemark scales them -- NOT a thread per
node. One `_FleetShard` thread drives ~10k hollow nodes off a single
event-time wheel (a heap of due ack/heartbeat actions) plus ONE
spec.nodeName-routed pod watch (apiserver.watch_routes), so a bind event
wakes only the shard that owns the target node and a shard never scans
its siblings' traffic.

Per node, the shard:

- acks each binding into pod status (phase=Running + start_time) after a
  configurable per-node latency draw -- the kubelet's syncLoop ack
  (kubelet.go:1820), the closing edge of the control loop;
- renews a coordination Lease every heartbeat interval and keeps the
  Ready NodeCondition true, writing NodeStatus only on change
  (kubelet.go:885 -- Leases exist so steady-state heartbeats don't fan
  O(nodes) Node MODIFIED events into the schedulers' informers);
- optionally drifts the node's `pods` allocatable by one either way (the
  NodeStatus-churn substrate for the tensor delta-scatter path);
- goes dark on command (`go_dark`): acks AND heartbeats cease, the
  spot-kill / power-loss shape the nodelifecycle monitor must catch.

Fault points (robustness/faults.py), drawn from the installed injector:

- SLOW_ACK: adds `hang_seconds` to one ack's latency;
- ZOMBIE_KUBELET: drawn once per node at fleet build -- heartbeats keep
  flowing but acks NEVER land (the silent kubelet death only
  scheduler-side bind-ack tracking can detect);
- HEARTBEAT_LAPSE: suppresses one node's renewals for `hang_seconds`
  (the lease lapses; the monitor's taint-evict arc runs).

The ack write is fenced INSIDE the status mutate (atomic under the store
lock): if the pod was unbound (rebind-after-timeout won the race) or
replaced by a new incarnation, the mutate raises and no write lands -- a
late ack can never mark a requeued pod Running.
"""

from __future__ import annotations

import heapq
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set
from zlib import crc32

from kubernetes_tpu_torch.api.types import (
    Lease,
    Node,
    NodeCondition,
    ObjectMeta,
    POD_RUNNING,
    Pod,
    RESOURCE_PODS,
)
from kubernetes_tpu_torch.kubelet.hollow import LEASE_NAMESPACE
from kubernetes_tpu_torch.robustness.faults import FaultPoint, get_injector
from kubernetes_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)


@dataclass
class FleetConfig:
    """Knobs of the hollow fleet (bench `hollow_fleet` workload key /
    README "Closing the bind loop")."""

    #: hollow nodes per shard thread (kubemark economy: the fleet is
    #: O(nodes/shard_size) threads, not O(nodes))
    shard_size: int = 10_000
    #: mean per-node ack latency; each node draws its own mean from
    #: N(ack_latency_seconds, ack_latency_jitter) at build, then each
    #: ack jitters around that (a slow rack stays slow)
    ack_latency_seconds: float = 0.0
    ack_latency_jitter: float = 0.0
    heartbeat_interval_seconds: float = 10.0
    lease_duration_seconds: float = 40.0
    #: probability per heartbeat that the node's `pods` allocatable
    #: drifts by one (bounded to base-2..base+2); 0 = no NodeStatus churn
    allocatable_drift: float = 0.0
    seed: int = 0


class _NodeState:
    __slots__ = (
        "name", "ack_mean", "rng", "dark", "zombie", "lapse_until",
        "alloc_base", "alloc_cur",
    )

    def __init__(self, name: str, cfg: FleetConfig) -> None:
        self.name = name
        # deterministic per-node stream: the fleet is reproducible for a
        # given (seed, node set) regardless of thread interleaving
        self.rng = random.Random(cfg.seed * 1000003 + crc32(name.encode()))
        self.ack_mean = max(
            0.0,
            self.rng.gauss(cfg.ack_latency_seconds, cfg.ack_latency_jitter)
            if cfg.ack_latency_jitter > 0.0 else cfg.ack_latency_seconds,
        )
        self.dark = False
        self.zombie = False
        self.lapse_until = 0.0
        self.alloc_base: Optional[int] = None
        self.alloc_cur: Optional[int] = None


class _StaleAck(Exception):
    """Raised inside the ack mutate when the pod is no longer this
    node's incarnation; aborts the guaranteed_update before any write."""


class _FleetShard:
    """One thread, ~shard_size hollow nodes, one event-time wheel."""

    def __init__(self, fleet: "HollowNodeFleet", nodes: List[str]) -> None:
        self.fleet = fleet
        self.nodes: Dict[str, _NodeState] = {
            n: _NodeState(n, fleet.config) for n in nodes
        }
        self._wheel: list = []  # (due, seq, action, payload)
        self._seq = 0
        self._pending_acks: Set[str] = set()  # pod uids with a due ack
        self._watch = None
        self._thread: Optional[threading.Thread] = None

    # -- wheel ---------------------------------------------------------------

    def _push(self, due: float, action: str, payload) -> None:
        self._seq += 1
        heapq.heappush(self._wheel, (due, self._seq, action, payload))

    # -- pod acks ------------------------------------------------------------

    def _schedule_ack(self, pod: Pod, now: float) -> None:
        st = self.nodes.get(pod.spec.node_name)
        if st is None or st.dark or st.zombie:
            if st is not None and st.zombie:
                self.fleet.acks_suppressed += 1
            return
        if pod.status.phase == POD_RUNNING:
            return
        uid = pod.metadata.uid
        if uid in self._pending_acks:
            return
        self._pending_acks.add(uid)
        latency = st.ack_mean
        if st.rng.random() < 0.5:
            latency += st.rng.uniform(0.0, st.ack_mean * 0.25 or 0.0)
        inj = get_injector()
        if inj is not None:
            latency += inj.hang_seconds_maybe(FaultPoint.SLOW_ACK)
        self._push(
            now + latency, "ack",
            (pod.metadata.namespace, pod.metadata.name, uid,
             pod.spec.node_name),
        )

    def _fire_ack(self, payload) -> None:
        namespace, name, uid, node = payload
        self._pending_acks.discard(uid)
        st = self.nodes.get(node)
        if st is None or st.dark or st.zombie:
            return

        def set_running(p: Pod) -> None:
            # fenced under the store lock: a rebound/respawned pod must
            # not be marked Running by a late ack from the old node
            if p.metadata.uid != uid or p.spec.node_name != node:
                raise _StaleAck()
            p.status.phase = POD_RUNNING
            if p.status.start_time is None:
                p.status.start_time = time.time()

        try:
            self.fleet.client.update_pod_status(namespace, name, set_running)
            self.fleet.pods_acked += 1
            metrics.hollow_acks.inc()
        except KeyError:
            pass  # deleted before the ack landed
        except _StaleAck:
            self.fleet.stale_acks += 1
        except Exception:
            logger.exception("hollow fleet acking pod %s/%s",
                             namespace, name)

    # -- heartbeats ----------------------------------------------------------

    def _fire_heartbeat(self, node_name: str, now_mono: float) -> None:
        st = self.nodes.get(node_name)
        if st is None or st.dark:
            return  # dark nodes never reschedule: silence is the fault
        cfg = self.fleet.config
        inj = get_injector()
        if inj is not None and now_mono >= st.lapse_until:
            hang = inj.hang_seconds_maybe(FaultPoint.HEARTBEAT_LAPSE)
            if hang > 0.0:
                st.lapse_until = now_mono + hang
                self.fleet.heartbeat_lapses += 1
        if now_mono < st.lapse_until:
            # lapsed: skip the renew, come back when the window ends
            self._push(
                min(st.lapse_until, now_mono + cfg.heartbeat_interval_seconds)
                + 0.01,
                "hb", node_name,
            )
            return
        try:
            self._renew(st)
            self.fleet.heartbeats_sent += 1
            metrics.hollow_heartbeats.inc()
        except Exception:
            logger.exception("hollow fleet heartbeat for %s", node_name)
        jitter = 0.9 + 0.2 * st.rng.random()
        self._push(
            now_mono + cfg.heartbeat_interval_seconds * jitter,
            "hb", node_name,
        )

    def _renew(self, st: _NodeState) -> None:
        fleet = self.fleet
        server = fleet.client.server
        now = fleet._now()
        try:
            server.guaranteed_update(
                "Lease", LEASE_NAMESPACE, st.name,
                lambda le: setattr(le, "renew_time", now),
            )
        except KeyError:
            try:
                server.create(
                    Lease(
                        metadata=ObjectMeta(
                            name=st.name, namespace=LEASE_NAMESPACE
                        ),
                        holder_identity=st.name,
                        lease_duration_seconds=(
                            fleet.config.lease_duration_seconds
                        ),
                        acquire_time=now,
                        renew_time=now,
                    )
                )
            except Exception:
                pass
        # Ready condition: written only on change (hollow.py rationale --
        # steady-state heartbeats must not fan out Node MODIFIED events)
        try:
            node = server.get("Node", "", st.name)
        except KeyError:
            return
        if not any(
            c.type == "Ready" and c.status == "True"
            for c in node.status.conditions
        ):
            def set_ready(n: Node) -> None:
                n.status.conditions = [
                    c for c in n.status.conditions if c.type != "Ready"
                ] + [NodeCondition(type="Ready", status="True")]

            try:
                server.guaranteed_update("Node", "", st.name, set_ready)
            except KeyError:
                pass
        cfg = fleet.config
        if cfg.allocatable_drift > 0.0 and (
            st.rng.random() < cfg.allocatable_drift
        ):
            self._drift_allocatable(st, node)

    def _drift_allocatable(self, st: _NodeState, node: Node) -> None:
        """NodeStatus allocatable drift: bump the `pods` allocatable one
        step within base +/- 2 -- real kubelets re-report allocatable as
        system reservations move, and the churn exercises the tensor
        cache's alloc row scatter."""
        base = node.status.allocatable.get(RESOURCE_PODS)
        if base is None:
            return
        if st.alloc_base is None:
            st.alloc_base = base
            st.alloc_cur = base
        step = st.rng.choice((-1, 1))
        nxt = max(st.alloc_base - 2, min(st.alloc_base + 2,
                                         (st.alloc_cur or base) + step))
        if nxt == st.alloc_cur:
            return
        st.alloc_cur = nxt

        def set_alloc(n: Node) -> None:
            alloc = dict(n.status.allocatable)
            alloc[RESOURCE_PODS] = nxt
            n.status.allocatable = alloc

        try:
            self.fleet.client.server.guaranteed_update(
                "Node", "", st.name, set_alloc
            )
            self.fleet.allocatable_drifts += 1
        except KeyError:
            pass

    # -- run loop ------------------------------------------------------------

    def _relist(self, server) -> None:
        pods, rv = server.list("Pod")
        self._watch = server.watch_routes("Pod", set(self.nodes), since_rv=rv)
        now = time.monotonic()
        for pod in pods:
            if pod.spec.node_name in self.nodes:
                self._schedule_ack(pod, now)

    def run(self) -> None:
        fleet = self.fleet
        server = fleet.client.server
        try:
            self._relist(server)
        except Exception:
            logger.exception("hollow fleet shard startup list")
            return
        # first heartbeat immediately: the lease must exist before the
        # lifecycle monitor's first sweep, staggered across the shard
        now = time.monotonic()
        for i, name in enumerate(self.nodes):
            self._push(now + (i % 97) * 1e-4, "hb", name)
        while not fleet._stop.is_set():
            now = time.monotonic()
            timeout = 0.2
            if self._wheel:
                timeout = max(0.0, min(timeout, self._wheel[0][0] - now))
            try:
                evs = self._watch.next_batch(timeout=timeout)
            except Exception:  # noqa: BLE001 - Gone (410): relist + diff
                try:
                    self._relist(server)
                except Exception:
                    logger.exception("hollow fleet shard relist")
                    fleet._stop.wait(0.2)
                continue
            now = time.monotonic()
            for ev in evs:
                if ev.type in ("ADDED", "MODIFIED"):
                    self._schedule_ack(ev.object, now)
                elif ev.type == "DELETED":
                    self._pending_acks.discard(ev.object.metadata.uid)
            while self._wheel and self._wheel[0][0] <= now:
                _due, _seq, action, payload = heapq.heappop(self._wheel)
                if action == "ack":
                    self._fire_ack(payload)
                else:
                    self._fire_heartbeat(payload, now)

    def drain_due(self) -> None:
        """Synchronously fire everything due (tests drive shards without
        threads via HollowNodeFleet.pump)."""
        server = self.fleet.client.server
        if self._watch is None:
            self._relist(server)
        else:
            try:
                evs = self._watch.pending()
            except Exception:  # noqa: BLE001 - Gone: relist + diff
                self._relist(server)
                evs = []
            now = time.monotonic()
            for ev in evs:
                if ev.type in ("ADDED", "MODIFIED"):
                    self._schedule_ack(ev.object, now)
                elif ev.type == "DELETED":
                    self._pending_acks.discard(ev.object.metadata.uid)
        now = time.monotonic()
        while self._wheel and self._wheel[0][0] <= now:
            _due, _seq, action, payload = heapq.heappop(self._wheel)
            if action == "ack":
                self._fire_ack(payload)
            else:
                self._fire_heartbeat(payload, now)


class HollowNodeFleet:
    """A sharded fleet of hollow kubelets closing the bind loop.

    `start()` runs one daemon thread per ~shard_size nodes; `stop()`
    halts them. Tests can instead call `heartbeat_once()` +
    `pump()` for deterministic, thread-free driving."""

    def __init__(
        self,
        client,
        node_names: List[str],
        config: Optional[FleetConfig] = None,
        now=time.time,
    ) -> None:
        self.client = client
        self.config = config or FleetConfig()
        self._now = now
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.shards: List[_FleetShard] = []
        size = max(1, int(self.config.shard_size))
        names = list(node_names)
        for i in range(0, len(names), size):
            self.shards.append(_FleetShard(self, names[i:i + size]))
        # ZOMBIE_KUBELET draws once per node, in node order, so a given
        # (profile seed, node list) always yields the same zombie set
        self.zombies: Set[str] = set()
        inj = get_injector()
        if inj is not None:
            for shard in self.shards:
                for name, st in shard.nodes.items():
                    if inj.should_fire(FaultPoint.ZOMBIE_KUBELET):
                        st.zombie = True
                        self.zombies.add(name)
        # counters (bench result record + tests)
        self.pods_acked = 0
        self.heartbeats_sent = 0
        self.heartbeat_lapses = 0
        self.stale_acks = 0
        self.acks_suppressed = 0
        self.allocatable_drifts = 0

    @property
    def node_names(self) -> Set[str]:
        out: Set[str] = set()
        for shard in self.shards:
            out.update(shard.nodes)
        return out

    def go_dark(self, node_names) -> None:
        """Silence the given nodes completely: no more acks, no more
        heartbeats (the spot-kill shape; the lifecycle monitor must
        notice via the lapsed lease)."""
        wanted = set(node_names)
        for shard in self.shards:
            for name in wanted & set(shard.nodes):
                shard.nodes[name].dark = True

    def mark_zombie(self, node_names) -> None:
        """Deterministically zombify nodes (tests; the fault point draws
        probabilistically at build instead): heartbeats continue, acks
        never land."""
        wanted = set(node_names)
        for shard in self.shards:
            for name in wanted & set(shard.nodes):
                shard.nodes[name].zombie = True
                self.zombies.add(name)

    # -- deterministic driving (tests) ---------------------------------------

    def heartbeat_once(self) -> None:
        """One lease renew + Ready write per non-dark node, bypassing
        the wheel (lapse windows still respected)."""
        now = time.monotonic()
        for shard in self.shards:
            for st in shard.nodes.values():
                if st.dark or now < st.lapse_until:
                    continue
                shard._renew(st)
                self.heartbeats_sent += 1

    def pump(self) -> None:
        """Drain watches + fire everything due, synchronously."""
        for shard in self.shards:
            shard.drain_due()

    def sync_once(self) -> int:
        """Catch-up ack over the full pod list, ignoring latency (the
        deterministic test hook; zombie/dark nodes still never ack)."""
        before = self.pods_acked
        owned: Dict[str, _FleetShard] = {}
        for shard in self.shards:
            for name in shard.nodes:
                owned[name] = shard
        pods, _ = self.client.list_pods()
        for pod in pods:
            shard = owned.get(pod.spec.node_name)
            if shard is None or pod.status.phase == POD_RUNNING:
                continue
            shard._fire_ack((
                pod.metadata.namespace, pod.metadata.name,
                pod.metadata.uid, pod.spec.node_name,
            ))
        return self.pods_acked - before

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        for i, shard in enumerate(self.shards):
            t = threading.Thread(
                target=shard.run, name=f"hollow-fleet-{i}", daemon=True
            )
            t.start()
            shard._thread = t
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for shard in self.shards:
            if shard._watch is not None:
                try:
                    shard._watch.stop()
                except Exception:
                    pass
        for t in self._threads:
            t.join(timeout=2)
        self._threads.clear()
