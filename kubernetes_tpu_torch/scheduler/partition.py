"""Partitioned multi-active scheduling: the lease-backed ownership layer.

Fenced single-leader HA (scheduler/leaderelection.py) runs ONE live
scheduler stack, one Lease, `holds_lease()` probed immediately before
every commit. This module generalizes that lease to a **partition map** so N active
`BatchScheduler` stacks share one apiserver, each owning a slice of the
node space:

- the node space is split into ``num_partitions`` consistent-hash
  partitions (``partition_of_name``: crc32 over the node name, or over
  the zone label when ``zone_aligned`` -- a whole zone then fails over
  as a unit);
- every partition is one ``Lease`` object in the apiserver
  (``<prefix>-<k>``), claimed and renewed exactly like
  ``leaderelection.LeaderElector``'s single lease, including the
  clock-skew grace for challengers and the ``lease_renew_fail``
  injection seam;
- pending pods are partitioned too (hash of the pod uid -- or of the
  GANG group key, so a pod group homes as a unit and never splits
  across stacks -- overridable by the spill annotation), so each pod
  has exactly ONE home stack and the
  stacks never race over fresh work -- overlap is the rare exception
  (takeover windows), resolved by typed bind conflicts, not prevented
  by global locks;
- desired assignment is **rendezvous hashing** over the live members
  (each stack also renews a member lease): every coordinator
  independently computes, per partition, the highest-scoring live
  member. Members agree without talking to each other, a dead stack's
  partitions scatter across ALL survivors (the "split the orphaned
  range" property), and a returning stack reclaims exactly its old
  partitions (minimal movement).

Failure modes are rehearsed paths:

- **partition-loss adoption**: a lapsed partition lease (stack crash,
  injected renew failures, partition of the partition-owner) is seized
  by the rendezvous winner among the survivors after the skew grace;
  the adopter then runs a ``recover_on_startup``-style sweep scoped to
  the partition: nodes join its cache (the tensor cache's slot machinery absorbs
  them as membership scatters), bound pods are adopted, and the dead
  stack's in-flight assumed-but-never-bound pods -- still pending at
  the apiserver -- are requeued and re-bound exactly once.
  ``partition_takeover_ms`` meters detection -> adoption-complete.
- **commit fencing**: the batch committer probes
  ``may_bind(node)`` -- a FRESH lease read per partition, the
  multi-lease `holds_lease()` -- immediately before every bulk bind;
  pods on unowned partitions are absorbed as typed conflicts (requeue,
  never silent). The apiserver double-checks under its own store lock
  (``PartitionAuthority``) so a binder racing the probe still gets a
  per-slot typed conflict instead of a double placement.
- **spill**: a pod whose feasible nodes all live in a foreign
  partition (NO_NODE on its home stack) is re-stamped
  (``SPILL_TARGET_ANNOTATION``) and forwarded through the apiserver --
  the target stack's informer enqueues it; the pod is never dropped
  and never fails silently. After visiting every partition the normal
  unschedulable backoff applies.
"""

from __future__ import annotations

import logging
import threading
import time
import zlib
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api.types import (
    LABEL_ZONE_KEYS,
    Lease,
    ObjectMeta,
    POD_GROUP_LABEL,
    Pod,
)
from kubernetes_tpu_torch.config.types import PartitionConfiguration
from kubernetes_tpu_torch.robustness.faults import FaultPoint, get_injector
from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)

#: spill re-stamp: overrides the pod's hashed home partition. Written by
#: the failing stack via guaranteed_update; the target stack's informer
#: sees the MODIFIED event and enqueues the pod.
SPILL_TARGET_ANNOTATION = "scheduler.tpu/partition"
#: how many partitions this pod has already failed in; spilling stops
#: (normal unschedulable backoff takes over) once every partition has
#: had a look
SPILL_COUNT_ANNOTATION = "scheduler.tpu/spill-count"
#: comma-joined partition ids this pod has already FAILED in. The
#: feasibility hint makes spill hops non-ring-ordered, so the
#: every-partition-gets-a-look guarantee can no longer ride the hop
#: count alone: candidates are picked unvisited-first against this set
#: (ring revisits only as the last resort within the hop budget)
SPILL_VISITED_ANNOTATION = "scheduler.tpu/spill-visited"


def partition_of_name(name: str, num_partitions: int) -> int:
    """Stable consistent-hash partition for a node (or pod-uid) name.
    crc32 is stable across processes and runs (unlike hash())."""
    if num_partitions <= 1:
        return 0
    return zlib.crc32(name.encode()) % num_partitions


def rendezvous_ranking(partition: int, members: List[str]) -> List[str]:
    """Members ranked by highest-random-weight score for one partition:
    every stack computes the same order independently (no coordination
    round), and a removed member simply drops out of every ranking."""
    return sorted(
        sorted(members),
        key=lambda m: zlib.crc32(f"{m}/{partition}".encode()),
        reverse=True,
    )


def compute_assignment(
    num_partitions: int, members: List[str]
) -> Dict[int, str]:
    """Deterministic balanced partition assignment: rendezvous ranking
    per partition, capped at ceil(P / M) partitions per member so the
    load always spreads across every live stack (pure rendezvous can
    hand one member everything at small P). Identical on every stack
    for the same member set; a dead member's partitions scatter across
    the survivors with the remaining assignments unmoved (the "split
    the orphaned range" property)."""
    members = sorted(set(members))
    if not members or num_partitions < 1:
        return {}
    cap = -(-num_partitions // len(members))  # ceil
    counts = {m: 0 for m in members}
    out: Dict[int, str] = {}
    for k in range(num_partitions):
        for m in rendezvous_ranking(k, members):
            if counts[m] < cap:
                out[k] = m
                counts[m] += 1
                break
    return out


class PartitionAuthority:
    """Server-side bind fence: installed on the APIServer so bulk binds
    carrying a ``binder`` identity are checked against the CURRENT
    partition leases under the store lock -- strictly fresher than any
    committer-side probe. Returns a conflict reason string ("foreign-
    partition") or None (allowed).

    An unheld or expired partition allows the bind: adoption is in
    flight and the committer-side probe plus the per-pod already-bound
    conflict are the remaining guards -- refusing here would wedge
    takeover re-binds behind the lease CAS."""

    def __init__(self, server, config: PartitionConfiguration,
                 clock=time.monotonic) -> None:
        self.server = server
        self.config = config
        self.clock = clock

    def _lease(self, k: int) -> Optional[Lease]:
        store = self.server._stores.get("Lease")
        if not store:
            return None
        return store.get(
            (self.config.resource_namespace,
             f"{self.config.resource_prefix}-{k}")
        )

    def partition_of_node(self, node_name: str) -> int:
        cfg = self.config
        if cfg.zone_aligned:
            node = self.server._stores.get("Node", {}).get(
                ("", node_name)
            ) or self.server._stores.get("Node", {}).get(
                ("default", node_name)
            )
            if node is not None:
                for key in LABEL_ZONE_KEYS:
                    zone = node.metadata.labels.get(key)
                    if zone:
                        return partition_of_name(
                            zone, cfg.num_partitions
                        )
        return partition_of_name(node_name, cfg.num_partitions)

    def check(self, binder: str, node_name: str) -> Optional[str]:
        lease = self._lease(self.partition_of_node(node_name))
        if lease is None or not lease.holder_identity:
            return None
        if lease.holder_identity == binder:
            return None
        if lease.renew_time + lease.lease_duration_seconds <= self.clock():
            return None  # expired: adoption window, probes take over
        return "foreign-partition"


class PartitionCoordinator:
    """One scheduler stack's view of (and claims on) the partition map.

    Runs a renew loop (like ``LeaderElector.run`` but over a member
    lease plus every rendezvous-desired partition lease) and keeps the
    stack's cache/queue scoped to its held partitions:

    - ``owns_node`` / ``wants_pod`` gate the informer event handlers
      (scheduler/eventhandlers.py) and the resilience sweeps;
    - ``may_bind`` is the commit-time fencing probe (fresh lease read);
    - partition acquisition triggers adoption (nodes + bound pods into
      the cache, pending home pods into the queue), partition release
      or loss evicts the partition's state.

    ``fault_injector`` mirrors the LeaderElector seam: a targeted
    injector makes THIS stack's renews fail deterministically (the
    stack-kill chaos primitive) while siblings stay healthy.
    """

    def __init__(
        self,
        client,
        sched,
        config: PartitionConfiguration,
        identity: str,
        clock=time.monotonic,
    ) -> None:
        self.client = client
        self.sched = sched
        self.config = config
        self.identity = identity
        self.clock = clock
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._watch = None
        self._watch_thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        #: held partition -> fencing epoch (the lease_transitions value
        #: observed when we acquired it)
        self.held: Dict[int, int] = {}
        #: first time we saw a foreign partition's lease expired
        #: (detection timestamps for partition_takeover_ms)
        self._expiry_seen: Dict[int, float] = {}
        #: last successful renew per held partition: a partition that
        #: has not renewed within the lease duration is treated as LOST
        #: locally (the lease may already be seized) -- the deposed
        #: stack stops wanting its pods instead of fencing forever
        self._last_renewed: Dict[int, float] = {}
        #: zone-aligned mode: node name -> partition, learned from node
        #: objects (the zone label travels with the object, not the name)
        self._node_partition: Dict[str, int] = {}
        self.fault_injector = None
        # -- counters (mirrored into metrics) ----------------------------
        self.takeovers = 0
        self.adoptions_requeued = 0
        self.adoptions_bound = 0
        self.releases = 0
        #: spill feasibility hints that stamped the owner directly
        self.spill_hint_hits = 0
        # per-signature owner-hint cache (see _spill_owner_hint),
        # invalidated when the Node list's resourceVersion moves
        self._spill_hint_cache: Dict[Tuple, Optional[int]] = {}
        self._spill_hint_rv = -1

    # -- partition arithmetic ------------------------------------------------

    @property
    def num_partitions(self) -> int:
        return max(1, self.config.num_partitions)

    def node_partition(self, node_name: str) -> int:
        if self.config.zone_aligned:
            cached = self._node_partition.get(node_name)
            if cached is not None:
                return cached
        return partition_of_name(node_name, self.num_partitions)

    def note_node(self, node) -> int:
        """Record (and return) a node OBJECT's partition; zone-aligned
        mode learns the name -> partition mapping here so later
        name-only lookups (pod.spec.node_name) resolve correctly."""
        k = partition_of_name(
            node.metadata.name, self.num_partitions
        )
        if self.config.zone_aligned:
            for key in LABEL_ZONE_KEYS:
                zone = node.metadata.labels.get(key)
                if zone:
                    k = partition_of_name(zone, self.num_partitions)
                    break
            self._node_partition[node.metadata.name] = k
        return k

    def pod_partition(self, pod: Pod) -> int:
        """The pod's home partition: the spill annotation overrides the
        hash (a re-stamped pod belongs to its spill target). Gang pods
        hash their GROUP key (namespace/pod-group label) instead of the
        per-pod uid, so a gang homes as a unit on one stack -- a
        uid-split gang could never reach quorum on either side and paid
        multi-hop spill convergence to reassemble.
        The group hash is deterministic across stacks, and a spilled
        gang member re-homes with the same annotation mechanism as any
        pod (its siblings fail quorum on the same stack and follow to
        the same ring successor)."""
        ann = pod.metadata.annotations.get(SPILL_TARGET_ANNOTATION)
        if ann is not None:
            try:
                k = int(ann)
                if 0 <= k < self.num_partitions:
                    return k
            except ValueError:
                pass
        gang = (pod.metadata.labels or {}).get(POD_GROUP_LABEL)
        if gang:
            return partition_of_name(
                f"{pod.metadata.namespace}/{gang}", self.num_partitions
            )
        return partition_of_name(pod.metadata.uid, self.num_partitions)

    # -- ownership answers (event handlers, resilience, skip checks) --------

    def owns_node(self, node_name: str) -> bool:
        if not node_name:
            return False
        return self.node_partition(node_name) in self.held

    def owns_node_obj(self, node) -> bool:
        return self.note_node(node) in self.held

    def wants_pod(self, pod: Pod) -> bool:
        return self.pod_partition(pod) in self.held

    def held_partitions(self) -> Set[int]:
        with self._lock:
            return set(self.held)

    # -- lease primitives ----------------------------------------------------

    def _lease_name(self, k: int) -> str:
        return f"{self.config.resource_prefix}-{k}"

    def _member_name(self) -> str:
        return f"{self.config.resource_prefix}-member-{self.identity}"

    def _renew_fails_injected(self) -> bool:
        inj = (
            self.fault_injector
            if self.fault_injector is not None
            else get_injector()
        )
        return inj is not None and inj.should_fire(
            FaultPoint.LEASE_RENEW_FAIL
        )

    def _get_or_create(self, name: str) -> Lease:
        server = self.client.server
        ns = self.config.resource_namespace
        try:
            return server.get("Lease", ns, name)
        except KeyError:
            lease = Lease(metadata=ObjectMeta(name=name, namespace=ns))
            try:
                return server.create(lease)
            except ValueError:  # lost the create race
                return server.get("Lease", ns, name)

    def _try_claim(self, name: str, challenger_grace: bool) -> Optional[int]:
        """One CAS round on one lease (tryAcquireOrRenew generalized).
        Returns the lease_transitions epoch on success, None when held
        by a live other."""
        if self._renew_fails_injected():
            metrics.lease_renew_failures.inc()
            return None
        server = self.client.server
        now = self.clock()
        skew = max(0.0, self.config.clock_skew_tolerance_seconds)
        self._get_or_create(name)

        class _Held(Exception):
            pass

        out = {}

        def mutate(obj: Lease) -> None:
            grace = skew if (
                challenger_grace and obj.holder_identity != self.identity
            ) else 0.0
            expired = (
                obj.renew_time + obj.lease_duration_seconds + grace <= now
            )
            if obj.holder_identity not in ("", self.identity) and not expired:
                raise _Held()
            if obj.holder_identity != self.identity:
                obj.lease_transitions += 1
                obj.acquire_time = now
            obj.holder_identity = self.identity
            obj.lease_duration_seconds = self.config.lease_duration_seconds
            obj.renew_time = now
            out["epoch"] = obj.lease_transitions

        try:
            server.guaranteed_update(
                "Lease", self.config.resource_namespace, name, mutate
            )
            return out.get("epoch", 0)
        except _Held:
            return None
        except Exception:
            logger.exception("partition lease update failed: %s", name)
            metrics.lease_renew_failures.inc()
            return None

    def _release_lease(self, name: str) -> None:
        def mutate(obj: Lease) -> None:
            if obj.holder_identity != self.identity:
                return  # already seized: don't clobber
            obj.holder_identity = ""
            obj.renew_time = 0.0

        try:
            self.client.server.guaranteed_update(
                "Lease", self.config.resource_namespace, name, mutate
            )
        except Exception:
            logger.exception("releasing partition lease %s", name)

    def _live_members(self, now: float) -> List[str]:
        """Identities with a live member lease (self always counts while
        running -- our own member renew may race this read)."""
        members = {self.identity}
        prefix = f"{self.config.resource_prefix}-member-"
        try:
            leases, _rv = self.client.server.list("Lease")
        except Exception:
            return sorted(members)
        for lease in leases:
            name = lease.metadata.name
            if (
                not name.startswith(prefix)
                or lease.metadata.namespace
                != self.config.resource_namespace
            ):
                continue
            if not lease.holder_identity:
                continue
            if lease.renew_time + lease.lease_duration_seconds > now:
                members.add(lease.holder_identity)
        return sorted(members)

    # -- commit-time fencing -------------------------------------------------

    def holds_partition(self, k: int) -> bool:
        """Fresh-read fencing probe for one partition (the multi-lease
        ``holds_lease``): any doubt answers False."""
        if k not in self.held:
            return False
        try:
            obj = self.client.server.get(
                "Lease", self.config.resource_namespace,
                self._lease_name(k),
            )
        except Exception:  # noqa: BLE001 - can't prove ownership: fence
            return False
        return (
            obj.holder_identity == self.identity
            and obj.renew_time + obj.lease_duration_seconds > self.clock()
        )

    def may_bind(self, node_name: str) -> bool:
        return self.holds_partition(self.node_partition(node_name))

    def elected_singleton_writer(self) -> bool:
        """Single-writer election for cluster-scoped reconcilers (the
        quota ``sync_all`` absolute used-rewrite): the elected stack is
        the one holding the LOWEST partition currently held by any live
        stack. Every stack evaluates the same lease ground truth, so at
        most one answers True per lease window -- two stacks can only
        disagree across a takeover boundary, and the deposed holder's
        next fresh read flips it False. Doubt (unreadable lease)
        fences; no live holder at all (cold start, single stack racing
        its very first claim round) elects self -- there is nobody to
        race."""
        now = self.clock()
        server = self.client.server
        ns = self.config.resource_namespace
        for k in range(self.num_partitions):
            try:
                obj = server.get("Lease", ns, self._lease_name(k))
            except KeyError:
                continue  # never claimed: not held by anyone
            except Exception:  # noqa: BLE001 - can't prove: fence
                return False
            if not obj.holder_identity:
                continue
            if obj.renew_time + obj.lease_duration_seconds <= now:
                continue  # expired holder is not live
            return obj.holder_identity == self.identity
        return True

    def fence_hosts(self, hosts: List[str]) -> Set[int]:
        """Indexes of hosts this stack may NOT commit to right now; one
        fresh lease probe per unique partition, not per pod."""
        verdict: Dict[int, bool] = {}
        fenced: Set[int] = set()
        for i, host in enumerate(hosts):
            k = self.node_partition(host)
            ok = verdict.get(k)
            if ok is None:
                ok = self.holds_partition(k)
                verdict[k] = ok
            if not ok:
                fenced.add(i)
        return fenced

    # -- spill ---------------------------------------------------------------

    def _spill_owner_hint(self, pod: Pod) -> Optional[int]:
        """Feasibility hint: which partition
        OWNS the pod's selector-matching nodes. A nodeSelector/nodeName
        pod that NO_NODEs here almost always failed on feasibility, not
        capacity -- ring-ordered spill then walks it through every
        partition until it happens to land on the owner. This matches
        the pod's cached constraint signature (the static-mask-row key,
        ops/host_masks._constraint_signature -- same dedup the mask rows
        use) against the full Node kind and returns the partition owning
        the most matching nodes, so the spill stamps the owner directly:
        one hop max. Pods with no selector/nodeName get no hint (any
        partition is as good as the next -- ring order stands). The
        per-signature answer is cached until the Node list's
        resourceVersion moves."""
        sel = pod.spec.node_selector
        pinned = pod.spec.node_name
        if not sel and not pinned:
            return None
        from kubernetes_tpu_torch.ops.host_masks import _constraint_signature

        sig = _constraint_signature(pod)
        server = self.client.server
        try:
            # invalidate on NODE-kind mutations only: the kind's event
            # log ordinal (base + length) is a monotone count of node
            # adds/updates/deletes, unlike the global resourceVersion,
            # which every pod bind bumps (a cache keyed on that would
            # clear on essentially every call under load)
            node_gen = server._history_base.get(
                "Node", 0
            ) + len(server._history.get("Node", ()))
        except Exception:  # noqa: BLE001 - foreign server shape
            node_gen = -1
        cache = self._spill_hint_cache
        if node_gen < 0 or node_gen != self._spill_hint_rv:
            cache.clear()
            self._spill_hint_rv = node_gen
        elif sig in cache:
            return cache[sig]
        try:
            nodes, _rv = server.list("Node")
        except Exception:  # noqa: BLE001 - hint only: ring order stands
            return None
        counts: Dict[int, int] = {}
        for node in nodes:
            if pinned and node.metadata.name != pinned:
                continue
            labels = node.metadata.labels
            if sel and any(labels.get(k) != v for k, v in sel.items()):
                continue
            k = self.note_node(node)
            counts[k] = counts.get(k, 0) + 1
        hint = max(counts, key=counts.get) if counts else None
        cache[sig] = hint
        return hint

    def try_spill(self, pod: Pod) -> bool:
        """Re-stamp an unplaceable pod to the next partition not held by
        this stack and forward it through the apiserver. Returns True
        when the pod was forwarded (or turned out to be already bound:
        nothing left to do) -- the caller then skips the normal failure
        path. False = spill exhausted or impossible; fail normally."""
        P = self.num_partitions
        if P <= 1:
            return False
        ann = pod.metadata.annotations
        try:
            count = int(ann.get(SPILL_COUNT_ANNOTATION, "0"))
        except ValueError:
            count = 0
        if count >= P - 1:
            return False  # every partition has had a look
        cur = self.pod_partition(pod)
        visited = {cur}
        for tok in ann.get(SPILL_VISITED_ANNOTATION, "").split(","):
            try:
                visited.add(int(tok))
            except ValueError:
                pass
        target = None
        # feasibility hint first: stamp the partition that owns the
        # pod's selector-matching nodes directly (one hop max) instead
        # of walking the ring until the owner happens to come up
        hint = self._spill_owner_hint(pod)
        if (
            hint is not None and hint != cur
            and hint not in self.held and hint not in visited
        ):
            target = hint
            self.spill_hint_hits += 1
            metrics.spill_hint_hits.inc()
        if target is None:
            # UNVISITED-first: a hint hop desynchronizes the ring, so
            # the walk must not burn the hop budget revisiting
            # partitions that already failed while a fresh one remains
            for step in range(1, P):
                k = (cur + step) % P
                if k not in self.held and k not in visited:
                    target = k
                    break
        if target is None:
            # every unvisited partition is held HERE (this stack just
            # NO_NODEd the pod against its whole slice): fall back to
            # the classic ring revisit within the remaining hop budget
            for step in range(1, P):
                k = (cur + step) % P
                if k not in self.held:
                    target = k
                    break
        if target is None:
            return False  # we hold everything: nowhere to forward
        visited.add(target)

        class _AlreadyBound(Exception):
            pass

        def mutate(obj: Pod) -> None:
            if obj.spec.node_name:
                raise _AlreadyBound()
            # the stored object's annotations dict is shared with the
            # old revision (copy-on-write clones metadata shallowly) --
            # replace, never mutate in place
            obj.metadata.annotations = {
                **obj.metadata.annotations,
                SPILL_TARGET_ANNOTATION: str(target),
                SPILL_COUNT_ANNOTATION: str(count + 1),
                SPILL_VISITED_ANNOTATION: ",".join(
                    str(k) for k in sorted(visited)
                ),
            }

        try:
            self.client.server.guaranteed_update(
                "Pod", pod.metadata.namespace, pod.metadata.name, mutate
            )
        except _AlreadyBound:
            return True  # bound while we deliberated: nothing to do
        except KeyError:
            return True  # deleted: nothing to do
        except Exception:
            logger.exception("spilling pod %s", pod.key())
            return False
        metrics.pods_spilled.inc()
        self.sched.pods_spilled += 1
        return True

    # -- adoption / release --------------------------------------------------

    def _adopt_partition(self, k: int) -> None:
        """Bring partition ``k``'s state into this stack: nodes into the
        cache (tensor-cache slot claims), bound pods adopted, pending home pods
        (including a dead sibling's assumed-but-never-bound in-flight
        pods, which the apiserver still shows pending) requeued. Every
        entry point is idempotent against the informer's own delivery."""
        sched = self.sched
        try:
            nodes, _ = self.client.list_nodes()
        except Exception:
            logger.exception("adoption list_nodes for partition %d", k)
            nodes = []
        for node in nodes:
            if self.note_node(node) != k:
                continue
            try:
                sched.cache.add_node(node)
            except Exception:
                logger.exception("adopting node %s", node.metadata.name)
        attach = getattr(sched, "attach_volume_counts", None)
        try:
            pods, _ = self.client.list_pods()
        except Exception:
            logger.exception("adoption list_pods for partition %d", k)
            pods = []
        for pod in pods:
            if pod.spec.node_name:
                if self.node_partition(pod.spec.node_name) != k:
                    continue
                if sched.cache.get_pod(pod) is None:
                    try:
                        if attach is not None:
                            attach(pod)
                        sched.cache.add_pod(pod)
                        self.adoptions_bound += 1
                    except Exception:
                        logger.exception("adopting bound pod %s", pod.key())
            elif (
                self.pod_partition(pod) == k
                and pod.spec.scheduler_name in sched.profiles
                and pod.metadata.deletion_timestamp is None
            ):
                classify = getattr(sched, "classify_pod", None)
                try:
                    if classify is not None:
                        classify(pod)
                    sched.queue.add(pod)
                    self.adoptions_requeued += 1
                except Exception:
                    logger.exception("requeueing adopted pod %s", pod.key())

    def _drop_partition(self, k: int) -> None:
        """Evict partition ``k``'s state: its nodes leave the cache
        (their bound pods go with the NodeInfo; stranded assumed pods
        fast-expire through the cache's node_removed path and the sweeper
        routes them by apiserver truth)."""
        sched = self.sched
        try:
            names = [
                name for name in sched.cache.known_node_names()
                if self.node_partition(name) == k
            ]
        except Exception:
            logger.exception("listing cache nodes for partition %d", k)
            return
        from kubernetes_tpu_torch.api.types import Node

        for name in names:
            try:
                # remove resident pods first: remove_node keeps a
                # nodeless NodeInfo while pods remain, which would leak
                # phantom accounting for a partition we no longer own
                for pod in list(sched.cache.pods_on_node(name)):
                    sched.cache.remove_pod(pod)
                sched.cache.remove_node(
                    Node(metadata=ObjectMeta(name=name, namespace=""))
                )
            except Exception:
                logger.exception("dropping node %s", name)
        self.releases += 1

    # -- the loop ------------------------------------------------------------

    def step(self) -> None:
        """One coordination round: renew the member lease, compute the
        rendezvous-desired set over the live members, renew/claim
        desired partitions, release undesired ones (graceful handoff),
        and note foreign expiries for takeover metering."""
        now = self.clock()
        self._try_claim(self._member_name(), challenger_grace=False)
        members = self._live_members(now)
        assignment = compute_assignment(self.num_partitions, members)
        desired = {
            k for k, owner in assignment.items()
            if owner == self.identity
        }
        server = self.client.server
        for k in range(self.num_partitions):
            held = k in self.held
            if k in desired:
                was_foreign = False
                if not held:
                    # takeover vs fresh claim: is the lease currently
                    # someone else's (possibly expired)?
                    try:
                        obj = server.get(
                            "Lease", self.config.resource_namespace,
                            self._lease_name(k),
                        )
                        was_foreign = bool(obj.holder_identity) and (
                            obj.holder_identity != self.identity
                        )
                        expired = (
                            obj.renew_time
                            + obj.lease_duration_seconds <= now
                        )
                        if was_foreign and expired:
                            self._expiry_seen.setdefault(
                                k, time.perf_counter()
                            )
                        else:
                            # holder recovered (or it's our own/fresh
                            # lease): a stale detection stamp would
                            # inflate a LATER takeover's latency metric
                            self._expiry_seen.pop(k, None)
                    except KeyError:
                        pass
                    except Exception:
                        pass
                epoch = self._try_claim(
                    self._lease_name(k), challenger_grace=True
                )
                if epoch is None:
                    continue  # still held live by another: wait it out
                self._last_renewed[k] = self.clock()
                if not held:
                    with self._lock:
                        self.held[k] = epoch
                    t_claim = time.perf_counter()
                    self._adopt_partition(k)
                    if was_foreign:
                        # a seized (not fresh/released) partition: meter
                        # the takeover from expiry detection -- or from
                        # the claim, when the watch beat the tick -- to
                        # adoption complete
                        self.takeovers += 1
                        metrics.partition_takeovers.inc()
                        detected = self._expiry_seen.pop(k, None)
                        span = time.perf_counter() - (
                            detected if detected is not None else t_claim
                        )
                        metrics.partition_takeover_ms.observe(span * 1000.0)
                        flightrecorder.mark(
                            "partition_takeover", partition=k,
                            by=self.identity,
                            ms=round(span * 1000.0, 1),
                        )
                        logger.warning(
                            "partition %d adopted by %s in %.0f ms",
                            k, self.identity, span * 1000.0,
                        )
            elif held:
                # rendezvous says another live member owns this now
                # (a member joined): graceful handoff
                with self._lock:
                    self.held.pop(k, None)
                self._last_renewed.pop(k, None)
                self._drop_partition(k)
                self._release_lease(self._lease_name(k))
            else:
                # not desired, not held: any expiry detection for it is
                # no longer ours to meter
                self._expiry_seen.pop(k, None)
        # deposition: a held partition that has not renewed within the
        # lease duration may already be seized (our renews are failing,
        # or the map moved under us). Drop it locally -- commit fencing
        # already refuses it; this stops the stack WANTING its pods so
        # the adopter isn't shadow-raced on every batch. No release:
        # we cannot prove we still own the lease to clear it.
        now2 = self.clock()
        for k in list(self.held):
            renewed = self._last_renewed.get(k)
            if renewed is not None and (
                now2 - renewed > self.config.lease_duration_seconds
            ):
                logger.warning(
                    "partition %d lost by %s (renewals failing); "
                    "dropping locally", k, self.identity,
                )
                with self._lock:
                    self.held.pop(k, None)
                self._last_renewed.pop(k, None)
                self._drop_partition(k)
        metrics.partitions_held.set(float(len(self.held)))

    def _run(self) -> None:
        while not self._stop.is_set():
            if getattr(self.sched, "crashed", False):
                # simulated process death: abandon the leases (no
                # release -- a real crash wouldn't), let them lapse
                return
            try:
                self.step()
            except Exception:
                logger.exception("partition coordination step failed")
            self._wake.wait(self.config.retry_period_seconds)
            self._wake.clear()

    def _watch_map(self) -> None:
        """The map watch: Lease events where the holder CHANGED (a
        release, a seizure) wake the loop immediately instead of
        waiting out the retry period. Renewals (same holder) don't."""
        holders: Dict[str, str] = {}
        prefix = self.config.resource_prefix
        while not self._stop.is_set():
            try:
                evs = self._watch.next_batch(timeout=0.2)
            except Exception:  # noqa: BLE001 - lagged/stopped: reopen
                if self._stop.is_set():
                    return
                try:
                    self._watch = self.client.server.watch(
                        "Lease",
                        since_rv=self.client.server.current_rv(),
                    )
                except Exception:
                    self._stop.wait(0.2)
                continue
            changed = False
            for ev in evs:
                lease = ev.object
                if not lease.metadata.name.startswith(prefix):
                    continue
                prev = holders.get(lease.metadata.name)
                cur = lease.holder_identity
                holders[lease.metadata.name] = cur
                if prev is not None and prev != cur:
                    changed = True
            if changed:
                self._wake.set()

    def start(self) -> None:
        if self._thread is not None:
            return
        # claim synchronously once so callers see an initial ownership
        # set before informers start filtering on it
        try:
            self.step()
        except Exception:
            logger.exception("initial partition claim failed")
        try:
            self._watch = self.client.server.watch(
                "Lease", since_rv=self.client.server.current_rv()
            )
            self._watch_thread = threading.Thread(
                target=self._watch_map,
                name=f"partition-watch-{self.identity}", daemon=True,
            )
            self._watch_thread.start()
        except Exception:
            logger.exception("partition map watch failed to open")
        self._thread = threading.Thread(
            target=self._run, name=f"partition-{self.identity}",
            daemon=True,
        )
        self._thread.start()

    def stop(self, release: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if self._watch is not None:
            try:
                self._watch.stop()
            except Exception:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=2)
            self._watch_thread = None
        if release:
            for k in list(self.held):
                self._release_lease(self._lease_name(k))
            self._release_lease(self._member_name())
            self.held.clear()


def attach_partitioning(sched, client, config: PartitionConfiguration,
                        identity: str) -> PartitionCoordinator:
    """Wire a coordinator into a scheduler stack and install the
    server-side authority (idempotent per server). The coordinator is
    NOT started; the caller starts it before its informers sync so the
    event handlers filter from the first frame."""
    coordinator = PartitionCoordinator(client, sched, config, identity)
    sched.partition_coordinator = coordinator
    server = client.server
    if getattr(server, "_partition_authority", None) is None:
        server.install_partition_authority(
            PartitionAuthority(server, config)
        )
    return coordinator
