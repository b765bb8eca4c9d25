"""Control-plane resilience: crash recovery, the assumed-pod TTL sweeper,
and the cache<->apiserver drift checker.

Reference analogues:

- ``recover_on_startup``: the new-leader resume semantics
  (server.go:241) -- nothing is persisted by the scheduler; a fresh
  incarnation relists, ADOPTS pods already bound by its predecessor, and
  requeues pods that died mid-flight (assumed but never bound, which the
  apiserver still shows as pending). This function runs after the
  informers' initial sync and verifies/meters that rebuild.
- ``ControlPlaneReconciler``: the reference's cleanupAssumedPods
  goroutine (cache.go run every 1s) -- dead code here since the seed
  (``cleanup_expired_assumed_pods`` had zero callers) -- plus a drift
  checker in the spirit of the cache comparer (internal/cache/debugger),
  promoted from a debug endpoint to a self-healing sweep: divergence
  between the cache and a fresh apiserver list is healed in place and
  counted in ``scheduler_cache_drift_total``.

Everything is observable: adoption, requeues, expiries, and every healed
divergence land in metrics (utils/metrics.py), because a failover or
restart must be as rehearsed -- and as visible -- as a solver fault.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, TYPE_CHECKING

from kubernetes_tpu_torch.api.types import Node, ObjectMeta
from kubernetes_tpu_torch.utils import metrics

if TYPE_CHECKING:
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# crash recovery
# ---------------------------------------------------------------------------


@dataclass
class RecoveryReport:
    adopted: int = 0  # bound pods inherited from the previous incarnation
    requeued: int = 0  # pending pods (incl. predecessor's in-flight ones)
    healed: int = 0  # bound pods the informer sync somehow missed


def _attach_volume_counts(sched, pod) -> None:
    """Every direct cache adoption must resolve the pod's attachable-
    volume counts first (BatchScheduler.attach_volume_counts), or the
    re-adopted pod's attaches go uncounted in NodeInfo.volume_in_use and
    the device volume-limit columns over-admit past the node's CSINode
    allocatable. The normal informer path does this in eventhandlers;
    recovery/heal paths bypass it, so mirror it here."""
    attach = getattr(sched, "attach_volume_counts", None)
    if attach is not None:
        attach(pod)


def recover_on_startup(sched: "Scheduler", client: "Client") -> RecoveryReport:
    """Verify + meter the post-restart rebuild against apiserver ground
    truth. The informers' list+watch already rebuilt cache and queue; this
    pass catches anything that slipped (a bound pod missing from the
    cache is re-adopted directly) and publishes the adoption counts a
    restarted control plane is judged by."""
    report = RecoveryReport()
    try:
        pods, _ = client.list_pods()
    except Exception:
        # apiserver unavailable at startup (injected or real): the
        # informers' relist-retry machinery still converges the caches;
        # recovery just goes unmetered for this incarnation
        logger.exception("startup recovery list failed; skipping")
        return report
    # partitioned stack: recovery is scoped to the held partitions --
    # a sibling's pods and nodes are its incarnation's job
    coord = getattr(sched, "partition_coordinator", None)
    for pod in pods:
        if pod.spec.node_name:
            if coord is not None and not coord.owns_node(
                pod.spec.node_name
            ):
                continue
            report.adopted += 1
            if sched.cache.get_pod(pod) is None:
                # informer sync missed it (watch raced the relist): adopt
                try:
                    _attach_volume_counts(sched, pod)
                    sched.cache.add_pod(pod)
                    report.healed += 1
                except Exception:
                    logger.exception("adopting bound pod %s", pod.key())
        elif (
            pod.spec.scheduler_name in sched.profiles
            and pod.metadata.deletion_timestamp is None
            and (coord is None or coord.wants_pod(pod))
        ):
            # pending: either genuinely new or a predecessor's
            # assumed-but-never-bound in-flight pod -- both are pending
            # at the apiserver and must (re)enter the queue. The keyed
            # activeQ makes this idempotent against the informer's add.
            report.requeued += 1
            try:
                sched.queue.add(pod)
            except Exception:
                logger.exception("requeueing pending pod %s", pod.key())
    if report.adopted:
        metrics.pods_adopted_on_restart.inc(report.adopted)
    if report.requeued:
        metrics.pods_requeued_on_restart.inc(report.requeued)
    logger.info(
        "startup recovery: adopted %d bound pod(s) (%d healed into the "
        "cache), requeued %d pending pod(s)",
        report.adopted, report.healed, report.requeued,
    )
    return report


# ---------------------------------------------------------------------------
# the sweeper: assumed-pod TTL expiry + drift checking
# ---------------------------------------------------------------------------


@dataclass
class DriftReport:
    """One drift check's findings (already healed when returned)."""

    pods_readopted: int = 0  # bound in API, missing from cache
    pods_evicted: int = 0  # in cache, gone from / not bound in API
    pods_requeued: int = 0  # evicted pods still pending in API
    nodes_added: int = 0
    nodes_removed: int = 0

    def total(self) -> int:
        return (
            self.pods_readopted + self.pods_evicted
            + self.nodes_added + self.nodes_removed
        )


class ControlPlaneReconciler:
    """Periodic sweeper thread: every ``sweep_interval`` expire assumed
    pods whose binding finished > TTL ago (the confirmation never
    arrived); every ``drift_interval`` diff cache state against a fresh
    apiserver list and heal divergence in place.

    Healing actions reuse the exact informer-driven cache entry points
    (add_pod/remove_pod/add_node/remove_node), so a heal that races the
    real watch event degenerates to a no-op on whichever side lands
    second."""

    def __init__(
        self,
        sched: "Scheduler",
        client: "Client",
        sweep_interval: float = 1.0,
        drift_interval: float = 5.0,
        carry_audit_interval: float = 2.0,
    ) -> None:
        self.sched = sched
        self.client = client
        self.sweep_interval = max(0.01, sweep_interval)
        self.drift_interval = max(self.sweep_interval, drift_interval)
        self.carry_audit_interval = max(
            self.sweep_interval, carry_audit_interval
        )
        self._stop = threading.Event()
        self._thread = None
        self.sweeps = 0
        self.drift_checks = 0
        self.carry_audits = 0

    # -- assumed-pod TTL expiry (the formerly dead cache path) --------------

    def sweep_assumed_once(self) -> List:
        """Run the cache's TTL expiry and route each expired pod by
        apiserver ground truth: still pending -> requeue for another
        attempt; actually bound (the bind landed but its confirmation
        was lost) -> re-adopt; deleted -> nothing to do."""
        expired = self.sched.cache.cleanup_expired_assumed_pods()
        for pod in expired:
            node_removed = pod.__dict__.pop("_node_removed_expired", False)
            metrics.assumed_pods_expired.inc()
            if node_removed:
                logger.warning(
                    "assumed pod %s fast-expired (node %s deleted "
                    "mid-bind)", pod.key(), pod.spec.node_name,
                )
            else:
                logger.warning(
                    "assumed pod %s expired (binding finished, "
                    "confirmation never arrived)", pod.key(),
                )
            try:
                live = self.client.get_pod(
                    pod.metadata.namespace, pod.metadata.name
                )
            except KeyError:
                continue  # deleted while assumed: already forgotten
            except Exception:
                logger.exception("checking expired pod %s", pod.key())
                continue
            try:
                if live.spec.node_name:
                    _attach_volume_counts(self.sched, live)
                    self.sched.cache.add_pod(live)
                    metrics.cache_drift.inc(kind="pod", action="readopt")
                else:
                    self.sched.queue.add(live)
                    if node_removed:
                        metrics.node_removed_requeues.inc()
            except Exception:
                logger.exception("routing expired pod %s", pod.key())
        return expired

    # -- drift checking ------------------------------------------------------

    def check_drift_once(self) -> DriftReport:
        report = DriftReport()
        cache = self.sched.cache
        try:
            pods, _ = self.client.list_pods()
            nodes, _ = self.client.list_nodes()
        except Exception:
            logger.exception("drift check list failed; will retry")
            return report
        # partitioned stack: the cache legitimately excludes foreign
        # partitions, so the drift sweep only compares the owned slice
        # (healing a sibling's nodes in would phantom-double capacity)
        coord = getattr(self.sched, "partition_coordinator", None)
        if coord is not None:
            nodes = [
                n for n in nodes if coord.owns_node_obj(n)
            ]
            pods = [
                p for p in pods
                if (
                    coord.owns_node(p.spec.node_name)
                    if p.spec.node_name
                    else coord.wants_pod(p)
                )
            ]
        cached = cache.pod_states_snapshot()
        api_bound: Dict[str, object] = {
            p.metadata.uid: p for p in pods if p.spec.node_name
        }

        def fresh(pod):
            """Per-pod re-read at heal time. The list above happened
            BEFORE the cache snapshot, so a pod that bound (or was
            deleted) in between looks divergent on stale evidence; a
            heal moves real capacity, so it only acts on a fresh read.
            Returns (ok, live): ok False = unverifiable, skip."""
            try:
                return True, self.client.get_pod(
                    pod.metadata.namespace, pod.metadata.name
                )
            except KeyError:
                return True, None  # genuinely gone
            except Exception:
                logger.exception("drift re-check for %s", pod.key())
                return False, None

        # bound in the API but missing from the cache: the scheduler is
        # blind to real capacity consumption -- re-adopt
        for uid, pod in api_bound.items():
            if uid in cached:
                continue
            ok, live = fresh(pod)
            if not ok or live is None or not live.spec.node_name:
                continue  # deleted/unbound since the list: not drift
            try:
                _attach_volume_counts(self.sched, live)
                cache.add_pod(live)
                report.pods_readopted += 1
                metrics.cache_drift.inc(kind="pod", action="readopt")
            except Exception:
                logger.exception("re-adopting drifted pod %s", pod.key())

        # in the cache but the API disagrees: phantom capacity. Assumed
        # entries are the scheduler's own in-flight overlay -- NEVER
        # healed here (the TTL sweep owns their lifecycle).
        for uid, (pod, assumed) in cached.items():
            if assumed or uid in api_bound:
                continue
            ok, live = fresh(pod)
            if not ok:
                continue
            if (
                live is not None
                and live.metadata.uid == uid
                and live.spec.node_name
            ):
                continue  # bound between the list and the snapshot
            try:
                cache.remove_pod(pod)
                report.pods_evicted += 1
                metrics.cache_drift.inc(kind="pod", action="evict")
            except Exception:
                logger.exception("evicting drifted pod %s", pod.key())
                continue
            if (
                live is not None
                and live.metadata.uid == uid
                and live.spec.scheduler_name in self.sched.profiles
                and live.metadata.deletion_timestamp is None
                and (coord is None or coord.wants_pod(live))
            ):
                # the pod still wants scheduling (cache wrongly believed
                # it placed): give it back to the queue
                try:
                    self.sched.queue.add(live)
                    report.pods_requeued += 1
                    metrics.cache_drift.inc(kind="pod", action="requeue")
                except Exception:
                    logger.exception("requeueing drifted pod %s", pod.key())

        api_nodes = {n.metadata.name: n for n in nodes}
        cached_nodes = set(cache.known_node_names())
        for name, node in api_nodes.items():
            if name not in cached_nodes:
                try:
                    cache.add_node(node)
                    report.nodes_added += 1
                    metrics.cache_drift.inc(kind="node", action="add")
                except Exception:
                    logger.exception("adding drifted node %s", name)
        for name in cached_nodes - set(api_nodes):
            try:
                cache.remove_node(
                    Node(metadata=ObjectMeta(name=name, namespace=""))
                )
                report.nodes_removed += 1
                metrics.cache_drift.inc(kind="node", action="remove")
            except Exception:
                logger.exception("removing drifted node %s", name)
        if report.total():
            logger.warning(
                "drift check healed %d divergence(s): +%d/-%d pods "
                "(%d requeued), +%d/-%d nodes",
                report.total(), report.pods_readopted, report.pods_evicted,
                report.pods_requeued, report.nodes_added,
                report.nodes_removed,
            )
        return report

    # -- carry integrity audit (blast-radius containment, ISSUE 14) ---------

    def audit_carry_once(self) -> str:
        """Run the batch scheduler's device-carry integrity audit
        (BatchScheduler.audit_carry): cheap on-device checksums of the
        resident req/nzr/alloc/valid state against the host shadow,
        full compare + counted-upload heal only on mismatch. A plain
        (non-batch) scheduler has no carry; returns "unsupported"
        then."""
        audit = getattr(self.sched, "audit_carry", None)
        if audit is None:
            return "unsupported"
        return audit()

    # -- the loop ------------------------------------------------------------

    def _run(self) -> None:
        next_drift = self.drift_interval
        next_audit = self.carry_audit_interval
        elapsed = 0.0
        while not self._stop.wait(self.sweep_interval):
            elapsed += self.sweep_interval
            try:
                self.sweep_assumed_once()
                self.sweeps += 1
            except Exception:
                logger.exception("assumed-pod sweep failed")
            if elapsed >= next_audit:
                next_audit = elapsed + self.carry_audit_interval
                try:
                    if self.audit_carry_once() != "unsupported":
                        self.carry_audits += 1
                except Exception:
                    logger.exception("carry integrity audit failed")
            if elapsed >= next_drift:
                next_drift = elapsed + self.drift_interval
                try:
                    self.check_drift_once()
                    self.drift_checks += 1
                except Exception:
                    logger.exception("drift check failed")

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="cp-reconciler", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
