"""Quota controller: the multi-tenant hard-cap ledger.

Reference: the reference Kubernetes tree,
pkg/controller/resourcequota (the used-recalculation loop) +
plugin/pkg/admission/resourcequota (the check-and-increment admission
gate). This build fuses the two: the
scheduler is the admission point ("millions of users" contend at the
scheduling gate, not at object creation), so the controller owns

- the **charge**: ``try_admit(pod)`` atomically increments every
  matching quota's ``status.used`` through ``guaranteed_update`` (the
  PDB ``checkAndDecrement`` discipline -- concurrent gates contend on
  the stored counter, never on a stale informer read). A charge taken
  from quota A is given back if quota B then denies, so a denial never
  strands partial spend.
- the **refund**: a charged pod that fails to bind (requeue, spill,
  quarantine, crash recovery) or is deleted gives its units back --
  exactly once, keyed by uid -- so the ledger never leaks under chaos.
  Transport failures park the refund on a retry list drained by the
  controller loop instead of dropping it.
- the **wake**: quota-exhausted pods park typed-``QuotaExceeded`` in
  the scheduling queue (queue/scheduling_queue.py) and are released by
  EVENTS only -- a quota object add/update (hard may have risen) or a
  usage drop (refund/delete) marks the namespace dirty and the loop
  releases exactly the parked pods that now have headroom. Never polled.
- the **reconcile**: ``sync_all`` (startup, and per dirty namespace)
  recomputes ``used`` from ground truth -- bound pods plus live
  in-flight charges -- healing any drift a crash left behind.

Ledger semantics: ``used`` = requests of (bound pods) + (pods currently
charged for an in-flight scheduling attempt). A bind keeps the charge
(the pod now consumes real capacity); the eventual pod DELETE refunds
it. K8s charges at object creation instead; charging at the scheduling
gate keeps apiserver-side creation cheap at 100k pods/s and makes
``used`` reflect actual placements -- what the DRF dominant-share bias
(scheduler/tenancy.py) arbitrates on.

Multi-active note: charge/refund are safe from N scheduler stacks (the
apiserver serializes guaranteed_update), but ``sync_all``'s absolute
rewrite must run in ONE stack (the controller-manager analogue): two
concurrent absolute rewrites race adopt-then-rewrite and can clobber a
charge the other just landed. Partitioned deployments therefore attach
the partition coordinator (``partition_coordinator``); ``sync_all``
then runs only on the elected singleton writer -- the stack holding
the lowest live-held partition
(PartitionCoordinator.elected_singleton_writer) -- and every other
stack skips the rewrite (their charge/refund paths stay active).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api.types import (
    Pod,
    RESOURCE_PODS,
    ResourceQuota,
    pod_resource_requests,
)
from kubernetes_tpu_torch.client.informer import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)

#: the typed condition reason parked pods carry (PodScheduled=False)
QUOTA_EXCEEDED_REASON = "QuotaExceeded"


def quota_pod_usage(pod: Pod) -> Dict[str, int]:
    """The pod's quota-countable usage vector: its effective resource
    requests (memoized ``pod_resource_requests`` -- the ingest stamp
    already built it for plain pods) plus one unit of "pods". Base
    units match ResourceQuota.hard (milliCPU / bytes / counts)."""
    usage = dict(pod_resource_requests(pod))
    usage[RESOURCE_PODS] = usage.get(RESOURCE_PODS, 0) + 1
    return usage


class QuotaController:
    def __init__(self, client, informer_factory: InformerFactory) -> None:
        self.client = client
        self._quotas = informer_factory.resource_quotas()
        self._pods = informer_factory.pods()
        self._lock = threading.Lock()
        # uid -> (namespace, usage vector) for every live charge; the
        # exactly-once refund key
        self._charged: Dict[str, Tuple[str, Dict[str, int]]] = {}
        # namespace -> set of quota names (hot-path index: the gate's
        # no-quota fast path is one dict get)
        self._ns_index: Dict[str, Set[str]] = {}
        # per-quota refunds whose guaranteed_update failed (injected
        # api_unavailable): (namespace, quota_name, usage) retried by
        # the loop, never dropped -- and never widened to sibling
        # quotas whose give-back already landed
        self._refund_retry: List[Tuple[str, str, Dict[str, int]]] = []
        self._dirty: Set[str] = set()  # namespaces to recheck/release
        # pending QuotaExceeded condition writes, drained by the loop
        self._cond_writes: List[Tuple[Pod, str]] = []
        # quota objects FIRST seen mid-run (created after startup):
        # their used must adopt the namespace's existing charges before
        # the hard cap means anything -- resynced by the loop
        self._resync: Set[Tuple[str, str]] = set()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # wired by the scheduler (attach_queue): parked-pod accessors
        self._queue = None
        #: multi-active mode: the stack's PartitionCoordinator; when
        #: set, sync_all's absolute rewrite runs only on the elected
        #: singleton writer (see module docstring)
        self.partition_coordinator = None
        #: optional callback fired (namespace) whenever headroom may
        #: have appeared; the default release path goes through the
        #: attached queue directly
        self.on_headroom: Optional[Callable[[str], None]] = None
        # visibility counters (mirrored to metrics)
        self.admissions_granted = 0
        self.admissions_denied = 0
        self.refunds = 0
        self.releases = 0
        self.syncs_skipped_not_writer = 0

        self._quotas.add_event_handler(
            ResourceEventHandler(
                on_add=self._quota_changed,
                on_update=lambda old, new: self._quota_changed(new),
                on_delete=self._quota_deleted,
            )
        )
        # pod deletes refund the charge (bound pods hold theirs until
        # deletion; a charged pending pod deleted mid-queue refunds too)
        self._pods.add_event_handler(
            ResourceEventHandler(on_delete=self._pod_deleted)
        )

    # -- wiring ---------------------------------------------------------------

    def attach_queue(self, queue) -> None:
        """Wire the scheduling queue whose quota-parked pods this
        controller releases on headroom events."""
        self._queue = queue

    # -- event handlers -------------------------------------------------------

    def _quota_changed(self, quota: ResourceQuota) -> None:
        ns = quota.metadata.namespace
        name = quota.metadata.name
        with self._lock:
            names = self._ns_index.setdefault(ns, set())
            fresh = name not in names
            names.add(name)
            if fresh:
                # a quota object this controller has never indexed: its
                # used=0 knows nothing of the namespace's existing
                # bound/in-flight charges -- without adoption the cap
                # would silently overspend until a restart's sync_all.
                # (Our own status-write echoes arrive already-indexed,
                # so they never re-queue a resync.)
                self._resync.add((ns, name))
        self._mark_dirty(ns)

    def _quota_deleted(self, quota: ResourceQuota) -> None:
        ns = quota.metadata.namespace
        with self._lock:
            names = self._ns_index.get(ns)
            if names is not None:
                names.discard(quota.metadata.name)
                if not names:
                    del self._ns_index[ns]
        # one fewer cap can only ADD headroom
        self._mark_dirty(ns)

    def _pod_deleted(self, pod: Pod) -> None:
        self.refund(pod, reason="delete")

    def _mark_dirty(self, namespace: str) -> None:
        with self._cond:
            self._dirty.add(namespace)
            self._cond.notify()

    # -- the admission gate ---------------------------------------------------

    def has_quota(self, namespace: str) -> bool:
        return namespace in self._ns_index

    def _quotas_in(self, namespace: str) -> List[ResourceQuota]:
        names = self._ns_index.get(namespace)
        if not names:
            return []
        out = []
        for name in sorted(names):
            q = self._quotas.get(namespace, name)
            if q is not None:
                out.append(q)
        return out

    def try_admit(self, pod: Pod) -> str:
        """Charge the pod against every quota in its namespace. Returns
        "" on grant (or when no quota binds / the pod already holds a
        charge), else the denial message. All-or-nothing across quota
        objects: a later denial refunds what earlier objects already
        took (the ``can_disrupt`` discipline). Raises on transport
        failure -- the caller routes the pod to a backoff retry, never
        to the event-woken park (a park with no wake event strands)."""
        ns = pod.metadata.namespace
        if ns not in self._ns_index:
            return ""
        uid = pod.metadata.uid
        with self._lock:
            if uid in self._charged:
                return ""  # an earlier attempt's charge still stands
        quotas = self._quotas_in(ns)
        if not quotas:
            return ""
        usage = quota_pod_usage(pod)
        # read-only pre-check against the lister: a pod that clearly
        # does not fit is denied WITHOUT the transactional write (a
        # guaranteed_update on the deny path would store an unchanged
        # object, bump rv, and fan a MODIFIED out to every informer
        # set per denial). Staleness is safe both ways: a spurious
        # deny parks the pod and the park's dirty-recheck releases it
        # against real headroom; a spurious pass falls through to the
        # authoritative check-and-increment below.
        room = self._headroom(ns)
        if room is not None:
            for rname, avail in room.items():
                if usage.get(rname, 0) > avail:
                    self.admissions_denied += 1
                    metrics.quota_admissions.inc(result="denied")
                    return (
                        f"exceeded quota in {ns}: {rname} over hard limit"
                    )
        charged: List[ResourceQuota] = []
        denial = ""
        for q in quotas:
            verdict = {}

            def check_and_increment(obj: ResourceQuota) -> None:
                # copy-on-write discipline: guaranteed_update shares
                # nested collections with the stored old object
                used = dict(obj.status.used)
                for name, hard in obj.hard.items():
                    if used.get(name, 0) + usage.get(name, 0) > hard:
                        verdict["over"] = name
                        return
                for name in obj.hard:
                    add = usage.get(name, 0)
                    if add:
                        used[name] = used.get(name, 0) + add
                obj.status.used = used
                obj.status.hard = dict(obj.hard)

            try:
                self.client.update_resource_quota_status(
                    q.metadata.namespace, q.metadata.name,
                    check_and_increment,
                )
            except KeyError:
                continue  # quota deleted mid-check: it no longer binds
            except Exception:
                # transport failure mid-charge: give back what this
                # attempt already took (retry list on failure -- never
                # a leak), then re-raise so the caller routes the pod
                # to the backoff clock instead of the event-woken park
                for g in charged:
                    try:
                        self._decrement(
                            g.metadata.namespace, g.metadata.name, usage
                        )
                    except Exception:  # noqa: BLE001 - retried by loop
                        with self._lock:
                            self._refund_retry.append(
                                (ns, g.metadata.name, usage)
                            )
                raise
            over = verdict.get("over")
            if over is not None:
                denial = (
                    f"exceeded quota {q.metadata.name}: "
                    f"{over} over hard limit"
                )
                break
            charged.append(q)
        if denial:
            # give back what this attempt already took from the other
            # matching quotas (best effort; a failed give-back lands on
            # the retry list so it is never silently lost)
            for g in charged:
                try:
                    self._decrement(g.metadata.namespace,
                                    g.metadata.name, usage)
                except Exception:  # noqa: BLE001 - retried by the loop
                    with self._lock:
                        self._refund_retry.append(
                            (ns, g.metadata.name, usage)
                        )
            self.admissions_denied += 1
            metrics.quota_admissions.inc(result="denied")
            return denial
        with self._lock:
            self._charged[uid] = (ns, usage)
        # close the delete race: a DELETE event processed between the
        # increments above and the charge store found nothing to refund
        # (its handler runs only AFTER the informer store reflects the
        # delete, so a lister re-read here sees every such delete); a
        # delete landing after this check finds the stored charge
        live = self._pods.get(ns, pod.metadata.name)
        if live is None or live.metadata.uid != uid:
            self.refund(pod, reason="delete")
            return ""  # moot: the pod is gone; caller's skip paths drop it
        self.admissions_granted += 1
        metrics.quota_admissions.inc(result="granted")
        return ""

    def note_parked(self, pod: Pod, denial: str) -> None:
        """Bookkeeping for a pod the gate just parked: the typed
        condition write (async -- the gate runs on the dispatcher
        thread), the flight-recorder mark, and a dirty-recheck so a
        refund racing the park can never strand it (the lost-wakeup
        guard)."""
        metrics.quota_parked.set(
            self._queue.quota_parked_count()
            if self._queue is not None else 0.0
        )
        flightrecorder.mark(
            "quota_denied", pod=pod.metadata.uid,
            namespace=pod.metadata.namespace, message=denial,
        )
        self._write_condition_async(pod, denial)
        self._mark_dirty(pod.metadata.namespace)

    def charged_uids(self) -> Set[str]:
        with self._lock:
            return set(self._charged)

    # -- refunds --------------------------------------------------------------

    def _decrement(self, namespace: str, name: str,
                   usage: Dict[str, int]) -> None:
        def give_back(obj: ResourceQuota) -> None:
            used = dict(obj.status.used)
            for rname, qty in usage.items():
                if rname in used and qty:
                    used[rname] = max(0, used[rname] - qty)
            obj.status.used = used

        self.client.update_resource_quota_status(namespace, name, give_back)

    def refund(self, pod: Pod, reason: str = "requeue") -> bool:
        """Give back a charged pod's units (exactly once, uid-keyed).
        Returns True when a refund actually happened. Transport
        failures land the refund on the retry list -- the ledger heals
        instead of leaking."""
        uid = pod.metadata.uid
        with self._lock:
            entry = self._charged.pop(uid, None)
        if entry is None:
            return False
        ns, usage = entry
        self.refunds += 1
        metrics.quota_refunds.inc(reason=reason)
        flightrecorder.mark(
            "quota_refund", pod=uid, namespace=ns, reason=reason,
        )
        for q in self._quotas_in(ns):
            try:
                self._decrement(q.metadata.namespace, q.metadata.name, usage)
            except KeyError:
                continue  # quota deleted: nothing to give back to
            except Exception:  # noqa: BLE001 - retried by the loop
                with self._lock:
                    self._refund_retry.append(
                        (ns, q.metadata.name, usage)
                    )
        self._mark_dirty(ns)  # usage dropped: parked pods may fit now
        return True

    # -- the typed condition --------------------------------------------------

    def _write_condition_async(self, pod: Pod, message: str) -> None:
        """PodScheduled=False / reason=QuotaExceeded on the apiserver --
        the operator-visible half of the park. Status-only, so the
        write's own echo never wakes the parked pod (the queue's
        ``_is_pod_updated`` guard). Enqueued for the controller LOOP
        (never written on the dispatcher thread, and never a
        thread-per-denial: a park storm is the COMMON case for this
        plane, unlike the quarantine park's rare one)."""
        if self.client is None:
            return
        with self._cond:
            self._cond_writes.append((pod, message))
            self._cond.notify()

    def _write_condition(self, pod: Pod, message: str) -> None:
        from kubernetes_tpu_torch.api.types import PodCondition

        def set_condition(p: Pod) -> None:
            p.status.conditions = [
                c for c in p.status.conditions if c.type != "PodScheduled"
            ] + [
                PodCondition(
                    type="PodScheduled", status="False",
                    reason=QUOTA_EXCEEDED_REASON, message=message,
                )
            ]

        try:
            self.client.update_pod_status(
                pod.metadata.namespace, pod.metadata.name, set_condition
            )
        except KeyError:
            pass  # deleted while parking
        except Exception:  # noqa: BLE001 - the park itself already took
            logger.exception(
                "writing QuotaExceeded condition for %s", pod.key()
            )

    # -- headroom recheck + parked release ------------------------------------

    def _headroom(self, namespace: str) -> Optional[Dict[str, int]]:
        """Elementwise min headroom across the namespace's quotas (None
        when no quota binds = unbounded). AUTHORITATIVE store reads
        (plain gets -- no write, no rv bump, no watch fan-out): the
        gate's own charge/refund writes outrun the informer during a
        burst, and a lister-stale headroom would spuriously deny-park
        freshly refunded capacity. The decision is still advisory; the
        pod re-runs the atomic charge at its next pop."""
        names = self._ns_index.get(namespace)
        if not names:
            return None
        quotas = []
        for name in sorted(names):
            try:
                quotas.append(
                    self.client.get("ResourceQuota", namespace, name)
                )
            except KeyError:
                continue
            except Exception:  # noqa: BLE001 - advisory: fall back
                q = self._quotas.get(namespace, name)
                if q is not None:
                    quotas.append(q)
        if not quotas:
            return None
        room: Dict[str, int] = {}
        for q in quotas:
            for name, hard in q.hard.items():
                avail = hard - q.status.used.get(name, 0)
                if name in room:
                    room[name] = min(room[name], avail)
                else:
                    room[name] = avail
        return room

    def _recheck_namespace(self, namespace: str) -> int:
        """Release the parked pods of ``namespace`` that now fit the
        quota headroom (greedy, park order). Releasing only what fits
        prevents the release->deny->park churn loop; the released pods
        still run the real atomic charge at pop."""
        queue = self._queue
        if queue is None:
            if self.on_headroom is not None:
                self.on_headroom(namespace)
            return 0
        parked = queue.quota_parked_infos(namespace)
        if not parked:
            return 0
        room = self._headroom(namespace)
        to_release = []
        for pi in parked:
            if room is None:
                to_release.append(pi)
                continue
            usage = quota_pod_usage(pi.pod)
            if all(
                usage.get(name, 0) <= avail for name, avail in room.items()
            ):
                for name in room:
                    room[name] -= usage.get(name, 0)
                to_release.append(pi)
        if not to_release:
            return 0
        released = queue.release_quota_parked(to_release)
        if released:
            self.releases += released
            metrics.quota_releases.inc(released)
            metrics.quota_parked.set(queue.quota_parked_count())
        return released

    # -- reconcile ------------------------------------------------------------

    def sync_all(self) -> None:
        """Absolute used-recalculation (startup recovery / drift heal):
        adopt every BOUND, non-terminating pod into the charge ledger
        (a restarted scheduler has no in-flight charges to preserve),
        then rewrite each quota's ``used`` from the ledger. Runs in ONE
        stack: in multi-active partitioned mode only the elected
        singleton writer (lowest live-held partition) performs the
        absolute rewrite -- a second concurrent rewriter could adopt
        the same bound pods and clobber a charge the first just landed
        (see module docstring)."""
        coord = self.partition_coordinator
        if coord is not None and not coord.elected_singleton_writer():
            self.syncs_skipped_not_writer += 1
            logger.info(
                "quota sync_all skipped: not the elected singleton "
                "writer (lowest live-held partition is foreign)"
            )
            return
        with self._lock:
            bound_uids = {
                uid for uid, (ns, _u) in self._charged.items()
            }
        for pod in self._pods.list():
            if not pod.spec.node_name:
                continue
            if pod.metadata.deletion_timestamp is not None:
                continue
            if pod.metadata.uid in bound_uids:
                continue
            with self._lock:
                self._charged[pod.metadata.uid] = (
                    pod.metadata.namespace, quota_pod_usage(pod)
                )
        # per-namespace totals from the ledger
        totals: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for _uid, (ns, usage) in self._charged.items():
                t = totals.setdefault(ns, {})
                for name, qty in usage.items():
                    t[name] = t.get(name, 0) + qty
        for quota in self._quotas.list():
            ns = quota.metadata.namespace
            t = totals.get(ns, {})

            def rewrite(obj: ResourceQuota) -> None:
                obj.status.used = {
                    name: t.get(name, 0) for name in obj.hard
                }
                obj.status.hard = dict(obj.hard)

            try:
                self.client.update_resource_quota_status(
                    ns, quota.metadata.name, rewrite
                )
            except KeyError:
                continue
            except Exception:
                logger.exception("reconciling quota %s", quota.key())
            self._mark_dirty(ns)

    def _resync_quota(self, namespace: str, name: str) -> None:
        """Adopt the namespace's existing usage into one quota's
        ``used`` (a quota created mid-run starts at 0 and would
        otherwise admit past its cap). Pods that ran the gate while the
        namespace was quota-FREE were never charged, so the namespace's
        BOUND pods are adopted into the ledger first (the sync_all
        adoption, scoped); the total is then computed INSIDE the
        guaranteed_update mutate -- the store lock serializes it
        against concurrent charge increments, so the rewrite can never
        clobber a charge that landed after the count. (A free-admitted
        pod still in flight when the quota lands binds uncharged until
        the next restart's sync_all -- a one-batch-deep window.)"""
        for pod in self._pods.list():
            if (
                pod.metadata.namespace != namespace
                or not pod.spec.node_name
                or pod.metadata.deletion_timestamp is not None
            ):
                continue
            with self._lock:
                if pod.metadata.uid not in self._charged:
                    self._charged[pod.metadata.uid] = (
                        namespace, quota_pod_usage(pod)
                    )

        def rewrite(obj: ResourceQuota) -> None:
            with self._lock:
                total: Dict[str, int] = {}
                for _uid, (ns2, usage) in self._charged.items():
                    if ns2 != namespace:
                        continue
                    for rname, qty in usage.items():
                        total[rname] = total.get(rname, 0) + qty
            obj.status.used = {
                rname: total.get(rname, 0) for rname in obj.hard
            }
            obj.status.hard = dict(obj.hard)

        try:
            self.client.update_resource_quota_status(
                namespace, name, rewrite
            )
        except KeyError:
            pass  # deleted before the resync ran
        except Exception:
            logger.exception("resyncing quota %s/%s", namespace, name)
            with self._lock:
                self._resync.add((namespace, name))

    def drain_resync(self) -> None:
        """Deterministically run the pending mid-run quota adoptions
        (the loop's resync step, callable from tests/startup)."""
        with self._lock:
            resync, self._resync = self._resync, set()
        for ns, name in resync:
            self._resync_quota(ns, name)

    # -- loop -----------------------------------------------------------------

    def _drain_refund_retries(self) -> None:
        with self._lock:
            retries, self._refund_retry = self._refund_retry, []
        for ns, qname, usage in retries:
            try:
                self._decrement(ns, qname, usage)
            except KeyError:
                continue  # quota deleted: the debt died with it
            except Exception:  # noqa: BLE001 - keep retrying
                with self._lock:
                    self._refund_retry.append((ns, qname, usage))
                continue
            self._mark_dirty(ns)

    def run(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                while (
                    not self._dirty
                    and not self._refund_retry
                    and not self._resync
                    and not self._cond_writes
                    and not self._stop.is_set()
                ):
                    self._cond.wait(0.5)
                dirty, self._dirty = self._dirty, set()
                writes, self._cond_writes = self._cond_writes, []
            for pod, message in writes:
                self._write_condition(pod, message)
            self.drain_resync()
            if self._refund_retry:
                self._drain_refund_retries()
            for ns in dirty:
                try:
                    self._recheck_namespace(ns)
                except Exception:
                    logger.exception("quota recheck for namespace %s", ns)
            if self._refund_retry or self._resync:
                # work that FAILED this pass (transport down) stays
                # queued; back off instead of busy-spinning the
                # decrement loop against a dead apiserver
                self._stop.wait(0.2)

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(
            target=self.run, name="quota-controller", daemon=True
        )
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
