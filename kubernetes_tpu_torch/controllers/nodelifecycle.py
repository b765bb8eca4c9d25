"""Node lifecycle controller: heartbeat-driven failure detection.

Reference: pkg/controller/nodelifecycle/node_lifecycle_controller.go
(:171 monitors NodeStatus + coordination Leases, :303/:324 marks stale
nodes NotReady and applies NoExecute taints) plus the NoExecute taint
manager's eviction of intolerant pods. The scheduler side needs no
changes: its TaintToleration filter already keeps new pods off tainted
nodes, and the eviction deletes wake parked pods via the normal
informer paths.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.api.types import (
    Node,
    NodeCondition,
    TAINT_EFFECT_NO_EXECUTE,
    Taint,
)
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.kubelet.hollow import LEASE_NAMESPACE
from kubernetes_tpu_torch.robustness.ladder import LadderExhausted
from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)

TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"


class NodeLifecycleController:
    def __init__(
        self,
        client,
        informer_factory: InformerFactory,
        grace_period: float = 40.0,
        monitor_interval: float = 5.0,
        now=time.time,
        disruption=None,
    ) -> None:
        """``disruption``: an optional DisruptionController whose
        ``can_disrupt`` gate taint evictions share with node drains --
        one PDB budget for EVERY voluntary disruption path, so a rolling
        upgrade and an unreachable-node eviction can't independently
        spend the same budget."""
        self.client = client
        self._nodes = informer_factory.nodes()
        self._pods = informer_factory.pods()
        self.grace_period = grace_period
        self.monitor_interval = monitor_interval
        self._now = now
        self.disruption = disruption
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.evictions = 0
        self.evictions_blocked = 0  # denied by the shared PDB gate

    # -- one monitor pass (monitorNodeHealth, :303) --------------------------

    def monitor_once(self) -> None:
        now = self._now()
        for node in self._nodes.list():
            name = node.metadata.name
            lease = self._lease(name)
            fresh = (
                lease is not None
                and now - lease.renew_time <= self.grace_period
            )
            tainted = any(
                t.key == TAINT_UNREACHABLE for t in node.spec.taints
            )
            if fresh and tainted:
                self._untaint(name)
            elif not fresh and lease is not None:
                # had a heartbeat once, lost it: unreachable. Eviction
                # reconciles EVERY pass while the node stays stale (the
                # NoExecute taint manager is continuous, not edge-
                # triggered): pods that appear on the node later -- or
                # that a lagging informer missed at transition time --
                # still get evicted.
                if not tainted:
                    self._mark_unreachable(name)
                self._evict_intolerant_pods(name)

    def _lease(self, name: str):
        try:
            return self.client.server.get("Lease", LEASE_NAMESPACE, name)
        except KeyError:
            return None

    def _mark_unreachable(self, name: str) -> None:
        def mutate(node: Node) -> None:
            # dedup inside the mutate closure: guaranteed_update has
            # refetched the authoritative object, so a stale informer
            # view in monitor_once can't stack duplicate taints
            if any(t.key == TAINT_UNREACHABLE for t in node.spec.taints):
                return
            node.spec.taints = list(node.spec.taints) + [
                Taint(
                    key=TAINT_UNREACHABLE,
                    effect=TAINT_EFFECT_NO_EXECUTE,
                )
            ]
            node.status.conditions = [
                c for c in node.status.conditions if c.type != "Ready"
            ] + [NodeCondition(type="Ready", status="Unknown")]

        try:
            self.client.server.guaranteed_update("Node", "", name, mutate)
            # the lapse mark + the per-pod taint_eviction marks below are
            # the flight-recorder spine a post-mortem replays: the dump
            # alone reconstructs every heartbeat-lapse eviction arc
            metrics.node_heartbeat_lapses.inc()
            flightrecorder.mark("heartbeat_lapse", node=name)
            logger.warning("node %s marked unreachable (stale lease)", name)
        except KeyError:
            pass

    def _untaint(self, name: str) -> None:
        def mutate(node: Node) -> None:
            node.spec.taints = [
                t for t in node.spec.taints if t.key != TAINT_UNREACHABLE
            ]

        try:
            self.client.server.guaranteed_update("Node", "", name, mutate)
        except KeyError:
            pass

    def _evict_intolerant_pods(self, node_name: str) -> None:
        """NoExecute semantics: pods without a matching toleration are
        evicted (the NoExecuteTaintManager, zero toleration-seconds
        model) -- THROUGH the shared PDB gate when a
        DisruptionController is wired: a taint eviction and a drain
        spend the same ``can_disrupt`` budget, and a denied pod is
        retried on the next monitor pass (the reconcile loop re-opens
        the budget as earlier evictees terminate)."""
        taint = Taint(key=TAINT_UNREACHABLE, effect=TAINT_EFFECT_NO_EXECUTE)
        for pod in self._pods.list():
            if pod.spec.node_name != node_name:
                continue
            if any(t.tolerates(taint) for t in pod.spec.tolerations):
                continue
            if (
                self.disruption is not None
                and not self.disruption.can_disrupt(pod)
            ):
                self.evictions_blocked += 1
                continue
            try:
                self.client.delete_pod(
                    pod.metadata.namespace, pod.metadata.name
                )
                self.evictions += 1
                metrics.taint_evictions.inc()
                flightrecorder.mark(
                    "taint_eviction", node=node_name,
                    pod=pod.metadata.uid,
                )
            except KeyError:
                # already gone: OUR grant evicted nothing -- refund it
                # (the reconcile would eventually recompute, but sibling
                # pods under the PDB shouldn't be denied meanwhile)
                if self.disruption is not None:
                    self.disruption.refund_disruption(pod)
            except Exception:
                logger.exception("evicting pod %s", pod.key())
                if self.disruption is not None:
                    # the grant was spent but nothing was evicted: give
                    # the units back or a crash-looping delete drains
                    # the budget to zero across every disruption path
                    self.disruption.refund_disruption(pod)

    # -- loop ----------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.monitor_once()
            except Exception:
                logger.exception("node lifecycle monitor")
            self._stop.wait(self.monitor_interval)

    def start(self) -> threading.Thread:
        self._thread = threading.Thread(
            target=self.run, name="nodelifecycle", daemon=True
        )
        self._thread.start()
        return self._thread

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


class NodeDrainer:
    """Cordon + PDB-gated eviction: the rolling node-upgrade primitive
    (``kubectl drain`` semantics against this API surface, plus the
    eviction REST handler's budget contention).

    ``cordon`` flips ``spec.unschedulable`` -- the scheduler's
    NodeUnschedulable filter (and the batch path's static mask) keeps
    new pods off the node from the next snapshot. ``drain`` then evicts
    every pod on the node through the SAME ``can_disrupt`` budget the
    taint manager spends, retrying denied pods as the reconcile loop
    re-opens the budget, until the node is empty or the deadline
    passes. A drain that respects PDBs is therefore paced by the
    evictees actually re-placing elsewhere -- exactly the coupling the
    lifecycle-chaos wave exists to measure."""

    def __init__(
        self, client, disruption=None, poll: float = 0.02,
        should_abort=None, preemptor=None,
    ) -> None:
        """``should_abort``: optional nullary callable polled while a
        drain waits on budget-blocked pods -- lets a harness tear down a
        long drain instead of waiting out the deadline.

        ``preemptor``: an optional scheduler Preemptor; when wired,
        ``drain_via_preemption`` drives its device victim-search kernel
        to pick PER-POD evictees (pods with a live destination) instead
        of draining the whole node: on the card the plan is one launch
        of the victim-search kernel (K3), and a fault there propagates
        out of the drain."""
        self.client = client
        self.disruption = disruption
        self.poll = poll
        self.should_abort = should_abort or (lambda: False)
        self.preemptor = preemptor
        self.evictions = 0
        self.evictions_blocked = 0
        self.drains = 0
        # drain-via-preemption observability: pods the kernel planned a
        # destination for (and were evicted), vs pods left RUNNING on
        # the cordoned node because no destination exists -- the
        # strictly-fewer-evictions-than-whole-node ledger
        self.preempt_planned = 0
        self.preempt_left_running = 0

    def _set_unschedulable(self, node_name: str, value: bool) -> bool:
        def mutate(node: Node) -> None:
            node.spec.unschedulable = value

        try:
            self.client.server.guaranteed_update(
                "Node", "", node_name, mutate
            )
            return True
        except KeyError:
            return False

    def cordon(self, node_name: str) -> bool:
        return self._set_unschedulable(node_name, True)

    def uncordon(self, node_name: str) -> bool:
        return self._set_unschedulable(node_name, False)

    def _pods_on(self, node_name: str):
        pods, _rv = self.client.list_pods()
        return [
            p for p in pods
            if p.spec.node_name == node_name
            and p.metadata.deletion_timestamp is None
        ]

    def drain(
        self, node_name: str, timeout: float = 30.0, cordon: bool = True
    ) -> bool:
        """Returns True when the node emptied within the deadline; False
        leaves the node cordoned with the stragglers still running
        (their PDBs would not release them -- exactly what a real drain
        reports back to the operator)."""
        if cordon and not self.cordon(node_name):
            return False
        deadline = time.monotonic() + timeout
        blocked_prev: set = set()
        while True:
            remaining = self._pods_on(node_name)
            if not remaining:
                self.drains += 1
                return True
            progressed = False
            blocked_now: set = set()
            for pod in remaining:
                if (
                    self.disruption is not None
                    and not self.disruption.can_disrupt(pod)
                ):
                    if pod.metadata.uid not in blocked_prev:
                        self.evictions_blocked += 1
                    blocked_now.add(pod.metadata.uid)
                    continue
                try:
                    self.client.delete_pod(
                        pod.metadata.namespace, pod.metadata.name
                    )
                    self.evictions += 1
                    progressed = True
                except KeyError:
                    progressed = True  # already gone
                    if self.disruption is not None:
                        # a concurrent path deleted it first: OUR grant
                        # evicted nothing -- refund, or the unit leaks
                        # until the reconcile recomputes
                        self.disruption.refund_disruption(pod)
                except Exception:
                    logger.exception("draining pod %s", pod.key())
                    if self.disruption is not None:
                        # spent grant, no eviction: refund, or the
                        # retry loop bleeds the budget dry
                        self.disruption.refund_disruption(pod)
            blocked_prev = blocked_now
            if time.monotonic() >= deadline or self.should_abort():
                return False
            if not progressed:
                # everything left is budget-blocked: wait for earlier
                # evictees to terminate/re-place and the reconcile loop
                # to re-open the budget
                time.sleep(self.poll)

    def drain_via_preemption(
        self,
        node_name: str,
        timeout: float = 30.0,
        cordon: bool = True,
        preemptor=None,
    ) -> bool:
        """Drain by DEVICE-CHOSEN evictees instead of the whole node:
        the preemptor's victim-search kernel (run as a plan -- wave
        priority clamped so it never cascades secondary evictions)
        answers, per resident pod, whether a live destination exists
        RIGHT NOW, with each planned pod's claim carried into the next
        pod's answer. Only pods WITH a destination are evicted --
        through the same ``can_disrupt`` budget as every other
        voluntary disruption -- and pods with nowhere to go stay
        RUNNING on the cordoned node (``preempt_left_running``): a
        whole-node drain would evict them into a pending limbo while
        freeing capacity nobody can use.

        Pods the plan model cannot answer exactly (gang members,
        affinity/spread/port/PVC carriers) take the classic
        unconditional eviction path -- the scheduler re-places them with
        its full filter pipeline.

        Returns True when the node emptied within the deadline; False
        leaves the cordoned node with its unplaceable (or
        budget-blocked) residents still running."""
        preemptor = preemptor or self.preemptor
        if preemptor is None:
            return self.drain(node_name, timeout=timeout, cordon=cordon)
        if cordon and not self.cordon(node_name):
            return False
        deadline = time.monotonic() + timeout
        blocked_prev: set = set()
        evicted: dict = {}  # (ns, name) -> evicted incarnation's uid

        def unfinished() -> bool:
            # the left-running ledger reflects pods still RUNNING on
            # the cordoned node when the drain hands back -- not pods
            # that were merely transiently unplaceable in some round
            # (those may be planned and evicted later)
            try:
                pods_now, _ = self.client.list_pods()
                self.preempt_left_running += sum(
                    1 for p in pods_now
                    if p.spec.node_name == node_name
                    and p.metadata.deletion_timestamp is None
                )
            except Exception:  # noqa: BLE001 - counting is best effort
                pass
            return False

        while True:
            pods_all, _rv = self.client.list_pods()
            remaining = [
                p for p in pods_all
                if p.spec.node_name == node_name
                and p.metadata.deletion_timestamp is None
            ]
            if not remaining:
                self.drains += 1
                return True
            # let earlier evictees' REPLACEMENTS land before re-planning:
            # a respawned clone (same name, new uid) that is still
            # pending is about to claim the very capacity the next plan
            # would count as free -- planning over it would evict pods
            # whose destination evaporates, exactly the over-eviction
            # this drain mode exists to avoid
            settling = [
                p for p in pods_all
                if not p.spec.node_name
                and p.metadata.deletion_timestamp is None
                and evicted.get(
                    (p.metadata.namespace, p.metadata.name)
                ) not in (None, p.metadata.uid)
            ]
            if settling:
                if time.monotonic() >= deadline or self.should_abort():
                    return unfinished()
                time.sleep(self.poll)
                continue
            # most-important-first plan order: the pods hardest to
            # re-place elsewhere get first claim on the free capacity
            # (mirrors the wave's priority-desc activeQ order)
            remaining.sort(
                key=lambda p: (
                    -p.spec.priority,
                    p.status.start_time or 0.0,
                    p.metadata.name,
                )
            )
            planable = [p for p in remaining if preemptor.plan_eligible(p)]
            classic = [
                p for p in remaining if not preemptor.plan_eligible(p)
            ]
            try:
                plans = (
                    preemptor.plan_replacements(
                        planable, exclude_nodes=(node_name,)
                    )
                    if planable else []
                )
            except LadderExhausted:
                # on the CPU a concurrent chaos wave can have opened the
                # wave tier's breaker: the drain retries paced while the
                # breaker cools off. Nothing else is caught: a kernel or
                # card fault (KernelError, a CUDA error) propagates out of
                # the drain, never retried behind the kernel's back
                logger.exception(
                    "drain plan for %s failed; retrying paced", node_name
                )
                if time.monotonic() >= deadline or self.should_abort():
                    return unfinished()
                time.sleep(self.poll)
                continue
            evictees = [
                p for p, dest in zip(planable, plans) if dest
            ] + classic
            stuck = [p for p, dest in zip(planable, plans) if not dest]
            progressed = False
            blocked_now: set = set()
            classic_uids = {c.metadata.uid for c in classic}
            for pod in evictees:
                if (
                    self.disruption is not None
                    and not self.disruption.can_disrupt(pod)
                ):
                    if pod.metadata.uid not in blocked_prev:
                        self.evictions_blocked += 1
                    blocked_now.add(pod.metadata.uid)
                    continue
                try:
                    self.client.delete_pod(
                        pod.metadata.namespace, pod.metadata.name
                    )
                    self.evictions += 1
                    evicted[
                        (pod.metadata.namespace, pod.metadata.name)
                    ] = pod.metadata.uid
                    if pod.metadata.uid not in classic_uids:
                        self.preempt_planned += 1
                    progressed = True
                except KeyError:
                    progressed = True  # already gone
                    if self.disruption is not None:
                        # a concurrent path deleted it first: OUR grant
                        # evicted nothing -- refund it
                        self.disruption.refund_disruption(pod)
                except Exception:
                    logger.exception("draining pod %s", pod.key())
                    if self.disruption is not None:
                        self.disruption.refund_disruption(pod)
            blocked_prev = blocked_now
            if stuck and not evictees:
                # every resident is unplaceable: evicting them would
                # only trade running pods for pending ones. The drain
                # reports back incomplete -- exactly what an operator
                # needs to know before taking the node away.
                return unfinished()
            if time.monotonic() >= deadline or self.should_abort():
                return unfinished()
            if not progressed:
                # evictable pods are budget-blocked, or stuck pods wait
                # for capacity elsewhere: pace, then re-plan (earlier
                # evictees re-placing frees destinations)
                time.sleep(self.poll)
