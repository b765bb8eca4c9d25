"""Tenant fairness plane: DRF dominant-share tracking + the fair solve
order.

Tenant identity is the pod's NAMESPACE -- a field the ingest decode
already materialized (the (namespace, name) key record every watch-frame
consumer shares), so stamping it costs nothing and the plain-pod native
``ingest_stamp`` C fast path is untouched: no new memo, no new branch.

**Dominant share** (DRF, Ghodsi et al.): a tenant's share is
``max over resources of used_r / cluster_capacity_r`` over the two
dominant axes the solver already scores on (milliCPU, memory KiB). The
tracker maintains per-tenant ``used`` incrementally from the committer's
own bind echoes -- the cache-side informer frames
(scheduler/eventhandlers.py) deliver every bound pod exactly once,
including a restarted scheduler's relist and a sibling stack's commits,
so the shares recover for free and stay honest in multi-active mode
(scoped to the stack's node slice when partitioned). Cluster capacity
refreshes from the packed node tensor at dispatch: two O(N) int column
sums against state the dispatcher already holds.

**The fairness bias** rides the batched solve as a per-pod scalar: each
pod carries its tenant's dominant share, and the SOLVE ORDER -- the
arbitration point of the sequential-replay scan, where contended
capacity is claimed -- is re-merged so that, within a priority level,
the tenant with the lowest (virtual) dominant share places next. The
virtual share advances by each placed pod's requests, so one batch
arbitrates like a full DRF progression instead of freezing the
batch-start shares. Every solve (greedy, constrained, sinkhorn, mesh,
host-greedy) consumes the same ``order`` array, so the bias needs ZERO
kernel changes -- exactly how the volume columns rode the existing fit
rule.

Single-tenant fast path: a batch whose pods share one namespace (the
10k-burst steady state) exits after one set-membership sweep -- no
sort, no heap, no share reads.
"""

from __future__ import annotations

import heapq
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import (
    Pod,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    pod_resource_requests,
)
from kubernetes_tpu_torch.utils import metrics


def _pod_cpu_mem(pod: Pod) -> Tuple[int, int]:
    """(milliCPU, memory KiB) of the pod's effective request -- the
    memoized ``pod_resource_requests`` read the ingest stamp already
    primed for plain pods."""
    req = pod_resource_requests(pod)
    return req.get(RESOURCE_CPU, 0), -(-req.get(RESOURCE_MEMORY, 0) // 1024)


def _node_cpu_mem(node) -> Tuple[int, int]:
    """(milliCPU, memory KiB) of a node's allocatable, in the SAME units
    the node tensor packs (memory floored to KiB) so the cluster-wide
    capacity sum and the slice tensor sum agree on a single stack."""
    alloc = node.status.allocatable
    return alloc.get(RESOURCE_CPU, 0), alloc.get(RESOURCE_MEMORY, 0) // 1024


class TenantShareTracker:
    """Per-tenant (cpu, memKiB) usage + O(1) dominant-share reads.
    Thread-safe: informer frames write (note_bound/note_unbound) while
    the dispatcher reads shares per batch.

    Multi-active: usage and capacity are
    CLUSTER-wide, not per-slice. The informer's bind echoes include
    sibling stacks' commits (the event handlers route bound pods on
    foreign-partition nodes here even though the partitioned cache drops
    them), deduplicated per pod UID so relist + MODIFIED re-echoes of
    the same bind never double-count; and the node informer feeds every
    node's allocatable BEFORE the partition ownership gate, so the
    dominant-share denominator is the whole cluster, not the N/P rows
    this stack's tensor carries."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._used: Dict[str, List[int]] = {}  # ns -> [cpu, memKiB]
        # uid -> (ns, cpu, memKiB): the exactly-once ledger. unbind
        # subtracts what bind ADDED (the recorded vector), immune to a
        # pod whose requests mutated between the two echoes
        self._seen: Dict[str, Tuple[str, int, int]] = {}
        self._cap_cpu = 0
        self._cap_mem = 0
        self._cap_epoch = -1
        # cluster-wide capacity from the (ungated) node informer feed;
        # overrides the per-slice tensor sum when populated
        self._node_caps: Dict[str, Tuple[int, int]] = {}
        self._caps_dirty = False

    # -- capacity (refreshed from the packed node tensor at dispatch) ------

    def refresh_capacity(self, nt) -> None:
        """Two int column sums over ``nt.allocatable`` -- cached per
        tensor-cache epoch so steady dispatches against an unchanged
        cluster skip even that. When the node-informer capacity feed is
        live (``note_node_capacity``), its cluster-wide sum wins over
        the slice tensor: a partitioned stack's tensor is only N/P
        rows, and dividing by a slice inflates every share P-fold."""
        with self._lock:
            if self._node_caps:
                if self._caps_dirty:
                    self._cap_cpu = sum(
                        c for c, _ in self._node_caps.values()
                    )
                    self._cap_mem = sum(
                        m for _, m in self._node_caps.values()
                    )
                    self._caps_dirty = False
                return
        delta = getattr(nt, "delta", None)
        epoch = delta.epoch if delta is not None else -1
        if epoch == self._cap_epoch and epoch >= 0:
            return
        alloc = nt.allocatable
        cap_cpu = int(alloc[:, 0].sum())
        cap_mem = int(alloc[:, 1].sum())
        with self._lock:
            self._cap_cpu = cap_cpu
            self._cap_mem = cap_mem
            self._cap_epoch = epoch

    def set_capacity(self, cpu_milli: int, mem_kib: int) -> None:
        with self._lock:
            self._cap_cpu = int(cpu_milli)
            self._cap_mem = int(mem_kib)

    def note_node_capacity(self, node) -> None:
        """Node add/update from the informer, BEFORE the partition
        ownership gate -- every stack sees every node, so the DRF
        denominator is cluster capacity in multi-active mode too."""
        cpu, mem = _node_cpu_mem(node)
        with self._lock:
            prev = self._node_caps.get(node.metadata.name)
            if prev == (cpu, mem):
                return
            self._node_caps[node.metadata.name] = (cpu, mem)
            self._caps_dirty = True

    def note_node_gone(self, name: str) -> None:
        with self._lock:
            if self._node_caps.pop(name, None) is not None:
                self._caps_dirty = True

    # -- incremental usage (the committer's bind echoes) --------------------

    def note_bound(self, pods: List[Pod]) -> None:
        with self._lock:
            for pod in pods:
                uid = pod.metadata.uid
                if uid and uid in self._seen:
                    continue  # relist / re-echo of a counted bind
                cpu, mem = _pod_cpu_mem(pod)
                ns = pod.metadata.namespace
                if uid:
                    self._seen[uid] = (ns, cpu, mem)
                u = self._used.get(ns)
                if u is None:
                    self._used[ns] = [cpu, mem]
                else:
                    u[0] += cpu
                    u[1] += mem

    def note_unbound(self, pods: List[Pod]) -> None:
        with self._lock:
            for pod in pods:
                rec = self._seen.pop(pod.metadata.uid or "", None)
                if rec is not None:
                    ns, cpu, mem = rec
                else:
                    # legacy direct callers (no prior note_bound ledger
                    # entry): recompute from the pod itself
                    ns = pod.metadata.namespace
                    cpu, mem = _pod_cpu_mem(pod)
                u = self._used.get(ns)
                if u is None:
                    continue
                u[0] = max(0, u[0] - cpu)
                u[1] = max(0, u[1] - mem)
                if u[0] == 0 and u[1] == 0:
                    del self._used[ns]

    # -- reads ---------------------------------------------------------------

    def _share_locked(self, used: List[int]) -> float:
        s = 0.0
        if self._cap_cpu:
            s = used[0] / self._cap_cpu
        if self._cap_mem:
            s = max(s, used[1] / self._cap_mem)
        return s

    def share(self, namespace: str) -> float:
        with self._lock:
            u = self._used.get(namespace)
            return self._share_locked(u) if u is not None else 0.0

    def shares_for(self, namespaces) -> Dict[str, float]:
        out = {}
        with self._lock:
            for ns in namespaces:
                u = self._used.get(ns)
                out[ns] = self._share_locked(u) if u is not None else 0.0
        return out

    def usage_and_caps(self, namespaces) -> Tuple[
        Dict[str, Tuple[int, int]], int, int
    ]:
        """Per-tenant ACTUAL (cpu, memKiB) usage vectors plus the
        capacities, in one lock hold -- the fair-order merge seeds its
        virtual DRF progression from these (seeding both axes from the
        dominant share would inflate the non-dominant axis and
        mis-order mixed-resource tenants)."""
        with self._lock:
            used = {}
            for ns in namespaces:
                u = self._used.get(ns)
                used[ns] = (u[0], u[1]) if u is not None else (0, 0)
            return used, (self._cap_cpu or 1), (self._cap_mem or 1)

    def max_share(self) -> float:
        with self._lock:
            if not self._used:
                return 0.0
            return max(self._share_locked(u) for u in self._used.values())

    def share_spread(self) -> float:
        """max - min dominant share over tenants WITH usage: the
        fairness-gap gauge the perf matrix labels carry."""
        with self._lock:
            if not self._used:
                return 0.0
            shares = [self._share_locked(u) for u in self._used.values()]
            return max(shares) - min(shares)

    def register_gauges(self) -> None:
        """Scrape-time callbacks for scheduler_tenant_dominant_share
        (labeled ``stat``); idempotent -- re-registration replaces."""
        metrics.tenant_dominant_share.register_callback(
            self.max_share, stat="max"
        )
        metrics.tenant_dominant_share.register_callback(
            self.share_spread, stat="spread"
        )


def fair_order(
    base_order: np.ndarray,
    pods: List[Pod],
    priorities: np.ndarray,
    tracker: TenantShareTracker,
) -> np.ndarray:
    """Re-merge the batch's solve order so that, WITHIN each priority
    level, tenants place in ascending (virtual) dominant-share order.
    ``base_order`` is pack_pod_batch's (-priority, enqueue-time) order;
    priority strictly dominates (the bias arbitrates peers, it never
    inverts PriorityClass semantics), each tenant's own pods keep their
    FIFO order, and the virtual share advances by every placed pod's
    requests so the merge IS a DRF progression, not a frozen snapshot.

    Single-tenant fast path: one namespace across the batch returns
    ``base_order`` untouched after a single sweep.
    """
    idxs = [int(i) for i in base_order]
    first_ns: Optional[str] = None
    multi = False
    for i in idxs:
        ns = pods[i].metadata.namespace
        if first_ns is None:
            first_ns = ns
        elif ns != first_ns:
            multi = True
            break
    if not multi:
        return base_order

    used, cap_cpu, cap_mem = tracker.usage_and_caps(
        {pods[i].metadata.namespace for i in idxs}
    )

    out: List[int] = []
    n = len(idxs)
    pos = 0
    while pos < n:
        # one run of equal priority [pos, end)
        p = int(priorities[idxs[pos]])
        end = pos
        while end < n and int(priorities[idxs[end]]) == p:
            end += 1
        run = idxs[pos:end]
        pos = end
        if len(run) == 1:
            out.append(run[0])
            continue
        # per-tenant FIFO queues, in run order
        queues: Dict[str, List[int]] = {}
        arrival: Dict[str, int] = {}
        for i in run:
            ns = pods[i].metadata.namespace
            if ns not in queues:
                queues[ns] = []
                arrival[ns] = len(arrival)
            queues[ns].append(i)
        if len(queues) == 1:
            out.extend(run)
            continue
        # DRF merge: lowest virtual dominant share places next (ties
        # break on first arrival, deterministically)
        virt: Dict[str, Tuple[int, int]] = {}
        heap: List[Tuple[float, int, str]] = []
        for ns in queues:
            ucpu, umem = used.get(ns, (0, 0))
            virt[ns] = (ucpu, umem)
            heap.append(
                (max(ucpu / cap_cpu, umem / cap_mem), arrival[ns], ns)
            )
        heapq.heapify(heap)
        cursors = {ns: 0 for ns in queues}
        while heap:
            _s, arr, ns = heapq.heappop(heap)
            q = queues[ns]
            c = cursors[ns]
            i = q[c]
            cursors[ns] = c + 1
            out.append(i)
            if cursors[ns] < len(q):
                cpu, mem = _pod_cpu_mem(pods[i])
                ucpu, umem = virt[ns]
                ucpu += cpu
                umem += mem
                virt[ns] = (ucpu, umem)
                new_share = max(ucpu / cap_cpu, umem / cap_mem)
                heapq.heappush(heap, (new_share, arr, ns))
    return np.asarray(out, dtype=np.int32)


def arm_tenancy(
    sched,
    client,
    informer_factory,
    *,
    quota: bool = True,
    drf_bias: bool = True,
):
    """Wire the fairness plane onto a scheduler: the ResourceQuota
    admission gate (controllers/quota.py) and/or the DRF dominant-share
    tracker + solve-order bias. Returns the QuotaController (caller
    owns sync_all/start/stop; see SchedulerApp) or None. Idempotent
    per scheduler."""
    qc = None
    if quota:
        from kubernetes_tpu_torch.controllers.quota import QuotaController

        qc = QuotaController(client, informer_factory)
        qc.attach_queue(sched.queue)
        # multi-active: sync_all's absolute rewrite elects a single
        # writer through the partition coordinator (attach_partitioning
        # runs before arm_tenancy in SchedulerApp, so the attribute is
        # live here when partitioning is on)
        qc.partition_coordinator = getattr(
            sched, "partition_coordinator", None
        )
        sched.quota = qc
    if drf_bias:
        tracker = TenantShareTracker()
        tracker.register_gauges()
        sched.tenant_shares = tracker
    return qc
