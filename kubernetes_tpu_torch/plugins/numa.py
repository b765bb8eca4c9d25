"""NUMA-aligned extended-resource placement (BASELINE config #4:
"nvidia.com/gpu + topology-aware NUMA requests").

The reference has no scheduler-side NUMA model: alignment lives in the
kubelet's device manager + TopologyManager
(/root/reference/pkg/kubelet/cm/devicemanager/manager.go:103
GetTopologyHints, :128 Allocate) -- a pod that schedules onto a node
whose free devices cannot be aligned is REJECTED at admission
(TopologyAffinityError) and retries elsewhere. This plugin lifts the
hint semantics to scheduling time so aligned pods never bounce:

- a node advertises its device topology with the label
  ``numa.kubernetes-tpu.io/gpu-groups`` = "4_4" (devices per NUMA
  group; the device-manager's per-socket pools),
- a pod opts in with the annotation
  ``numa.kubernetes-tpu.io/aligned`` = "<resource>", requesting that
  its ENTIRE <resource> request fit inside one NUMA group,
- Filter rejects nodes where no group has enough free devices
  (mirroring the hint "no single-NUMA placement exists"),
- Score implements the device-manager's best-fit preference: tighter
  surviving groups score higher (keep big groups whole),
- Reserve records the chosen (best-fit) group in the pod annotation
  ``numa.kubernetes-tpu.io/assigned-group`` so later pods account the
  group's usage; Unreserve removes it.

Aligned pods take the sequential host path (scheduler/batch.py
solver_supported routes on the annotation): group bookkeeping is a
per-node argmin over free groups with in-flight state, which the batch
solver does not model.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import dataclasses

from kubernetes_tpu_torch.api.types import Pod, pod_resource_requests
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status

GROUPS_LABEL = "numa.kubernetes-tpu.io/gpu-groups"
ALIGNED_ANNOTATION = "numa.kubernetes-tpu.io/aligned"
ASSIGNED_ANNOTATION = "numa.kubernetes-tpu.io/assigned-group"


def aligned_resource(pod: Pod) -> str:
    """The resource name the pod wants single-NUMA-aligned ("" none)."""
    return pod.metadata.annotations.get(ALIGNED_ANNOTATION, "")


def _aligned_request(pod: Pod, resource: str) -> int:
    return int(pod_resource_requests(pod).get(resource, 0))


def _node_groups(node_info: NodeInfo) -> Optional[List[int]]:
    node = node_info.node
    if node is None:
        return None
    raw = node.metadata.labels.get(GROUPS_LABEL)
    if not raw:
        return None
    try:
        return [int(x) for x in raw.split("_") if x]
    except ValueError:
        return None


def group_free(
    node_info: NodeInfo, resource: str
) -> Optional[List[int]]:
    """Free devices per NUMA group: label capacities minus the recorded
    group assignments of the node's pods (assumed pods included -- they
    are in NodeInfo.pods). Devices held by UNALIGNED pods have no known
    group, so they are subtracted from EVERY group -- pessimistic, but
    the only direction that keeps the "aligned pods never bounce"
    guarantee on mixed nodes (the kubelet may have scattered them
    anywhere)."""
    groups = _node_groups(node_info)
    if groups is None:
        return None
    free = list(groups)
    unattributed = 0
    for p in node_info.pods:
        g = p.metadata.annotations.get(ASSIGNED_ANNOTATION)
        if g is None:
            unattributed += int(
                pod_resource_requests(p).get(resource, 0)
            )
            continue
        try:
            gi = int(g)
        except ValueError:
            continue
        if 0 <= gi < len(free):
            free[gi] -= _aligned_request(p, resource)
    if unattributed:
        free = [f - unattributed for f in free]
    return free


def _best_fit(free: List[int], want: int) -> Optional[int]:
    """Smallest group that still fits (device-manager hint preference:
    keep large groups whole); None when nothing fits."""
    best = None
    for gi, f in enumerate(free):
        if f >= want and (best is None or f < free[best]):
            best = gi
    return best


class NodeResourcesNumaAligned(Plugin):
    """Filter + Score + Reserve for single-NUMA-aligned extended
    resources (no-op for pods without the opt-in annotation)."""

    NAME = "NodeResourcesNumaAligned"

    def __init__(self, handle=None) -> None:
        self._handle = handle

    def _want(self, pod: Pod) -> Tuple[str, int]:
        res = aligned_resource(pod)
        if not res:
            return "", 0
        return res, _aligned_request(pod, res)

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        res, want = self._want(pod)
        if not want:
            return None
        free = group_free(node_info, res)
        if free is None:
            # a node without the topology label cannot guarantee
            # alignment for an opted-in pod (TopologyAffinityError
            # would reject it at the kubelet)
            return Status.unschedulable(
                "node advertises no NUMA device topology"
            )
        if _best_fit(free, want) is None:
            return Status.unschedulable(
                f"no NUMA group with {want} free {res}"
            )
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        res, want = self._want(pod)
        if not want:
            return 0, None
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name) if snapshot else None
        if ni is None:
            return 0, None
        free = group_free(ni, res)
        if free is None:
            return 0, None
        gi = _best_fit(free, want)
        if gi is None:
            return 0, None
        # tighter best-fit -> higher score (leftover 0 scores 100)
        leftover = free[gi] - want
        cap = max(free[gi], 1)
        return int(100 * (cap - leftover) / cap), None

    def reserve_relevant(self, pod: Pod) -> bool:
        """Bulk-commit fast-path predicate: reserve() is a no-op for
        pods without the single-NUMA-alignment opt-in annotation (the
        ``not want`` early return below). Declaring it lets the batch
        committer keep annotation-free pods on the bulk assume path
        instead of running a per-pod Reserve pipeline for a guaranteed
        no-op."""
        return bool(aligned_resource(pod))

    def reserve(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Optional[Status]:
        res, want = self._want(pod)
        if not want:
            return None
        snapshot = (
            self._handle.snapshot_shared_lister()
            if self._handle is not None else None
        )
        ni = snapshot.get_node_info(node_name) if snapshot else None
        if ni is None:
            return Status.error("no node info at reserve")
        free = group_free(ni, res)
        if free is None:
            return Status.unschedulable(
                "node advertises no NUMA device topology"
            )
        gi = _best_fit(free, want)
        if gi is None:
            return Status.unschedulable(
                f"no NUMA group with {want} free {res}"
            )
        # local write on a REPLACED metadata object: the assumed
        # clone's metadata dict is shared with the informer-cache/store
        # object and is contractually read-only (types.py assumed_clone),
        # so the clone gets its own copy carrying the assignment (the
        # cache's NodeInfo holds the clone -> in-flight filters see it)
        # and the durable API write below updates the stored object
        # through the store's own copy-on-write path
        pod.metadata = dataclasses.replace(
            pod.metadata,
            annotations={
                **pod.metadata.annotations,
                ASSIGNED_ANNOTATION: str(gi),
            },
        )
        client = getattr(self._handle, "client", None)
        if client is not None:
            try:
                def set_group(p: Pod) -> None:
                    p.metadata.annotations[ASSIGNED_ANNOTATION] = str(gi)

                client.server.guaranteed_update(
                    "Pod", pod.metadata.namespace, pod.metadata.name,
                    set_group,
                )
            except Exception:  # noqa: BLE001 - reserve must not crash
                pass
        return None

    def unreserve(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> None:
        if ASSIGNED_ANNOTATION in pod.metadata.annotations:
            ann = dict(pod.metadata.annotations)
            ann.pop(ASSIGNED_ANNOTATION, None)
            pod.metadata = dataclasses.replace(
                pod.metadata, annotations=ann
            )
        client = getattr(self._handle, "client", None)
        if client is not None:
            try:
                def clear_group(p: Pod) -> None:
                    # never strip a BOUND pod: a stale re-attempt's
                    # unreserve must not destroy the live placement's
                    # group assignment (written by the attempt that won)
                    if p.spec.node_name:
                        return
                    p.metadata.annotations.pop(ASSIGNED_ANNOTATION, None)

                client.server.guaranteed_update(
                    "Pod", pod.metadata.namespace, pod.metadata.name,
                    clear_group,
                )
            except Exception:  # noqa: BLE001
                pass
