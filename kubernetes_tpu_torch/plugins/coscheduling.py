"""Coscheduling: all-or-nothing gang scheduling via the Permit extension
point.

Reference: the Permit/WaitingPod machinery this rides on is
/root/reference/pkg/scheduler/framework/v1alpha1/interface.go:384 (Permit,
can return Wait) + waiting_pods_map.go; the gang semantics follow the
out-of-tree scheduler-plugins Coscheduling plugin that SURVEY.md section
2.2 identifies as the reference's gang mechanism ("not in-tree -- enabled
by the Permit extension point").

Flow: each member of a PodGroup is filtered/scored/assumed normally; at
Permit, if fewer than ``min_member`` members hold assignments the pod
parks in WAIT (holding its resources via the assume). When the threshold
member arrives, it allows every waiting member. A timeout rejects the
waiters, which unreserves + requeues them -- all-or-nothing with bounded
capacity hold.

The TPU batch solver composes naturally: a whole gang usually lands in
one batch, each member is assumed during commit, and the final member's
Permit releases the group in the same cycle.
"""

from __future__ import annotations

from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import POD_GROUP_LABEL, Pod, PodGroup
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status

DEFAULT_SCHEDULE_TIMEOUT_SECONDS = 60


class Coscheduling(Plugin):
    NAME = "Coscheduling"

    def __init__(self, args: Optional[dict] = None, handle=None) -> None:
        args = args or {}
        self.handle = handle
        self.default_timeout = float(
            args.get("schedule_timeout_seconds", DEFAULT_SCHEDULE_TIMEOUT_SECONDS)
        )

    # -- helpers ------------------------------------------------------------

    def _group_of(self, pod: Pod) -> Optional[str]:
        return pod.metadata.labels.get(POD_GROUP_LABEL)

    def _pod_group(self, pod: Pod, name: str) -> Optional[PodGroup]:
        informers = getattr(self.handle, "informers", None)
        if informers is None:
            return None
        return informers.pod_groups().get(pod.metadata.namespace, name)

    def _count_total_members(self, pod: Pod, group: str) -> int:
        """Every group member known to the cluster (informer view)."""
        informers = getattr(self.handle, "informers", None)
        if informers is None:
            return 0
        return sum(
            1
            for p in informers.pods().list()
            if p.metadata.namespace == pod.metadata.namespace
            and p.metadata.labels.get(POD_GROUP_LABEL) == group
        )

    def group_quorum_info(self, pod: Pod, group: str):
        """Public quorum query for the batch solver's all-or-nothing
        group masks: (min_member, total known members). The same
        knowledge horizon as pre_filter's fail-fast."""
        pg = self._pod_group(pod, group)
        return (
            pg.min_member if pg is not None else 1,
            self._count_total_members(pod, group),
        )

    def _count_holding_members(self, pod: Pod, group: str) -> int:
        """Distinct members currently holding resources: bound/assumed
        pods in the snapshot, pods parked at Permit, and the pod being
        permitted itself (assumed, but the snapshot may predate it --
        especially on the batch path where a whole gang is assumed before
        any Permit runs). Deduplicated by uid: an assumed pod that is also
        waiting must count once."""
        ns = pod.metadata.namespace
        uids = {pod.metadata.uid}
        snapshot = self.handle.snapshot_shared_lister()
        for p in snapshot.list_pods():
            if (
                p.metadata.namespace == ns
                and p.metadata.labels.get(POD_GROUP_LABEL) == group
            ):
                uids.add(p.metadata.uid)

        def visit(wp) -> None:
            wpod = wp.pod
            if (
                wpod.metadata.namespace == ns
                and wpod.metadata.labels.get(POD_GROUP_LABEL) == group
            ):
                uids.add(wpod.metadata.uid)

        self.handle.iterate_over_waiting_pods(visit)
        return len(uids)

    # -- PreFilter: fail fast when the gang can never assemble --------------

    def pre_filter(self, state: CycleState, pod: Pod) -> Optional[Status]:
        group = self._group_of(pod)
        if not group:
            return None
        pg = self._pod_group(pod, group)
        if pg is None:
            return None
        total = self._count_total_members(pod, group)
        if total < pg.min_member:
            return Status.unschedulable_and_unresolvable(
                f"pod group {group!r} has {total} members, "
                f"less than minMember {pg.min_member}"
            )
        return None

    # -- Permit: the gang barrier -------------------------------------------

    def permit_relevant(self, pod: Pod) -> bool:
        """Bulk-commit fast-path predicate: permit() is a no-op for pods
        without a pod-group label."""
        return bool(pod.metadata.labels.get(POD_GROUP_LABEL))

    def permit(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[Optional[Status], float]:
        group = self._group_of(pod)
        if not group:
            return None, 0.0
        pg = self._pod_group(pod, group)
        min_member = pg.min_member if pg is not None else 1
        timeout = (
            pg.schedule_timeout_seconds if pg is not None
            else self.default_timeout
        )
        assigned = self._count_holding_members(pod, group)
        if assigned >= min_member:
            # threshold reached: release every waiting member
            ns = pod.metadata.namespace

            def allow(wp) -> None:
                if (
                    wp.pod.metadata.namespace == ns
                    and wp.pod.metadata.labels.get(POD_GROUP_LABEL) == group
                ):
                    wp.allow(self.NAME)

            self.handle.iterate_over_waiting_pods(allow)
            return None, 0.0
        return Status.wait(), float(timeout)
