"""NodeUnschedulable filter
(reference framework/plugins/nodeunschedulable/node_unschedulable.go)."""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import (
    TAINT_EFFECT_NO_SCHEDULE,
    Pod,
    Taint,
)
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status

TAINT_NODE_UNSCHEDULABLE = "node.kubernetes.io/unschedulable"

ERR_REASON_UNSCHEDULABLE = "node(s) were unschedulable"


class NodeUnschedulable(Plugin):
    NAME = "NodeUnschedulable"

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        if node_info.node is None:
            return Status.unschedulable_and_unresolvable("node not found")
        if not node_info.node.spec.unschedulable:
            return None
        # A pod tolerating the unschedulable taint may still land here
        # (node_unschedulable.go:58).
        fake_taint = Taint(
            key=TAINT_NODE_UNSCHEDULABLE, effect=TAINT_EFFECT_NO_SCHEDULE
        )
        if any(t.tolerates(fake_taint) for t in pod.spec.tolerations):
            return None
        return Status.unschedulable_and_unresolvable(ERR_REASON_UNSCHEDULABLE)
