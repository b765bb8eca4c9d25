"""NodeName filter (reference framework/plugins/nodename/node_name.go)."""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status

ERR_REASON = "node(s) didn't match the requested hostname"


class NodeName(Plugin):
    NAME = "NodeName"

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        if node_info.node is None:
            return Status.error("node not found")
        if pod.spec.node_name and pod.spec.node_name != node_info.node_name:
            return Status.unschedulable(ERR_REASON)
        return None
