"""NodePorts PreFilter+Filter
(reference framework/plugins/nodeports/node_ports.go)."""

from __future__ import annotations

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo, pod_host_ports
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status

_STATE_KEY = "PreFilterNodePorts"
ERR_REASON = "node(s) didn't have free ports for the requested pod ports"


class _PortsState(list):
    def clone(self) -> "_PortsState":
        return _PortsState(self)


class NodePorts(Plugin):
    NAME = "NodePorts"

    def pre_filter(self, state: CycleState, pod: Pod) -> Optional[Status]:
        state.write(_STATE_KEY, _PortsState(pod_host_ports(pod)))
        return None

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        try:
            want: List[Tuple[str, str, int]] = state.read(_STATE_KEY)
        except KeyError:
            want = pod_host_ports(pod)
        for ip, proto, port in want:
            if node_info.used_ports.conflicts(ip, proto, port):
                return Status.unschedulable(ERR_REASON)
        return None
