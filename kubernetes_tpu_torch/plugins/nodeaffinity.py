"""NodeAffinity Filter+Score
(reference framework/plugins/nodeaffinity/node_affinity.go)."""

from __future__ import annotations

from typing import Optional, Tuple

from kubernetes_tpu_torch.api.selectors import (
    match_node_selector_term,
    node_matches_node_selector,
    node_selector_dict_matches,
)
from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status
from kubernetes_tpu_torch.plugins.helpers import default_normalize_score

ERR_REASON = "node(s) didn't match node selector"


def pod_matches_node_selector_and_affinity(pod: Pod, node_info: NodeInfo) -> bool:
    """Reference predicates: both pod.spec.nodeSelector and
    requiredDuringSchedulingIgnoredDuringExecution must match."""
    node = node_info.node
    labels = node.metadata.labels
    fields = {"metadata.name": node.metadata.name}
    if pod.spec.node_selector and not node_selector_dict_matches(
        pod.spec.node_selector, labels
    ):
        return False
    aff = pod.spec.affinity
    if aff and aff.node_affinity and aff.node_affinity.required_during_scheduling:
        if not node_matches_node_selector(
            labels, aff.node_affinity.required_during_scheduling, fields
        ):
            return False
    return True


class NodeAffinity(Plugin):
    NAME = "NodeAffinity"

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        if node_info.node is None:
            return Status.error("node not found")
        if not pod_matches_node_selector_and_affinity(pod, node_info):
            return Status.unschedulable(ERR_REASON)
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        node = ni.node
        count = 0
        aff = pod.spec.affinity
        if aff and aff.node_affinity:
            for term in aff.node_affinity.preferred_during_scheduling:
                if term.weight == 0:
                    continue
                if match_node_selector_term(
                    node.metadata.labels,
                    term.preference,
                    {"metadata.name": node.metadata.name},
                ):
                    count += term.weight
        return count, None

    def normalize_score(self, state, pod, scores) -> Optional[Status]:
        default_normalize_score(100, False, scores)
        return None
