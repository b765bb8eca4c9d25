"""NodePreferAvoidPods score
(reference framework/plugins/nodepreferavoidpods/node_prefer_avoid_pods.go).

Nodes annotated with scheduler.alpha.kubernetes.io/preferAvoidPods get score
0 (vs 100) for pods controlled by a RC/RS listed in the annotation; the
default weight is 10000 so this dominates other scorers.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.interface import CycleState, MAX_NODE_SCORE, Plugin, Status

ANNOTATION_KEY = "scheduler.alpha.kubernetes.io/preferAvoidPods"


class NodePreferAvoidPods(Plugin):
    NAME = "NodePreferAvoidPods"

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        raw = ni.node.metadata.annotations.get(ANNOTATION_KEY)
        if not raw:
            return MAX_NODE_SCORE, None
        controller = next(
            (ref for ref in pod.metadata.owner_references if ref.controller), None
        )
        # Only RC/RS-controlled pods are subject to avoidance
        # (node_prefer_avoid_pods.go:53).
        if controller is None or controller.kind not in (
            "ReplicationController",
            "ReplicaSet",
        ):
            return MAX_NODE_SCORE, None
        try:
            avoids = json.loads(raw).get("preferAvoidPods", [])
        except (ValueError, AttributeError):
            return MAX_NODE_SCORE, None
        for entry in avoids:
            ref = entry.get("podSignature", {}).get("podController", {})
            # exact UID equality (node_prefer_avoid_pods.go): an entry
            # without a uid matches nothing
            if (
                ref.get("kind") == controller.kind
                and ref.get("uid") == controller.uid
            ):
                return 0, None
        return MAX_NODE_SCORE, None
