"""TaintToleration Filter+PreScore+Score
(reference framework/plugins/tainttoleration/taint_toleration.go)."""

from __future__ import annotations

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    TAINT_EFFECT_NO_EXECUTE,
    TAINT_EFFECT_NO_SCHEDULE,
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
    Pod,
    Taint,
    Toleration,
)
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status
from kubernetes_tpu_torch.plugins.helpers import default_normalize_score

_STATE_KEY = "PreScoreTaintToleration"


def find_untolerated_taint(
    taints: List[Taint], tolerations: List[Toleration], effects: List[str]
) -> Optional[Taint]:
    for taint in taints:
        if taint.effect not in effects:
            continue
        if not any(t.tolerates(taint) for t in tolerations):
            return taint
    return None


class _TolerationState(list):
    def clone(self) -> "_TolerationState":
        return _TolerationState(self)


class TaintToleration(Plugin):
    NAME = "TaintToleration"

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        if node_info.node is None:
            return Status.error("node not found")
        taint = find_untolerated_taint(
            node_info.node.spec.taints,
            pod.spec.tolerations,
            [TAINT_EFFECT_NO_SCHEDULE, TAINT_EFFECT_NO_EXECUTE],
        )
        if taint is not None:
            return Status.unschedulable_and_unresolvable(
                f"node(s) had taint {{{taint.key}: {taint.value}}}, "
                "that the pod didn't tolerate"
            )
        return None

    def pre_score(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Optional[Status]:
        # Only PreferNoSchedule-effect tolerations matter for scoring
        # (taint_toleration.go:97 getAllTolerationPreferNoSchedule).
        tolerations = [
            t
            for t in pod.spec.tolerations
            if not t.effect or t.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
        ]
        state.write(_STATE_KEY, _TolerationState(tolerations))
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        try:
            tolerations = state.read(_STATE_KEY)
        except KeyError:
            return 0, Status.error("no prescore state")
        count = sum(
            1
            for taint in ni.node.spec.taints
            if taint.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
            and not any(t.tolerates(taint) for t in tolerations)
        )
        return count, None

    def normalize_score(self, state, pod, scores) -> Optional[Status]:
        # Fewer intolerable taints => higher score (reversed normalize).
        default_normalize_score(100, True, scores)
        return None
