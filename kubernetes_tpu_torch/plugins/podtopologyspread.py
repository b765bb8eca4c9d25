"""PodTopologySpread: hard (DoNotSchedule) filtering and soft
(ScheduleAnyway) scoring of topology-spread constraints.

Reference: /root/reference/pkg/scheduler/framework/plugins/podtopologyspread/
(filtering.go: preFilterState :43, criticalPaths :86, calPreFilterState :198,
Filter :285; scoring.go: preScoreState :38, PreScore :92, Score :166,
NormalizeScore :199; common.go: topologySpreadConstraint :34).

On TPU the pair-count maps become dense ``[num_constraints, num_topologies]``
count tensors updated by scatter-add inside the assignment scan
(kubernetes_tpu_torch.ops); this host implementation is the correctness oracle.

DefaultConstraints (service/RC/RS/STS-derived selectors, common.go:44) are
not wired because the default v1alpha2 provider enables none; pods without
explicit constraints simply produce an empty state.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.selectors import labels_match_selector
from kubernetes_tpu_torch.api.types import Node, Pod, TopologySpreadConstraint
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    MAX_NODE_SCORE,
    NodeScore,
    Plugin,
    PreFilterExtensions,
    Status,
)
from kubernetes_tpu_torch.plugins.nodeaffinity import (
    pod_matches_node_selector_and_affinity,
)

PRE_FILTER_STATE_KEY = "PreFilterPodTopologySpread"
PRE_SCORE_STATE_KEY = "PreScorePodTopologySpread"

ERR_REASON_CONSTRAINTS_NOT_MATCH = (
    "node(s) didn't match pod topology spread constraints"
)

DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

_MAX_INT32 = (1 << 31) - 1


class _Constraint:
    """Internal parsed constraint (reference common.go:34)."""

    __slots__ = ("max_skew", "topology_key", "selector")

    def __init__(self, c: TopologySpreadConstraint) -> None:
        self.max_skew = c.max_skew
        self.topology_key = c.topology_key
        self.selector = c.label_selector


def _filter_constraints(
    constraints: List[TopologySpreadConstraint], action: str
) -> List[_Constraint]:
    return [_Constraint(c) for c in constraints if c.when_unsatisfiable == action]


def _node_labels_match_constraints(
    node_labels: Dict[str, str], constraints: List[_Constraint]
) -> bool:
    """ALL topology keys must be present (reference common.go:60)."""
    return all(c.topology_key in node_labels for c in constraints)


class CriticalPaths:
    """2-slot min tracker (reference filtering.go:86 criticalPaths).
    Slot 0 always holds the global minimum match count."""

    __slots__ = ("values", "nums")

    def __init__(self) -> None:
        self.values: List[Optional[str]] = [None, None]
        self.nums: List[int] = [_MAX_INT32, _MAX_INT32]

    def min_match_num(self) -> int:
        return self.nums[0]

    def update(self, tp_val: str, num: int) -> None:
        if tp_val == self.values[0]:
            i = 0
        elif tp_val == self.values[1]:
            i = 1
        else:
            i = -1
        if i >= 0:
            self.nums[i] = num
            if self.nums[0] > self.nums[1]:
                self.values[0], self.values[1] = self.values[1], self.values[0]
                self.nums[0], self.nums[1] = self.nums[1], self.nums[0]
        elif num < self.nums[0]:
            self.values[1], self.nums[1] = self.values[0], self.nums[0]
            self.values[0], self.nums[0] = tp_val, num
        elif num < self.nums[1]:
            self.values[1], self.nums[1] = tp_val, num

    def copy(self) -> "CriticalPaths":
        cp = CriticalPaths()
        cp.values = list(self.values)
        cp.nums = list(self.nums)
        return cp


class PreFilterState:
    """Reference filtering.go:43 preFilterState."""

    def __init__(
        self,
        constraints: Optional[List[_Constraint]] = None,
    ) -> None:
        self.constraints: List[_Constraint] = constraints or []
        self.tp_key_to_critical_paths: Dict[str, CriticalPaths] = {}
        self.tp_pair_to_match_num: Dict[Tuple[str, str], int] = {}

    def clone(self) -> "PreFilterState":
        s = PreFilterState(self.constraints)  # constraints are immutable
        s.tp_key_to_critical_paths = {
            k: v.copy() for k, v in self.tp_key_to_critical_paths.items()
        }
        s.tp_pair_to_match_num = dict(self.tp_pair_to_match_num)
        return s

    def update_with_pod(
        self, updated_pod: Pod, preemptor: Pod, node: Optional[Node], delta: int
    ) -> None:
        """Reference filtering.go:127 updateWithPod: incremental count update
        used by AddPod/RemovePod (nominated pods + preemption)."""
        if (
            node is None
            or updated_pod.metadata.namespace != preemptor.metadata.namespace
        ):
            return
        if not _node_labels_match_constraints(
            node.metadata.labels, self.constraints
        ):
            return
        pod_labels = updated_pod.metadata.labels
        for c in self.constraints:
            if not labels_match_selector(pod_labels, c.selector):
                continue
            k = c.topology_key
            v = node.metadata.labels[k]
            pair = (k, v)
            self.tp_pair_to_match_num[pair] = (
                self.tp_pair_to_match_num.get(pair, 0) + delta
            )
            self.tp_key_to_critical_paths[k].update(
                v, self.tp_pair_to_match_num[pair]
            )


class _SpreadPreFilterExtensions(PreFilterExtensions):
    def add_pod(self, state, pod_to_schedule, pod_to_add, node_info):
        s = _get_pre_filter_state(state)
        if isinstance(s, Status):
            return s
        s.update_with_pod(pod_to_add, pod_to_schedule, node_info.node, 1)
        return None

    def remove_pod(self, state, pod_to_schedule, pod_to_remove, node_info):
        s = _get_pre_filter_state(state)
        if isinstance(s, Status):
            return s
        s.update_with_pod(pod_to_remove, pod_to_schedule, node_info.node, -1)
        return None


def _get_pre_filter_state(state: CycleState):
    try:
        return state.read(PRE_FILTER_STATE_KEY)
    except KeyError:
        return Status.error(
            f"error reading {PRE_FILTER_STATE_KEY!r} from cycleState"
        )


class PreScoreState:
    """Reference scoring.go:38 preScoreState."""

    def __init__(self) -> None:
        self.constraints: List[_Constraint] = []
        self.node_name_set: set = set()
        self.topology_pair_to_pod_counts: Dict[Tuple[str, str], int] = {}

    def clone(self) -> "PreScoreState":
        return self  # reference Clone is a no-op share


class PodTopologySpread(Plugin):
    NAME = "PodTopologySpread"

    def __init__(self, handle=None) -> None:
        self.handle = handle
        self._extensions = _SpreadPreFilterExtensions()

    # -- PreFilter / Filter (DoNotSchedule) ---------------------------------

    def pre_filter(self, state: CycleState, pod: Pod) -> Optional[Status]:
        s = self._cal_pre_filter_state(state, pod)
        state.write(PRE_FILTER_STATE_KEY, s)
        return None

    def pre_filter_extensions(self) -> PreFilterExtensions:
        return self._extensions

    def _cal_pre_filter_state(
        self, state: CycleState, pod: Pod
    ) -> PreFilterState:
        """Reference filtering.go:198 calPreFilterState."""
        constraints = _filter_constraints(
            pod.spec.topology_spread_constraints, DO_NOT_SCHEDULE
        )
        if not constraints:
            return PreFilterState()
        snapshot = state.read("__snapshot__")
        s = PreFilterState(constraints)
        for ni in snapshot.list_node_infos():
            node = ni.node
            if node is None:
                continue
            # Spreading applies only to nodes passing nodeSelector/affinity.
            if not pod_matches_node_selector_and_affinity(pod, ni):
                continue
            if not _node_labels_match_constraints(
                node.metadata.labels, constraints
            ):
                continue
            for c in constraints:
                match_total = 0
                for existing in ni.pods:
                    if (
                        existing.metadata.deletion_timestamp is not None
                        or existing.metadata.namespace != pod.metadata.namespace
                    ):
                        continue
                    if labels_match_selector(
                        existing.metadata.labels, c.selector
                    ):
                        match_total += 1
                pair = (c.topology_key, node.metadata.labels[c.topology_key])
                s.tp_pair_to_match_num[pair] = (
                    s.tp_pair_to_match_num.get(pair, 0) + match_total
                )
        for c in constraints:
            s.tp_key_to_critical_paths[c.topology_key] = CriticalPaths()
        for (k, v), num in s.tp_pair_to_match_num.items():
            s.tp_key_to_critical_paths[k].update(v, num)
        return s

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        """Reference filtering.go:285 Filter."""
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        s = _get_pre_filter_state(state)
        if isinstance(s, Status):
            return s
        if not s.tp_pair_to_match_num or not s.constraints:
            return None
        pod_labels = pod.metadata.labels
        for c in s.constraints:
            tp_key = c.topology_key
            if tp_key not in node.metadata.labels:
                return Status.unschedulable(ERR_REASON_CONSTRAINTS_NOT_MATCH)
            tp_val = node.metadata.labels[tp_key]
            self_match = 1 if labels_match_selector(pod_labels, c.selector) else 0
            paths = s.tp_key_to_critical_paths.get(tp_key)
            if paths is None:
                continue
            min_match = paths.min_match_num()
            match_num = s.tp_pair_to_match_num.get((tp_key, tp_val), 0)
            skew = match_num + self_match - min_match
            if skew > c.max_skew:
                return Status.unschedulable(ERR_REASON_CONSTRAINTS_NOT_MATCH)
        return None

    # -- PreScore / Score (ScheduleAnyway) ----------------------------------

    def pre_score(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Optional[Status]:
        """Reference scoring.go:92 PreScore."""
        snapshot = state.read("__snapshot__")
        all_nodes = snapshot.list_node_infos()
        s = PreScoreState()
        state.write(PRE_SCORE_STATE_KEY, s)
        if not nodes or not all_nodes:
            return None
        s.constraints = _filter_constraints(
            pod.spec.topology_spread_constraints, SCHEDULE_ANYWAY
        )
        if not s.constraints:
            return None
        # init: eligible topology pairs come from *filtered* nodes only
        # (scoring.go:56 initPreScoreState).
        for ni in nodes:
            node = ni.node
            if node is None or not _node_labels_match_constraints(
                node.metadata.labels, s.constraints
            ):
                continue
            for c in s.constraints:
                pair = (c.topology_key, node.metadata.labels[c.topology_key])
                s.topology_pair_to_pod_counts.setdefault(pair, 0)
            s.node_name_set.add(node.metadata.name)
        # count matches over ALL nodes (scoring.go:120 processAllNode).
        for ni in all_nodes:
            node = ni.node
            if node is None:
                continue
            if not pod_matches_node_selector_and_affinity(pod, ni):
                continue
            if not _node_labels_match_constraints(
                node.metadata.labels, s.constraints
            ):
                continue
            for c in s.constraints:
                pair = (c.topology_key, node.metadata.labels[c.topology_key])
                if pair not in s.topology_pair_to_pod_counts:
                    continue
                match_sum = 0
                for existing in ni.pods:
                    if (
                        existing.metadata.deletion_timestamp is not None
                        or existing.metadata.namespace != pod.metadata.namespace
                    ):
                        continue
                    if labels_match_selector(
                        existing.metadata.labels, c.selector
                    ):
                        match_sum += 1
                s.topology_pair_to_pod_counts[pair] += match_sum
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        """Raw score = matching pod count (normalized later);
        reference scoring.go:166."""
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        try:
            s: PreScoreState = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return 0, Status.error(
                f"error reading {PRE_SCORE_STATE_KEY!r} from cycleState"
            )
        node = ni.node
        if node.metadata.name not in s.node_name_set:
            return 0, None
        score = 0
        for c in s.constraints:
            tp_val = node.metadata.labels.get(c.topology_key)
            if tp_val is not None:
                score += s.topology_pair_to_pod_counts.get(
                    (c.topology_key, tp_val), 0
                )
        return score, None

    def normalize_score(
        self, state: CycleState, pod: Pod, scores: List[NodeScore]
    ) -> Optional[Status]:
        """Reference scoring.go:199 NormalizeScore: flipped-linear against
        (total - min); ineligible nodes score 0."""
        try:
            s: PreScoreState = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return Status.error(
                f"error reading {PRE_SCORE_STATE_KEY!r} from cycleState"
            )
        # min stays MaxInt64 when no node is eligible, making the diff
        # non-zero so every node normalizes to 0 (matches reference).
        min_score = (1 << 63) - 1
        total = 0
        for ns in scores:
            if ns.name not in s.node_name_set:
                continue
            total += ns.score
            min_score = min(min_score, ns.score)
        max_min_diff = total - min_score
        for ns in scores:
            if max_min_diff == 0:
                ns.score = MAX_NODE_SCORE
                continue
            if ns.name not in s.node_name_set:
                ns.score = 0
                continue
            flipped = total - ns.score
            ns.score = int(MAX_NODE_SCORE * (flipped / max_min_diff))
        return None
