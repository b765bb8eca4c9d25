"""Generic (per-pod, sequential) scheduling algorithm -- the oracle path.

Reference: /root/reference/pkg/scheduler/core/generic_scheduler.go
(Schedule :150, findNodesThatFitPod :414, findNodesThatPassFilters :429,
numFeasibleNodesToFind :390, prioritizeNodes :626, selectHost :235,
podPassesFiltersOnNode :570 with the 2-pass nominated-pods logic).

On TPU this whole pipeline is replaced by vectorized masks/scores + batched
assignment (kubernetes_tpu_torch.ops.assignment); adaptive node sampling is
deliberately NOT used there -- full vectorized evaluation is cheaper than
divergence on TPU (SURVEY.md section 2.5).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.cache.cache import SchedulerCache
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch.config.types import (
    MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND,
    MIN_FEASIBLE_NODES_TO_FIND,
)
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    FitError,
    NodeToStatusMap,
    Status,
    StatusCode,
)
from kubernetes_tpu_torch.framework.runtime import Framework

SNAPSHOT_STATE_KEY = "__snapshot__"


@dataclass
class ScheduleResult:
    """Reference generic_scheduler.go:107."""

    suggested_host: str = ""
    evaluated_nodes: int = 0
    feasible_nodes: int = 0


class GenericScheduler:
    def __init__(
        self,
        cache: SchedulerCache,
        snapshot: Optional[Snapshot] = None,
        percentage_of_nodes_to_score: int = 0,
        nominated_pods_lister=None,
        extenders: Optional[list] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        self.cache = cache
        self.snapshot = snapshot or Snapshot()
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.next_start_node_index = 0
        self.nominated_pods_lister = nominated_pods_lister  # PriorityQueue
        self.extenders = extenders or []
        self.rng = rng or random.Random()

    # -- entry point (generic_scheduler.go:150 Schedule) --------------------

    def schedule(
        self, prof: Framework, state: CycleState, pod: Pod
    ) -> ScheduleResult:
        self.cache.update_snapshot(self.snapshot)
        state.write(SNAPSHOT_STATE_KEY, self.snapshot)
        num_nodes = self.snapshot.num_nodes()
        if num_nodes == 0:
            raise FitError(pod, 0, {})

        status = prof.run_pre_filter_plugins(state, pod)
        if status is not None and not status.is_success():
            if status.is_unschedulable():
                raise FitError(
                    pod, num_nodes, {"": status}
                )
            raise RuntimeError(status.message())

        feasible, statuses = self.find_nodes_that_fit_pod(prof, state, pod)
        if not feasible:
            raise FitError(pod, num_nodes, statuses)
        if len(feasible) == 1:
            return ScheduleResult(
                suggested_host=feasible[0].node_name,
                evaluated_nodes=1 + len(statuses),
                feasible_nodes=1,
            )

        priority_list = self.prioritize_nodes(prof, state, pod, feasible)
        host = self.select_host(priority_list)
        return ScheduleResult(
            suggested_host=host,
            evaluated_nodes=len(feasible) + len(statuses),
            feasible_nodes=len(feasible),
        )

    # -- filtering ----------------------------------------------------------

    def num_feasible_nodes_to_find(self, num_all_nodes: int) -> int:
        """Adaptive search truncation (generic_scheduler.go:390)."""
        if (
            num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND
            or self.percentage_of_nodes_to_score >= 100
        ):
            return num_all_nodes
        adaptive_percentage = self.percentage_of_nodes_to_score
        if adaptive_percentage <= 0:
            basic_percentage = 50
            adaptive_percentage = basic_percentage - num_all_nodes // 125
            if adaptive_percentage < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
                adaptive_percentage = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
        num_nodes = num_all_nodes * adaptive_percentage // 100
        if num_nodes < MIN_FEASIBLE_NODES_TO_FIND:
            return MIN_FEASIBLE_NODES_TO_FIND
        return num_nodes

    def find_nodes_that_fit_pod(
        self, prof: Framework, state: CycleState, pod: Pod
    ) -> Tuple[List[NodeInfo], NodeToStatusMap]:
        """generic_scheduler.go:414 + :429 findNodesThatPassFilters."""
        all_nodes = self.snapshot.list_node_infos()
        num_all = len(all_nodes)
        num_to_find = self.num_feasible_nodes_to_find(num_all)
        feasible: List[NodeInfo] = []
        statuses: NodeToStatusMap = {}

        if not prof.has_filter_plugins():
            # length check preserves round-robin semantics (:447)
            start = self.next_start_node_index % num_all
            feasible = [all_nodes[(start + i) % num_all] for i in range(num_to_find)]
            self.next_start_node_index = (start + num_to_find) % num_all
        else:
            checked = 0
            for i in range(num_all):
                if len(feasible) >= num_to_find:
                    break
                ni = all_nodes[(self.next_start_node_index + i) % num_all]
                checked += 1
                fits, status = self.pod_passes_filters_on_node(
                    prof, state, pod, ni
                )
                if fits:
                    feasible.append(ni)
                elif status is not None:
                    statuses[ni.node_name] = status
            self.next_start_node_index = (
                self.next_start_node_index + checked
            ) % num_all

        feasible = self._find_nodes_that_pass_extenders(pod, feasible, statuses)
        return feasible, statuses

    def pod_passes_filters_on_node(
        self, prof: Framework, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Tuple[bool, Optional[Status]]:
        """2-pass filter with nominated pods (generic_scheduler.go:570):
        pass 1 with higher/equal-priority nominated pods virtually added,
        pass 2 without (only needed when pass 1 added some)."""
        status: Optional[Status] = None
        pod_added = False
        state_to_use = state
        info_to_use = node_info
        for i in range(2):
            if i == 0:
                pod_added, state_to_use, info_to_use = self._add_nominated_pods(
                    prof, pod, state, node_info
                )
            elif not pod_added:
                break
            else:
                state_to_use, info_to_use = state, node_info
            statuses = prof.run_filter_plugins(state_to_use, pod, info_to_use)
            if statuses:
                status = self._merge_statuses(statuses)
                return False, status
        return True, status

    def _add_nominated_pods(
        self, prof: Framework, pod: Pod, state: CycleState, node_info: NodeInfo
    ) -> Tuple[bool, CycleState, NodeInfo]:
        """generic_scheduler.go:535 addNominatedPods."""
        if self.nominated_pods_lister is None:
            return False, state, node_info
        nominated = self.nominated_pods_lister.nominated_pods_for_node(
            node_info.node_name
        )
        if not nominated:
            return False, state, node_info
        node_info_out = node_info.clone()
        state_out = state.clone()
        added = False
        for p in nominated:
            if (
                p.spec.priority >= pod.spec.priority
                and p.metadata.uid != pod.metadata.uid
            ):
                node_info_out.add_pod(p)
                prof.run_pre_filter_extension_add_pod(
                    state_out, pod, p, node_info_out
                )
                added = True
        return added, state_out, node_info_out

    @staticmethod
    def _merge_statuses(statuses: Dict[str, Status]) -> Status:
        """PluginToStatus.Merge (framework interface.go:103): reasons
        accumulate; UnschedulableAndUnresolvable dominates Unschedulable."""
        code = StatusCode.UNSCHEDULABLE
        reasons: List[str] = []
        for s in statuses.values():
            if s.code == StatusCode.ERROR:
                code = StatusCode.ERROR
            elif (
                s.code == StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
                and code != StatusCode.ERROR
            ):
                code = StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
            reasons.extend(s.reasons)
        return Status(code, *reasons)

    def _find_nodes_that_pass_extenders(
        self, pod: Pod, feasible: List[NodeInfo], statuses: NodeToStatusMap
    ) -> List[NodeInfo]:
        """generic_scheduler.go:502: HTTP extenders filter after in-tree."""
        for extender in self.extenders:
            if not feasible:
                break
            if not extender.is_interested(pod):
                continue
            feasible, failed = extender.filter(pod, feasible)
            for name, reason in failed.items():
                statuses[name] = Status.unschedulable(reason)
        return feasible

    # -- scoring ------------------------------------------------------------

    def prioritize_nodes(
        self,
        prof: Framework,
        state: CycleState,
        pod: Pod,
        nodes: List[NodeInfo],
    ) -> List[Tuple[str, int]]:
        """generic_scheduler.go:626: returns [(node_name, total_score)]."""
        if not self.extenders and not prof.has_score_plugins():
            return [(ni.node_name, 1) for ni in nodes]

        status = prof.run_pre_score_plugins(state, pod, nodes)
        if status is not None and not status.is_success():
            raise RuntimeError(status.message())

        node_names = [ni.node_name for ni in nodes]
        scores_by_plugin, status = prof.run_score_plugins(state, pod, node_names)
        if status is not None and not status.is_success():
            raise RuntimeError(status.message())

        totals: Dict[str, int] = {name: 0 for name in node_names}
        for plugin_scores in scores_by_plugin.values():
            for ns in plugin_scores:
                totals[ns.name] += ns.score

        for extender in self.extenders:
            if not extender.is_interested(pod):
                continue
            ext_scores = extender.prioritize(pod, nodes)
            for name, score in ext_scores.items():
                totals[name] = totals.get(name, 0) + score

        return [(name, totals[name]) for name in node_names]

    def select_host(self, priority_list: List[Tuple[str, int]]) -> str:
        """Reservoir-sampled argmax among ties (generic_scheduler.go:235)."""
        if not priority_list:
            raise ValueError("empty priority list")
        selected, max_score = priority_list[0]
        ties = 1
        for name, score in priority_list[1:]:
            if score > max_score:
                max_score = score
                selected = name
                ties = 1
            elif score == max_score:
                ties += 1
                if self.rng.randrange(ties) == 0:
                    selected = name
        return selected
