"""SelectorSpread (DefaultPodTopologySpread), ServiceAffinity, NodeLabel.

References:
- defaultpodtopologyspread/default_pod_topology_spread.go (:49
  zoneWeighting=2/3, :78 Score = matching-pod count on node, :107
  NormalizeScore with zone blending) + helper/spread.go:29 DefaultSelector
  (merged Service/RC selectors + RS/SS selector requirements)
- serviceaffinity/service_affinity.go (:108 createPreFilterState over
  service-mate pods, :233 Filter label homogeneity with backfilled
  "implicit selector", :273 Score, :310 NormalizeScore reversed)
- nodelabel/node_label.go (presence/absence filter + preference score)
- pkg/util/node GetZoneKey: region + ":\x00:" + zone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.selectors import (
    label_selector_as_dict_matches,
    labels_match_selector,
)
from kubernetes_tpu_torch.api.types import (
    LABEL_REGION_KEYS,
    LABEL_ZONE_KEYS,
    LabelSelector,
    Node,
    Pod,
)
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    MAX_NODE_SCORE,
    NodeScore,
    Plugin,
    PreFilterExtensions,
    Status,
)
from kubernetes_tpu_torch.plugins.helpers import default_normalize_score

ZONE_WEIGHTING = 2.0 / 3.0

PRE_SCORE_SELECTOR_KEY = "PreScoreDefaultPodTopologySpread"
PRE_FILTER_SERVICE_AFFINITY_KEY = "PreFilterServiceAffinity"
PRE_SCORE_SERVICE_AFFINITY_KEY = "PreScoreServiceAffinity"

ERR_REASON_SERVICE_AFFINITY = "node(s) didn't match service affinity"


def get_zone_key(node: Optional[Node]) -> str:
    """pkg/util/node GetZoneKey: combined region/zone id."""
    if node is None:
        return ""
    labels = node.metadata.labels
    region = next((labels[k] for k in LABEL_REGION_KEYS if k in labels), "")
    zone = next((labels[k] for k in LABEL_ZONE_KEYS if k in labels), "")
    if not region and not zone:
        return ""
    return region + ":\x00:" + zone


class CombinedSelector:
    """The merged 'default selector' (helper/spread.go:29): Service + RC
    map selectors merged into one label set, plus RS/SS LabelSelector
    requirements ANDed on top. Empty => matches nothing."""

    def __init__(self) -> None:
        self.match_labels: Dict[str, str] = {}
        self.extra: List[LabelSelector] = []

    @property
    def empty(self) -> bool:
        return not self.match_labels and not self.extra

    def matches(self, labels: Dict[str, str]) -> bool:
        if self.empty:
            return False
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for sel in self.extra:
            if not labels_match_selector(labels, sel):
                return False
        return True


def default_selector(pod: Pod, informers) -> CombinedSelector:
    out = CombinedSelector()
    if informers is None:
        return out
    ns, pod_labels = pod.metadata.namespace, pod.metadata.labels
    for svc in informers.services().list():
        if svc.metadata.namespace == ns and label_selector_as_dict_matches(
            svc.selector, pod_labels
        ):
            out.match_labels.update(svc.selector)
    for rc in informers.replication_controllers().list():
        if rc.metadata.namespace == ns and label_selector_as_dict_matches(
            rc.selector, pod_labels
        ):
            out.match_labels.update(rc.selector)
    for rs in informers.replica_sets().list():
        if rs.metadata.namespace == ns and labels_match_selector(
            pod_labels, rs.selector
        ):
            out.extra.append(rs.selector)
    for ss in informers.stateful_sets().list():
        if ss.metadata.namespace == ns and labels_match_selector(
            pod_labels, ss.selector
        ):
            out.extra.append(ss.selector)
    return out


def _count_matching_pods(
    namespace: str, selector: CombinedSelector, node_info: NodeInfo
) -> int:
    """default_pod_topology_spread.go:206 countMatchingPods."""
    if not node_info.pods or selector.empty:
        return 0
    count = 0
    for p in node_info.pods:
        if (
            p.metadata.namespace == namespace
            and p.metadata.deletion_timestamp is None
            and selector.matches(p.metadata.labels)
        ):
            count += 1
    return count


class DefaultPodTopologySpread(Plugin):
    NAME = "DefaultPodTopologySpread"

    def __init__(self, handle=None) -> None:
        self.handle = handle

    @staticmethod
    def _skip(pod: Pod) -> bool:
        return bool(pod.spec.topology_spread_constraints)

    def pre_score(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Optional[Status]:
        if self._skip(pod):
            return None  # score/normalize will ignore it anyway
        informers = getattr(self.handle, "informers", None)
        state.write(PRE_SCORE_SELECTOR_KEY, default_selector(pod, informers))
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        if self._skip(pod):
            return 0, None
        try:
            selector: CombinedSelector = state.read(PRE_SCORE_SELECTOR_KEY)
        except KeyError:
            return 0, Status.error(
                f"error reading {PRE_SCORE_SELECTOR_KEY!r} from cycleState"
            )
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        return _count_matching_pods(pod.metadata.namespace, selector, ni), None

    def normalize_score(
        self, state: CycleState, pod: Pod, scores: List[NodeScore]
    ) -> Optional[Status]:
        """default_pod_topology_spread.go:107: invert counts, blending
        2/3 zone-level spread when zones are labeled."""
        if self._skip(pod):
            return None
        snapshot = state.read("__snapshot__")
        counts_by_zone: Dict[str, int] = {}
        max_by_node = 0
        for ns in scores:
            max_by_node = max(max_by_node, ns.score)
            ni = snapshot.get_node_info(ns.name)
            zone_id = get_zone_key(ni.node if ni else None)
            if zone_id:
                counts_by_zone[zone_id] = counts_by_zone.get(zone_id, 0) + ns.score
        max_by_zone = max(counts_by_zone.values(), default=0)
        have_zones = bool(counts_by_zone)
        for ns in scores:
            f_score = float(MAX_NODE_SCORE)
            if max_by_node > 0:
                f_score = MAX_NODE_SCORE * (max_by_node - ns.score) / max_by_node
            if have_zones:
                ni = snapshot.get_node_info(ns.name)
                zone_id = get_zone_key(ni.node if ni else None)
                if zone_id:
                    zone_score = float(MAX_NODE_SCORE)
                    if max_by_zone > 0:
                        zone_score = (
                            MAX_NODE_SCORE
                            * (max_by_zone - counts_by_zone[zone_id])
                            / max_by_zone
                        )
                    f_score = (
                        f_score * (1.0 - ZONE_WEIGHTING)
                        + ZONE_WEIGHTING * zone_score
                    )
            ns.score = int(f_score)
        return None


class _ServiceAffinityState:
    def __init__(self, matching_pods: List[Pod]) -> None:
        self.matching_pods = matching_pods

    def clone(self) -> "_ServiceAffinityState":
        return _ServiceAffinityState(list(self.matching_pods))


class _ServiceAffinityExtensions(PreFilterExtensions):
    def add_pod(self, state, pod_to_schedule, pod_to_add, node_info):
        try:
            s: _ServiceAffinityState = state.read(PRE_FILTER_SERVICE_AFFINITY_KEY)
        except KeyError:
            return None
        if pod_to_add.metadata.namespace != pod_to_schedule.metadata.namespace:
            return None
        if pod_to_schedule.metadata.labels and all(
            pod_to_add.metadata.labels.get(k) == v
            for k, v in pod_to_schedule.metadata.labels.items()
        ):
            s.matching_pods.append(pod_to_add)
        return None

    def remove_pod(self, state, pod_to_schedule, pod_to_remove, node_info):
        try:
            s: _ServiceAffinityState = state.read(PRE_FILTER_SERVICE_AFFINITY_KEY)
        except KeyError:
            return None
        s.matching_pods = [
            p for p in s.matching_pods
            if not (
                p.metadata.name == pod_to_remove.metadata.name
                and p.metadata.namespace == pod_to_remove.metadata.namespace
            )
        ]
        return None


class ServiceAffinity(Plugin):
    """Policy-era plugin: service-mate pods land on nodes with identical
    values for the configured label keys."""

    NAME = "ServiceAffinity"

    def __init__(self, args: Optional[dict] = None, handle=None) -> None:
        args = args or {}
        self.affinity_labels: List[str] = list(args.get("affinity_labels", ()))
        self.anti_affinity_labels_preference: List[str] = list(
            args.get("anti_affinity_labels_preference", ())
        )
        self.handle = handle
        self._extensions = _ServiceAffinityExtensions()

    def _service_mate_pods(self, state: CycleState, pod: Pod) -> List[Pod]:
        """Scheduled pods selected by any service that also selects
        ``pod`` (service_affinity.go:108)."""
        informers = getattr(self.handle, "informers", None)
        if informers is None:
            return []
        snapshot = state.read("__snapshot__")
        selectors = [
            svc.selector
            for svc in informers.services().list()
            if svc.metadata.namespace == pod.metadata.namespace
            and label_selector_as_dict_matches(
                svc.selector, pod.metadata.labels
            )
        ]
        if not selectors:
            return []
        out = []
        for p in snapshot.list_pods():
            if p.metadata.namespace != pod.metadata.namespace:
                continue
            if any(
                label_selector_as_dict_matches(sel, p.metadata.labels)
                for sel in selectors
            ):
                out.append(p)
        return out

    def pre_filter(self, state: CycleState, pod: Pod) -> Optional[Status]:
        """service_affinity.go:108 createPreFilterState: matching pods are
        same-namespace pods carrying ALL of the incoming pod's labels (the
        pod's own labels as selector) -- the same predicate AddPod uses, so
        incremental updates equal a recompute."""
        if not self.affinity_labels:
            return None
        snapshot = state.read("__snapshot__")
        own = pod.metadata.labels
        matching = [
            p
            for p in snapshot.list_pods()
            if p.metadata.namespace == pod.metadata.namespace
            and own
            and all(p.metadata.labels.get(k) == v for k, v in own.items())
        ]
        state.write(
            PRE_FILTER_SERVICE_AFFINITY_KEY, _ServiceAffinityState(matching)
        )
        return None

    def pre_filter_extensions(self) -> PreFilterExtensions:
        return self._extensions

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        """service_affinity.go:233: backfill unset affinity labels from an
        already-scheduled service mate's node, then require the candidate
        node to match them all."""
        if not self.affinity_labels:
            return None
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        wanted: Dict[str, str] = {
            k: pod.spec.node_selector[k]
            for k in self.affinity_labels
            if k in pod.spec.node_selector
        }
        if len(wanted) < len(self.affinity_labels):
            try:
                s: _ServiceAffinityState = state.read(
                    PRE_FILTER_SERVICE_AFFINITY_KEY
                )
            except KeyError:
                self.pre_filter(state, pod)
                s = state.read(PRE_FILTER_SERVICE_AFFINITY_KEY)
            snapshot = state.read("__snapshot__")
            scheduled = [
                p for p in s.matching_pods if p.spec.node_name
            ]
            if scheduled:
                mate_ni = snapshot.get_node_info(scheduled[0].spec.node_name)
                if mate_ni is not None and mate_ni.node is not None:
                    for k in self.affinity_labels:
                        if k not in wanted and k in mate_ni.node.metadata.labels:
                            wanted[k] = mate_ni.node.metadata.labels[k]
        for k, v in wanted.items():
            if node.metadata.labels.get(k) != v:
                return Status.unschedulable(ERR_REASON_SERVICE_AFFINITY)
        return None

    def pre_score(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Optional[Status]:
        """Compute the (node-independent) service-mate set once per cycle;
        score() reads it instead of rescanning services x pods per node."""
        if self.anti_affinity_labels_preference:
            state.write(
                PRE_SCORE_SERVICE_AFFINITY_KEY,
                self._service_mate_pods(state, pod),
            )
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        """service_affinity.go:273: count service mates on nodes sharing
        this node's values for the preference labels."""
        if not self.anti_affinity_labels_preference:
            return 0, None
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        try:
            mates = state.read(PRE_SCORE_SERVICE_AFFINITY_KEY)
        except KeyError:
            mates = self._service_mate_pods(state, pod)
        score = 0
        for label in self.anti_affinity_labels_preference:
            node_val = ni.node.metadata.labels.get(label)
            if node_val is None:
                continue
            for mate in mates:
                if not mate.spec.node_name:
                    continue
                mate_ni = snapshot.get_node_info(mate.spec.node_name)
                if (
                    mate_ni is not None
                    and mate_ni.node is not None
                    and mate_ni.node.metadata.labels.get(label) == node_val
                ):
                    score += 1
        return score, None

    def normalize_score(
        self, state: CycleState, pod: Pod, scores: List[NodeScore]
    ) -> Optional[Status]:
        if not self.anti_affinity_labels_preference:
            return None
        default_normalize_score(MAX_NODE_SCORE, True, scores)  # reversed
        return None


ERR_REASON_NODE_LABEL = "node(s) didn't have the requested labels"


class NodeLabel(Plugin):
    """Policy-era presence/absence label plugin (nodelabel/node_label.go)."""

    NAME = "NodeLabel"

    def __init__(self, args: Optional[dict] = None) -> None:
        args = args or {}
        self.present_labels = list(args.get("present_labels", ()))
        self.absent_labels = list(args.get("absent_labels", ()))
        self.present_labels_preference = list(
            args.get("present_labels_preference", ())
        )
        self.absent_labels_preference = list(
            args.get("absent_labels_preference", ())
        )
        conflict = set(self.present_labels) & set(self.absent_labels)
        if conflict:
            raise ValueError(
                f"labels in both present and absent lists: {sorted(conflict)}"
            )

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        labels = node.metadata.labels
        for l in self.present_labels:
            if l not in labels:
                return Status.unschedulable_and_unresolvable(
                    ERR_REASON_NODE_LABEL
                )
        for l in self.absent_labels:
            if l in labels:
                return Status.unschedulable_and_unresolvable(
                    ERR_REASON_NODE_LABEL
                )
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        labels = ni.node.metadata.labels
        size = len(self.present_labels_preference) + len(
            self.absent_labels_preference
        )
        if size == 0:
            return 0, None
        score = 0
        for l in self.present_labels_preference:
            if l in labels:
                score += MAX_NODE_SCORE
        for l in self.absent_labels_preference:
            if l not in labels:
                score += MAX_NODE_SCORE
        return score // size, None
