"""InterPodAffinity: required (Filter) and preferred (Score) pod
(anti-)affinity.

Reference: /root/reference/pkg/scheduler/framework/plugins/interpodaffinity/
(filtering.go: preFilterState :52, topologyToMatchedTermCount :119,
getTPMapMatchingExistingAntiAffinity :212,
getTPMapMatchingIncomingAffinityAntiAffinity :256, PreFilter :330,
satisfiesExistingPodsAntiAffinity :404, satisfiesPodsAffinityAntiAffinity
:479, Filter :516; scoring.go: preScoreState :36, processExistingPod :111,
PreScore :169, Score :267, NormalizeScore :294) and
pkg/scheduler/util/topologies.go (:28 GetNamespacesFromPodAffinityTerm,
:40 PodMatchesTermsNamespaceAndSelector).

On TPU the O(pods x nodes) prefilter becomes a single scatter pass into
``[num_topology_pairs]`` count tensors (kubernetes_tpu_torch.ops); this host
implementation is the correctness oracle.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api.selectors import labels_match_selector
from kubernetes_tpu_torch.api.types import (
    LabelSelector,
    Node,
    Pod,
    PodAffinityTerm,
    WeightedPodAffinityTerm,
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

PRE_FILTER_STATE_KEY = "PreFilterInterPodAffinity"
PRE_SCORE_STATE_KEY = "PreScoreInterPodAffinity"

ERR_REASON_AFFINITY_NOT_MATCH = "node(s) didn't match pod affinity/anti-affinity"
ERR_REASON_EXISTING_ANTI_AFFINITY = (
    "node(s) didn't satisfy existing pods anti-affinity rules"
)
ERR_REASON_AFFINITY_RULES = "node(s) didn't match pod affinity rules"
ERR_REASON_ANTI_AFFINITY_RULES = "node(s) didn't match pod anti-affinity rules"

DEFAULT_HARD_POD_AFFINITY_WEIGHT = 1

TopologyPair = Tuple[str, str]


def _term_namespaces(pod: Pod, term: PodAffinityTerm) -> Set[str]:
    """Empty term namespaces default to the owner pod's namespace
    (topologies.go:28)."""
    if term.namespaces:
        return set(term.namespaces)
    return {pod.metadata.namespace}


def _pod_matches_term(pod: Pod, namespaces: Set[str], selector) -> bool:
    """topologies.go:40 PodMatchesTermsNamespaceAndSelector."""
    if pod.metadata.namespace not in namespaces:
        return False
    return labels_match_selector(pod.metadata.labels, selector)


class _Term:
    """Processed affinity term (filtering.go:170 affinityTerm)."""

    __slots__ = ("namespaces", "selector", "topology_key", "weight")

    def __init__(
        self, owner: Pod, term: PodAffinityTerm, weight: int = 0
    ) -> None:
        self.namespaces = _term_namespaces(owner, term)
        self.selector: Optional[LabelSelector] = term.label_selector
        self.topology_key = term.topology_key
        self.weight = weight

    def matches(self, pod: Pod) -> bool:
        return _pod_matches_term(pod, self.namespaces, self.selector)


def _required_affinity_terms(pod: Pod) -> List[PodAffinityTerm]:
    a = pod.spec.affinity
    if a is None or a.pod_affinity is None:
        return []
    return a.pod_affinity.required_during_scheduling


def _required_anti_affinity_terms(pod: Pod) -> List[PodAffinityTerm]:
    a = pod.spec.affinity
    if a is None or a.pod_anti_affinity is None:
        return []
    return a.pod_anti_affinity.required_during_scheduling


def _preferred_terms(terms: List[WeightedPodAffinityTerm], owner: Pod) -> List[_Term]:
    return [
        _Term(owner, wt.pod_affinity_term, wt.weight) for wt in terms
    ]


class TermCount:
    """topologyToMatchedTermCount (filtering.go:119): (key,value) -> count."""

    __slots__ = ("counts",)

    def __init__(self) -> None:
        self.counts: Dict[TopologyPair, int] = {}

    def clone(self) -> "TermCount":
        tc = TermCount()
        tc.counts = dict(self.counts)
        return tc

    def get(self, pair: TopologyPair) -> int:
        return self.counts.get(pair, 0)

    def _bump(self, pair: TopologyPair, value: int) -> None:
        n = self.counts.get(pair, 0) + value
        if n == 0:
            self.counts.pop(pair, None)
        else:
            self.counts[pair] = n

    def update_with_affinity_terms(
        self, target: Pod, target_node: Node, terms: List[_Term], value: int
    ) -> None:
        """Bump every term's pair iff target matches ALL terms
        (filtering.go:135)."""
        if not terms or not all(t.matches(target) for t in terms):
            return
        for t in terms:
            tp_val = target_node.metadata.labels.get(t.topology_key)
            if tp_val is not None:
                self._bump((t.topology_key, tp_val), value)

    def update_with_anti_affinity_terms(
        self, target: Pod, target_node: Node, terms: List[_Term], value: int
    ) -> None:
        """Bump per-term on ANY match (filtering.go:153)."""
        for t in terms:
            if t.matches(target):
                tp_val = target_node.metadata.labels.get(t.topology_key)
                if tp_val is not None:
                    self._bump((t.topology_key, tp_val), value)


class PreFilterState:
    """filtering.go:52 preFilterState."""

    def __init__(self) -> None:
        self.existing_anti_affinity = TermCount()
        self.affinity = TermCount()
        self.anti_affinity = TermCount()

    def clone(self) -> "PreFilterState":
        s = PreFilterState()
        s.existing_anti_affinity = self.existing_anti_affinity.clone()
        s.affinity = self.affinity.clone()
        s.anti_affinity = self.anti_affinity.clone()
        return s

    def update_with_pod(
        self, updated: Pod, pod: Pod, node: Optional[Node], multiplier: int
    ) -> None:
        """filtering.go:75 updateWithPod."""
        if node is None:
            return
        up_aff = updated.spec.affinity
        if up_aff is not None and up_aff.pod_anti_affinity is not None:
            terms = [
                _Term(updated, t)
                for t in _required_anti_affinity_terms(updated)
            ]
            self.existing_anti_affinity.update_with_anti_affinity_terms(
                pod, node, terms, multiplier
            )
        if pod.spec.affinity is not None and updated.spec.node_name:
            aff_terms = [_Term(pod, t) for t in _required_affinity_terms(pod)]
            if aff_terms:
                self.affinity.update_with_affinity_terms(
                    updated, node, aff_terms, multiplier
                )
            anti_terms = [
                _Term(pod, t) for t in _required_anti_affinity_terms(pod)
            ]
            if anti_terms:
                self.anti_affinity.update_with_anti_affinity_terms(
                    updated, node, anti_terms, multiplier
                )


class _AffinityPreFilterExtensions(PreFilterExtensions):
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
    """scoring.go:36 preScoreState."""

    def __init__(self) -> None:
        self.topology_score: Dict[str, Dict[str, int]] = {}
        self.affinity_terms: List[_Term] = []
        self.anti_affinity_terms: List[_Term] = []

    def clone(self) -> "PreScoreState":
        return self


class InterPodAffinity(Plugin):
    NAME = "InterPodAffinity"

    def __init__(self, args: Optional[dict] = None, handle=None) -> None:
        args = args or {}
        self.hard_pod_affinity_weight = int(
            args.get("hard_pod_affinity_weight", DEFAULT_HARD_POD_AFFINITY_WEIGHT)
        )
        self.handle = handle
        self._extensions = _AffinityPreFilterExtensions()

    # -- PreFilter / Filter -------------------------------------------------

    def pre_filter(self, state: CycleState, pod: Pod) -> Optional[Status]:
        """filtering.go:330 PreFilter."""
        snapshot = state.read("__snapshot__")
        all_nodes = snapshot.list_node_infos()
        affinity_nodes = snapshot.have_pods_with_affinity_list

        s = PreFilterState()
        # (1) existing pods' anti-affinity terms that match the incoming pod
        #     (filtering.go:212; only nodes that have pods with affinity).
        for ni in affinity_nodes:
            node = ni.node
            if node is None:
                continue
            for existing in ni.pods_with_affinity:
                terms = [
                    _Term(existing, t)
                    for t in _required_anti_affinity_terms(existing)
                ]
                s.existing_anti_affinity.update_with_anti_affinity_terms(
                    pod, node, terms, 1
                )
        # (2) existing pods matching the incoming pod's terms
        #     (filtering.go:256; all nodes x all pods).
        aff_terms = [_Term(pod, t) for t in _required_affinity_terms(pod)]
        anti_terms = [_Term(pod, t) for t in _required_anti_affinity_terms(pod)]
        if aff_terms or anti_terms:
            for ni in all_nodes:
                node = ni.node
                if node is None:
                    continue
                for existing in ni.pods:
                    s.affinity.update_with_affinity_terms(
                        existing, node, aff_terms, 1
                    )
                    s.anti_affinity.update_with_anti_affinity_terms(
                        existing, node, anti_terms, 1
                    )
        state.write(PRE_FILTER_STATE_KEY, s)
        return None

    def pre_filter_extensions(self) -> PreFilterExtensions:
        return self._extensions

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        """filtering.go:516 Filter."""
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        s = _get_pre_filter_state(state)
        if isinstance(s, Status):
            return s

        # existing pods' anti-affinity (filtering.go:404): any label pair of
        # this node with a positive count blocks the pod.
        for key, value in node.metadata.labels.items():
            if s.existing_anti_affinity.get((key, value)) > 0:
                return Status.unschedulable(
                    ERR_REASON_AFFINITY_NOT_MATCH,
                    ERR_REASON_EXISTING_ANTI_AFFINITY,
                )

        aff_terms = _required_affinity_terms(pod)
        anti_terms = _required_anti_affinity_terms(pod)
        if not aff_terms and not anti_terms:
            return None

        # incoming affinity: node must carry every term's topology pair with
        # a positive count (filtering.go:420 nodeMatchesAllTopologyTerms).
        if aff_terms:
            matches_all = True
            for term in aff_terms:
                tp_val = node.metadata.labels.get(term.topology_key)
                if tp_val is None or s.affinity.get(
                    (term.topology_key, tp_val)
                ) <= 0:
                    matches_all = False
                    break
            if not matches_all:
                # first-pod-in-series escape hatch (filtering.go:494): no pod
                # anywhere matches and the pod matches its own terms.
                terms = [_Term(pod, t) for t in aff_terms]
                self_match = bool(terms) and all(
                    t.matches(pod) for t in terms
                )
                if s.affinity.counts or not self_match:
                    return Status.unschedulable_and_unresolvable(
                        ERR_REASON_AFFINITY_NOT_MATCH,
                        ERR_REASON_AFFINITY_RULES,
                    )

        # incoming anti-affinity: any positive pair blocks
        # (filtering.go:437 nodeMatchesAnyTopologyTerm).
        for term in anti_terms:
            tp_val = node.metadata.labels.get(term.topology_key)
            if tp_val is not None and s.anti_affinity.get(
                (term.topology_key, tp_val)
            ) > 0:
                return Status.unschedulable(
                    ERR_REASON_AFFINITY_NOT_MATCH,
                    ERR_REASON_ANTI_AFFINITY_RULES,
                )
        return None

    # -- PreScore / Score ---------------------------------------------------

    def pre_score(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Optional[Status]:
        """scoring.go:169 PreScore."""
        s = PreScoreState()
        state.write(PRE_SCORE_STATE_KEY, s)
        if not nodes:
            return None
        snapshot = state.read("__snapshot__")
        affinity = pod.spec.affinity
        has_aff = affinity is not None and affinity.pod_affinity is not None
        has_anti = affinity is not None and affinity.pod_anti_affinity is not None
        if has_aff:
            s.affinity_terms = _preferred_terms(
                affinity.pod_affinity.preferred_during_scheduling, pod
            )
        if has_anti:
            s.anti_affinity_terms = _preferred_terms(
                affinity.pod_anti_affinity.preferred_during_scheduling, pod
            )
        # Unless the incoming pod has constraints, only nodes hosting pods
        # with affinity matter (scoring.go:193).
        if has_aff or has_anti:
            all_nodes = snapshot.list_node_infos()
        else:
            all_nodes = snapshot.have_pods_with_affinity_list
        for ni in all_nodes:
            node = ni.node
            if node is None:
                continue
            pods = ni.pods if (has_aff or has_anti) else ni.pods_with_affinity
            for existing in pods:
                self._process_existing_pod(s, existing, node, pod)
        return None

    def _process_term(
        self,
        s: PreScoreState,
        term: _Term,
        pod_to_check: Pod,
        fixed_node: Node,
        multiplier: int,
    ) -> None:
        """scoring.go:79 processTerm."""
        if not fixed_node.metadata.labels:
            return
        tp_val = fixed_node.metadata.labels.get(term.topology_key)
        if tp_val is None or not term.matches(pod_to_check):
            return
        by_val = s.topology_score.setdefault(term.topology_key, {})
        by_val[tp_val] = by_val.get(tp_val, 0) + term.weight * multiplier

    def _process_existing_pod(
        self, s: PreScoreState, existing: Pod, existing_node: Node, incoming: Pod
    ) -> None:
        """scoring.go:111 processExistingPod."""
        for term in s.affinity_terms:
            self._process_term(s, term, existing, existing_node, 1)
        for term in s.anti_affinity_terms:
            self._process_term(s, term, existing, existing_node, -1)

        ex_aff = existing.spec.affinity
        if ex_aff is not None and ex_aff.pod_affinity is not None:
            if self.hard_pod_affinity_weight > 0:
                for t in ex_aff.pod_affinity.required_during_scheduling:
                    term = _Term(existing, t, self.hard_pod_affinity_weight)
                    self._process_term(s, term, incoming, existing_node, 1)
            for term in _preferred_terms(
                ex_aff.pod_affinity.preferred_during_scheduling, existing
            ):
                self._process_term(s, term, incoming, existing_node, 1)
        if ex_aff is not None and ex_aff.pod_anti_affinity is not None:
            for term in _preferred_terms(
                ex_aff.pod_anti_affinity.preferred_during_scheduling, existing
            ):
                self._process_term(s, term, incoming, existing_node, -1)

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        """scoring.go:267 Score."""
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
        score = 0
        for tp_key, by_val in s.topology_score.items():
            tp_val = ni.node.metadata.labels.get(tp_key)
            if tp_val is not None:
                score += by_val.get(tp_val, 0)
        return score, None

    def normalize_score(
        self, state: CycleState, pod: Pod, scores: List[NodeScore]
    ) -> Optional[Status]:
        """scoring.go:294 NormalizeScore: linear rescale of
        [min, max] -> [0, 100]; zero-initialized extremes match reference."""
        try:
            s: PreScoreState = state.read(PRE_SCORE_STATE_KEY)
        except KeyError:
            return Status.error(
                f"error reading {PRE_SCORE_STATE_KEY!r} from cycleState"
            )
        if not s.topology_score:
            return None
        max_count = 0
        min_count = 0
        for ns in scores:
            max_count = max(max_count, ns.score)
            min_count = min(min_count, ns.score)
        diff = max_count - min_count
        for ns in scores:
            if diff > 0:
                ns.score = int(MAX_NODE_SCORE * (ns.score - min_count) / diff)
            else:
                ns.score = 0
        return None
