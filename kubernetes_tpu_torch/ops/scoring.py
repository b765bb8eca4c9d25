"""Device-side score parity: the full default-provider Score plugin set
for the batch solver.

The default provider (reference algorithmprovider/registry.go:118-125)
scores with BalancedAllocation, ImageLocality, InterPodAffinity,
LeastAllocated, NodeAffinity, NodePreferAvoidPods w10000,
DefaultPodTopologySpread, TaintToleration (+ gated PodTopologySpread
soft scoring). The resource scorers already run in the scan
(ops/scores.py); this module packs the REST so batch-path rankings equal
the sequential path:

- **static rows** -- ImageLocality (image_locality.go:60
  calculatePriority), NodePreferAvoidPods (node_prefer_avoid_pods.go:53),
  preferred NodeAffinity raw weights (node_affinity.go Score), and
  TaintToleration's intolerable PreferNoSchedule count
  (taint_toleration.go Score) depend only on (pod spec, node spec), so
  pods sharing a score signature share one precomputed row. ImageLocality
  and PreferAvoidPods are final values (no normalize); NodeAffinity and
  TaintToleration ship RAW and are normalized per scan step over the
  step's feasible set, because the reference normalizes over the filtered
  node list (helper/normalize_score.go).
- **selector spread** (DefaultPodTopologySpread,
  default_pod_topology_spread.go:107) -- per combined-selector-group
  match counts per node, zone-blended (2/3) at normalize; counts replay
  within the batch like every other dynamic family.
- **soft topology spread** (podtopologyspread/scoring.go) -- per-group
  (namespace, key, selector) match counts per topology value with the
  flipped-linear normalize against (total - min) over feasible eligible
  nodes.

- **preferred inter-pod affinity** (interpodaffinity/scoring.go:110-268)
  -- weighted topology count tensors per deduplicated term: the incoming
  pod's preferred (anti-)affinity terms gather unweighted match counts
  (``ipa_counts``) scaled by the pod-side signed weights, and existing
  pods' terms (required affinity x hardPodAffinityWeight, preferred
  affinity +w, preferred anti-affinity -w) accumulate owner-weighted
  mass at the owner's topology value (``ipa_wcounts``) gathered where
  the incoming pod matches. Both tensors replay within the batch (a
  placed pod bumps counts it matches and contributes its own terms'
  mass), normalized per step [min,max] -> [0,100] over the feasible set
  with zero-seeded extremes (scoring.go:294).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.selectors import labels_match_selector
from kubernetes_tpu_torch.api.types import (
    Pod,
    TAINT_EFFECT_PREFER_NO_SCHEDULE,
)
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch.plugins.imagelocality import ImageLocality
from kubernetes_tpu_torch.plugins.nodeaffinity import match_node_selector_term
from kubernetes_tpu_torch.plugins.nodepreferavoidpods import (
    ANNOTATION_KEY as AVOID_ANNOTATION,
)
from kubernetes_tpu_torch.plugins.podtopologyspread import (
    SCHEDULE_ANYWAY,
)
from kubernetes_tpu_torch.plugins.selectorspread import (
    CombinedSelector,
    default_selector,
    get_zone_key,
)
from kubernetes_tpu_torch.tensors.node_tensor import (
    NodeTensor,
    value_capacity as _value_capacity_shared,
)

MAX_SCORE_SIGS = 16
SIG_BUCKET = 4
MAX_SEL_GROUPS = 8
MAX_ZONES = 64
MAX_SOFT_GROUPS = 16
MAX_SOFT_VALUES = 128  # floor; grows to node capacity (hostname keys)
MAX_SOFT_CONSTRAINTS = 4
MAX_IPA_ROWS = 16
MAX_IPA_VALUES = 128  # floor; tensors.node_tensor.value_capacity grows it


def _preferred_aff_terms(pod: Pod):
    a = pod.spec.affinity
    if a is None or a.pod_affinity is None:
        return []
    return a.pod_affinity.preferred_during_scheduling


def _preferred_anti_terms(pod: Pod):
    a = pod.spec.affinity
    if a is None or a.pod_anti_affinity is None:
        return []
    return a.pod_anti_affinity.preferred_during_scheduling


def _required_aff_terms(pod: Pod):
    a = pod.spec.affinity
    if a is None or a.pod_affinity is None:
        return []
    return a.pod_affinity.required_during_scheduling


def cluster_has_affinity_scoring(snapshot: Snapshot) -> bool:
    """True when any existing pod carries terms that score EVERY incoming
    pod symmetrically (scoring.go:111 processExistingPod: required
    affinity x hardPodAffinityWeight, preferred (anti-)affinity) -- such
    clusters need the preferred-affinity tensors for every batch."""
    for ni in snapshot.have_pods_with_affinity_list:
        for p in ni.pods_with_affinity:
            if (
                _required_aff_terms(p)
                or _preferred_aff_terms(p)
                or _preferred_anti_terms(p)
            ):
                return True
    return False


def batch_has_scoring_terms(pods: List[Pod]) -> bool:
    """True when placing any of these pods makes it a symmetric scorer
    for later pods (preferred terms, or required affinity terms via
    hardPodAffinityWeight) -- an in-flight batch with such pods must
    land before a later batch packs its ipa tensors."""
    return any(
        _preferred_aff_terms(p)
        or _preferred_anti_terms(p)
        or _required_aff_terms(p)
        for p in pods
    )


def batch_score_dynamic(
    pods: List[Pod], informers, ipa_weight: int = 1
) -> bool:
    """True when the batch's scoring depends on host pod-placement state
    (selector spread, soft topology spread, or preferred inter-pod
    affinity) -- the dispatch pipeline must drain in-flight batches
    BEFORE packing such batches. ``ipa_weight`` gates the
    preferred-affinity check on the profile actually scoring with
    InterPodAffinity."""
    if any(_soft_constraints(p) for p in pods):
        return True
    if ipa_weight and any(
        _preferred_aff_terms(p) or _preferred_anti_terms(p) for p in pods
    ):
        return True
    return batch_selector_spread_live(pods, informers)


def batch_selector_spread_live(pods: List[Pod], informers) -> bool:
    """The informer-dependent slice of ``batch_score_dynamic``: selector
    spread is live for the batch when workload objects exist AND a pod
    without its own spread constraints matches one. Split out so the
    dispatcher can answer the spec-derived parts from the cached
    admission bits (scheduler/admission.py) and only pay this check
    against live cluster state."""
    if informers is None:
        return False
    if not any(
        (
            informers.services().list(),
            informers.replication_controllers().list(),
            informers.replica_sets().list(),
            informers.stateful_sets().list(),
        )
    ):
        return False
    return any(
        not p.spec.topology_spread_constraints
        and not default_selector(p, informers).empty
        for p in pods
    )


class ScoreEnvelopeExceeded(Exception):
    """Batch exceeds the device scoring envelope: fall back to host."""


@dataclass
class ScoreBatch:
    """Packed score state (greedy_assign_constrained ``scoring`` operand).

    direct_rows    [U, N] float32  pre-weighted final scores (ImageLocality
                                   + NodePreferAvoidPods)
    nodeaff_rows   [U, N] int32    raw preferred-node-affinity weights
    taint_rows     [U, N] int32    raw intolerable PreferNoSchedule counts
    pod_sig        [B] int32       row index per pod
    sel_counts     [Gs, N] int32   selector-group match counts per node
    zone_onehot    [N, Z] bool     node -> zone membership
    zone_id        [N] int32       -1 = unzoned
    pod_sel_group  [B] int32       the pod's own selector group (-1 skip)
    pod_sel_match  [B, Gs] int32   placement bumps these groups
    soft_counts    [Gt, V] int32   soft-spread match counts per value
    soft_node_value[Gt, N] int32   per-group node topology value (-1 absent)
    pod_soft_groups[B, C] int32    the pod's soft constraint groups
    pod_soft_match [B, Gt] int32   placement bumps these groups
    ipa_node_value [Rp, N] int32   per-ipa-row node topology value
    ipa_counts     [Rp, V] f32     unweighted match counts per value
    ipa_wcounts    [Rp, V] f32     owner-weighted symmetric mass
    pod_ipa_weight [B, Rp] f32     incoming preferred +-weights per row
    pod_ipa_match  [B, Rp] f32     pod matches the row's selector
    pod_ipa_bump   [B, Rp] f32     pod's own signed term mass (replay)
    weights        [5] float32     (nodeaffinity, tainttoleration,
                                   selectorspread, softspread,
                                   interpodaffinity)
    """

    direct_rows: np.ndarray
    nodeaff_rows: np.ndarray
    taint_rows: np.ndarray
    pod_sig: np.ndarray
    sel_counts: np.ndarray
    zone_onehot: np.ndarray
    zone_id: np.ndarray
    pod_sel_group: np.ndarray
    pod_sel_match: np.ndarray
    soft_counts: np.ndarray
    soft_node_value: np.ndarray
    pod_soft_groups: np.ndarray
    pod_soft_match: np.ndarray
    ipa_node_value: np.ndarray  # [Rp, N] int32 per-row node topo value
    ipa_counts: np.ndarray  # [Rp, V] f32 unweighted match counts
    ipa_wcounts: np.ndarray  # [Rp, V] f32 owner-weighted symmetric mass
    pod_ipa_weight: np.ndarray  # [B, Rp] f32 incoming preferred +-w
    pod_ipa_match: np.ndarray  # [B, Rp] f32 pod matches row selector
    pod_ipa_bump: np.ndarray  # [B, Rp] f32 pod's own signed term mass
    weights: np.ndarray
    dynamic: bool = False  # True when sel/soft/ipa families are live


def _selector_sig(sel) -> Tuple:
    if sel is None:
        return ("<nil>",)
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple(
            (r.key, r.operator, tuple(r.values)) for r in sel.match_expressions
        ),
    )


def _combined_sig(cs: CombinedSelector) -> Tuple:
    return (
        tuple(sorted(cs.match_labels.items())),
        tuple(_selector_sig(s) for s in cs.extra),
    )


def _static_sig(pod: Pod) -> Tuple:
    images = tuple(sorted(c.image for c in pod.spec.containers if c.image))
    aff = ()
    a = pod.spec.affinity
    if a is not None and a.node_affinity is not None:
        aff = tuple(
            (
                t.weight,
                tuple(
                    (r.key, r.operator, tuple(r.values))
                    for r in t.preference.match_expressions
                ),
                tuple(
                    (r.key, r.operator, tuple(r.values))
                    for r in t.preference.match_fields
                ),
            )
            for t in a.node_affinity.preferred_during_scheduling
        )
    tols = tuple(
        (t.key, t.operator, t.value, t.effect) for t in pod.spec.tolerations
    )
    controller = next(
        (r for r in pod.metadata.owner_references if r.controller), None
    )
    ctrl = (controller.kind, controller.uid) if controller else None
    return (images, aff, tols, ctrl)


def _soft_constraints(pod: Pod):
    return [
        c
        for c in pod.spec.topology_spread_constraints
        if c.when_unsatisfiable == SCHEDULE_ANYWAY
    ]


def pack_score_batch(
    pods: List[Pod],
    snapshot: Snapshot,
    nt: NodeTensor,
    informers,
    weights: Dict[str, int],
    hard_pod_affinity_weight: int = 1,
    cluster_affinity_scoring: Optional[bool] = None,
) -> Optional[ScoreBatch]:
    """Returns None when no non-resource scorer can influence ranking for
    this batch (the common fast path); raises ScoreEnvelopeExceeded when
    the batch needs the host path."""
    infos = snapshot.list_node_infos()
    node_rows = nt.rows_for(infos).tolist()
    n_cap = nt.capacity
    b = len(pods)

    any_images = any(ni.image_states for ni in infos)
    any_soft_taints = any(
        t.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
        for ni in infos
        if ni.node is not None
        for t in ni.node.spec.taints
    )
    any_avoid = any(
        ni.node is not None
        and AVOID_ANNOTATION in ni.node.metadata.annotations
        for ni in infos
    )
    need_images = any_images and any(
        c.image for p in pods for c in p.spec.containers
    )
    need_nodeaff = any(
        p.spec.affinity is not None
        and p.spec.affinity.node_affinity is not None
        and p.spec.affinity.node_affinity.preferred_during_scheduling
        for p in pods
    )
    need_avoid = any_avoid
    need_taint = any_soft_taints
    need_soft = any(_soft_constraints(p) for p in pods)

    # combined selectors only exist when owner objects do
    selectors: List[Optional[CombinedSelector]] = [None] * b
    need_sel = False
    if informers is not None and any(
        inf_list
        for inf_list in (
            informers.services().list(),
            informers.replication_controllers().list(),
            informers.replica_sets().list(),
            informers.stateful_sets().list(),
        )
    ):
        for i, p in enumerate(pods):
            if p.spec.topology_spread_constraints:
                continue  # DefaultPodTopologySpread skips such pods
            cs = default_selector(p, informers)
            if not cs.empty:
                selectors[i] = cs
                need_sel = True

    # preferred inter-pod affinity is live when any incoming pod carries
    # preferred terms OR any existing pod scores incoming pods
    # symmetrically (scoring.go:111; the caller may pass the cluster
    # answer it already computed for its drain decision)
    if cluster_affinity_scoring is None:
        cluster_affinity_scoring = cluster_has_affinity_scoring(snapshot)
    need_ipa = bool(weights.get("InterPodAffinity", 0)) and (
        any(
            _preferred_aff_terms(p) or _preferred_anti_terms(p)
            for p in pods
        )
        or cluster_affinity_scoring
    )

    if not (
        need_images or need_nodeaff or need_avoid or need_taint
        or need_soft or need_sel or need_ipa
    ):
        return None

    # ---- static rows ------------------------------------------------------
    sig_ids: Dict[Tuple, int] = {}
    pod_sig = np.zeros(b, dtype=np.int32)
    sig_pods: List[Pod] = []
    for i, p in enumerate(pods):
        sig = _static_sig(p)
        u = sig_ids.get(sig)
        if u is None:
            if len(sig_pods) >= MAX_SCORE_SIGS:
                raise ScoreEnvelopeExceeded("too many score signatures")
            u = len(sig_pods)
            sig_ids[sig] = u
            sig_pods.append(p)
        pod_sig[i] = u

    u_count = len(sig_pods)
    direct_rows = np.zeros((u_count, n_cap), dtype=np.float32)
    nodeaff_rows = np.zeros((u_count, n_cap), dtype=np.int32)
    taint_rows = np.zeros((u_count, n_cap), dtype=np.int32)

    w_img = float(weights.get("ImageLocality", 0))
    w_avoid = float(weights.get("NodePreferAvoidPods", 0))
    total_nodes = snapshot.num_nodes()
    image_counts = snapshot.image_num_nodes() if need_images else {}

    for u, p in enumerate(sig_pods):
        na = (
            p.spec.affinity.node_affinity.preferred_during_scheduling
            if (
                p.spec.affinity is not None
                and p.spec.affinity.node_affinity is not None
            )
            else []
        )
        for j, ni in zip(node_rows, infos):
            node = ni.node
            if node is None:
                continue
            if need_images:
                score_sum = 0.0
                for c in p.spec.containers:
                    size = ni.image_states.get(c.image)
                    if size is None:
                        continue
                    spread = (
                        image_counts.get(c.image, 0) / total_nodes
                        if total_nodes
                        else 0.0
                    )
                    score_sum += size * spread
                direct_rows[u, j] += w_img * ImageLocality._calculate_priority(
                    score_sum
                )
            if need_avoid:
                direct_rows[u, j] += w_avoid * _avoid_score(p, node)
            if need_nodeaff:
                count = 0
                for term in na:
                    if term.weight and match_node_selector_term(
                        node.metadata.labels,
                        term.preference,
                        {"metadata.name": node.metadata.name},
                    ):
                        count += term.weight
                nodeaff_rows[u, j] = count
            if need_taint:
                taint_rows[u, j] = sum(
                    1
                    for t in node.spec.taints
                    if t.effect == TAINT_EFFECT_PREFER_NO_SCHEDULE
                    and not any(tol.tolerates(t) for tol in p.spec.tolerations)
                )

    u_padded = SIG_BUCKET * max(1, -(-u_count // SIG_BUCKET))
    direct_rows = np.concatenate(
        [direct_rows, np.zeros((u_padded - u_count, n_cap), np.float32)]
    )
    nodeaff_rows = np.concatenate(
        [nodeaff_rows, np.zeros((u_padded - u_count, n_cap), np.int32)]
    )
    taint_rows = np.concatenate(
        [taint_rows, np.zeros((u_padded - u_count, n_cap), np.int32)]
    )

    # ---- zones ------------------------------------------------------------
    zone_ids: Dict[str, int] = {}
    zone_id = np.full(n_cap, -1, dtype=np.int32)
    for j, ni in zip(node_rows, infos):
        zk = get_zone_key(ni.node)
        if not zk:
            continue
        z = zone_ids.get(zk)
        if z is None:
            if len(zone_ids) >= MAX_ZONES:
                raise ScoreEnvelopeExceeded("too many zones")
            z = len(zone_ids)
            zone_ids[zk] = z
        zone_id[j] = z
    zone_onehot = np.zeros((n_cap, MAX_ZONES), dtype=bool)
    present = zone_id >= 0
    zone_onehot[np.nonzero(present)[0], zone_id[present]] = True

    # ---- selector spread groups ------------------------------------------
    sel_counts = np.zeros((MAX_SEL_GROUPS, n_cap), dtype=np.int32)
    pod_sel_group = np.full(b, -1, dtype=np.int32)
    pod_sel_match = np.zeros((b, MAX_SEL_GROUPS), dtype=np.int32)
    sel_groups: Dict[Tuple, int] = {}
    group_selectors: List[Tuple[str, CombinedSelector]] = []
    if need_sel:
        for i, cs in enumerate(selectors):
            if cs is None:
                continue
            key = (pods[i].metadata.namespace, _combined_sig(cs))
            g = sel_groups.get(key)
            if g is None:
                if len(group_selectors) >= MAX_SEL_GROUPS:
                    raise ScoreEnvelopeExceeded("too many selector groups")
                g = len(group_selectors)
                sel_groups[key] = g
                group_selectors.append((pods[i].metadata.namespace, cs))
            pod_sel_group[i] = g
        for g, (ns, cs) in enumerate(group_selectors):
            for j, ni in zip(node_rows, infos):
                count = 0
                for p in ni.pods:
                    if (
                        p.metadata.namespace == ns
                        and p.metadata.deletion_timestamp is None
                        and cs.matches(p.metadata.labels)
                    ):
                        count += 1
                sel_counts[g, j] = count
            for i, p in enumerate(pods):
                if p.metadata.namespace == ns and cs.matches(
                    p.metadata.labels
                ):
                    pod_sel_match[i, g] = 1

    # ---- soft topology spread groups -------------------------------------
    v_soft = _value_capacity_shared(n_cap, MAX_SOFT_VALUES)
    soft_counts = np.zeros((MAX_SOFT_GROUPS, v_soft), dtype=np.int32)
    soft_node_value = np.full((MAX_SOFT_GROUPS, n_cap), -1, dtype=np.int32)
    pod_soft_groups = np.full((b, MAX_SOFT_CONSTRAINTS), -1, dtype=np.int32)
    pod_soft_match = np.zeros((b, MAX_SOFT_GROUPS), dtype=np.int32)
    if need_soft:
        soft_specs: List[Tuple[str, str, object]] = []
        soft_group_ids: Dict[Tuple, int] = {}
        for i, p in enumerate(pods):
            soft = _soft_constraints(p)
            if len(soft) > MAX_SOFT_CONSTRAINTS:
                raise ScoreEnvelopeExceeded("too many soft constraints")
            # per-pod node eligibility scoping (the pod's own
            # nodeSelector/affinity, scoring.go:120) can't share group
            # counts -- the caller routes such pods to the host path
            for ci, c in enumerate(soft):
                sig = (
                    p.metadata.namespace,
                    c.topology_key,
                    _selector_sig(c.label_selector),
                )
                g = soft_group_ids.get(sig)
                if g is None:
                    if len(soft_specs) >= MAX_SOFT_GROUPS:
                        raise ScoreEnvelopeExceeded("too many soft groups")
                    g = len(soft_specs)
                    soft_group_ids[sig] = g
                    soft_specs.append(
                        (p.metadata.namespace, c.topology_key, c.label_selector)
                    )
                pod_soft_groups[i, ci] = g
        for g, (ns, key, sel) in enumerate(soft_specs):
            value_ids: Dict[str, int] = {}
            for j, ni in zip(node_rows, infos):
                node = ni.node
                if node is None:
                    continue
                val = node.metadata.labels.get(key)
                if val is None:
                    continue
                vid = value_ids.get(val)
                if vid is None:
                    if len(value_ids) >= v_soft:
                        raise ScoreEnvelopeExceeded("too many soft values")
                    vid = len(value_ids)
                    value_ids[val] = vid
                soft_node_value[g, j] = vid
                count = 0
                for p in ni.pods:
                    if (
                        p.metadata.deletion_timestamp is None
                        and p.metadata.namespace == ns
                        and labels_match_selector(p.metadata.labels, sel)
                    ):
                        count += 1
                soft_counts[g, vid] += count
            for i, p in enumerate(pods):
                if p.metadata.namespace == ns and labels_match_selector(
                    p.metadata.labels, sel
                ):
                    pod_soft_match[i, g] = 1

    # ---- preferred inter-pod affinity (scoring.go:110-268) ----------------
    v_ipa = _value_capacity_shared(n_cap, MAX_IPA_VALUES)
    ipa_node_value = np.full((MAX_IPA_ROWS, n_cap), -1, dtype=np.int32)
    ipa_counts = np.zeros((MAX_IPA_ROWS, v_ipa), dtype=np.float32)
    ipa_wcounts = np.zeros((MAX_IPA_ROWS, v_ipa), dtype=np.float32)
    pod_ipa_weight = np.zeros((b, MAX_IPA_ROWS), dtype=np.float32)
    pod_ipa_match = np.zeros((b, MAX_IPA_ROWS), dtype=np.float32)
    pod_ipa_bump = np.zeros((b, MAX_IPA_ROWS), dtype=np.float32)
    if need_ipa:
        from kubernetes_tpu_torch.ops.affinity import (
            _Matcher,
            _selector_sig as _aff_sel_sig,
            _term_namespaces,
        )

        matcher = _Matcher()
        ipa_rows: List[Tuple] = []  # (namespaces, selector, sel_sig, key)
        ipa_row_ids: Dict[Tuple, int] = {}
        row_value_ids: List[Dict[str, int]] = []

        def ipa_row(owner: Pod, term) -> int:
            sig = (
                _term_namespaces(owner, term),
                _aff_sel_sig(term.label_selector),
                term.topology_key,
            )
            r = ipa_row_ids.get(sig)
            if r is None:
                if len(ipa_rows) >= MAX_IPA_ROWS:
                    raise ScoreEnvelopeExceeded(
                        "too many preferred-affinity rows"
                    )
                r = len(ipa_rows)
                ipa_row_ids[sig] = r
                ipa_rows.append(
                    (
                        _term_namespaces(owner, term),
                        term.label_selector,
                        _aff_sel_sig(term.label_selector),
                        term.topology_key,
                    )
                )
                ids: Dict[str, int] = {}
                row_value_ids.append(ids)
                for j, ni in zip(node_rows, infos):
                    node = ni.node
                    if node is None:
                        continue
                    val = node.metadata.labels.get(term.topology_key)
                    if val is None:
                        continue
                    vid = ids.get(val)
                    if vid is None:
                        if len(ids) >= v_ipa:
                            raise ScoreEnvelopeExceeded(
                                "too many preferred-affinity values"
                            )
                        vid = len(ids)
                        ids[val] = vid
                    ipa_node_value[r, j] = vid
            return r

        def signed_terms(pod: Pod):
            """(term, signed_weight) for everything this pod contributes
            as an EXISTING pod (processExistingPod :111): required
            affinity x hard weight, preferred affinity +w, preferred
            anti-affinity -w."""
            out = []
            if hard_pod_affinity_weight > 0:
                for t in _required_aff_terms(pod):
                    out.append((t, float(hard_pod_affinity_weight)))
            for wt in _preferred_aff_terms(pod):
                out.append((wt.pod_affinity_term, float(wt.weight)))
            for wt in _preferred_anti_terms(pod):
                out.append((wt.pod_affinity_term, -float(wt.weight)))
            return out

        # incoming pods' preferred terms (family a: count-gather rows)
        for i, p in enumerate(pods):
            for wt in _preferred_aff_terms(p):
                r = ipa_row(p, wt.pod_affinity_term)
                pod_ipa_weight[i, r] += float(wt.weight)
            for wt in _preferred_anti_terms(p):
                r = ipa_row(p, wt.pod_affinity_term)
                pod_ipa_weight[i, r] -= float(wt.weight)
            # the pod's own symmetric contributions once placed
            for t, wgt in signed_terms(p):
                r = ipa_row(p, t)
                pod_ipa_bump[i, r] += wgt

        node_of_pod = {}
        for j, ni in zip(node_rows, infos):
            for e in ni.pods:
                node_of_pod[id(e)] = j

        # existing pods' symmetric terms (family c: weighted mass at the
        # owner's topology value)
        for ni in snapshot.have_pods_with_affinity_list:
            if ni.node is None:
                continue
            for e in ni.pods_with_affinity:
                j = node_of_pod.get(id(e))
                if j is None:
                    continue
                for t, wgt in signed_terms(e):
                    r = ipa_row(e, t)
                    v = ipa_node_value[r, j]
                    if v >= 0:
                        ipa_wcounts[r, v] += wgt

        # family-a counts: matching EXISTING pods per row per value, and
        # the per-pod match matrix (count replay + family-c gather)
        for j, ni in zip(node_rows, infos):
            if ni.node is None:
                continue
            for e in ni.pods:
                for r, (nss, sel, sel_sig, _key) in enumerate(ipa_rows):
                    if matcher.matches(e, nss, sel, sel_sig):
                        v = ipa_node_value[r, j]
                        if v >= 0:
                            ipa_counts[r, v] += 1.0
        for i, p in enumerate(pods):
            for r, (nss, sel, sel_sig, _key) in enumerate(ipa_rows):
                if matcher.matches(p, nss, sel, sel_sig):
                    pod_ipa_match[i, r] = 1.0

    w = np.array(
        [
            float(weights.get("NodeAffinity", 0)),
            float(weights.get("TaintToleration", 0)),
            float(weights.get("DefaultPodTopologySpread", 0)),
            float(weights.get("PodTopologySpread", 0)),
            float(weights.get("InterPodAffinity", 0)),
        ],
        dtype=np.float32,
    )
    return ScoreBatch(
        direct_rows=direct_rows,
        nodeaff_rows=nodeaff_rows,
        taint_rows=taint_rows,
        pod_sig=pod_sig,
        sel_counts=sel_counts,
        zone_onehot=zone_onehot,
        zone_id=zone_id,
        pod_sel_group=pod_sel_group,
        pod_sel_match=pod_sel_match,
        soft_counts=soft_counts,
        soft_node_value=soft_node_value,
        pod_soft_groups=pod_soft_groups,
        pod_soft_match=pod_soft_match,
        ipa_node_value=ipa_node_value,
        ipa_counts=ipa_counts,
        ipa_wcounts=ipa_wcounts,
        pod_ipa_weight=pod_ipa_weight,
        pod_ipa_match=pod_ipa_match,
        pod_ipa_bump=pod_ipa_bump,
        weights=w,
        dynamic=need_sel or need_soft or need_ipa,
    )


def _avoid_score(pod: Pod, node) -> float:
    """node_prefer_avoid_pods.go:53 semantics on raw objects."""
    raw = node.metadata.annotations.get(AVOID_ANNOTATION)
    if not raw:
        return 100.0
    import json as _json

    controller = next(
        (r for r in pod.metadata.owner_references if r.controller), None
    )
    if controller is None or controller.kind not in (
        "ReplicationController",
        "ReplicaSet",
    ):
        return 100.0
    try:
        avoids = _json.loads(raw).get("preferAvoidPods", [])
    except (ValueError, AttributeError):
        return 100.0
    for entry in avoids:
        ref = entry.get("podSignature", {}).get("podController", {})
        # exact UID equality: the reference compares the full controller
        # ref including UID (node_prefer_avoid_pods.go), so a malformed
        # annotation without a uid never matches
        if (
            ref.get("kind") == controller.kind
            and ref.get("uid") == controller.uid
        ):
            return 0.0
    return 100.0


def noop_score_tensors(padded: int, n_cap: int) -> Tuple[np.ndarray, ...]:
    """All-inactive scoring tensors, in kernel argument order."""
    return (
        np.zeros((SIG_BUCKET, n_cap), dtype=np.float32),
        np.zeros((SIG_BUCKET, n_cap), dtype=np.int32),
        np.zeros((SIG_BUCKET, n_cap), dtype=np.int32),
        np.zeros(padded, dtype=np.int32),
        np.zeros((MAX_SEL_GROUPS, n_cap), dtype=np.int32),
        np.zeros((n_cap, MAX_ZONES), dtype=bool),
        np.full(n_cap, -1, dtype=np.int32),
        np.full(padded, -1, dtype=np.int32),
        np.zeros((padded, MAX_SEL_GROUPS), dtype=np.int32),
        np.zeros(
            (MAX_SOFT_GROUPS, _value_capacity_shared(n_cap, MAX_SOFT_VALUES)),
            dtype=np.int32,
        ),
        np.full((MAX_SOFT_GROUPS, n_cap), -1, dtype=np.int32),
        np.full((padded, MAX_SOFT_CONSTRAINTS), -1, dtype=np.int32),
        np.zeros((padded, MAX_SOFT_GROUPS), dtype=np.int32),
        np.full((MAX_IPA_ROWS, n_cap), -1, dtype=np.int32),
        np.zeros(
            (MAX_IPA_ROWS, _value_capacity_shared(n_cap, MAX_IPA_VALUES)),
            dtype=np.float32,
        ),
        np.zeros(
            (MAX_IPA_ROWS, _value_capacity_shared(n_cap, MAX_IPA_VALUES)),
            dtype=np.float32,
        ),
        np.zeros((padded, MAX_IPA_ROWS), dtype=np.float32),
        np.zeros((padded, MAX_IPA_ROWS), dtype=np.float32),
        np.zeros((padded, MAX_IPA_ROWS), dtype=np.float32),
        np.zeros(5, dtype=np.float32),
    )


def pad_score_tensors(sb: ScoreBatch, padded: int) -> Tuple[np.ndarray, ...]:
    """Pad per-pod arrays (already in solve order) to the fixed batch
    axis, kernel argument order."""
    b = sb.pod_sig.shape[0]

    def pad_pods(a: np.ndarray, fill) -> np.ndarray:
        out = np.full((padded,) + a.shape[1:], fill, dtype=a.dtype)
        out[:b] = a
        return out

    return (
        sb.direct_rows,
        sb.nodeaff_rows,
        sb.taint_rows,
        pad_pods(sb.pod_sig, 0),
        sb.sel_counts,
        sb.zone_onehot,
        sb.zone_id,
        pad_pods(sb.pod_sel_group, -1),
        pad_pods(sb.pod_sel_match, 0),
        sb.soft_counts,
        sb.soft_node_value,
        pad_pods(sb.pod_soft_groups, -1),
        pad_pods(sb.pod_soft_match, 0),
        sb.ipa_node_value,
        sb.ipa_counts,
        sb.ipa_wcounts,
        pad_pods(sb.pod_ipa_weight, 0.0),
        pad_pods(sb.pod_ipa_match, 0.0),
        pad_pods(sb.pod_ipa_bump, 0.0),
        sb.weights,
    )
