"""Device-side topology-spread: pair-count tensors + within-batch updates.

This vectorizes PodTopologySpread's DoNotSchedule filtering (reference
podtopologyspread/filtering.go: TpPairToMatchNum + criticalPaths min) for
the batch solver:

- Host side, constraints are deduplicated into GROUPS keyed by
  (namespace, topology_key, selector): one row of a ``[G, V]`` count
  tensor per group, where V indexes interned topology values for that
  group's key. Initial counts replicate calPreFilterState (existing
  matching pods per topology value over eligible nodes).
- Device side, the assignment scan carries the count tensor: placing a
  selector-matching pod scatter-adds into its group rows, which is the
  AddPod/updateWithPod increment (filtering.go:127) generalized to the
  whole batch -- pod i's placement changes pod j's skew the same way
  nominated-pod virtual adds do sequentially (SURVEY.md section 7 stage 5).
- The Filter check per candidate node: for every group g of the pod,
  ``count[g, value_of(node)] + self_match - min_value(count[g, :]) <=
  max_skew`` and the node must carry the topology key, mirroring
  filtering.go:322-330.

The min over values runs over pairs that exist among eligible nodes
(``value_valid``), matching the reference's min over pairs recorded at
PreFilter time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.selectors import labels_match_selector
from kubernetes_tpu_torch.api.types import LabelSelector, Pod
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch.plugins.podtopologyspread import DO_NOT_SCHEDULE
from kubernetes_tpu_torch.tensors.node_tensor import NodeTensor, value_capacity

MAX_GROUPS = 16  # batches needing more fall back to the host path
MAX_VALUES = 128  # floor; tensors.node_tensor.value_capacity grows it
MAX_CONSTRAINTS_PER_POD = 4
BIG = np.int32(1 << 20)  # "absent value" sentinel for the min-reduce


def _selector_sig(sel: Optional[LabelSelector]) -> Tuple:
    if sel is None:
        return ("<nil>",)
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple(
            (r.key, r.operator, tuple(r.values)) for r in sel.match_expressions
        ),
    )


@dataclass
class SpreadBatch:
    """Packed spread state for one solver batch.

    group_counts  [G, V] int32   initial match counts per (group, value)
    value_valid   [G, V] bool    value exists among eligible nodes
    node_value    [G, N] int32   per-group interned value index of each
                                 node (-1 when the node lacks the key or
                                 fails the pod-independent eligibility)
    pod_groups    [B, C] int32   group index per pod constraint (-1 pad)
    pod_max_skew  [B, C] int32
    pod_self      [B, C] int32   1 if the pod matches the group selector
    pod_match     [B, G] int32   1 if placing the pod bumps the group's
                                 count (same namespace + selector match)
                                 -- the AddPod increment for EVERY group,
                                 not just the pod's own constraints
    """

    group_counts: np.ndarray
    value_valid: np.ndarray
    node_value: np.ndarray
    pod_groups: np.ndarray
    pod_max_skew: np.ndarray
    pod_self: np.ndarray
    pod_match: np.ndarray

    @property
    def num_groups(self) -> int:
        return self.group_counts.shape[0]


def _eligibility_sig(pod: Pod) -> Tuple:
    """Signature of the pod's node-affinity/selector scoping: spread
    pair counting runs only over nodes the pod itself could land on
    (filtering.go:245 PodMatchesNodeSelectorAndAffinityTerms), so pods
    with different scoping cannot share a group."""
    spec = pod.spec
    sel = tuple(sorted(spec.node_selector.items()))
    aff: Tuple = ()
    if spec.affinity is not None and spec.affinity.node_affinity is not None:
        na = spec.affinity.node_affinity
        if na.required_during_scheduling is not None:
            aff = tuple(
                (
                    tuple(
                        (r.key, r.operator, tuple(r.values))
                        for r in term.match_expressions
                    ),
                    tuple(
                        (r.key, r.operator, tuple(r.values))
                        for r in term.match_fields
                    ),
                )
                for term in na.required_during_scheduling.node_selector_terms
            )
    return (sel, aff)


def pack_spread_batch(
    pods: List[Pod], snapshot: Snapshot, nt: NodeTensor
) -> Optional[SpreadBatch]:
    """Returns None when the batch exceeds the device envelope (too many
    groups/values/constraints) -- caller falls back to the host path."""
    b = len(pods)
    groups: Dict[Tuple, int] = {}
    # ns, key, sel, representative pod (its node-affinity scopes the group)
    specs: List[Tuple[str, str, Optional[LabelSelector], Pod]] = []

    pod_groups = np.full((b, MAX_CONSTRAINTS_PER_POD), -1, dtype=np.int32)
    pod_max_skew = np.zeros((b, MAX_CONSTRAINTS_PER_POD), dtype=np.int32)
    pod_self = np.zeros((b, MAX_CONSTRAINTS_PER_POD), dtype=np.int32)

    infos = snapshot.list_node_infos()
    node_rows = nt.rows_for(infos).tolist()
    # Per-key "some node lacks it" cache: reference pair counting
    # (common.go nodeLabelsMatchSpreadConstraints) excludes a node from
    # ALL of a pod's constraints when it lacks ANY constraint key. Shared
    # group counts can't express that per-pod eligibility, so a pod whose
    # constraints span 2+ keys with incomplete node coverage falls back
    # to the host path (ADVICE round-1, medium).
    _key_incomplete: Dict[str, bool] = {}

    def key_incomplete(key: str) -> bool:
        v = _key_incomplete.get(key)
        if v is None:
            v = any(
                ni.node is not None and key not in ni.node.metadata.labels
                for ni in infos
            )
            _key_incomplete[key] = v
        return v

    for i, pod in enumerate(pods):
        hard = [
            c
            for c in pod.spec.topology_spread_constraints
            if c.when_unsatisfiable == DO_NOT_SCHEDULE
        ]
        if len(hard) > MAX_CONSTRAINTS_PER_POD:
            return None
        keys = {c.topology_key for c in hard}
        if len(keys) > 1 and any(key_incomplete(k) for k in keys):
            return None
        for ci, c in enumerate(hard):
            # pair counting is scoped to nodes passing the pod's own
            # nodeSelector/affinity (filtering.go:245): the scoping is
            # part of the group identity, and the group's node_value
            # row is -1 on out-of-scope nodes (no counts, no bumps,
            # infeasible there -- matching the static mask)
            sig = (
                pod.metadata.namespace,
                c.topology_key,
                _selector_sig(c.label_selector),
                _eligibility_sig(pod),
            )
            g = groups.get(sig)
            if g is None:
                if len(groups) >= MAX_GROUPS:
                    return None
                g = len(groups)
                groups[sig] = g
                specs.append(
                    (
                        pod.metadata.namespace, c.topology_key,
                        c.label_selector, pod,
                    )
                )
            pod_groups[i, ci] = g
            pod_max_skew[i, ci] = c.max_skew
            pod_self[i, ci] = int(
                labels_match_selector(pod.metadata.labels, c.label_selector)
            )

    num_groups = len(groups)
    if num_groups == 0:
        return None

    pod_match = np.zeros((b, MAX_GROUPS), dtype=np.int32)
    for i, pod in enumerate(pods):
        for g, (ns, _key, sel, _rep) in enumerate(specs):
            if pod.metadata.namespace == ns and labels_match_selector(
                pod.metadata.labels, sel
            ):
                pod_match[i, g] = 1

    n_cap = nt.capacity
    v_cap = value_capacity(n_cap)
    group_counts = np.zeros((MAX_GROUPS, v_cap), dtype=np.int32)
    value_valid = np.zeros((MAX_GROUPS, v_cap), dtype=bool)
    node_value = np.full((MAX_GROUPS, n_cap), -1, dtype=np.int32)

    from kubernetes_tpu_torch.plugins.nodeaffinity import (
        pod_matches_node_selector_and_affinity,
    )

    for g, (ns, key, sel, rep) in enumerate(specs):
        scoped = bool(_eligibility_sig(rep) != ((), ()))
        value_ids: Dict[str, int] = {}
        for j, ni in zip(node_rows, infos):
            node = ni.node
            if node is None:
                continue
            if scoped and not pod_matches_node_selector_and_affinity(
                rep, ni
            ):
                continue  # out of the owner pod's scope: -1 everywhere
            val = node.metadata.labels.get(key)
            if val is None:
                continue  # node lacks the key: hard-excluded for this group
            vid = value_ids.get(val)
            if vid is None:
                if len(value_ids) >= v_cap:
                    return None
                vid = len(value_ids)
                value_ids[val] = vid
            node_value[g, j] = vid
            value_valid[g, vid] = True
            # initial counts: existing same-namespace matching pods
            # (filtering.go:255; terminating pods skipped)
            count = 0
            for p in ni.pods:
                if (
                    p.metadata.deletion_timestamp is None
                    and p.metadata.namespace == ns
                    and labels_match_selector(p.metadata.labels, sel)
                ):
                    count += 1
            group_counts[g, vid] += count

    return SpreadBatch(
        group_counts=group_counts,
        value_valid=value_valid,
        node_value=node_value,
        pod_groups=pod_groups,
        pod_max_skew=pod_max_skew,
        pod_self=pod_self,
        pod_match=pod_match,
    )




def noop_spread_tensors(padded: int, n_cap: int):
    """All-inactive spread tensors (kernel no-op), in
    greedy_assign_constrained argument order."""
    return (
        np.zeros((MAX_GROUPS, value_capacity(n_cap)), dtype=np.int32),
        np.zeros((MAX_GROUPS, value_capacity(n_cap)), dtype=bool),
        np.full((MAX_GROUPS, n_cap), -1, dtype=np.int32),
        np.full((padded, MAX_CONSTRAINTS_PER_POD), -1, dtype=np.int32),
        np.zeros((padded, MAX_CONSTRAINTS_PER_POD), dtype=np.int32),
        np.zeros((padded, MAX_CONSTRAINTS_PER_POD), dtype=np.int32),
        np.zeros((padded, MAX_GROUPS), dtype=np.int32),
    )


def pad_spread_tensors(sp: SpreadBatch, padded: int):
    """Pad the per-pod arrays (already in solve order) to the fixed batch
    axis."""
    b = sp.pod_groups.shape[0]

    def pad_pods(a, fill):
        out = np.full((padded,) + a.shape[1:], fill, dtype=a.dtype)
        out[:b] = a
        return out

    return (
        sp.group_counts,
        sp.value_valid,
        sp.node_value,
        pad_pods(sp.pod_groups, -1),
        pad_pods(sp.pod_max_skew, 0),
        pad_pods(sp.pod_self, 0),
        pad_pods(sp.pod_match, 0),
    )
