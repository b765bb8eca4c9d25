"""Device-side InterPodAffinity: topology-pair count tensors + within-batch
replay.

This vectorizes the reference's required pod (anti-)affinity filtering
(/root/reference/pkg/scheduler/framework/plugins/interpodaffinity/
filtering.go) for the batch solver. The O(pods x nodes) PreFilter
(filtering.go:212 getTPMapMatchingExistingAntiAffinity, :256
getTPMapMatchingIncomingAffinityAntiAffinity) becomes one host pack into
dense ``[rows, values]`` count tensors; the three Filter checks
(:404 satisfiesExistingPodsAntiAffinity, :420 nodeMatchesAllTopologyTerms,
:437 nodeMatchesAnyTopologyTerm) become gathers against those tensors
inside the assignment scan; and the within-batch interaction (pod i's
placement changes pod j's counts -- addNominatedPods/updateWithPod
semantics, filtering.go:75) is a scatter-add in the scan carry, exactly
like the topology-spread replay (ops/topology.py).

Row families (all with per-topology-key interned values):

- **affinity rows** -- the incoming required-affinity TERM-SETS, deduped
  by (owner namespace, full term-set signature). The reference bumps every
  term's pair only when a target pod matches ALL terms of the set
  (filtering.go:135 updateWithAffinityTerms), so counts are per
  (term-set, term): row r of group g counts targets matching ALL of g's
  terms, bucketed by r's topology key value.
- **anti rows** -- the incoming required-anti-affinity terms, deduped per
  term; bumped on ANY match (filtering.go:153).
- **exist rows** -- required anti-affinity terms OF existing pods (and of
  batch pods, so a batch placement imposes symmetric constraints on later
  batch pods), deduped per term. A node value with a positive count
  blocks any incoming pod matching the term.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.selectors import labels_match_selector
from kubernetes_tpu_torch.api.types import LabelSelector, Pod, PodAffinityTerm
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch.tensors.node_tensor import NodeTensor

MAX_KEYS = 8  # distinct topology keys per batch
MAX_AFF_ROWS = 16
MAX_ANTI_ROWS = 16
MAX_EXIST_ROWS = 64
MAX_TERMS_PER_POD = 4
from kubernetes_tpu_torch.tensors.node_tensor import value_capacity

MAX_VALUES = 128  # interned-value floor (tensors.value_capacity grows it)


def _selector_sig(sel: Optional[LabelSelector]) -> Tuple:
    if sel is None:
        return ("<nil>",)
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple(
            (r.key, r.operator, tuple(r.values)) for r in sel.match_expressions
        ),
    )


def _term_namespaces(owner: Pod, term: PodAffinityTerm) -> Tuple[str, ...]:
    """topologies.go:28: empty term namespaces default to the owner's."""
    if term.namespaces:
        return tuple(sorted(term.namespaces))
    return (owner.metadata.namespace,)


def _term_sig(owner: Pod, term: PodAffinityTerm) -> Tuple:
    return (
        _term_namespaces(owner, term),
        _selector_sig(term.label_selector),
        term.topology_key,
    )


def _required_affinity(pod: Pod) -> List[PodAffinityTerm]:
    a = pod.spec.affinity
    if a is None or a.pod_affinity is None:
        return []
    return a.pod_affinity.required_during_scheduling


def _required_anti_affinity(pod: Pod) -> List[PodAffinityTerm]:
    a = pod.spec.affinity
    if a is None or a.pod_anti_affinity is None:
        return []
    return a.pod_anti_affinity.required_during_scheduling


class _Matcher:
    """Memoized PodMatchesTermsNamespaceAndSelector (topologies.go:40):
    match results cached per (term signature, pod labels signature)."""

    def __init__(self) -> None:
        self._label_sigs: Dict[int, Tuple] = {}
        self._cache: Dict[Tuple, bool] = {}

    def _labels_sig(self, pod: Pod) -> Tuple:
        sig = self._label_sigs.get(id(pod))
        if sig is None:
            sig = (
                pod.metadata.namespace,
                tuple(sorted(pod.metadata.labels.items())),
            )
            self._label_sigs[id(pod)] = sig
        return sig

    def matches(
        self,
        target: Pod,
        namespaces: Tuple[str, ...],
        selector: Optional[LabelSelector],
        sel_sig: Tuple,
    ) -> bool:
        key = (self._labels_sig(target), namespaces, sel_sig)
        hit = self._cache.get(key)
        if hit is None:
            hit = target.metadata.namespace in namespaces and (
                labels_match_selector(target.metadata.labels, selector)
            )
            self._cache[key] = hit
        return hit


@dataclass
class _Row:
    namespaces: Tuple[str, ...]
    selector: Optional[LabelSelector]
    sel_sig: Tuple
    key_idx: int


@dataclass
class AffinityBatch:
    """Packed (anti-)affinity state for one solver batch.

    node_value      [K, N] int32  per-key interned value of each node (-1
                                  when the node lacks the key)
    counts_aff      [Ra, V] int32 targets matching ALL terms of the row's
                                  group, per value of the row's key
    row_key_aff     [Ra] int32    key index per affinity row (-1 pad)
    pod_aff_rows    [B, C] int32  rows of the pod's own term-set (-1 pad)
    pod_self_match  [B] bool      pod matches ALL its own affinity terms
                                  (the first-pod escape, filtering.go:494)
    pod_bump_aff    [B, Ra] int32 placing this pod bumps the row (pod
                                  matches ALL terms of the row's group)
    counts_anti     [Rt, V] / row_key_anti [Rt] / pod_anti_rows [B, C] /
    pod_bump_anti   [B, Rt]       same structure, per-term ANY-match
    counts_exist    [Re, V] / row_key_exist [Re]
    pod_exist_match [B, Re] bool  incoming pod matches the row's term ->
                                  blocked where count > 0
    pod_bump_exist  [B, Re] int32 the row is one of THIS pod's own anti
                                  terms -> placement bumps it
    """

    node_value: np.ndarray
    counts_aff: np.ndarray
    row_key_aff: np.ndarray
    pod_aff_rows: np.ndarray
    pod_self_match: np.ndarray
    pod_bump_aff: np.ndarray
    counts_anti: np.ndarray
    row_key_anti: np.ndarray
    pod_anti_rows: np.ndarray
    pod_bump_anti: np.ndarray
    counts_exist: np.ndarray
    row_key_exist: np.ndarray
    pod_exist_match: np.ndarray
    pod_bump_exist: np.ndarray


def pack_affinity_batch(
    pods: List[Pod], snapshot: Snapshot, nt: NodeTensor
) -> Optional[AffinityBatch]:
    """Returns None when the batch exceeds the device envelope (too many
    keys/rows/values) -- the caller falls back to the host path."""
    b = len(pods)
    infos = snapshot.list_node_infos()
    node_rows = nt.rows_for(infos).tolist()
    n_cap = nt.capacity

    v_cap = value_capacity(n_cap)
    keys: Dict[str, int] = {}
    value_ids: List[Dict[str, int]] = []

    def key_idx(key: str) -> Optional[int]:
        idx = keys.get(key)
        if idx is None:
            if len(keys) >= MAX_KEYS:
                return None
            idx = len(keys)
            keys[key] = idx
            value_ids.append({})
        return idx

    matcher = _Matcher()

    # ---- collect rows -----------------------------------------------------
    aff_rows: List[_Row] = []
    aff_groups: Dict[Tuple, Tuple[int, List[int]]] = {}  # sig -> (gid, rows)
    anti_rows: List[_Row] = []
    anti_row_ids: Dict[Tuple, int] = {}
    exist_rows: List[_Row] = []
    exist_row_ids: Dict[Tuple, int] = {}

    pod_aff_rows = np.full((b, MAX_TERMS_PER_POD), -1, dtype=np.int32)
    pod_anti_rows = np.full((b, MAX_TERMS_PER_POD), -1, dtype=np.int32)
    pod_self_match = np.zeros(b, dtype=bool)
    pod_bump_exist = np.zeros((b, MAX_EXIST_ROWS), dtype=np.int32)

    def add_exist_row(owner: Pod, term: PodAffinityTerm) -> Optional[int]:
        sig = _term_sig(owner, term)
        r = exist_row_ids.get(sig)
        if r is None:
            if len(exist_rows) >= MAX_EXIST_ROWS:
                return None
            k = key_idx(term.topology_key)
            if k is None:
                return None
            r = len(exist_rows)
            exist_row_ids[sig] = r
            exist_rows.append(
                _Row(_term_namespaces(owner, term), term.label_selector,
                     _selector_sig(term.label_selector), k)
            )
        return r

    for i, pod in enumerate(pods):
        aff_terms = _required_affinity(pod)
        anti_terms = _required_anti_affinity(pod)
        if (
            len(aff_terms) > MAX_TERMS_PER_POD
            or len(anti_terms) > MAX_TERMS_PER_POD
        ):
            return None
        if aff_terms:
            gsig = (
                pod.metadata.namespace,
                tuple(_term_sig(pod, t) for t in aff_terms),
            )
            entry = aff_groups.get(gsig)
            if entry is None:
                if len(aff_rows) + len(aff_terms) > MAX_AFF_ROWS:
                    return None
                rows = []
                for t in aff_terms:
                    k = key_idx(t.topology_key)
                    if k is None:
                        return None
                    rows.append(len(aff_rows))
                    aff_rows.append(
                        _Row(_term_namespaces(pod, t), t.label_selector,
                             _selector_sig(t.label_selector), k)
                    )
                entry = (len(aff_groups), rows)
                aff_groups[gsig] = entry
            _, rows = entry
            pod_aff_rows[i, : len(rows)] = rows
            pod_self_match[i] = all(
                matcher.matches(
                    pod, _term_namespaces(pod, t), t.label_selector,
                    _selector_sig(t.label_selector),
                )
                for t in aff_terms
            )
        for t in anti_terms:
            sig = _term_sig(pod, t)
            r = anti_row_ids.get(sig)
            if r is None:
                if len(anti_rows) >= MAX_ANTI_ROWS:
                    return None
                k = key_idx(t.topology_key)
                if k is None:
                    return None
                r = len(anti_rows)
                anti_row_ids[sig] = r
                anti_rows.append(
                    _Row(_term_namespaces(pod, t), t.label_selector,
                         _selector_sig(t.label_selector), k)
                )
            slot = list(pod_anti_rows[i]).index(-1)
            pod_anti_rows[i, slot] = r
            # the pod's own anti term also constrains LATER batch pods
            # symmetrically once this pod places
            er = add_exist_row(pod, t)
            if er is None:
                return None
            pod_bump_exist[i, er] = 1

    # existing pods' required anti-affinity -> exist rows
    existing_with_anti: List[Tuple[Pod, PodAffinityTerm, int]] = []
    for ni in snapshot.have_pods_with_affinity_list:
        if ni.node is None:
            continue
        for e in ni.pods_with_affinity:
            for t in _required_anti_affinity(e):
                r = add_exist_row(e, t)
                if r is None:
                    return None
                existing_with_anti.append((e, t, r))

    if not aff_rows and not anti_rows and not exist_rows:
        return None  # nothing affinity-shaped in this batch

    # ---- node value interning --------------------------------------------
    node_value = np.full((MAX_KEYS, n_cap), -1, dtype=np.int32)
    for key, k in keys.items():
        ids = value_ids[k]
        for j, ni in zip(node_rows, infos):
            node = ni.node
            if node is None:
                continue
            val = node.metadata.labels.get(key)
            if val is None:
                continue
            vid = ids.get(val)
            if vid is None:
                if len(ids) >= v_cap:
                    return None
                vid = len(ids)
                ids[val] = vid
            node_value[k, j] = vid

    # ---- count initialization from existing pods --------------------------
    counts_aff = np.zeros((MAX_AFF_ROWS, v_cap), dtype=np.int32)
    counts_anti = np.zeros((MAX_ANTI_ROWS, v_cap), dtype=np.int32)
    counts_exist = np.zeros((MAX_EXIST_ROWS, v_cap), dtype=np.int32)

    # exist rows: one bump per (existing pod, term) at the pod's node value
    # (filtering.go:212; the batch pods' own rows start at zero)
    node_row_of = {ni.node_name: j for j, ni in zip(node_rows, infos)}
    for e, t, r in existing_with_anti:
        j = node_row_of.get(e.spec.node_name)
        if j is None:
            continue
        v = node_value[exist_rows[r].key_idx, j]
        if v >= 0:
            counts_exist[r, v] += 1

    # affinity groups: existing pod bumps every row of a group iff it
    # matches ALL the group's terms (filtering.go:135); anti rows bump on
    # any single-term match (filtering.go:153)
    if aff_rows or anti_rows:
        group_rows = [rows for (_gid, rows) in aff_groups.values()]
        for j, ni in zip(node_rows, infos):
            if ni.node is None:
                continue
            for e in ni.pods:
                for rows in group_rows:
                    if all(
                        matcher.matches(
                            e, aff_rows[r].namespaces, aff_rows[r].selector,
                            aff_rows[r].sel_sig,
                        )
                        for r in rows
                    ):
                        for r in rows:
                            v = node_value[aff_rows[r].key_idx, j]
                            if v >= 0:
                                counts_aff[r, v] += 1
                for r, row in enumerate(anti_rows):
                    if matcher.matches(
                        e, row.namespaces, row.selector, row.sel_sig
                    ):
                        v = node_value[row.key_idx, j]
                        if v >= 0:
                            counts_anti[r, v] += 1

    # ---- per-pod match/bump matrices --------------------------------------
    pod_bump_aff = np.zeros((b, MAX_AFF_ROWS), dtype=np.int32)
    pod_bump_anti = np.zeros((b, MAX_ANTI_ROWS), dtype=np.int32)
    pod_exist_match = np.zeros((b, MAX_EXIST_ROWS), dtype=bool)
    group_row_lists = [rows for (_gid, rows) in aff_groups.values()]
    for i, pod in enumerate(pods):
        for rows in group_row_lists:
            if all(
                matcher.matches(
                    pod, aff_rows[r].namespaces, aff_rows[r].selector,
                    aff_rows[r].sel_sig,
                )
                for r in rows
            ):
                for r in rows:
                    pod_bump_aff[i, r] = 1
        for r, row in enumerate(anti_rows):
            if matcher.matches(pod, row.namespaces, row.selector, row.sel_sig):
                pod_bump_anti[i, r] = 1
        for r, row in enumerate(exist_rows):
            if matcher.matches(pod, row.namespaces, row.selector, row.sel_sig):
                pod_exist_match[i, r] = True

    row_key_aff = np.full(MAX_AFF_ROWS, -1, dtype=np.int32)
    for r, row in enumerate(aff_rows):
        row_key_aff[r] = row.key_idx
    row_key_anti = np.full(MAX_ANTI_ROWS, -1, dtype=np.int32)
    for r, row in enumerate(anti_rows):
        row_key_anti[r] = row.key_idx
    row_key_exist = np.full(MAX_EXIST_ROWS, -1, dtype=np.int32)
    for r, row in enumerate(exist_rows):
        row_key_exist[r] = row.key_idx

    return AffinityBatch(
        node_value=node_value,
        counts_aff=counts_aff,
        row_key_aff=row_key_aff,
        pod_aff_rows=pod_aff_rows,
        pod_self_match=pod_self_match,
        pod_bump_aff=pod_bump_aff,
        counts_anti=counts_anti,
        row_key_anti=row_key_anti,
        pod_anti_rows=pod_anti_rows,
        pod_bump_anti=pod_bump_anti,
        counts_exist=counts_exist,
        row_key_exist=row_key_exist,
        pod_exist_match=pod_exist_match,
        pod_bump_exist=pod_bump_exist,
    )


def add_host_port_rows(
    pods: List[Pod], snapshot: Snapshot, nt, af: Optional[AffinityBatch]
) -> Optional[AffinityBatch]:
    """Model WITHIN-BATCH host-port conflicts as synthetic anti-affinity
    rows (nodeinfo/host_ports.go semantics): each distinct
    (protocol, port, ip) in the batch becomes an anti row over a
    synthetic per-node-unique value row, counts starting at zero
    (conflicts with EXISTING pods are already baked into the static
    mask, host_masks.static_mask_compact). A pod

    - BUMPS its own (proto, port, ip) row when placed, and
    - BLOCKS on every row it conflicts with: its own row, the wildcard
      row of the same (proto, port) when it binds a specific IP, and
      every specific-IP row of that (proto, port) when it binds the
      wildcard -- exactly HostPortInfo.CheckConflict.

    Returns the (possibly extended) AffinityBatch, a fresh one when the
    batch had no other affinity, or None when the rows don't fit the
    device envelope (callers fall back to the host path)."""
    from kubernetes_tpu_torch.cache.node_info import pod_host_ports

    per_pod_ports = [pod_host_ports(p) for p in pods]
    if not any(per_pod_ports):
        return af
    b = len(pods)
    n_cap = nt.capacity
    # node-index values must fit the value axis of the counts arrays
    assert value_capacity(n_cap) >= n_cap
    if af is None:
        noop = noop_affinity_tensors(b, n_cap)
        af = AffinityBatch(
            node_value=noop[0].copy(), counts_aff=noop[1].copy(),
            row_key_aff=noop[2].copy(), pod_aff_rows=noop[3].copy(),
            pod_self_match=noop[4].copy(), pod_bump_aff=noop[5].copy(),
            counts_anti=noop[6].copy(), row_key_anti=noop[7].copy(),
            pod_anti_rows=noop[8].copy(), pod_bump_anti=noop[9].copy(),
            counts_exist=noop[10].copy(), row_key_exist=noop[11].copy(),
            pod_exist_match=noop[12].copy(),
            pod_bump_exist=noop[13].copy(),
        )
    # synthetic key whose value is the node's own row index (unique per
    # node; value_capacity(n_cap) >= n_cap guarantees room)
    keys_used = {
        int(k)
        for arr in (af.row_key_aff, af.row_key_anti, af.row_key_exist)
        for k in arr
        if k >= 0
    }
    key_free = next(
        (
            k
            for k in range(af.node_value.shape[0])
            if k not in keys_used and (af.node_value[k] == -1).all()
        ),
        None,
    )
    if key_free is None:
        return None  # no key slot left: host path
    infos = snapshot.list_node_infos()
    for j, ni in zip(nt.rows_for(infos).tolist(), infos):
        if ni.node is not None and j < n_cap:
            af.node_value[key_free, j] = j

    # distinct port identities -> anti rows
    row_of: Dict[Tuple, int] = {}
    by_proto_port: Dict[Tuple, List[Tuple]] = {}

    def row_for(ident) -> Optional[int]:
        r = row_of.get(ident)
        if r is None:
            used = int(np.count_nonzero(af.row_key_anti >= 0))
            if used >= af.row_key_anti.shape[0]:
                return None
            r = used
            af.row_key_anti[r] = key_free
            row_of[ident] = r
            by_proto_port.setdefault(ident[:2], []).append(ident)
        return r

    for i, ports in enumerate(per_pod_ports):
        if not ports:
            continue
        for ip, proto, port in ports:
            ident = (proto, port, ip or "0.0.0.0")
            if row_for(ident) is None:
                return None
    for i, ports in enumerate(per_pod_ports):
        if not ports:
            continue
        block_rows = set()
        for ip, proto, port in ports:
            ident = (proto, port, ip or "0.0.0.0")
            r = row_of[ident]
            af.pod_bump_anti[i, r] = 1
            if ident[2] == "0.0.0.0":
                # wildcard conflicts with every identity of (proto, port)
                for other in by_proto_port.get(ident[:2], ()):
                    block_rows.add(row_of[other])
            else:
                block_rows.add(r)
                wild = (proto, port, "0.0.0.0")
                if wild in row_of:
                    block_rows.add(row_of[wild])
        slots = list(af.pod_anti_rows[i])
        free = [c for c, v in enumerate(slots) if v == -1]
        if len(free) < len(block_rows):
            return None  # not enough term slots: host path
        for c, r in zip(free, sorted(block_rows)):
            af.pod_anti_rows[i, c] = r
    return af


def cluster_has_required_anti_affinity(snapshot: Snapshot) -> bool:
    """True when any existing pod carries required anti-affinity -- such
    pods impose symmetric constraints on every incoming pod
    (filtering.go:404), so batches without their own affinity still need
    the affinity tensors."""
    for ni in snapshot.have_pods_with_affinity_list:
        for p in ni.pods_with_affinity:
            if _required_anti_affinity(p):
                return True
    return False


def noop_affinity_tensors(padded: int, n_cap: int) -> Tuple[np.ndarray, ...]:
    """All-inactive affinity tensors (kernel no-op), in
    greedy_assign_constrained argument order."""
    return (
        np.full((MAX_KEYS, n_cap), -1, dtype=np.int32),
        np.zeros((MAX_AFF_ROWS, value_capacity(n_cap)), dtype=np.int32),
        np.full(MAX_AFF_ROWS, -1, dtype=np.int32),
        np.full((padded, MAX_TERMS_PER_POD), -1, dtype=np.int32),
        np.zeros(padded, dtype=bool),
        np.zeros((padded, MAX_AFF_ROWS), dtype=np.int32),
        np.zeros((MAX_ANTI_ROWS, value_capacity(n_cap)), dtype=np.int32),
        np.full(MAX_ANTI_ROWS, -1, dtype=np.int32),
        np.full((padded, MAX_TERMS_PER_POD), -1, dtype=np.int32),
        np.zeros((padded, MAX_ANTI_ROWS), dtype=np.int32),
        np.zeros((MAX_EXIST_ROWS, value_capacity(n_cap)), dtype=np.int32),
        np.full(MAX_EXIST_ROWS, -1, dtype=np.int32),
        np.zeros((padded, MAX_EXIST_ROWS), dtype=bool),
        np.zeros((padded, MAX_EXIST_ROWS), dtype=np.int32),
    )


def pad_affinity_tensors(
    af: AffinityBatch, padded: int
) -> Tuple[np.ndarray, ...]:
    """Pad the per-pod arrays (already in solve order) to the fixed batch
    axis, returning the kernel-order tuple."""
    b = af.pod_aff_rows.shape[0]

    def pad_pods(a: np.ndarray, fill) -> np.ndarray:
        out = np.full((padded,) + a.shape[1:], fill, dtype=a.dtype)
        out[:b] = a
        return out

    return (
        af.node_value,
        af.counts_aff,
        af.row_key_aff,
        pad_pods(af.pod_aff_rows, -1),
        pad_pods(af.pod_self_match, False),
        pad_pods(af.pod_bump_aff, 0),
        af.counts_anti,
        af.row_key_anti,
        pad_pods(af.pod_anti_rows, -1),
        pad_pods(af.pod_bump_anti, 0),
        af.counts_exist,
        af.row_key_exist,
        pad_pods(af.pod_exist_match, False),
        pad_pods(af.pod_bump_exist, 0),
    )


def batch_has_affinity(pods: List[Pod]) -> bool:
    return any(
        _required_affinity(p) or _required_anti_affinity(p) for p in pods
    )


def batch_has_required_anti_affinity(pods: List[Pod]) -> bool:
    return any(_required_anti_affinity(p) for p in pods)

