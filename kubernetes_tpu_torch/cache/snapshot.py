"""Snapshot: an immutable-for-the-cycle view of cluster state.

Reference: /root/reference/pkg/scheduler/internal/cache/snapshot.go:31 and
pkg/scheduler/listers/listers.go (SharedLister). The snapshot carries both
the object view (NodeInfo list for the host/oracle path) and, lazily, the
packed tensor view consumed by the TPU solver
(kubernetes_tpu_torch.tensors.node_tensor).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo, pod_has_affinity_constraints

#: above this many accumulated changed names the per-name tracking stops
#: paying for itself -- consumers fall back to the full generation walk
CHANGE_TRACK_CAP = 4096


def _entry_seq(entry: Tuple[int, str]) -> int:
    return entry[0]


class Snapshot:
    def __init__(self, node_infos: Optional[Dict[str, NodeInfo]] = None) -> None:
        self.node_info_map: Dict[str, NodeInfo] = node_infos or {}
        # Stable iteration order for the cycle (reference keeps nodeInfoList).
        self.node_info_list: List[NodeInfo] = [
            ni for ni in self.node_info_map.values() if ni.node is not None
        ]
        self.have_pods_with_affinity_list: List[NodeInfo] = [
            ni for ni in self.node_info_list if ni.pods_with_affinity
        ]
        self.generation: int = 0
        # -- change tracking (epoch plumbing for the tensor packer) ---------
        # update_snapshot notes every name it re-clones in an APPEND-ONLY
        # sequence-stamped log so any NodeTensorCache can repack O(changed)
        # rows without walking all N NodeInfos per dispatch. Reads are
        # cursor-based and never mutate the log: the scheduler's cache,
        # the preemptor's sibling cache, and the prewarm thread's fresh
        # cache all share this snapshot, so a one-shot consume would let
        # one consumer steal another's notes (silently stale rows).
        self._change_lock = threading.Lock()
        self._change_log: List[Tuple[int, str]] = []
        self._change_seq = 0
        # seqs <= _dropped_seq may be missing from the log (cap overflow):
        # a cursor behind it must take the full generation walk
        self._dropped_seq = 0
        # seq of the last membership / ordering change
        self._membership_seq = 0

    # SharedLister surface ---------------------------------------------------

    def list_node_infos(self) -> List[NodeInfo]:
        return self.node_info_list

    def get_node_info(self, name: str) -> Optional[NodeInfo]:
        return self.node_info_map.get(name)

    def list_pods(self) -> List[Pod]:
        return [p for ni in self.node_info_list for p in ni.pods]

    def num_nodes(self) -> int:
        return len(self.node_info_list)

    # -- change tracking -----------------------------------------------------

    def note_changed(self, name: str) -> None:
        """update_snapshot re-cloned this node's NodeInfo."""
        with self._change_lock:
            self._change_seq += 1
            self._change_log.append((self._change_seq, name))
            if len(self._change_log) > CHANGE_TRACK_CAP:
                # tracking stopped paying for itself: drop the log and
                # send every cursor behind this point to the full walk
                self._dropped_seq = self._change_seq
                self._change_log.clear()

    def note_membership_change(self) -> None:
        """A node appeared in / disappeared from the map (or lost its
        Node object): row identity may have moved."""
        with self._change_lock:
            self._change_seq += 1
            self._membership_seq = self._change_seq

    def change_cursor(self) -> int:
        """Current change-log position: the baseline for a NEW consumer
        (which must full-walk once, then read ``changes_since`` from
        here)."""
        with self._change_lock:
            return self._change_seq

    def changes_since(
        self, cursor: int
    ) -> Tuple[Optional[Set[str]], bool, int]:
        """Read-only cursor advance over the change log:
        ``(changed_names_or_None, membership_moved, new_cursor)``.
        ``None`` names mean the log was truncated past ``cursor`` (cap
        overflow) and the caller must fall back to the full generation
        walk. Never mutates the log, so any number of NodeTensorCache
        consumers can share one snapshot without stealing each other's
        notes."""
        with self._change_lock:
            membership_moved = self._membership_seq > cursor
            if cursor < self._dropped_seq:
                return None, membership_moved, self._change_seq
            # the log is seq-sorted (append-only, monotonic): bisect to
            # the cursor instead of rescanning all (up to cap) entries
            i = bisect_right(self._change_log, cursor, key=_entry_seq)
            names = {n for _s, n in self._change_log[i:]}
            return names, membership_moved, self._change_seq

    def refresh_lists(self) -> None:
        old = self.node_info_list
        self.node_info_list = [
            ni for ni in self.node_info_map.values() if ni.node is not None
        ]
        # any change to the NAME SEQUENCE (add/remove/reorder) moves row
        # identity for the tensor packer -- flag it so the change-tracked
        # fast path never packs against a stale row layout
        if len(old) != len(self.node_info_list) or any(
            a.node_name != b.node_name
            for a, b in zip(old, self.node_info_list)
        ):
            self.note_membership_change()
        self.have_pods_with_affinity_list = [
            ni for ni in self.node_info_list if ni.pods_with_affinity
        ]
        self._image_num_nodes = None

    def image_num_nodes(self) -> Dict[str, int]:
        """image name -> number of nodes holding it; computed once per
        snapshot refresh (reference ImageStateSummary.NumNodes,
        snapshot.go:124 createImageStates)."""
        cached = getattr(self, "_image_num_nodes", None)
        if cached is None:
            cached = {}
            for ni in self.node_info_list:
                for image in ni.image_states:
                    cached[image] = cached.get(image, 0) + 1
            self._image_num_nodes = cached
        return cached


def new_snapshot(pods: Iterable[Pod], nodes: Iterable[Node]) -> Snapshot:
    """Test/bench helper, reference snapshot.go:51 NewSnapshot."""
    infos: Dict[str, NodeInfo] = {}
    for node in nodes:
        infos[node.metadata.name] = NodeInfo(node)
    for pod in pods:
        name = pod.spec.node_name
        if name and name in infos:
            infos[name].add_pod(pod)
    snap = Snapshot(infos)
    return snap
