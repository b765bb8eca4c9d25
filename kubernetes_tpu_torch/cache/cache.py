"""Scheduler cache with assumed-pod overlay and incremental snapshots.

Reference: /root/reference/pkg/scheduler/internal/cache/cache.go:59
(schedulerCache), AssumePod :344, UpdateSnapshot :203, pod state machine
interface.go:16-58 (Initial -> Assumed -> Added -> Deleted, with TTL expiry
of assumed pods that finished binding).

The incremental snapshot uses per-NodeInfo generation counters: only
NodeInfos whose generation advanced past the snapshot's generation are
re-cloned (reference orders nodes in a doubly-linked list by modification
generation, cache.go:53; here a generation compare over the map achieves the
same "copy only changed nodes" property).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo, next_generation
from kubernetes_tpu_torch.cache.snapshot import Snapshot

DEFAULT_ASSUME_TTL_SECONDS = 30.0  # reference scheduler.go:240


@dataclass
class _PodState:
    pod: Pod
    assumed: bool = False
    binding_finished: bool = False
    deadline: Optional[float] = None  # absolute expiry, set by finish_binding
    # the pod's node was deleted while this pod was assumed (drain /
    # spot reclamation racing an in-flight bind): expire on the NEXT
    # sweeper pass instead of waiting out the assume TTL -- the sweeper
    # routes the pod by apiserver truth either way
    node_removed: bool = False


class SchedulerCache:
    def __init__(
        self,
        ttl_seconds: float = DEFAULT_ASSUME_TTL_SECONDS,
        now=time.monotonic,
    ) -> None:
        self._lock = threading.RLock()
        self._ttl = ttl_seconds
        self._now = now
        self._nodes: Dict[str, NodeInfo] = {}
        self._pod_states: Dict[str, _PodState] = {}  # key: pod uid
        self._assumed_pods: Dict[str, bool] = {}
        # CSINode objects stashed by node name: a CSINode can arrive
        # before its Node (separate informers), so add_node re-applies it
        self._csi_nodes: Dict[str, object] = {}

    # -- assume / bind lifecycle (cache.go:344-) ----------------------------

    def assume_pod(self, pod: Pod) -> None:
        key = pod.metadata.uid
        with self._lock:
            if key in self._pod_states:
                raise KeyError(f"pod {pod.key()} is already in the cache")
            self._add_pod_to_node(pod)
            self._pod_states[key] = _PodState(pod=pod, assumed=True)
            self._assumed_pods[key] = True

    def assume_pods(self, pods: List[Pod]) -> List[Optional[Exception]]:
        """Bulk assume under one lock hold (the batch-commit analogue of N
        AssumePod calls). Per-pod failures don't abort the rest; slot i
        carries pod i's error or None.

        Consecutive same-node pods land as one ``NodeInfo.add_pods`` run
        (one node lookup + one generation bump per run). The batch
        committer maximizes the runs by argsorting its clones per target
        node before calling; arbitrary order stays correct -- runs just
        degenerate to length 1."""
        out: List[Optional[Exception]] = []
        with self._lock:
            states = self._pod_states
            assumed = self._assumed_pods
            nodes = self._nodes
            run: List[Pod] = []
            run_node: Optional[str] = None
            for pod in pods:
                key = pod.metadata.uid
                if key in states:
                    out.append(
                        KeyError(f"pod {pod.key()} is already in the cache")
                    )
                    continue
                node = pod.spec.node_name
                if node != run_node:
                    if run:
                        self._node_for(nodes, run_node).add_pods(run)
                    run = []
                    run_node = node
                run.append(pod)
                states[key] = _PodState(pod=pod, assumed=True)
                assumed[key] = True
                out.append(None)
            if run:
                self._node_for(nodes, run_node).add_pods(run)
        return out

    @staticmethod
    def _node_for(nodes, name) -> NodeInfo:
        ni = nodes.get(name)
        if ni is None:
            # pod observed before its node: nodeless NodeInfo, matching
            # _add_pod_to_node
            ni = NodeInfo()
            nodes[name] = ni
        return ni

    def finish_binding(self, pod: Pod) -> None:
        key = pod.metadata.uid
        with self._lock:
            state = self._pod_states.get(key)
            if state and state.assumed:
                state.binding_finished = True
                # node deleted while the bind was in flight: expire NOW
                # (the sweeper's next pass routes by apiserver truth)
                state.deadline = (
                    self._now() if state.node_removed
                    else self._now() + self._ttl
                )

    def finish_binding_bulk(self, pods: List[Pod]) -> None:
        with self._lock:
            now = self._now()
            deadline = now + self._ttl
            for pod in pods:
                state = self._pod_states.get(pod.metadata.uid)
                if state and state.assumed:
                    state.binding_finished = True
                    state.deadline = (
                        now if state.node_removed else deadline
                    )

    def forget_pod(self, pod: Pod) -> None:
        key = pod.metadata.uid
        with self._lock:
            state = self._pod_states.get(key)
            if state is None:
                return
            if state.assumed and state.pod.spec.node_name != pod.spec.node_name:
                # Reference cache.go:399: forgetting a pod assumed to a
                # different node signals scheduler bookkeeping corruption.
                raise ValueError(
                    f"pod {pod.key()} was assumed on "
                    f"{state.pod.spec.node_name} but forgotten on "
                    f"{pod.spec.node_name}"
                )
            if not state.assumed:
                raise ValueError(f"pod {pod.key()} was added, not assumed")
            self._remove_pod_from_node(state.pod)
            del self._pod_states[key]
            self._assumed_pods.pop(key, None)

    def is_assumed_pod(self, pod: Pod) -> bool:
        with self._lock:
            return self._assumed_pods.get(pod.metadata.uid, False)

    def has_pod_uid(self, uid: str) -> bool:
        """Membership probe (preemption uses it to detect when victim
        deletions have propagated from the watch into the cache)."""
        with self._lock:
            return uid in self._pod_states

    # -- confirmed pod events (informer-driven) -----------------------------

    def _add_pod_locked(self, pod: Pod, strict: bool) -> None:
        key = pod.metadata.uid
        state = self._pod_states.get(key)
        if state is not None and state.assumed:
            # Confirmation of an assumed pod. If the actual node differs,
            # move it (reference cache.go:419 "was assumed to a different
            # node": remove then re-add).
            if state.pod.spec.node_name != pod.spec.node_name:
                self._remove_pod_from_node(state.pod)
                self._add_pod_to_node(pod)
            else:
                # same-node confirm keeps the clone's node accounting:
                # the eventual remove must subtract exactly what the
                # clone's volume-count memo added, so the memo carries
                # forward onto the confirming object (re-resolving it
                # against the live listers could differ)
                memo = state.pod.__dict__.get("_volcount_memo")
                if memo is not None:
                    pod.__dict__["_volcount_memo"] = memo
            self._pod_states[key] = _PodState(pod=pod, assumed=False)
            self._assumed_pods.pop(key, None)
            return
        if state is not None:
            if strict:
                raise KeyError(f"pod {pod.key()} already added")
            return  # already added (watch replay)
        self._add_pod_to_node(pod)
        self._pod_states[key] = _PodState(pod=pod, assumed=False)

    def add_pod(self, pod: Pod) -> None:
        with self._lock:
            self._add_pod_locked(pod, strict=True)

    def add_pods(self, pods: List[Pod]) -> None:
        """Bulk add/confirm under one lock hold (the watch-frame analogue
        of N add_pod calls); a duplicate add raises in add_pod but is
        skipped in bulk (the informer can legitimately replay an add
        after a relist). Failures are isolated per pod -- one bad object
        must not drop the rest of the frame from the cache."""
        import logging

        with self._lock:
            for pod in pods:
                try:
                    self._add_pod_locked(pod, strict=False)
                except Exception:
                    logging.getLogger(__name__).exception(
                        "bulk add of pod %s", pod.key()
                    )

    def update_pod(self, old: Pod, new: Pod) -> None:
        with self._lock:
            state = self._pod_states.get(old.metadata.uid)
            if state is None or state.assumed:
                raise KeyError(f"pod {old.key()} not added")
            self._remove_pod_from_node(state.pod)
            self._add_pod_to_node(new)
            self._pod_states[new.metadata.uid] = _PodState(pod=new, assumed=False)

    def _remove_pod_locked(self, pod: Pod) -> None:
        key = pod.metadata.uid
        state = self._pod_states.get(key)
        if state is None:
            return
        self._remove_pod_from_node(state.pod)
        del self._pod_states[key]
        self._assumed_pods.pop(key, None)

    def remove_pod(self, pod: Pod) -> None:
        with self._lock:
            self._remove_pod_locked(pod)

    def remove_pods(self, pods: List[Pod]) -> None:
        """Bulk remove under one lock hold (eviction/delete frames)."""
        with self._lock:
            for pod in pods:
                self._remove_pod_locked(pod)

    def get_pod(self, pod: Pod) -> Optional[Pod]:
        with self._lock:
            state = self._pod_states.get(pod.metadata.uid)
            return state.pod if state else None

    # -- node events --------------------------------------------------------

    def add_node(self, node: Node) -> None:
        with self._lock:
            ni = self._nodes.get(node.metadata.name)
            if ni is None:
                ni = NodeInfo(node)
                self._nodes[node.metadata.name] = ni
            else:
                ni.set_node(node)
            csi = self._csi_nodes.get(node.metadata.name)
            if csi is not None and not ni.csi_volume_limits:
                ni.set_csi_node(csi)

    def update_node(self, old: Node, new: Node) -> None:
        self.add_node(new)

    def remove_node(self, node: Node) -> None:
        with self._lock:
            name = node.metadata.name
            ni = self._nodes.pop(name, None)
            if ni is not None and ni.pods:
                # Keep a nodeless NodeInfo while pods remain (reference
                # removes the node object but keeps pod accounting;
                # cache.go:582). We keep the entry with node=None.
                ni.node = None
                ni.generation = next_generation()
                self._nodes[name] = ni
            # Assumed pods stranded on the deleted node (drain / spot
            # reclamation racing an in-flight bind) fast-expire: the
            # resilience sweeper's NEXT pass routes them by apiserver
            # truth instead of waiting out the assume TTL. Pods whose
            # bind is still in flight get the now-deadline when
            # finish_binding lands (expiring mid-bind would race the
            # committer's bookkeeping).
            now = self._now()
            for key in self._assumed_pods:
                state = self._pod_states[key]
                if state.pod.spec.node_name != name:
                    continue
                state.node_removed = True
                if state.binding_finished:
                    state.deadline = now

    # -- CSINode events (attachable-volume limits) --------------------------

    def add_csi_node(self, csi_node) -> None:
        """Apply a CSINode's per-driver attach limits to its NodeInfo
        (same object name as the node). Arriving before the Node is fine:
        the object is stashed and applied by add_node."""
        with self._lock:
            self._csi_nodes[csi_node.metadata.name] = csi_node
            ni = self._nodes.get(csi_node.metadata.name)
            if ni is not None:
                ni.set_csi_node(csi_node)

    def update_csi_node(self, old, new) -> None:
        self.add_csi_node(new)

    def remove_csi_node(self, csi_node) -> None:
        with self._lock:
            self._csi_nodes.pop(csi_node.metadata.name, None)
            ni = self._nodes.get(csi_node.metadata.name)
            if ni is not None:
                ni.set_csi_node(None)

    def node_count(self) -> int:
        with self._lock:
            return sum(1 for ni in self._nodes.values() if ni.node is not None)

    def pod_count(self) -> int:
        with self._lock:
            return sum(len(ni.pods) for ni in self._nodes.values())

    # -- reconciliation support (scheduler/resilience.py) -------------------

    def pod_states_snapshot(self) -> Dict[str, Tuple[Pod, bool]]:
        """One consistent read of every cached pod: uid -> (pod,
        assumed). The drift checker diffs this against a fresh apiserver
        list; assumed entries are the scheduler's own optimistic overlay
        and must never be "healed" away."""
        with self._lock:
            return {
                uid: (state.pod, state.assumed)
                for uid, state in self._pod_states.items()
            }

    def pods_on_node(self, node_name: str) -> List[Pod]:
        """Pods the cache accounts against one node (confirmed AND
        assumed). The partition coordinator evicts these wholesale when
        a partition is handed off -- phantom per-node accounting for a
        foreign partition would double-count capacity nobody here owns."""
        with self._lock:
            ni = self._nodes.get(node_name)
            return list(ni.pods) if ni is not None else []

    def known_node_names(self) -> List[str]:
        """Names of nodes the cache believes exist (entries kept only for
        straggler pods -- node=None -- are excluded: they are pod
        bookkeeping, not node state)."""
        with self._lock:
            return [
                name for name, ni in self._nodes.items()
                if ni.node is not None
            ]

    # -- expiry (reference cleanupAssumedPods, run every 1s) ----------------

    def cleanup_expired_assumed_pods(self) -> List[Pod]:
        """Expire assumed pods whose binding finished > TTL ago. Returns the
        expired pods so the caller can requeue/log them."""
        expired: List[Pod] = []
        now = self._now()
        with self._lock:
            for key in list(self._assumed_pods):
                state = self._pod_states[key]
                if state.binding_finished and state.deadline is not None:
                    if now >= state.deadline:
                        if state.node_removed:
                            # attribution for the sweeper's metric: this
                            # expiry is a node-removal fast path, not a
                            # lost bind confirmation
                            state.pod.__dict__["_node_removed_expired"] = True
                        expired.append(state.pod)
                        self._remove_pod_from_node(state.pod)
                        del self._pod_states[key]
                        del self._assumed_pods[key]
        return expired

    # -- snapshot (cache.go:203 UpdateSnapshot) -----------------------------

    def update_snapshot(self, snapshot: Snapshot) -> Snapshot:
        """Incrementally refresh ``snapshot`` in place: clone only NodeInfos
        whose generation advanced; drop deleted nodes; refresh derived
        lists."""
        with self._lock:
            max_gen = snapshot.generation
            changed = False
            for name, ni in self._nodes.items():
                if ni.generation > snapshot.generation:
                    prev = snapshot.node_info_map.get(name)
                    if prev is None or (prev.node is None) != (
                        ni.node is None
                    ):
                        # a new map entry, or a node-object transition,
                        # moves node_info_list membership/row identity
                        snapshot.note_membership_change()
                    snapshot.node_info_map[name] = ni.clone()
                    snapshot.note_changed(name)
                    changed = True
                    if ni.generation > max_gen:
                        max_gen = ni.generation
            stale = set(snapshot.node_info_map) - set(self._nodes)
            for name in stale:
                del snapshot.node_info_map[name]
                snapshot.note_membership_change()
                changed = True
            if changed:
                snapshot.refresh_lists()
            snapshot.generation = max_gen
            return snapshot

    # -- debugger support (internal/cache/debugger) -------------------------

    def dump(self) -> Dict[str, List[str]]:
        with self._lock:
            return {
                name: [p.key() for p in ni.pods]
                for name, ni in self._nodes.items()
            }

    # -- internals ----------------------------------------------------------

    def _add_pod_to_node(self, pod: Pod) -> None:
        name = pod.spec.node_name
        ni = self._nodes.get(name)
        if ni is None:
            # Pod observed before its node: keep a nodeless NodeInfo
            # (reference cache.go:514 addPod creates the entry).
            ni = NodeInfo()
            self._nodes[name] = ni
        ni.add_pod(pod)

    def _remove_pod_from_node(self, pod: Pod) -> None:
        name = pod.spec.node_name
        ni = self._nodes.get(name)
        if ni is None:
            return
        ni.remove_pod(pod)
        if ni.node is None and not ni.pods:
            del self._nodes[name]
