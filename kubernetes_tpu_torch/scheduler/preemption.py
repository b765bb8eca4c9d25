"""Preemption: evict lower-priority pods to make room for a pending pod.

Reference: /root/reference/pkg/scheduler/core/generic_scheduler.go
(Preempt :270, selectNodesForPreemption :850, selectVictimsOnNode :940,
filterPodsWithPDBViolation :884, pickOneNodeForPreemption :721,
nodesWherePreemptionMightHelp :1033, podEligibleToPreemptOthers :1054)
and pkg/scheduler/scheduler.go:392 (sched.preempt host-side actions), with
MoreImportantPod/GetPodStartTime from pkg/scheduler/util/utils.go:38-83.

A device-eligible pod (a plain pod, see ``device_eligible``) preempts
through the device victim search (ops/preemption.py): on the card a
whole wave is one launch of kernel K3 (ops/preempt_kernel.py), and a
fault there raises CardFault, which halts the scheduler -- nothing
steps down to the host oracle. The one exception is a chaos profile's
injected fault (FaultInjected) that has spent the ladder's in-place
attempts: the wave (or the single pod) gets no nomination this cycle,
is requeued on the ordinary backoff and is solved again by K3
(``injected_exhaustions``). On the CPU
the search runs K3's plain PyTorch version (the ``torch`` tier) and the
host oracle below is the floor. Every other pod takes the host oracle,
which is also the parity reference. Drain planning
(``plan_replacements``, called by ``NodeDrainer.drain_via_preemption``)
runs the same search as a plan, at a wave priority below every real
one: on the card one K3 launch per plan, a fault there raising out of
the drain.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.selectors import labels_match_selector
from kubernetes_tpu_torch.api.types import Pod, PodDisruptionBudget
from kubernetes_tpu_torch.cache.node_info import NodeInfo, pod_host_ports
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    FitError,
    StatusCode,
)
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjected,
    FaultPoint,
    get_injector,
)
from kubernetes_tpu_torch.robustness.ladder import (
    TIER_CUDA,
    TIER_TORCH,
    CardFault,
    LadderExhausted,
    SolverLadder,
)
from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)

_MAX_INT32 = (1 << 31) - 1
#: wave priority used by drain PLANNING: below every real pod priority,
#: so the victim search degenerates into pure fit + nomination carry
_PLAN_PRIO = -(1 << 31) + 1
#: the wave tier name for the host-oracle floor
TIER_HOST = "host"


def pod_start_time(pod: Pod) -> float:
    """utils.go:38 GetPodStartTime: assumed/bound-but-unstarted pods count
    as 'now'."""
    if pod.status.start_time is not None:
        return pod.status.start_time
    return time.time()


def more_important_pod(p1: Pod, p2: Pod) -> bool:
    """utils.go:76: higher priority, then earlier start time."""
    if p1.spec.priority != p2.spec.priority:
        return p1.spec.priority > p2.spec.priority
    return pod_start_time(p1) < pod_start_time(p2)


def filter_pods_with_pdb_violation(
    pods: List[Pod], pdbs: List[PodDisruptionBudget]
) -> Tuple[List[Pod], List[Pod]]:
    """generic_scheduler.go:884: greedily spend each PDB's
    DisruptionsAllowed budget; pods beyond it are 'violating'."""
    allowed = [pdb.status.disruptions_allowed for pdb in pdbs]
    violating: List[Pod] = []
    non_violating: List[Pod] = []
    for pod in pods:
        violated = False
        if pod.metadata.labels:
            for i, pdb in enumerate(pdbs):
                if pdb.metadata.namespace != pod.metadata.namespace:
                    continue
                if pdb.selector is None:
                    continue  # nil selector matches nothing
                if not labels_match_selector(pod.metadata.labels, pdb.selector):
                    continue
                if allowed[i] <= 0:
                    violated = True
                    break
                allowed[i] -= 1
        (violating if violated else non_violating).append(pod)
    return violating, non_violating


class Victims:
    __slots__ = ("pods", "num_pdb_violations")

    def __init__(self, pods: List[Pod], num_pdb_violations: int) -> None:
        self.pods = pods
        self.num_pdb_violations = num_pdb_violations


def pick_one_node_for_preemption(
    nodes_to_victims: Dict[str, Victims]
) -> Optional[str]:
    """generic_scheduler.go:721: 6-rule lexicographic choice."""
    if not nodes_to_victims:
        return None
    for name, victims in nodes_to_victims.items():
        if not victims.pods:
            return name  # free lunch: no preemption needed

    candidates = list(nodes_to_victims)
    # 1. fewest PDB violations
    min_v = min(nodes_to_victims[n].num_pdb_violations for n in candidates)
    candidates = [
        n for n in candidates if nodes_to_victims[n].num_pdb_violations == min_v
    ]
    if len(candidates) == 1:
        return candidates[0]
    # 2. lowest highest-victim priority (victims sorted important-first)
    min_hp = min(nodes_to_victims[n].pods[0].spec.priority for n in candidates)
    candidates = [
        n for n in candidates
        if nodes_to_victims[n].pods[0].spec.priority == min_hp
    ]
    if len(candidates) == 1:
        return candidates[0]
    # 3. smallest priority sum (offset keeps negatives comparable)
    def prio_sum(n: str) -> int:
        return sum(
            p.spec.priority + _MAX_INT32 + 1 for p in nodes_to_victims[n].pods
        )

    min_sum = min(prio_sum(n) for n in candidates)
    candidates = [n for n in candidates if prio_sum(n) == min_sum]
    if len(candidates) == 1:
        return candidates[0]
    # 4. fewest victims
    min_pods = min(len(nodes_to_victims[n].pods) for n in candidates)
    candidates = [
        n for n in candidates if len(nodes_to_victims[n].pods) == min_pods
    ]
    if len(candidates) == 1:
        return candidates[0]
    # 5. latest earliest-start-time among highest-priority victims
    def earliest_start(n: str) -> float:
        # victims are ordered PDB-violating-first, so pods[0] need not be
        # the highest priority; scan all (GetEarliestPodStartTime).
        pods = nodes_to_victims[n].pods
        max_prio = max(p.spec.priority for p in pods)
        return min(
            pod_start_time(p) for p in pods if p.spec.priority == max_prio
        )

    return max(candidates, key=earliest_start)


class Preemptor:
    """Wires the preemption algorithm to the API side effects
    (scheduler.go:392 preempt + podPreemptor)."""

    #: filter plugins whose semantics the device victim search models
    #: exactly for a plain (solver_supported) preemptor: resource fit +
    #: the static label mask, plus plugins that are no-ops for pods
    #: without the matching spec fields (ports/volumes/spread/affinity)
    DEVICE_MODELED_FILTERS = frozenset({
        "NodeUnschedulable", "NodeResourcesFit", "NodeName", "NodePorts",
        "NodeAffinity", "VolumeRestrictions", "TaintToleration",
        "EBSLimits", "GCEPDLimits", "AzureDiskLimits",
        "NodeVolumeLimitsCSI", "VolumeBinding", "VolumeZone",
        "PodTopologySpread", "InterPodAffinity",
        # no-op for pods without the numa opt-in annotation, and
        # annotated pods are rejected by solver_supported above
        "NodeResourcesNumaAligned",
    })

    def __init__(
        self, algorithm, queue, client, disruption=None, ladder=None,
        device=None,
    ) -> None:
        self.algorithm = algorithm  # GenericScheduler (snapshot + filters)
        self.queue = queue
        self.client = client
        # the shared voluntary-disruption gate (DisruptionController):
        # when wired, EVERY wave victim's eviction spends a PDB unit
        # through can_disrupt -- concurrent waves, drains, and taint
        # evictions contend on one budget and can never overspend it.
        # A denied victim set refunds the attempt's grants and the
        # preemptor requeues without a nomination.
        self.disruption = disruption
        # the wave's solver ladder: ONE device tier named by where the
        # victim search runs -- "cuda" (K3, no step down) on the card,
        # "torch" (its plain version, then the host-oracle floor) on the
        # CPU. Own instance by default so wave faults never poison the
        # batch solver's breakers; new_scheduler mirrors the batch
        # robustness config in.
        self.ladder = ladder if ladder is not None else SolverLadder()
        # where the victim search runs: the card unless the caller names
        # the CPU (new_scheduler passes the batch scheduler's device)
        self.device = resolve_device(device)
        # device victim-search state: tensors cached per snapshot
        # generation so a burst of failed pods packs (and uploads) once
        from kubernetes_tpu_torch.tensors import NodeTensorCache

        self._tensor_cache = NodeTensorCache()
        self._pack = None
        self._pack_key = None
        self._pack_cv = threading.Condition()
        self._nt_lock = threading.Lock()  # dims/topology interner guard
        self._prewarm_busy = False
        self.device_preemptions = 0
        self.host_preemptions = 0
        # victim searches (waves or single pods) whose injected fault
        # spent the ladder's attempts: on the card their pods requeue
        # without a nomination, on the CPU the host oracle answers them
        self.injected_exhaustions = 0
        # wave observability (bench solver labels + perf-matrix
        # DataItems). victims_by_tier books what actually HAPPENED: a
        # victim counts only after its eviction transaction landed, so
        # a wave aborted by a breaker, a fence, or a denied budget books
        # nothing (the PR-5 rule).
        self.waves = 0
        self.victims_by_tier: Dict[str, int] = {}
        self.budget_denials = 0
        self.victims_slow_death = 0
        self.wave_solver_tier = ""
        # drain planning reads CURRENT cache truth through a private
        # snapshot (the scheduler's own snapshot is pre-batch: it lags
        # the newest commits by one dispatch, and an idle scheduler
        # never refreshes it); update_snapshot holds the cache lock, so
        # refreshing it races nothing. The sibling tensor cache persists
        # with it so a drain's round-after-round re-plans pay
        # O(changed rows), not a full repack per call. The plan's pack is
        # its own object, so its device tensors (cached on the pack by
        # upload_pack) never overwrite the wave's.
        self._plan_snapshot = None
        self._plan_nt_cache = None
        self._plan_pack = None
        self._plan_pack_key = None

    # -- eligibility --------------------------------------------------------

    def pod_eligible_to_preempt_others(self, pod: Pod) -> bool:
        """generic_scheduler.go:1054."""
        if pod.spec.preemption_policy == "Never":
            return False
        nom = pod.status.nominated_node_name
        if nom:
            ni = self.algorithm.snapshot.get_node_info(nom)
            if ni is not None:
                for p in ni.pods:
                    if (
                        p.metadata.deletion_timestamp is not None
                        and p.spec.priority < pod.spec.priority
                    ):
                        return False  # a previous victim is still terminating
        return True

    # -- core algorithm -----------------------------------------------------

    def nodes_where_preemption_might_help(
        self, fit_err: FitError
    ) -> List[NodeInfo]:
        """generic_scheduler.go:1033: skip UnschedulableAndUnresolvable."""
        out = []
        for ni in self.algorithm.snapshot.list_node_infos():
            status = fit_err.filtered_nodes_statuses.get(ni.node_name)
            if (
                status is not None
                and status.code == StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE
            ):
                continue
            out.append(ni)
        return out

    def select_victims_on_node(
        self,
        prof,
        state: CycleState,
        pod: Pod,
        node_info: NodeInfo,
        pdbs: List[PodDisruptionBudget],
    ) -> Tuple[List[Pod], int, bool]:
        """generic_scheduler.go:940 on cloned state/nodeinfo."""
        node_info = node_info.clone()
        state = state.clone()

        def remove_pod(p: Pod) -> None:
            node_info.remove_pod(p)
            prof.run_pre_filter_extension_remove_pod(state, pod, p, node_info)

        def add_pod(p: Pod) -> None:
            node_info.add_pod(p)
            prof.run_pre_filter_extension_add_pod(state, pod, p, node_info)

        potential: List[Pod] = []
        for p in list(node_info.pods):
            if p.spec.priority < pod.spec.priority:
                potential.append(p)
                remove_pod(p)
        fits, _ = self.algorithm.pod_passes_filters_on_node(
            prof, state, pod, node_info
        )
        if not fits:
            return [], 0, False

        potential.sort(
            key=lambda p: (-p.spec.priority, pod_start_time(p))
        )  # MoreImportantPod order
        violating, non_violating = filter_pods_with_pdb_violation(
            potential, pdbs
        )
        victims: List[Pod] = []
        num_violating = 0

        def reprieve(p: Pod) -> bool:
            add_pod(p)
            fits, _ = self.algorithm.pod_passes_filters_on_node(
                prof, state, pod, node_info
            )
            if not fits:
                remove_pod(p)
                victims.append(p)
            return fits

        for p in violating:
            if not reprieve(p):
                num_violating += 1
        for p in non_violating:
            reprieve(p)
        return victims, num_violating, True

    def device_eligible(self, prof, pod: Pod, cluster_anti=None) -> bool:
        """True when the device victim search is exact for this pod:
        plain pod (solver_supported), no gang semantics, no extenders,
        no custom filter plugins, and no existing-pod required
        anti-affinity (whose removal the device fit model can't see).
        ``cluster_anti`` may carry a precomputed
        cluster_has_required_anti_affinity answer (the batch path checks
        eligibility for hundreds of pods against one snapshot)."""
        from kubernetes_tpu_torch.api.types import POD_GROUP_LABEL
        from kubernetes_tpu_torch.ops.affinity import (
            cluster_has_required_anti_affinity,
        )
        from kubernetes_tpu_torch.scheduler.batch import solver_supported

        if not solver_supported(pod):
            return False
        if any(v.pvc_claim_name for v in pod.spec.volumes):
            # bound-simple-PV pods are solver-safe for PLACEMENT, but
            # the victim search keeps them on the host oracle: volume
            # state can change between the wave and the retry, and the
            # exact oracle re-resolves claims per node
            return False
        # solver_supported admits required pod (anti-)affinity and hard
        # spread (the batch solver models them via count tensors); the
        # victim search does NOT -- a preemptor carrying either must take
        # the host oracle or it would evict victims for a node its
        # constraint still rejects
        if pod.spec.topology_spread_constraints:
            return False
        # host-port preemptors too: static_mask_compact bakes existing
        # port conflicts into the candidate mask, so a node whose only
        # remedy is evicting the current port holder is never searched.
        # The reference re-runs NodePorts with victims removed
        # (generic_scheduler.go:940); the host oracle does the same here.
        if pod_host_ports(pod):
            return False
        a = pod.spec.affinity
        if a is not None and (
            a.pod_affinity is not None or a.pod_anti_affinity is not None
        ):
            return False
        if pod.metadata.labels.get(POD_GROUP_LABEL):
            return False
        if getattr(self.algorithm, "extenders", []):
            return False
        filters = set(prof.list_plugins().get("filter", []))
        if not filters <= self.DEVICE_MODELED_FILTERS:
            return False
        if cluster_anti is None:
            cluster_anti = cluster_has_required_anti_affinity(
                self.algorithm.snapshot
            )
        if cluster_anti:
            return False
        return True

    def _device_answers(
        self, pods: List[Pod], potentials, pdbs, prio_override=None,
        snapshot=None,
    ) -> Tuple[List[Tuple[str, List[Pod], int]], str]:
        """The device victim search (ops/preemption.py) for a group of
        failed pods in priority-desc order, ONE device call: the search
        carries each nomination so later pods see earlier ones
        (addNominatedPods semantics). Returns (answers, tier) -- one
        (node_name, victims, num_violating) per pod ("" = no candidate)
        plus the solver tier that produced them.

        The call runs through the wave ladder's ONE device tier: "cuda"
        (K3) on the card, where any fault raises and an injected one is
        retried in place until it exhausts the ladder; "torch" (K3's
        plain version) on the CPU, behind its breaker and retries. An
        exhausted tier raises LadderExhausted; ``_device_search`` applies
        the card's rule to it.

        ``potentials``: per-pod iterable of candidate NodeInfos (already
        pruned of UnschedulableAndUnresolvable nodes).
        ``prio_override``: replace every pod's wave priority (the drain
        planner passes _PLAN_PRIO so no victim is ever eligible).
        ``snapshot``: solve against this snapshot instead of the
        algorithm's (the drain planner's cache-fresh private one)."""
        import numpy as np

        from kubernetes_tpu_torch.ops.host_masks import static_mask_compact
        from kubernetes_tpu_torch.ops.preemption import (
            pack_preemption_state,
            preempt_batch_device,
            victims_for_node,
        )
        from kubernetes_tpu_torch.tensors import pack_pod_batch

        if snapshot is not None:
            # private-snapshot path (drain planning): a PERSISTENT
            # sibling tensor cache sharing the dims/topology interners
            # (so both caches lay out the same slots), and a private
            # pack -- the shared _tensor_cache/_pack may be mid-wave on
            # the committing thread with the MAIN snapshot, and the two
            # snapshots must never thrash one cache's slot layout
            from kubernetes_tpu_torch.tensors import NodeTensorCache

            with self._nt_lock:
                if self._plan_nt_cache is None:
                    self._plan_nt_cache = NodeTensorCache(
                        dims=self._tensor_cache.dims,
                        topology_encoder=self._tensor_cache.topology,
                    )
                nt = self._plan_nt_cache.update(snapshot)
            # pack cached on (generation, pdbs) like the main path: an
            # unprogressing drain re-plans every poll tick against an
            # UNCHANGED snapshot, and rebuilding the pack per 20 ms poll
            # would turn budget-blocked pacing into a busy loop
            key = self._pack_cache_key(snapshot, pdbs)
            pack = self._plan_pack if self._plan_pack_key == key else None
            if pack is None:
                pack = pack_preemption_state(snapshot, nt, pdbs)
                self._plan_pack = pack
                self._plan_pack_key = key
        else:
            snapshot = self.algorithm.snapshot
            # the interners inside dims/topology are check-then-insert;
            # the prewarm thread updates a sibling cache sharing them
            with self._nt_lock:
                nt = self._tensor_cache.update(snapshot)
            key = self._pack_cache_key(snapshot, pdbs)
            with self._pack_cv:
                # a prewarm in flight is about to deliver this exact
                # pack: wait for it instead of duplicating the packing
                # work
                deadline = time.monotonic() + 2.0
                while (
                    self._prewarm_busy
                    and self._pack_key != key
                    and time.monotonic() < deadline
                ):
                    self._pack_cv.wait(0.05)
                pack = self._pack if self._pack_key == key else None
            if pack is None:
                pack = pack_preemption_state(snapshot, nt, pdbs)
                with self._pack_cv:
                    self._pack = pack
                    self._pack_key = key
        n = len(pack.node_names)
        b = len(pods)

        batch = pack_pod_batch(pods, nt.dims)
        mask_rows, mask_index = static_mask_compact(pods, snapshot, nt)
        nt_rows = np.array(
            [nt.row(name) for name in pack.node_names], dtype=np.int64
        )
        # candidate masks arrive PRE-DEDUPLICATED: the dedup key is
        # (static-mask row, potential-list identity) -- both known per
        # pod -- so a wave of identical pods shares one [N] row and the
        # kernel never sees (nor np.unique's) a [B, N] matrix
        pot_rows: Dict[int, np.ndarray] = {}
        cand_cache: Dict[Tuple[int, int], int] = {}
        content_cache: Dict[bytes, int] = {}
        cand_rows: List[np.ndarray] = []
        cand_index = np.zeros(b, dtype=np.int32)
        zero_row: Optional[int] = None
        for k, pod in enumerate(pods):
            if batch.unsatisfiable[k]:
                # no pod removal adds a resource dimension
                if zero_row is None:
                    zero_row = len(cand_rows)
                    cand_rows.append(np.zeros(n, dtype=bool))
                cand_index[k] = zero_row
                continue
            ckey = (int(mask_index[k]), id(potentials[k]))
            u = cand_cache.get(ckey)
            if u is None:
                pot_key = id(potentials[k])
                pot_row = pot_rows.get(pot_key)
                if pot_row is None:
                    pot_row = np.zeros(n, dtype=bool)
                    idxs = [
                        pack.node_index.get(ni.node_name)
                        for ni in potentials[k]
                    ]
                    pot_row[[i for i in idxs if i is not None]] = True
                    pot_rows[pot_key] = pot_row
                row = mask_rows[mask_index[k]][nt_rows] & pot_row
                # content-level dedup on top of the identity key: a
                # deferred wave combines failures from several batches
                # whose statuses/potential objects differ by identity
                # but not content, and one row per class keeps K3's
                # per-class key build shared
                content = row.tobytes()
                u = content_cache.get(content)
                if u is None:
                    u = len(cand_rows)
                    cand_rows.append(row)
                    content_cache[content] = u
                cand_cache[ckey] = u
            cand_index[k] = u

        # pre-existing nominations (in-wave ones ride the kernel carry)
        pod_uids = {p.metadata.uid for p in pods}
        nom_pods, nom_prio, nom_node = [], [], []
        for node_name, noms in (
            self.queue.all_nominated_pods_by_node() if self.queue else {}
        ).items():
            i = pack.node_index.get(node_name)
            if i is None:
                continue
            for p in noms:
                if p.metadata.uid in pod_uids:
                    continue
                nom_pods.append(p)
                nom_prio.append(p.spec.priority)
                nom_node.append(i)
        if nom_pods:
            nom_req = pack_pod_batch(nom_pods, nt.dims).requests
        else:
            nom_req = np.zeros((0, nt.dims.num_dims), dtype=np.int32)
        if prio_override is not None:
            wave_prio = np.full(b, prio_override, dtype=np.int32)
        else:
            wave_prio = np.clip(
                [p.spec.priority for p in pods], -(1 << 31), (1 << 31) - 2
            ).astype(np.int32)

        def run():
            inj = get_injector()
            if inj is not None:
                inj.raise_maybe(FaultPoint.PREEMPT_SOLVE)
            return preempt_batch_device(
                pack,
                batch.requests,
                wave_prio,
                np.stack(cand_rows),
                cand_index,
                nom_req,
                np.array(nom_prio, dtype=np.int32),
                np.array(nom_node, dtype=np.int32),
                device=self.device,
            )

        tier_name = TIER_CUDA if self.device.type == "cuda" else TIER_TORCH
        tier, (chosen, victims, viol, nviol) = self.ladder.run(
            [(tier_name, run)], label="preempt_wave"
        )
        if prio_override is None:
            # a drain PLAN's solve must not relabel the eviction ledger
            # a concurrent preempt() is about to book against
            self.wave_solver_tier = tier
        out = []
        for k in range(b):
            idx = int(chosen[k])
            if idx < 0:
                out.append(("", [], 0))
                continue
            out.append(
                (
                    pack.node_names[idx],
                    victims_for_node(pack, idx, victims[k], viol[k]),
                    int(nviol[k]),
                )
            )
        return out, tier

    def _pack_cache_key(self, snapshot, pdbs):
        return (
            snapshot.generation,
            tuple(
                (
                    pdb.metadata.namespace, pdb.metadata.name,
                    pdb.metadata.resource_version,
                    pdb.status.disruptions_allowed,
                )
                for pdb in pdbs
            ),
        )

    def prewarm_pack_async(self) -> None:
        """Speculatively build and upload the victim-search pack for the
        CURRENT snapshot on a helper thread. The BatchScheduler calls
        this when a dispatched batch's demand exceeds the cluster's free
        capacity -- preemption is then likely, and the host pack plus
        its one device upload overlap the failing solve instead of
        serializing into the wave."""
        with self._pack_cv:
            if self._prewarm_busy:
                return
            self._prewarm_busy = True

        def run() -> None:
            try:
                snapshot = self.algorithm.snapshot
                pdbs = []
                if self.client is not None:
                    try:
                        pdbs, _ = self.client.list_pdbs()
                    except Exception:
                        pass
                key = self._pack_cache_key(snapshot, pdbs)
                with self._pack_cv:
                    if self._pack_key == key:
                        return
                from kubernetes_tpu_torch.ops.preemption import (
                    pack_preemption_state,
                    upload_pack,
                )
                from kubernetes_tpu_torch.tensors import NodeTensorCache

                # own cache INSTANCE (update mutates arrays in place and
                # the committer may be mid-wave on self._tensor_cache)
                # but the SHARED dims/topology schema: a fresh
                # ResourceDims could order resource columns differently
                # and silently misalign the wave's pod packing against
                # this pack
                with self._nt_lock:
                    nt = NodeTensorCache(
                        dims=self._tensor_cache.dims,
                        topology_encoder=self._tensor_cache.topology,
                    ).update(snapshot)
                pack = pack_preemption_state(snapshot, nt, pdbs)
                upload_pack(pack, self.device)
                with self._pack_cv:
                    installed_gen = (
                        self._pack_key[0]
                        if self._pack_key is not None else -1
                    )
                    if self._pack_key != key and installed_gen <= key[0]:
                        # never clobber a NEWER pack a wave installed
                        # meanwhile; an older installed pack (or none)
                        # is always worth replacing -- a wave blocked
                        # in pack_wait may be waiting for this exact key
                        self._pack = pack
                        self._pack_key = key
            except Exception:
                logger.exception("preemption pack prewarm failed")
            finally:
                with self._pack_cv:
                    self._prewarm_busy = False
                    self._pack_cv.notify_all()

        threading.Thread(
            target=run, name="preempt-prewarm", daemon=True
        ).start()

    def _device_search(
        self, pods: List[Pod], potentials, pdbs
    ) -> Tuple[Optional[List[Tuple[str, List[Pod], int]]], str]:
        """``_device_answers`` under the card's fault rule. Returns
        (answers, tier); answers is None when an injected fault spent the
        ladder's attempts on the card: the pods get no nomination this
        cycle and the caller requeues them for K3. On the card every
        other failure raises CardFault. On the CPU an exhausted ladder
        raises LadderExhausted and the caller takes the host oracle."""
        on_card = self.device.type == "cuda"
        try:
            return self._device_answers(pods, potentials, pdbs)
        except Exception as e:
            injected = isinstance(e, LadderExhausted) and isinstance(
                e.__cause__, FaultInjected
            )
            if injected:
                self.injected_exhaustions += 1
                flightrecorder.mark(
                    "preempt_exhausted", pods=len(pods),
                    tier=self.device.type,
                )
            if not on_card:
                raise
            if injected:
                return None, TIER_CUDA
            raise CardFault(
                f"the victim search failed on the card: {e!r}"
            ) from e

    def _find_preemption_device(
        self, pod: Pod, potential, pdbs
    ) -> Tuple[Optional[Tuple[str, List[Pod], int]], str]:
        """Single-pod wrapper over ``_device_search``: returns (answer,
        tier), answer None when the card requeues the pod."""
        answers, tier = self._device_search([pod], [potential], pdbs)
        return (answers[0] if answers is not None else None), tier

    def find_preemption(
        self, prof, state: CycleState, pod: Pod, fit_err: FitError
    ) -> Tuple[str, List[Pod], List[Pod], str]:
        """generic_scheduler.go:270 Preempt. Returns (node_name,
        victims, nominated_pods_to_clear, solver_tier) -- the tier is
        plumbed through the return (not an instance attribute) so a
        concurrent drain plan or wave on another thread cannot relabel
        this preemption's eviction booking."""
        if not self.pod_eligible_to_preempt_others(pod):
            return "", [], [], TIER_HOST
        potential = self.nodes_where_preemption_might_help(fit_err)
        if not potential:
            return "", [], [pod], TIER_HOST  # clear any stale nomination
        pdbs = []
        if self.client is not None:
            try:
                pdbs, _ = self.client.list_pdbs()
            except Exception:
                logger.exception("listing PDBs")
        if self.device_eligible(prof, pod):
            try:
                result, tier = self._find_preemption_device(
                    pod, potential, pdbs
                )
            except LadderExhausted:
                # the CPU's device tier is down: the host oracle below
                # is the wave floor (counted as a host preemption)
                logger.warning(
                    "device preemption tiers exhausted for %s; "
                    "falling to the host oracle", pod.key(),
                )
            else:
                if result is None:
                    # the card: no nomination this cycle; the caller
                    # requeues the pod and K3 solves it again
                    return "", [], [], tier
                self.device_preemptions += 1
                node_name, victims, _ = result
                if not node_name:
                    return "", [], [], tier
                nominated_to_clear = self._lower_priority_nominated_pods(
                    pod, node_name
                )
                return node_name, victims, nominated_to_clear, tier
        self.host_preemptions += 1
        self.wave_solver_tier = TIER_HOST
        nodes_to_victims: Dict[str, Victims] = {}
        for ni in potential:
            victims, num_violating, fits = self.select_victims_on_node(
                prof, state, pod, ni, pdbs
            )
            if fits:
                nodes_to_victims[ni.node_name] = Victims(victims, num_violating)
        # extenders supporting preemption narrow the candidates
        # (generic_scheduler.go:328 processPreemptionWithExtenders)
        for extender in getattr(self.algorithm, "extenders", []):
            if not nodes_to_victims:
                break
            if getattr(extender, "supports_preemption", lambda: False)() and \
                    extender.is_interested(pod):
                nodes_to_victims = extender.process_preemption(
                    pod, nodes_to_victims
                )
        node_name = pick_one_node_for_preemption(nodes_to_victims)
        if node_name is None:
            return "", [], [], TIER_HOST
        nominated_to_clear = self._lower_priority_nominated_pods(pod, node_name)
        return (
            node_name, nodes_to_victims[node_name].pods,
            nominated_to_clear, TIER_HOST,
        )

    def _lower_priority_nominated_pods(
        self, pod: Pod, node_name: str
    ) -> List[Pod]:
        """generic_scheduler.go:364."""
        if self.queue is None:
            return []
        nominated = self.queue.nominated_pods_for_node(node_name)
        return [p for p in nominated if p.spec.priority < pod.spec.priority]

    # -- batched entry (the BatchScheduler's NO_NODE group) ------------------

    def preempt_batch(
        self, prof, items: List[Tuple[Pod, FitError]]
    ) -> Tuple[List[str], List[str]]:
        """Preemption for a whole failed-pod group (priority-desc order)
        in ONE device round trip, then the per-pod API side effects in
        order. Every pod must already be device_eligible. Returns
        (nominated node per pod, evicted victim uids); "" = no
        nomination for that pod. The victim uids let the caller wait for
        the deletions to propagate into its cache before retrying the
        nominated node name per pod ("" = none)."""
        pods = []
        for pod, _ in items:
            if self.client is not None:
                try:
                    pod = self.client.get_pod(
                        pod.metadata.namespace, pod.metadata.name
                    )
                except KeyError:
                    pod = None
            pods.append(pod)
        pdbs = []
        if self.client is not None:
            try:
                pdbs, _ = self.client.list_pdbs()
            except Exception:
                logger.exception("listing PDBs")
        live: List[int] = []
        live_pods: List[Pod] = []
        potentials = []
        results = [""] * len(items)
        # identical failed pods share one statuses dict (the batch path
        # dedups reason maps per mask row), so a wave computes each
        # potential-node list ONCE instead of O(pods x nodes) times
        pot_cache: Dict[int, List] = {}
        for k, (item, pod) in enumerate(zip(items, pods)):
            if pod is None or pod.spec.node_name:
                # deleted, or a STALE failure record: the pod bound
                # since (its signature would poison the wave's shared
                # candidate row with a single-node mask)
                continue
            if not self.pod_eligible_to_preempt_others(pod):
                continue
            pot_key = id(item[1].filtered_nodes_statuses)
            potential = pot_cache.get(pot_key)
            if potential is None:
                potential = self.nodes_where_preemption_might_help(item[1])
                pot_cache[pot_key] = potential
            if not potential:
                # no node can ever help: clear any stale nomination (the
                # host path's to_clear=[pod] branch)
                metrics.preemption_attempts.inc()
                self._clear_nomination(pod)
                continue
            live.append(k)
            live_pods.append(pod)
            potentials.append(potential)
        if not live_pods:
            return results, []
        try:
            answers, tier = self._device_search(
                live_pods, potentials, pdbs
            )
        except LadderExhausted:
            # the CPU's device tier is down (breaker open / faults
            # exhausted the retries): the wave still completes on the
            # per-pod host oracle with the nomination fold through the
            # queue
            logger.warning(
                "preemption wave device tiers exhausted; running the "
                "host-oracle floor for %d pods", len(live_pods),
            )
            answers = self._host_wave_answers(
                prof,
                [(pod, items[k][1]) for k, pod in zip(live, live_pods)],
                pdbs,
            )
            tier = TIER_HOST
            self.host_preemptions += len(live_pods)
        else:
            if answers is None:
                # the card: the wave nominates no pod; the caller
                # requeues them and the next wave solves them on K3
                return results, []
            self.device_preemptions += len(live_pods)
        self.wave_solver_tier = tier
        self.waves += 1
        metrics.preemption_waves.inc()
        all_victims: Dict[str, Pod] = {}
        spent: Dict[str, Pod] = {}  # uid -> victim with a granted PDB unit
        for k, pod, (node_name, victims, _) in zip(
            live, live_pods, answers
        ):
            metrics.preemption_attempts.inc()
            if not node_name:
                continue
            if self.disruption is not None and victims:
                taken = self._charge_victims(
                    victims,
                    already_paid=all_victims.keys() | spent.keys(),
                )
                if taken is None:
                    # denied: skip the nomination (evicting a partial
                    # victim set frees too little for the preemptor to
                    # fit). The host-oracle floor pre-folds nominations
                    # into the queue so later wave pods see them -- a
                    # denied pod's fold must come OUT again or it
                    # stands as a phantom reservation (no-op on the
                    # device tiers, which nominate only in
                    # _apply_preemption below)
                    if self.queue is not None:
                        self.queue.delete_nominated_pod_if_exists(pod)
                    continue
                for g in taken:
                    spent[g.metadata.uid] = g
            if self._apply_preemption(
                prof, pod, node_name, victims,
                delete_victims=False, write_status=False,
            ) is not None:
                metrics.preemption_victims.observe(len(victims))
                results[k] = node_name
                for v in victims:
                    all_victims[v.metadata.uid] = v
            elif self.disruption is not None:
                # defensive: with write_status=False _apply_preemption
                # currently has no failing path, but any failure mode it
                # grows must give back grants no other successful
                # preemptor shares -- a silent budget leak here would
                # only surface as drains starving much later
                for v in victims:
                    uid = v.metadata.uid
                    if uid in spent and uid not in all_victims:
                        self.disruption.refund_disruption(spent.pop(uid))
        # one eviction transaction for the whole group (victims chosen
        # by several pods dedup by uid; deletion is idempotent)
        if all_victims:
            evicted_now = self._evict_victims(all_victims, tier)
            if evicted_now is None:
                # eviction failed: nominations stand but the cluster is
                # unchanged -- refund every grant this wave spent (the
                # budget must track what actually happened), and make
                # callers requeue WITH backoff (None sentinel), or the
                # nominees hot-loop a full wave + eviction attempt
                # against a persistent API failure
                if self.disruption is not None:
                    for v in spent.values():
                        self.disruption.refund_disruption(v)
                return results, None
            for v in all_victims.values():
                waiting = prof.get_waiting_pod(v.metadata.uid)
                if waiting is not None:
                    waiting.reject("preemption", "preempted")
            return results, evicted_now
        return results, []

    def _charge_victims(
        self, victims: List[Pod], already_paid=frozenset()
    ) -> Optional[List[Pod]]:
        """All-or-nothing spend of ONE preemptor's victim set through
        the shared can_disrupt gate: concurrent waves, drains, and
        taint evictions contend on the same counters, so a stale
        kernel answer can never overspend. Returns the newly granted
        victims, or None on deny -- with every grant this attempt took
        refunded (evicting a partial set would strand spent budget)
        and the denial counted. No denial memo across attempts: a
        failed preemptor's refund re-opens the budget, so a victim
        denied for pod A may legitimately be granted to pod B -- every
        check goes to the authoritative counter.

        ``already_paid``: victim uids an earlier successful preemptor
        in the same wave already spent for (shared victims dedup by
        uid; deletion is idempotent)."""
        taken: List[Pod] = []
        for v in victims:
            if v.metadata.uid in already_paid:
                continue
            if not self.disruption.can_disrupt(v):
                for g in taken:
                    self.disruption.refund_disruption(g)
                self.budget_denials += 1
                metrics.preemption_budget_denials.inc()
                return None
            taken.append(v)
        return taken

    def _evict_victims(
        self, all_victims: Dict[str, Pod], tier: str
    ) -> Optional[List[str]]:
        """One bulk eviction for a wave's deduplicated victims. Returns
        the uids whose delete landed PROMPTLY (the caller's
        cache-propagation wait list), or None on transaction failure
        (nothing was evicted; the caller refunds the budget).

        Victims the VICTIM_SLOW_DEATH fault selects die gracefully
        instead: marked terminating now (deletion_timestamp -- so
        pod_eligible_to_preempt_others sees a terminating victim and
        nominees re-arm instead of re-evicting) but holding capacity
        until the grace timeout delivers the real, uid-fenced delete.

        Victim counters book HERE, after the transaction: a wave
        aborted earlier (breaker, fence, denied budget, apply rollback)
        has booked nothing."""
        inj = get_injector()
        slow: List[Pod] = []
        prompt: List[Pod] = []
        for v in all_victims.values():
            if inj is not None and inj.should_fire(
                FaultPoint.VICTIM_SLOW_DEATH
            ):
                slow.append(v)
            else:
                prompt.append(v)
        evicted_prompt: List[Pod] = list(prompt)
        slow_started = 0
        if self.client is not None:
            if prompt:
                missing: List[Tuple[str, str]] = []
                try:
                    self.client.delete_pods_bulk(
                        [
                            (v.metadata.namespace, v.metadata.name)
                            for v in prompt
                        ],
                        missing_out=missing,
                    )
                except Exception:
                    # nominations stand (they self-heal on the pods'
                    # retries), but waiting victims must NOT be rejected
                    # for an eviction that never happened
                    logger.exception("bulk victim eviction")
                    return None
                if missing:
                    # a concurrent disruption path got there first: OUR
                    # grant evicted nothing for these -- refund and
                    # UN-BOOK them (the invariant every other eviction
                    # path holds: counters record what actually
                    # happened)
                    gone = set(missing)
                    evicted_prompt = []
                    for v in prompt:
                        key = (v.metadata.namespace, v.metadata.name)
                        if key in gone:
                            if self.disruption is not None:
                                self.disruption.refund_disruption(v)
                        else:
                            evicted_prompt.append(v)
            grace = 0.25
            if inj is not None:
                cfg = inj.point_config(FaultPoint.VICTIM_SLOW_DEATH)
                if cfg is not None and cfg.hang_seconds:
                    grace = cfg.hang_seconds
            for v in slow:
                if self._slow_death(v, grace):
                    slow_started += 1
                elif self.disruption is not None:
                    # already gone / name reclaimed: same refund as the
                    # prompt path's missing report
                    self.disruption.refund_disruption(v)
        else:
            slow_started = len(slow)
        n = len(evicted_prompt) + slow_started
        if n:
            metrics.victims_selected.inc(n, tier=tier)
            self.victims_by_tier[tier] = (
                self.victims_by_tier.get(tier, 0) + n
            )
        self.victims_slow_death += slow_started
        return [v.metadata.uid for v in evicted_prompt]

    def _slow_death(self, victim: Pod, grace: float) -> bool:
        """Graceful eviction under the VICTIM_SLOW_DEATH fault: mark the
        pod terminating NOW, deliver the real delete after ``grace``
        seconds. Both the mark and the delayed delete are uid-FENCED --
        a respawned incarnation that reclaimed the name is neither
        stamped terminating nor killed by the old timer, which is what
        keeps eviction exactly-once per pod incarnation under chaos.
        Returns False when the victim was ALREADY gone (the caller
        refunds its grant and un-books it, like the prompt path's
        missing report)."""
        ns = victim.metadata.namespace
        name = victim.metadata.name
        uid = victim.metadata.uid
        marked = {}

        def mark(p: Pod) -> None:
            if p.metadata.uid != uid:
                return  # a fresh incarnation took the name: not ours
            marked["ok"] = True
            if p.metadata.deletion_timestamp is None:
                p.metadata.deletion_timestamp = time.time()

        try:
            self.client.server.guaranteed_update("Pod", ns, name, mark)
        except KeyError:
            return False  # already gone: nothing was evicted
        except Exception:
            logger.exception("marking slow-death victim %s/%s", ns, name)
        if not marked.get("ok"):
            return False  # name reclaimed by a new incarnation

        def finish() -> None:
            # uid-PRECONDITIONED delete, checked atomically under the
            # apiserver store lock: a read-then-delete would race a
            # concurrent evict+respawn and kill the fresh incarnation
            from kubernetes_tpu_torch.apiserver.server import Conflict

            try:
                self.client.server.delete(
                    "Pod", ns, name, expect_uid=uid
                )
            except KeyError:
                pass  # already gone
            except Conflict:
                pass  # a fresh incarnation took the name: never kill it
            except Exception:
                logger.exception("slow-death delete for %s/%s", ns, name)

        t = threading.Timer(grace, finish)
        t.daemon = True
        t.start()
        return True

    def _host_wave_answers(
        self, prof, live_items: List[Tuple[Pod, FitError]], pdbs
    ) -> List[Tuple[str, List[Pod], int]]:
        """The wave floor: the per-pod host oracle run in wave order
        with the nomination fold through the QUEUE -- each pod's filter
        pass virtually adds every earlier pod via _add_nominated_pods
        (generic_scheduler.go:535), the same view the device kernel's
        carry provides. Only reached when both device tiers are down."""
        from kubernetes_tpu_torch.scheduler.generic import SNAPSHOT_STATE_KEY

        out: List[Tuple[str, List[Pod], int]] = []
        snapshot = self.algorithm.snapshot
        for pod, fit_err in live_items:
            state = CycleState()
            state.write(SNAPSHOT_STATE_KEY, snapshot)
            try:
                prof.run_pre_filter_plugins(state, pod)
            except Exception:
                logger.exception("host wave prefilter for %s", pod.key())
                out.append(("", [], 0))
                continue
            potential = self.nodes_where_preemption_might_help(fit_err)
            nodes_to_victims: Dict[str, Victims] = {}
            for ni in potential:
                victims, num_violating, fits = self.select_victims_on_node(
                    prof, state, pod, ni, pdbs
                )
                if fits:
                    nodes_to_victims[ni.node_name] = Victims(
                        victims, num_violating
                    )
            node_name = pick_one_node_for_preemption(nodes_to_victims)
            if node_name is None:
                out.append(("", [], 0))
                continue
            chosen = nodes_to_victims[node_name]
            out.append((node_name, chosen.pods, chosen.num_pdb_violations))
            if self.queue is not None:
                # fold the nomination so later wave pods see it;
                # _apply_preemption re-installs it idempotently
                self.queue.update_nominated_pod_for_node(pod, node_name)
        return out

    # -- drain planning (NodeDrainer.drain_via_preemption) -------------------

    def plan_eligible(self, pod: Pod) -> bool:
        """True when the resource-fit + static-mask model answers
        replacement feasibility EXACTLY for this pod. The subset of
        device_eligible that needs no Framework at hand (drain planning
        runs outside a scheduling cycle); pods that fail it take the
        classic unconditional eviction path."""
        from kubernetes_tpu_torch.api.types import POD_GROUP_LABEL
        from kubernetes_tpu_torch.scheduler.batch import solver_supported

        if not solver_supported(pod):
            return False
        if any(v.pvc_claim_name for v in pod.spec.volumes):
            return False
        if pod.spec.topology_spread_constraints:
            return False
        if pod_host_ports(pod):
            return False
        a = pod.spec.affinity
        if a is not None and (
            a.pod_affinity is not None or a.pod_anti_affinity is not None
        ):
            return False
        if pod.metadata.labels.get(POD_GROUP_LABEL):
            return False
        return True

    def plan_replacements(
        self, pods: List[Pod], exclude_nodes=()
    ) -> List[str]:
        """Drain planning: for each pod (usually residents of a cordoned
        node), a node it could re-place onto RIGHT NOW with free
        capacity, "" = nowhere -- through the SAME victim search as a
        wave (on the card one K3 launch, run through the ``cuda`` tier
        alone like a wave: a fault raises). The wave priority is clamped
        below every real priority so no victim is ever eligible: a drain
        plan answers "where does this pod go without cascading more
        evictions", which degenerates the victim search into pure fit +
        the nomination carry (each planned pod's claim is visible to the
        next pod in the plan).

        ``exclude_nodes`` is masked out of every candidate row -- the
        drained node must never answer for its own pods even when the
        snapshot has not yet observed its cordon (the unschedulable flag
        lands with the next dispatch's snapshot update; the plan cannot
        wait for it). No queue or API side effects -- this is a plan,
        not a nomination."""
        if not pods:
            return []
        from kubernetes_tpu_torch.ops.affinity import (
            cluster_has_required_anti_affinity,
        )
        from kubernetes_tpu_torch.robustness.lifecycle import respawn_clone

        # plan against CURRENT cache truth through the private snapshot:
        # the algorithm's snapshot is pre-batch (it lags the newest
        # commits by one dispatch and an idle scheduler never refreshes
        # it), and a drain plan made against yesterday's free capacity
        # evicts pods whose destination is already taken
        cache = getattr(self.algorithm, "cache", None)
        if cache is not None:
            if self._plan_snapshot is None:
                from kubernetes_tpu_torch.cache.snapshot import Snapshot

                self._plan_snapshot = Snapshot()
            snapshot = cache.update_snapshot(self._plan_snapshot)
        else:
            snapshot = self.algorithm.snapshot
        if cluster_has_required_anti_affinity(snapshot):
            # an existing pod's required anti-affinity makes the fit
            # model inexact for EVERY destination: no plan
            return [""] * len(pods)
        exclude = set(exclude_nodes)
        live = [
            ni for ni in snapshot.list_node_infos()
            if ni.node is not None and ni.node_name not in exclude
        ]
        # plan the pod's POST-EVICTION incarnation: a pending respawn
        # clone. Planning the bound pod itself would let the NodeName
        # model pin its static mask to the very node being drained.
        clones = [respawn_clone(p) for p in pods]
        potentials = [live] * len(clones)
        answers, _tier = self._device_answers(
            clones, potentials, [], prio_override=_PLAN_PRIO,
            snapshot=snapshot,
        )
        return [node_name for node_name, _v, _nv in answers]

    def _clear_nomination(self, pod: Pod) -> None:
        self.queue.delete_nominated_pod_if_exists(pod)
        if self.client is not None and pod.status.nominated_node_name:
            try:
                def clear(q: Pod) -> None:
                    q.status.nominated_node_name = ""

                self.client.update_pod_status(
                    pod.metadata.namespace, pod.metadata.name, clear
                )
            except Exception:
                logger.exception("clearing nominatedNodeName")

    def _apply_preemption(
        self,
        prof,
        pod: Pod,
        node_name: str,
        victims: List[Pod],
        delete_victims: bool = True,
        write_status: bool = True,
    ) -> Optional[int]:
        """The API side effects of one successful preemption
        (scheduler.go:392): nominate, delete victims, clear superseded
        lower-priority nominations. Returns the number of victims whose
        delete actually LANDED (so the caller books evictions, not
        proposals; with ``delete_victims=False`` that is len(victims) --
        the deferred bulk eviction does its own booking), or None when
        the nomination write failed and was rolled back (no victims
        were evicted) -- callers must then report no nomination.
        ``delete_victims=False``
        lets preempt_batch evict the whole group's victims in one
        transaction afterwards. ``write_status=False`` skips the API
        nominatedNodeName write: the batched path defers it to
        record_scheduling_failure's condition write, which happens
        immediately after the pod is requeued -- the watch ECHO of a
        status write arrives as a pod update, and an update for a pod
        that is in no queue re-adds it to the activeQ
        (scheduling_queue.update), so a write issued while the pod is
        still parked for the wave creates a DUPLICATE scheduling of the
        same pod (phantom demand, cascading over-eviction)."""
        self.queue.update_nominated_pod_for_node(pod, node_name)
        if self.client is not None and write_status:
            try:
                def set_nominated(p: Pod) -> None:
                    p.status.nominated_node_name = node_name

                self.client.update_pod_status(
                    pod.metadata.namespace, pod.metadata.name, set_nominated
                )
            except Exception:
                logger.exception("setting nominatedNodeName")
                self.queue.delete_nominated_pod_if_exists(pod)
                return None
        evicted = 0
        for victim in victims:
            recorder = getattr(prof, "recorder", None)
            if recorder is not None:
                recorder.eventf(
                    victim, "Normal", "Preempted",
                    f"Preempted by {pod.metadata.namespace}/"
                    f"{pod.metadata.name} on node {node_name}",
                )
            if not delete_victims:
                evicted += 1  # deferred bulk eviction books for itself
                continue
            if self.client is not None:
                try:
                    self.client.delete_pod(
                        victim.metadata.namespace, victim.metadata.name
                    )
                    evicted += 1
                except KeyError:
                    # already gone: a concurrent disruption path got
                    # there first, so OUR spent grant evicted nothing
                    if self.disruption is not None:
                        self.disruption.refund_disruption(victim)
            else:
                evicted += 1
            waiting = prof.get_waiting_pod(victim.metadata.uid)
            if waiting is not None:
                waiting.reject("preemption", "preempted")
        for p in self._lower_priority_nominated_pods(pod, node_name):
            self.queue.delete_nominated_pod_if_exists(p)
            if self.client is not None and p.status.nominated_node_name:
                try:
                    def clear(q: Pod) -> None:
                        q.status.nominated_node_name = ""

                    self.client.update_pod_status(
                        p.metadata.namespace, p.metadata.name, clear
                    )
                except Exception:
                    logger.exception("clearing nominatedNodeName")
        return evicted

    # -- host-side actions (scheduler.go:392) --------------------------------

    def preempt(
        self, prof, state: CycleState, pod: Pod, fit_err: FitError
    ) -> str:
        if self.client is not None:
            try:
                pod = self.client.get_pod(
                    pod.metadata.namespace, pod.metadata.name
                )
            except KeyError:
                return ""
        node_name, victims, to_clear, tier = self.find_preemption(
            prof, state, pod, fit_err
        )
        metrics.preemption_attempts.inc()
        if node_name:
            if self.disruption is not None and victims:
                # the sequential path spends the same shared PDB budget
                # as the wave, drains, and taint evictions
                if self._charge_victims(victims) is None:
                    return ""
            metrics.preemption_victims.observe(len(victims))
            evicted = self._apply_preemption(prof, pod, node_name, victims)
            if evicted is None:
                if self.disruption is not None:
                    for v in victims:
                        self.disruption.refund_disruption(v)
                return ""  # nomination write failed and was rolled back
            if evicted:
                # book what actually happened: victims whose delete
                # raced a concurrent eviction were refunded, not evicted
                metrics.victims_selected.inc(evicted, tier=tier)
                self.victims_by_tier[tier] = (
                    self.victims_by_tier.get(tier, 0) + evicted
                )
            return node_name
        # no candidate: clear any stale nomination of the pod itself
        for p in to_clear:
            self._clear_nomination(p)
        return node_name
