"""Preemption: evict lower-priority pods to make room for a pending pod.

Reference: /root/reference/pkg/scheduler/core/generic_scheduler.go
(Preempt :270, selectNodesForPreemption :850, selectVictimsOnNode :940,
filterPodsWithPDBViolation :884, pickOneNodeForPreemption :721,
nodesWherePreemptionMightHelp :1033, podEligibleToPreemptOthers :1054)
and pkg/scheduler/scheduler.go:392 (sched.preempt host-side actions), with
MoreImportantPod/GetPodStartTime from pkg/scheduler/util/utils.go:38-83.

In this port only the host victim search runs: the device victim search
(the JAX package's preemption wave and its Pallas kernel) is not ported
yet, so ``device_eligible`` answers False and every preemption -- the
batch path's failed group included -- takes the host oracle.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.selectors import labels_match_selector
from kubernetes_tpu_torch.api.types import Pod, PodDisruptionBudget
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    FitError,
    StatusCode,
)
from kubernetes_tpu_torch.robustness.faults import FaultPoint, get_injector
from kubernetes_tpu_torch.robustness.ladder import (
    LadderExhausted,
    SolverLadder,
)
from kubernetes_tpu_torch.utils import metrics

logger = logging.getLogger(__name__)

_MAX_INT32 = (1 << 31) - 1
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
        self, algorithm, queue, client, disruption=None, ladder=None
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
        # the wave's solver ladder: its device tiers wait for the ported
        # victim search, so every wave takes the per-pod host oracle.
        # Own instance by default so wave faults never poison the batch
        # solver's breakers; new_scheduler mirrors the batch robustness
        # config in.
        self.ladder = ladder if ladder is not None else SolverLadder()
        self.device_preemptions = 0
        self.host_preemptions = 0
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
        """True when the device victim search answers for this pod. The
        device search is not ported yet (ROADMAP Queue 2, K3), so no pod
        is eligible and every preemption takes the host oracle."""
        return False

    def _device_answers(
        self, pods: List[Pod], potentials, pdbs, prio_override=None,
        snapshot=None,
    ) -> Tuple[List[Tuple[str, List[Pod], int]], str]:
        """The device victim search is not ported yet: raising
        LadderExhausted sends every caller to the host oracle."""
        raise LadderExhausted(
            "the device victim search arrives in a later slice of the port"
        )

    def prewarm_pack_async(self, adims=None) -> None:
        """No device victim pack to prewarm until the device victim
        search is ported."""

    def _find_preemption_device(
        self, pod: Pod, potential, pdbs
    ) -> Tuple[Optional[Tuple[str, List[Pod], int]], str]:
        """Single-pod wrapper over the batched device search: returns
        (answer, tier). Raises LadderExhausted when both device tiers
        are down; the caller falls to the host oracle."""
        answers, tier = self._device_answers([pod], [potential], pdbs)
        return answers[0], tier

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
                # both device tiers down: the host oracle below is the
                # wave floor (counted as a host preemption)
                logger.warning(
                    "device preemption tiers exhausted for %s; "
                    "falling to the host oracle", pod.key(),
                )
                result = None
            if result is not None:
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
            answers, tier = self._device_answers(
                live_pods, potentials, pdbs
            )
            self.device_preemptions += len(live_pods)
        except LadderExhausted:
            # both device tiers down (breakers open / faults exhausted
            # the retries): the wave still completes on the per-pod host
            # oracle with the nomination fold through the queue
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
