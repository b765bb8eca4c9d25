"""Scheduler: the scheduleOne control loop and its wiring.

Reference: /root/reference/pkg/scheduler/scheduler.go (Scheduler struct :79,
New :223, Run :363, scheduleOne :548, assume :474, bind :496,
recordSchedulingFailure :375) and pkg/scheduler/profile/profile.go.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional


from kubernetes_tpu_torch.api.types import Pod, PodCondition
from kubernetes_tpu_torch.cache.cache import SchedulerCache
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.config.types import KubeSchedulerProfile, Plugins
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    FitError,
    PodInfo,
    Status,
    StatusCode,
)
from kubernetes_tpu_torch.framework.registry import Registry
from kubernetes_tpu_torch.framework.runtime import Framework
from kubernetes_tpu_torch.plugins import new_in_tree_registry
from kubernetes_tpu_torch.queue.scheduling_queue import PriorityQueue
from kubernetes_tpu_torch.robustness.circuit import RetryPolicy
from kubernetes_tpu_torch.robustness.faults import (
    FaultPoint,
    SchedulerCrashed,
    get_injector,
    poison_raise_maybe,
)
from kubernetes_tpu_torch.robustness.ladder import CardFault
from kubernetes_tpu_torch.scheduler.generic import GenericScheduler
from kubernetes_tpu_torch.scheduler.provider import default_plugins
from kubernetes_tpu_torch.utils import flightrecorder, metrics

logger = logging.getLogger(__name__)


class Scheduler:
    def __init__(
        self,
        cache: SchedulerCache,
        queue: PriorityQueue,
        algorithm: GenericScheduler,
        profiles: Dict[str, Framework],
        client: Optional[Client] = None,
        preemptor=None,
        async_binding: bool = True,
        bind_workers: int = 16,
    ) -> None:
        self.cache = cache
        self.queue = queue
        self.algorithm = algorithm
        self.profiles = profiles
        self.client = client
        self.preemptor = preemptor  # set by stage-7 wiring
        self.async_binding = async_binding
        self._bind_pool = (
            ThreadPoolExecutor(max_workers=bind_workers, thread_name_prefix="bind")
            if async_binding
            else None
        )
        self._stop = threading.Event()
        self._inflight_binds = 0
        self._inflight_lock = threading.Condition()
        # bind/commit retry policy (robustness/): transient API failures
        # retry with backoff before the terminal failure path (which
        # guarantees forget + Unreserve + requeue)
        self.bind_retry_policy = RetryPolicy()
        self._retry_sleep = time.sleep
        # commit-time lease fencing (PR-2 HA): when set (SchedulerApp
        # wires LeaderElector.holds_lease), every commit verifies lease
        # ownership immediately before binding and aborts + requeues when
        # deposed -- two live schedulers can never double-bind
        self.fencing_check: Optional[Callable[[], bool]] = None
        # set when an injected crash_between_assume_and_bind fired: the
        # process is "dead" -- the loop halts and NO cleanup runs
        self.crashed = False
        # set while a batch run loop is up: it lands its in-flight batches
        # after a stop (their commits still go through the bind pool and
        # the fence), so the loop, not stop(), shuts the pool down
        self._loop_lands_inflight = False
        # multi-active partitioned scheduling (scheduler/partition.py):
        # when a coordinator is attached this stack owns a node-space
        # slice; event handlers, recovery sweeps, pop-time skips, and
        # commit fencing all consult it
        self.partition_coordinator = None
        # the conflict ledger: every typed bind conflict the committer
        # absorbs lands in exactly one disposition bucket --
        # requeued-for-retry or satisfied-elsewhere (the pod turned out
        # bound already). The tier-1 guard pins
        # absorbed == requeues + stale, so no conflict is silently lost.
        self.bind_conflicts_absorbed = 0
        self.conflict_requeues = 0
        self.conflict_stale_binds = 0
        # pods re-stamped and forwarded to a sibling partition because
        # their feasible nodes all live there
        self.pods_spilled = 0
        # -- multi-tenant fairness plane (scheduler/tenancy.py) ----------
        # the ResourceQuota admission gate (controllers/quota.py): when
        # attached, every popped pod charges its namespace ledger before
        # entering an attempt; exhausted namespaces park their pods
        # typed-QuotaExceeded. None = plane off (one is-None check).
        self.quota = None
        # the DRF dominant-share tracker: maintained from the bind
        # echoes (eventhandlers), consumed by the batched solve order
        self.tenant_shares = None
        self.quota_denials = 0
        # bind-ack ledger (scheduler/bindack.py): when attached, every
        # committed bind is pending until the node's Running ack arrives
        # over the watch; overdue pods are unbound back to the queue
        # (exactly once per incarnation). None = bind-and-forget.
        self.bind_ack_tracker = None
        # on the card a fault of the device path (a K3 victim search on
        # the per-pod path here; a failed batch completion in the batch
        # scheduler) is not retried behind the kernel's back: the error
        # is kept here and the scheduler stops (_halt_on_card_fault)
        self.card_fault: Optional[BaseException] = None

    # -- profile lookup (scheduler.go:741 profileForPod) --------------------

    def profile_for_pod(self, pod: Pod) -> Framework:
        prof = self.profiles.get(pod.spec.scheduler_name)
        if prof is None:
            raise KeyError(
                f"profile not found for scheduler name "
                f"{pod.spec.scheduler_name!r}"
            )
        return prof

    def _skip_pod_schedule(self, pod: Pod) -> bool:
        """scheduler.go:750 skipPodSchedule: deleting or already assumed.
        Also skips pods already CONFIRMED in the cache: a stale watch
        event (e.g. a pre-bind annotation write) can re-queue a pod that
        bound moments ago, and re-attempting it double-places it or --
        worse -- runs its failure/Unreserve path against the live
        placement's durable state."""
        if pod.metadata.deletion_timestamp is not None:
            return True
        if self.cache.is_assumed_pod(pod):
            return True
        if self.cache.has_pod_uid(pod.metadata.uid):
            return True
        coord = self.partition_coordinator
        if coord is not None and not coord.wants_pod(pod):
            # partitioned: the pod's home partition moved (spill
            # re-stamp, partition handoff) while it sat in our queue --
            # its new home stack schedules it
            return True
        return False

    # -- failure path (scheduler.go:375 recordSchedulingFailure) ------------

    def record_scheduling_failure(
        self,
        prof: Framework,
        pod_info: PodInfo,
        err_msg: str,
        reason: str,
        nominated_node: str,
        pod_scheduling_cycle: int,
        skip_backoff: bool = False,
    ) -> None:
        """``skip_backoff``: requeue straight to the activeQ -- used by
        the batched preemption path for pods whose failure was just
        resolved by the wave's own evictions (backoff exists to damp
        retries against a persistent failure, which this is not; the
        reference pays its 1s initial backoff here, scheduling_queue.go
        :643, purely because its preemption is asynchronous)."""
        pod = pod_info.pod
        # a requeued pod releases its in-flight quota charge (it
        # re-charges at its next pop): ``used`` stays bound + in-flight,
        # and the refund's headroom event may wake quota-parked peers
        self._quota_refund(pod, "requeue")
        prof.recorder.eventf(
            pod, "Warning", "FailedScheduling", err_msg
        )  # scheduler.go:378
        try:
            self.queue.add_unschedulable_if_not_present(
                pod_info, pod_scheduling_cycle, skip_backoff=skip_backoff
            )
        except KeyError:
            pass  # already requeued via an informer update
        if nominated_node:
            self.queue.update_nominated_pod_for_node(pod, nominated_node)
        if self.client is not None:
            try:
                def set_condition(p: Pod) -> None:
                    p.status.conditions = [
                        c for c in p.status.conditions if c.type != "PodScheduled"
                    ] + [
                        PodCondition(
                            type="PodScheduled",
                            status="False",
                            reason=reason,
                            message=err_msg,
                        )
                    ]
                    if nominated_node:
                        p.status.nominated_node_name = nominated_node

                self.client.update_pod_status(
                    pod.metadata.namespace, pod.metadata.name, set_condition
                )
            except Exception:
                logger.exception("updating pod condition for %s", pod.key())

    # -- multi-tenant quota gate (controllers/quota.py) ----------------------

    def _quota_refund(self, pod: Pod, reason: str) -> None:
        """Give back the pod's quota charge (no-op when the plane is
        off or the pod holds none); never raises -- a failed refund is
        parked on the controller's retry list, not lost."""
        qc = self.quota
        if qc is None:
            return
        try:
            qc.refund(pod, reason=reason)
        except Exception:
            logger.exception("quota refund for %s", pod.key())

    def _quota_admit(self, pod_info, pod_scheduling_cycle: int) -> bool:
        """The hard-quota admission gate, run once per popped pod when
        the plane is armed (callers check ``self.quota`` first, so the
        off state costs one is-None read). Granted pods proceed
        charged; exhausted namespaces park the pod typed-QuotaExceeded
        (released by quota/usage EVENTS, never polled). A transport
        failure fails CLOSED onto the backoff clock -- parking without
        a wake event would strand the pod."""
        qc = self.quota
        pod = pod_info.pod
        try:
            denial = qc.try_admit(pod)
        except Exception:  # noqa: BLE001 - injected api_unavailable etc.
            logger.exception("quota admission for %s", pod.key())
            prof = self.profiles.get(pod.spec.scheduler_name)
            if prof is not None:
                self.record_scheduling_failure(
                    prof, pod_info,
                    "quota admission check unavailable; retrying",
                    "QuotaError", "", pod_scheduling_cycle,
                )
            return False
        if not denial:
            return True
        self.quota_denials += 1
        self.queue.park_quota_exceeded(pod_info)
        qc.note_parked(pod, denial)
        prof = self.profiles.get(pod.spec.scheduler_name)
        if prof is not None:
            try:
                prof.recorder.eventf(
                    pod, "Warning", "FailedScheduling", denial
                )
            except Exception:  # noqa: BLE001 - events are best-effort
                pass
        return False

    # -- tenant dominant-share bookkeeping (scheduler/tenancy.py) ------------

    def note_pods_bound(self, pods: List[Pod]) -> None:
        """Bind echoes from the informer frames: the DRF tracker's
        incremental ``used`` update (covers our commits, sibling-stack
        commits, and the startup relist alike)."""
        tt = self.tenant_shares
        if tt is not None:
            tt.note_bound(pods)

    def note_pods_unbound(self, pods: List[Pod]) -> None:
        tt = self.tenant_shares
        if tt is not None:
            tt.note_unbound(pods)

    def note_node_capacity(self, node) -> None:
        """Node informer feed, ungated by partition ownership: the DRF
        capacity denominator stays cluster-wide in multi-active mode
        (ISSUE 18, residual 7(a))."""
        tt = self.tenant_shares
        if tt is not None:
            tt.note_node_capacity(node)

    def note_node_gone(self, name: str) -> None:
        tt = self.tenant_shares
        if tt is not None:
            tt.note_node_gone(name)

    # -- assume (scheduler.go:474) ------------------------------------------

    def assume(self, assumed: Pod, host: str) -> None:
        assumed.spec.node_name = host
        self.cache.assume_pod(assumed)
        self.queue.delete_nominated_pod_if_exists(assumed)

    # -- bind (scheduler.go:496) --------------------------------------------

    def _fence_ok(self) -> bool:
        """True when this scheduler may commit (no fencing configured, or
        the lease is verifiably still held). A False answer means the
        caller must abort the commit; the normal failure path then
        guarantees forget + Unreserve + requeue, and the pods land on
        whoever holds the lease now (their informers already queue
        them)."""
        check = self.fencing_check
        if check is None:
            return True
        try:
            return bool(check())
        except Exception:  # noqa: BLE001 - can't prove ownership: fence
            logger.exception("fencing check failed; aborting commit")
            return False

    def bind(
        self, prof: Framework, state: CycleState, assumed: Pod, host: str
    ) -> Optional[Status]:
        if not self._fence_ok():
            metrics.fencing_aborts.inc()
            flightrecorder.mark(
                "fencing_abort", pods=1, pod=assumed.metadata.uid
            )
            return Status.error(
                "lease lost before bind; commit fenced"
            )
        coord = self.partition_coordinator
        if coord is not None and not coord.may_bind(host):
            # partitioned commit fence on the per-pod path (Permit
            # waiters, custom binds): same fresh-probe rule as the bulk
            # committer; the binding cycle's failure path guarantees
            # forget + Unreserve + requeue
            metrics.fencing_aborts.inc()
            flightrecorder.mark(
                "fencing_abort", pods=1, pod=assumed.metadata.uid,
                fence="partition",
            )
            return Status.error(
                f"partition of node {host} not held at bind; fenced"
            )
        for extender in self.algorithm.extenders:
            if extender.is_binder() and extender.is_interested(assumed):
                try:
                    extender.bind(assumed, host)
                    self.cache.finish_binding(assumed)
                    return None
                except Exception as e:
                    return Status.error(str(e))
        status = self._bind_with_retry(prof, state, assumed, host)
        self.cache.finish_binding(assumed)
        if status is not None and status.code == StatusCode.SKIP:
            return Status.error("no bind plugin handled the pod")
        return status

    def _bind_with_retry(
        self, prof: Framework, state: CycleState, assumed: Pod, host: str
    ) -> Optional[Status]:
        """The bind plugins with retry-with-exponential-backoff around
        transient failures (API conflict/unavailable, injected
        bind_conflict). A terminal failure returns the error status; the
        binding cycle's existing failure path then guarantees forget +
        Unreserve + requeue -- a bind failure never strands a pod
        assumed-forever."""
        policy = self.bind_retry_policy
        attempt = 0
        while True:
            attempt += 1
            try:
                inj = get_injector()
                if inj is not None:
                    inj.raise_maybe(FaultPoint.BIND_CONFLICT)
                return prof.run_bind_plugins(state, assumed, host)
            except Exception as e:  # noqa: BLE001 - bind transport error
                # max_attempts counts TOTAL attempts (same semantics as
                # the solve ladder's in-place retries)
                if attempt >= max(1, policy.max_attempts):
                    return Status.error(
                        f"bind failed after {attempt} attempts: {e}"
                    )
                metrics.bind_retries.inc()
                self._retry_sleep(policy.backoff_for_attempt(attempt))

    # -- the loop -----------------------------------------------------------

    def schedule_one(self, timeout: Optional[float] = None) -> bool:
        """One iteration (scheduler.go:548). Returns False if no pod was
        popped (timeout/closed)."""
        pod_info = self.queue.pop(timeout=timeout)
        if pod_info is None:
            return False
        # skip-worthy pods (deleting / assumed / re-homed) must not
        # charge quota: attempt_schedule would drop them without a
        # failure path, so a charge here would never refund
        if self.quota is not None and not self._skip_pod_schedule(
            pod_info.pod
        ) and not self._quota_admit(
            pod_info, self.queue.scheduling_cycle
        ):
            return True  # parked typed-QuotaExceeded (or backoff-retried)
        self.attempt_schedule(pod_info)
        return True

    def handle_fit_error(
        self,
        prof: Framework,
        state: CycleState,
        pod_info: PodInfo,
        fit_err: FitError,
        pod_scheduling_cycle: int,
    ) -> None:
        """FitError branch of scheduleOne (scheduler.go:581-591):
        try preemption, then record the failure + nomination. In a
        partitioned stack, a pod that cannot place on OUR nodes spills
        to a sibling partition first -- its feasible nodes may simply
        live elsewhere; preemption and backoff apply only once every
        partition has had a look."""
        pod = pod_info.pod
        coord = self.partition_coordinator
        if coord is not None and coord.try_spill(pod):
            # re-homed to a sibling partition: ITS gate re-charges there
            self._quota_refund(pod, "spill")
            return
        nominated_node = ""
        if self.preemptor is not None:
            try:
                nominated_node = self.preemptor.preempt(
                    prof, state, pod, fit_err
                )
            except CardFault as e:
                # a fault of K3 on the per-pod path halts as a batch's
                # does; every other failure (an extender's preempt verb,
                # an API call) is logged and the pod requeued
                self._halt_on_card_fault(e)
                raise
            except Exception:
                logger.exception("preemption for %s failed", pod.key())
        self.record_scheduling_failure(
            prof,
            pod_info,
            str(fit_err),
            "Unschedulable",
            nominated_node,
            pod_scheduling_cycle,
        )

    def attempt_schedule(self, pod_info: PodInfo) -> None:
        """Scheduling cycle for one popped pod: the body of scheduleOne."""
        pod_scheduling_cycle = self.queue.scheduling_cycle
        pod = pod_info.pod
        try:
            prof = self.profile_for_pod(pod)
        except KeyError as e:
            logger.error("%s", e)
            return
        if self._skip_pod_schedule(pod):
            return

        state = CycleState()
        state.write("__cycle_start__", time.perf_counter())
        timer = metrics.SinceTimer(metrics.scheduling_algorithm_duration)
        try:
            # poison-pod seam (robustness/faults.py): the sequential
            # path reproduces the reference's failure economics -- a
            # malformed pod fails ALONE here (SchedulerError -> requeue
            # with backoff), while batched dispatch needs the bisection
            # containment to get the same per-pod blast radius
            poison_raise_maybe(pod)
            result = self.algorithm.schedule(prof, state, pod)
        except FitError as fit_err:
            metrics.schedule_attempts.inc(result="unschedulable")
            self.handle_fit_error(
                prof, state, pod_info, fit_err, pod_scheduling_cycle
            )
            return
        except Exception as e:
            metrics.schedule_attempts.inc(result="error")
            logger.exception("scheduling %s failed", pod.key())
            self.record_scheduling_failure(
                prof, pod_info, str(e), "SchedulerError", "", pod_scheduling_cycle
            )
            return
        finally:
            timer.observe()
        self.finish_schedule(
            prof, state, pod_info, result.suggested_host, pod_scheduling_cycle
        )

    def reserve_assume_permit(
        self,
        prof: Framework,
        state: CycleState,
        pod_info: PodInfo,
        host: str,
        pod_scheduling_cycle: int,
    ) -> Optional[Pod]:
        """First half of the post-decision pipeline (scheduler.go:615-660):
        Reserve -> assume -> Permit. Returns the assumed pod on success
        (possibly parked in the Permit waiting map), None after a recorded
        failure. Shared by the sequential path and the batch commit."""
        pod = pod_info.pod
        assumed = pod.assumed_clone()

        # Reserve
        status = prof.run_reserve_plugins(state, assumed, host)
        if status is not None and not status.is_success():
            self.record_scheduling_failure(
                prof, pod_info, status.message(), "SchedulerError", "",
                pod_scheduling_cycle,
            )
            return None

        # Assume: the pod occupies the node in cache from here on.
        try:
            self.assume(assumed, host)
        except Exception as e:
            prof.run_unreserve_plugins(state, assumed, host)
            self.record_scheduling_failure(
                prof, pod_info, str(e), "SchedulerError", "", pod_scheduling_cycle
            )
            return None

        # Permit
        status = prof.run_permit_plugins(state, assumed, host)
        if (
            status is not None
            and not status.is_success()
            and status.code != StatusCode.WAIT
        ):
            reason = (
                "Unschedulable" if status.is_unschedulable() else "SchedulerError"
            )
            self._forget(assumed)
            prof.run_unreserve_plugins(state, assumed, host)
            self.record_scheduling_failure(
                prof, pod_info, status.message(), reason, "", pod_scheduling_cycle
            )
            return None
        return assumed

    def finish_schedule(
        self,
        prof: Framework,
        state: CycleState,
        pod_info: PodInfo,
        host: str,
        pod_scheduling_cycle: int,
    ) -> None:
        """Post-decision pipeline (scheduler.go:615-738): Reserve ->
        assume -> Permit -> async binding cycle. Shared by the sequential
        path and the TPU batch solver (which replaces only the
        filter/score/select stage)."""
        assumed = self.reserve_assume_permit(
            prof, state, pod_info, host, pod_scheduling_cycle
        )
        if assumed is None:
            return

        # Binding cycle: async goroutine in the reference (scheduler.go:666).
        if self._bind_pool is not None:
            with self._inflight_lock:
                self._inflight_binds += 1
            self._bind_pool.submit(
                self._binding_cycle_safe,
                prof,
                state,
                pod_info,
                assumed,
                host,
                pod_scheduling_cycle,
            )
        else:
            self._binding_cycle(
                prof, state, pod_info, assumed, host, pod_scheduling_cycle
            )
        return

    def _binding_cycle_safe(self, *args) -> None:
        try:
            self._binding_cycle(*args)
        except SchedulerCrashed:
            self._simulate_crash()
        except Exception:
            logger.exception("binding cycle crashed")
        finally:
            with self._inflight_lock:
                self._inflight_binds -= 1
                self._inflight_lock.notify_all()

    def _halt_on_card_fault(self, err: BaseException) -> None:
        """A fault of the card's device path: keep the (first) error for
        the scheduler's owner and stop the scheduler, instead of
        requeueing the work to meet the same fault again."""
        if self.card_fault is None:
            logger.error("the device path failed on the card: %r", err)
            self.card_fault = err
        self._stop.set()

    def _simulate_crash(self) -> None:
        """The crash_between_assume_and_bind point fired: the process is
        dead from here. Halt the scheduling loop and run NO cleanup --
        the assumed pod stays assumed, nothing is requeued; recovery is
        the next incarnation's job (it relists, adopts bound pods, and
        requeues the in-flight ones)."""
        logger.error(
            "injected crash between assume and bind; halting scheduler "
            "with no cleanup"
        )
        self.crashed = True
        self._stop.set()

    def _binding_cycle(
        self,
        prof: Framework,
        state: CycleState,
        pod_info: PodInfo,
        assumed: Pod,
        host: str,
        pod_scheduling_cycle: int,
    ) -> None:
        """scheduler.go:666-738: WaitOnPermit -> PreBind -> bind -> PostBind."""
        status = prof.wait_on_permit(assumed)
        if status is not None and not status.is_success():
            reason = (
                "Unschedulable" if status.is_unschedulable() else "SchedulerError"
            )
            self._forget(assumed)
            prof.run_unreserve_plugins(state, assumed, host)
            self.record_scheduling_failure(
                prof, pod_info, status.message(), reason, "", pod_scheduling_cycle
            )
            return

        status = prof.run_pre_bind_plugins(state, assumed, host)
        if status is not None and not status.is_success():
            self._forget(assumed)
            prof.run_unreserve_plugins(state, assumed, host)
            self.record_scheduling_failure(
                prof, pod_info, status.message(), "SchedulerError", "",
                pod_scheduling_cycle,
            )
            return

        inj = get_injector()
        if inj is not None:
            # the pod is assumed but not yet bound: exactly the window a
            # process death strands (restart e2e drives this point)
            inj.crash_maybe(FaultPoint.CRASH_BETWEEN_ASSUME_AND_BIND)
        if self.crashed:
            return  # the process died meanwhile: no bind, no cleanup
        bind_timer = metrics.SinceTimer(metrics.binding_duration)
        status = self.bind(prof, state, assumed, host)
        bind_timer.observe()
        if status is not None and not status.is_success():
            metrics.schedule_attempts.inc(result="error")
            self._forget(assumed)
            prof.run_unreserve_plugins(state, assumed, host)
            self.record_scheduling_failure(
                prof, pod_info, status.message(), "SchedulerError", "",
                pod_scheduling_cycle,
            )
            return
        self._record_bind_success(prof, state, pod_info, assumed, host)

    def _record_bind_success(
        self,
        prof: Framework,
        state: CycleState,
        pod_info: PodInfo,
        assumed: Pod,
        host: str,
    ) -> None:
        prof.run_post_bind_plugins(state, assumed, host)
        prof.recorder.eventf(
            assumed, "Normal", "Scheduled",
            f"Successfully assigned "
            f"{assumed.metadata.namespace}/{assumed.metadata.name} to "
            f"{host}",
        )  # scheduler.go:544
        metrics.schedule_attempts.inc(result="scheduled")
        metrics.pod_scheduling_attempts.observe(pod_info.attempts)
        # PodInfo timestamps come from the queue's monotonic clock
        now = time.monotonic()
        if pod_info.initial_attempt_timestamp:
            duration = max(
                0.0, now - pod_info.initial_attempt_timestamp
            )
            metrics.pod_scheduling_duration.observe(duration)
            metrics.observe_pod_to_bind(duration)
        try:
            cycle_start = state.read("__cycle_start__")
        except KeyError:
            pass
        else:
            metrics.e2e_scheduling_duration.observe(
                max(0.0, time.perf_counter() - cycle_start)
            )

    def _forget(self, assumed: Pod) -> None:
        try:
            self.cache.forget_pod(assumed)
        except Exception:
            logger.exception("forgetting pod %s", assumed.key())

    def wait_for_inflight_binds(self, timeout: float = 30.0) -> bool:
        """Test/bench helper: block until async binding cycles drain."""
        deadline = time.monotonic() + timeout
        with self._inflight_lock:
            while self._inflight_binds > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._inflight_lock.wait(remaining)
        return True

    def run(self) -> None:
        """Blocking loop (scheduler.go:363)."""
        self.queue.run()
        while not self._stop.is_set():
            self.schedule_one(timeout=0.5)

    def start(self) -> threading.Thread:
        t = threading.Thread(target=self.run, name="scheduler", daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        self.queue.close()
        if self.bind_ack_tracker is not None:
            self.bind_ack_tracker.stop()
        broadcaster = getattr(self, "event_broadcaster", None)
        if broadcaster is not None:
            # let in-flight binding cycles record their events before the
            # broadcaster drains and exits (bounded: shutdown must not
            # hang on a stuck bind)
            self.wait_for_inflight_binds(timeout=5.0)
        if self._bind_pool is not None and not self._loop_lands_inflight:
            self._bind_pool.shutdown(wait=False)
        if broadcaster is not None:
            broadcaster.stop()


def new_scheduler(
    client: Client,
    informer_factory: InformerFactory,
    profiles: Optional[List[KubeSchedulerProfile]] = None,
    out_of_tree_registry: Optional[Registry] = None,
    percentage_of_nodes_to_score: int = 0,
    async_binding: bool = True,
    cache_ttl_seconds: float = 30.0,
    rng=None,
    batch: bool = False,
    max_batch: int = 256,
    solver_config=None,
    solver_mode: str = "greedy",
    mesh=None,
    extenders: Optional[List] = None,
    robustness_config=None,
    containment_config=None,
    bind_ack_config=None,
    device=None,
) -> Scheduler:
    """Build a fully wired scheduler (reference scheduler.go:223 New +
    factory.go create). ``batch=True`` selects the batch-solver loop,
    whose solve runs on ``device``: the card (``"cuda"``) unless the
    caller names the CPU. With no visible card the default raises.
    ``mesh`` (an ``ops.mesh.NodeMesh``) shards the batch solve's node
    state over its devices; the scheduler's device is then the mesh's
    first, where the preemption wave runs too."""
    from kubernetes_tpu_torch.ops.mesh import solve_device

    device = solve_device(device, mesh)
    registry = new_in_tree_registry()
    registry.merge(out_of_tree_registry)

    if not profiles:
        profiles = [KubeSchedulerProfile()]

    cache = SchedulerCache(ttl_seconds=cache_ttl_seconds)
    snapshot = Snapshot()

    frameworks: Dict[str, Framework] = {}
    built_extenders = []
    for ext in extenders or []:
        if hasattr(ext, "url_prefix"):  # ExtenderConfig -> HTTPExtender
            from kubernetes_tpu_torch.scheduler.extender import HTTPExtender

            built_extenders.append(HTTPExtender(ext))
        else:
            built_extenders.append(ext)

    algorithm = GenericScheduler(
        cache,
        snapshot,
        percentage_of_nodes_to_score=percentage_of_nodes_to_score,
        rng=rng,
        extenders=built_extenders,
    )
    from kubernetes_tpu_torch.scheduler.metrics_recorder import MetricsRecorder
    from kubernetes_tpu_torch.utils.event_recorder import EventBroadcaster

    recorder = MetricsRecorder()
    broadcaster = (
        EventBroadcaster(client.server) if client is not None else None
    )
    for profile_cfg in profiles:
        plugins = default_plugins()
        # prune defaults to registered plugins so the provider list can name
        # plugins that land in later stages
        plugins = _prune_unregistered(plugins, registry)
        plugins = plugins.apply(profile_cfg.plugins)
        fw = Framework(
            registry,
            plugins,
            plugin_config=profile_cfg.plugin_config,
            client=client,
            snapshot_provider=lambda: snapshot,
            informers=informer_factory,
            metrics_recorder=recorder,
            # per-profile recorder, source = schedulerName (profile.go:39)
            recorder=(
                broadcaster.new_recorder(profile_cfg.scheduler_name)
                if broadcaster is not None
                else None
            ),
        )
        frameworks[profile_cfg.scheduler_name] = fw

    first_fw = next(iter(frameworks.values()))
    queue = PriorityQueue(
        first_fw.queue_sort_less_func(),
        sort_key_func=first_fw.queue_sort_key_func(),
    )
    algorithm.nominated_pods_lister = queue

    if batch:
        from kubernetes_tpu_torch.ops.assignment import GreedyConfig
        from kubernetes_tpu_torch.scheduler.batch import BatchScheduler

        sched: Scheduler = BatchScheduler(
            cache,
            queue,
            algorithm,
            frameworks,
            client=client,
            async_binding=async_binding,
            max_batch=max_batch,
            solver_config=solver_config or GreedyConfig(),
            solver_mode=solver_mode,
            mesh=mesh,
            robustness_config=robustness_config,
            containment_config=containment_config,
            device=device,
        )
    else:
        sched = Scheduler(
            cache,
            queue,
            algorithm,
            frameworks,
            client=client,
            async_binding=async_binding,
        )
        if robustness_config is not None:
            # the sequential path has no ladder, but its bind retries
            # must still honor the configured policy (the batch path
            # inherits it from the ladder's config)
            sched.bind_retry_policy = robustness_config.retry
            sched._retry_sleep = robustness_config.sleep
    from kubernetes_tpu_torch.scheduler.eventhandlers import add_all_event_handlers
    from kubernetes_tpu_torch.scheduler.preemption import Preemptor

    # the victim search runs where the solve does: K3 on the card
    sched.preemptor = Preemptor(algorithm, queue, client, device=device)
    if batch:
        # the wave ladder mirrors the batch solver's robustness config
        # (watchdog/retry/breaker knobs, injectable sleep) with its OWN
        # breakers: a sick preemption path degrades independently of --
        # and never poisons -- the main solve tiers
        from kubernetes_tpu_torch.robustness.ladder import SolverLadder

        sched.preemptor.ladder = SolverLadder(sched.ladder.config)
    sched.event_broadcaster = broadcaster
    # the bind-ack ledger must exist BEFORE handler registration: the
    # eventhandlers capture it once and feed it the Running-ack frames
    if (
        bind_ack_config is not None
        and getattr(bind_ack_config, "enabled", False)
        and client is not None
    ):
        from kubernetes_tpu_torch.scheduler.bindack import BindAckTracker

        sched.bind_ack_tracker = BindAckTracker(
            client,
            ack_timeout_seconds=bind_ack_config.ack_timeout_seconds,
            sweep_interval_seconds=bind_ack_config.sweep_interval_seconds,
            node_suspect_threshold=bind_ack_config.node_suspect_threshold,
            taint_suspect_nodes=bind_ack_config.taint_suspect_nodes,
        )
        sched.bind_ack_tracker.start()
    add_all_event_handlers(sched, informer_factory)
    # materialize every plugin-consumed informer BEFORE factory start so
    # listers are synced by WaitForCacheSync (reference factory.go shape)
    for accessor in (
        "pdbs", "pod_groups", "services", "replication_controllers",
        "replica_sets", "stateful_sets", "persistent_volumes",
        "persistent_volume_claims", "storage_classes", "csi_nodes",
    ):
        getattr(informer_factory, accessor)()
    return sched


def new_scheduler_from_config(
    client: Client,
    informer_factory: InformerFactory,
    cfg,
    out_of_tree_registry: Optional[Registry] = None,
    rng=None,
    device=None,
) -> Scheduler:
    """Build the scheduler straight from a KubeSchedulerConfiguration
    (config/loader.py), including this build's tpuSolver block: batch
    mode, maxBatch and solverMode, solved on ``device`` (the card unless
    the caller names the CPU). meshDevices > 0 shards the solve over a
    NodeMesh of that many devices: distinct visible CUDA devices on the
    card (too few raises, as the JAX package does), or that many CPU
    shards with ``device="cpu"``."""
    from kubernetes_tpu_torch.config.validation import validate_config
    from kubernetes_tpu_torch.device import resolve_device

    errors = validate_config(cfg)
    if errors:
        raise ValueError(
            "invalid KubeSchedulerConfiguration: " + "; ".join(errors)
        )
    ts = cfg.tpu_solver
    mesh = None
    if ts.enabled and ts.mesh_devices > 0:
        import torch

        from kubernetes_tpu_torch.ops.mesh import NodeMesh

        base = resolve_device(device)
        if base.type == "cuda":
            visible = torch.cuda.device_count()
            if visible < ts.mesh_devices:
                raise ValueError(
                    f"tpuSolver.meshDevices={ts.mesh_devices} but only "
                    f"{visible} devices are visible"
                )
            mesh = NodeMesh(
                [f"cuda:{i}" for i in range(ts.mesh_devices)]
            )
        else:
            mesh = NodeMesh([base] * ts.mesh_devices)
        device = None
    from kubernetes_tpu_torch.robustness.containment import ContainmentConfig
    from kubernetes_tpu_torch.robustness.faults import (
        injector_from_configuration,
        install_injector,
    )
    from kubernetes_tpu_torch.robustness.ladder import RobustnessConfig

    sched = new_scheduler(
        client,
        informer_factory,
        profiles=cfg.profiles or None,
        out_of_tree_registry=out_of_tree_registry,
        percentage_of_nodes_to_score=cfg.percentage_of_nodes_to_score,
        rng=rng,
        batch=ts.enabled,
        max_batch=ts.max_batch,
        solver_mode=ts.solver_mode,
        extenders=list(getattr(cfg, "extenders", [])),
        robustness_config=RobustnessConfig.from_configuration(
            cfg.robustness
        ),
        containment_config=ContainmentConfig.from_configuration(
            cfg.containment
        ),
        bind_ack_config=getattr(cfg, "bind_ack", None),
        device=device,
        mesh=mesh,
    )
    if ts.enabled:
        sched.batch_window = ts.batch_window_seconds
    apply_streaming_config(
        sched, cfg, informer_factory, batch=ts.enabled,
        max_batch=ts.max_batch,
    )
    injector = injector_from_configuration(cfg.fault_injection)
    if injector is not None:
        install_injector(injector)
    return sched


def apply_streaming_config(
    sched: Scheduler,
    cfg,
    informer_factory: InformerFactory,
    *,
    batch: bool,
    max_batch: int,
) -> None:
    """Wire the ``streaming:`` block onto a built scheduler -- shared
    by ``new_scheduler_from_config`` and ``SchedulerApp`` (which builds
    through ``new_scheduler`` directly): the priority-band threshold
    arms queue jumping on ANY scheduler (the band lives in the queue),
    and the SLO-adaptive controller replaces the static batchWindow/
    maxBatch behavior on the batch path (streaming/autobatch.py)."""
    st = getattr(cfg, "streaming", None)
    if st is None or not st.enabled:
        return
    if st.band_priority_threshold is not None:
        sched.queue.band_threshold = st.band_priority_threshold
    if getattr(st, "band_priority_class", ""):
        # PriorityClass OBJECTS -- not raw integers -- select the
        # band: the named class's value arms the threshold, and a
        # PriorityClass update re-arms it live (the admission
        # classifier stamps each pod's resolved priority at ingest,
        # so the queue compares memo reads against this value)
        _wire_band_priority_class(
            sched, informer_factory, st.band_priority_class,
            fallback=st.band_priority_threshold,
        )
    if batch:
        from kubernetes_tpu_torch.streaming.autobatch import (
            AutoBatchController,
        )

        sched.attach_autobatch(AutoBatchController(
            slo_p99_seconds=st.slo_p99_seconds,
            min_window=st.min_window_seconds,
            max_window=st.max_window_seconds,
            latency_batch=st.latency_batch,
            max_batch=max_batch,
            interval_seconds=st.controller_interval_seconds,
            auto_rungs=getattr(st, "auto_rungs", False),
        ))


def _wire_band_priority_class(
    sched: Scheduler,
    informer_factory: InformerFactory,
    class_name: str,
    fallback: Optional[int] = None,
) -> None:
    """Arm (and live-track) the streaming band threshold from a named
    PriorityClass object: add/update events for that class set
    ``queue.band_threshold`` to its value; deleting it reverts to the
    configured raw ``bandPriorityThreshold`` integer (None when unset:
    band off). Registered before factory start so the initial list
    replay arms the threshold at sync."""
    from kubernetes_tpu_torch.client.informer import ResourceEventHandler

    def _apply(*args) -> None:
        obj = args[-1]
        if obj.metadata.name == class_name:
            sched.queue.band_threshold = int(obj.value)

    def _disarm(obj) -> None:
        if obj.metadata.name == class_name:
            sched.queue.band_threshold = fallback

    informer_factory.priority_classes().add_event_handler(
        ResourceEventHandler(
            on_add=_apply, on_update=_apply, on_delete=_disarm
        )
    )


def _prune_unregistered(plugins: Plugins, registry: Registry) -> Plugins:
    out = Plugins()
    for point in Plugins.EXTENSION_POINTS:
        ps = getattr(plugins, point)
        setattr(
            out,
            point,
            type(ps)(
                enabled=[p for p in ps.enabled if p.name in registry],
                disabled=list(ps.disabled),
            ),
        )
    return out
