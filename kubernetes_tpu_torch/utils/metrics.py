"""Prometheus-style metrics with the reference's metric names.

Reference: /root/reference/pkg/scheduler/metrics/metrics.go (metric set
:54-:230) and staging/src/k8s.io/component-base/metrics (registry +
text exposition). The names below are kept identical so dashboards and
the perf harness scrape unchanged.
"""

from __future__ import annotations

import threading
import time
from bisect import bisect_left
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_DEF_BUCKETS = (
    0.001, 0.002, 0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1, 2, 5, 10,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted(labels.items()))


def _escape_label_value(value) -> str:
    """Prometheus text exposition escaping for label VALUES: backslash,
    double-quote, and line-feed must be escaped or the emitted series is
    unparseable (a fault-point name or node name containing a quote used
    to corrupt the whole scrape)."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = () if not labels else _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class LockFreeCounter(Counter):
    """A counter written from a ``gc`` callback. A collection can start
    inside any allocation, also one made while this counter's lock is
    held, so the writer takes no lock; collections never overlap, so
    there is one writer at a time."""

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = () if not labels else _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount

    def collect(self) -> List[str]:
        values = dict(self._values)
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for key, v in sorted(values.items()):
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Gauge:
    def __init__(
        self,
        name: str,
        help: str,
        label_names: Sequence[str] = (),
        fn: Optional[Callable[[], float]] = None,
    ):
        if fn is not None and label_names:
            # a bare ``fn`` cannot answer for a labeled family --
            # collect() would emit an unlabeled sample under a labeled
            # HELP/TYPE header (a malformed series). Per-label callbacks
            # go through register_callback instead.
            raise ValueError(
                f"gauge {name!r}: a constructor callback cannot carry "
                f"label_names; use register_callback(fn, **labels)"
            )
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.fn = fn  # callback gauge (unlabeled)
        self._callbacks: Dict[Tuple, Callable[[], float]] = {}
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[_label_key(labels)] = value

    def register_callback(
        self, fn: Callable[[], float], **labels: str
    ) -> None:
        """Per-label-set callback: collect() calls ``fn`` at scrape
        time for exactly this series (the labeled analogue of the
        constructor ``fn``)."""
        with self._lock:
            self._callbacks[_label_key(labels)] = fn

    def value(self, **labels: str) -> float:
        if self.fn is not None:
            return self.fn()
        cb = self._callbacks.get(_label_key(labels))
        if cb is not None:
            return cb()
        return self._values.get(_label_key(labels), 0.0)

    def collect(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        if self.fn is not None:
            out.append(f"{self.name} {self.fn()}")
            return out
        with self._lock:
            callbacks = list(self._callbacks.items())
            values = [
                (key, v) for key, v in sorted(self._values.items())
                if key not in self._callbacks
            ]
        for key, cb in sorted(callbacks):
            out.append(f"{self.name}{_fmt_labels(key)} {cb()}")
        for key, v in values:
            out.append(f"{self.name}{_fmt_labels(key)} {v}")
        return out


class Histogram:
    def __init__(
        self,
        name: str,
        help: str,
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = _DEF_BUCKETS,
    ):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        # counts are stored per-bucket (first bucket the value falls in);
        # the Prometheus cumulative form is materialized in collect() --
        # one bisect instead of a Python loop over every bucket
        key = () if not labels else _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            counts[bisect_left(self.buckets, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def observe_many(self, values: Sequence[float], **labels: str) -> None:
        """Bulk observe under one lock (the batch-commit hot path)."""
        if not values:
            return
        key = () if not labels else _label_key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
            total = 0.0
            for v in values:
                counts[bisect_left(self.buckets, v)] += 1
                total += v
            self._sums[key] = self._sums.get(key, 0.0) + total
            self._totals[key] = self._totals.get(key, 0) + len(values)

    def count(self, **labels: str) -> int:
        return self._totals.get(_label_key(labels), 0)

    def sum(self, **labels: str) -> float:
        return self._sums.get(_label_key(labels), 0.0)

    def collect(self) -> List[str]:
        out = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ]
        with self._lock:
            for key in sorted(self._totals):
                cumulative = 0
                for i, b in enumerate(self.buckets):
                    cumulative += self._counts[key][i]
                    # the le label is hoisted into a variable: a backslash
                    # inside an f-string expression is 3.12-only syntax,
                    # and this module must import on 3.10
                    le_label = 'le="%s"' % b
                    out.append(
                        f"{self.name}_bucket"
                        f"{_fmt_labels(key, le_label)} "
                        f"{cumulative}"
                    )
                le_inf = 'le="+Inf"'
                out.append(
                    f"{self.name}_bucket{_fmt_labels(key, le_inf)} "
                    f"{self._totals[key]}"
                )
                out.append(f"{self.name}_sum{_fmt_labels(key)} {self._sums[key]}")
                out.append(f"{self.name}_count{_fmt_labels(key)} {self._totals[key]}")
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: List = []
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def expose(self) -> str:
        """Prometheus text exposition format."""
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


# -- the scheduler metric set (metrics.go names, verbatim) -------------------

registry = Registry()

schedule_attempts = registry.register(Counter(
    "scheduler_schedule_attempts_total",
    "Number of attempts to schedule pods, by result.",
    ("result",),
))
e2e_scheduling_duration = registry.register(Histogram(
    "scheduler_e2e_scheduling_duration_seconds",
    "E2e scheduling latency (scheduling algorithm + binding).",
))
scheduling_algorithm_duration = registry.register(Histogram(
    "scheduler_scheduling_algorithm_duration_seconds",
    "Scheduling algorithm latency.",
))
binding_duration = registry.register(Histogram(
    "scheduler_binding_duration_seconds",
    "Binding latency.",
))
preemption_victims = registry.register(Histogram(
    "scheduler_pod_preemption_victims",
    "Number of selected preemption victims.",
    buckets=(1, 2, 4, 8, 16, 32, 64),
))
preemption_attempts = registry.register(Counter(
    "scheduler_total_preemption_attempts",
    "Total preemption attempts in the cluster.",
))
pending_pods = registry.register(Gauge(
    "scheduler_pending_pods",
    "Number of pending pods by queue.",
    ("queue",),
))
pod_scheduling_duration = registry.register(Histogram(
    "scheduler_pod_scheduling_duration_seconds",
    "E2e latency for a pod being scheduled, from first attempt.",
))
pod_scheduling_attempts = registry.register(Histogram(
    "scheduler_pod_scheduling_attempts",
    "Number of attempts to successfully schedule a pod.",
    buckets=(1, 2, 4, 8, 16),
))
framework_extension_point_duration = registry.register(Histogram(
    "scheduler_framework_extension_point_duration_seconds",
    "Latency for running all plugins of a specific extension point.",
    ("extension_point", "status"),
))
plugin_execution_duration = registry.register(Histogram(
    "scheduler_plugin_execution_duration_seconds",
    "Duration for running a plugin at a specific extension point.",
    ("plugin", "extension_point", "status"),
))
queue_incoming_pods = registry.register(Counter(
    "scheduler_queue_incoming_pods_total",
    "Number of pods added to scheduling queues by event and queue type.",
    ("queue", "event"),
))
permit_wait_duration = registry.register(Histogram(
    "scheduler_permit_wait_duration_seconds",
    "Duration of waiting on permit.",
))
cache_size = registry.register(Gauge(
    "scheduler_scheduler_cache_size",
    "Number of nodes, pods, and assumed pods in the scheduler cache.",
    ("type",),
))
# TPU-path additions (new names, not replacements)
batch_solve_duration = registry.register(Histogram(
    "scheduler_tpu_batch_solve_duration_seconds",
    "Device solve latency per batch (pack + solve + readback).",
))
batch_size = registry.register(Histogram(
    "scheduler_tpu_batch_size",
    "Pods per device-solved batch.",
    buckets=(1, 8, 32, 64, 128, 256, 512, 1024),
))
# robustness subsystem (kubernetes_tpu_torch/robustness/): fault injection,
# solver degradation ladder, circuit breakers -- degradation must be
# observable, not silent
faults_injected = registry.register(Counter(
    "scheduler_faults_injected_total",
    "Faults fired by the injection harness, by injection point.",
    ("point",),
))
breaker_transitions = registry.register(Counter(
    "scheduler_circuit_breaker_transitions_total",
    "Circuit breaker state transitions, by solver tier and edge.",
    ("tier", "from_state", "to_state"),
))
solver_fallbacks = registry.register(Counter(
    "scheduler_solver_fallback_total",
    "Batches stepped down the solver degradation ladder, by the tier "
    "that handled them and the reason the higher tier was skipped.",
    ("tier", "reason"),
))
solve_retries = registry.register(Counter(
    "scheduler_solve_retries_total",
    "Device-solve retries before stepping down the ladder, by tier.",
    ("tier",),
))
bind_retries = registry.register(Counter(
    "scheduler_bind_retries_total",
    "Bind/commit attempts retried after a transient API failure.",
))
watch_relists = registry.register(Counter(
    "scheduler_watch_relist_total",
    "Informer relists forced by a broken watch stream, by kind.",
    ("kind",),
))
# control-plane resilience (PR 2): crash recovery, fenced HA failover,
# cache<->apiserver reconciliation -- failover and restart must be as
# observable as a solver fault
fencing_aborts = registry.register(Counter(
    "scheduler_fencing_aborts_total",
    "Commits aborted because the lease was no longer held at commit "
    "time (the deposed-leader double-bind guard).",
))
lease_renew_failures = registry.register(Counter(
    "scheduler_lease_renew_failures_total",
    "Failed lease acquire/renew rounds (API error or injected).",
))
assumed_pods_expired = registry.register(Counter(
    "scheduler_assumed_pods_expired_total",
    "Assumed pods expired by the TTL sweeper (binding finished but the "
    "watch confirmation never arrived).",
))
# cluster-lifecycle wave (PR 6): drains, reclamation storms, and churn
# must be as observable as any other rehearsed failure path
evictions_blocked_by_pdb = registry.register(Counter(
    "scheduler_evictions_blocked_by_pdb_total",
    "Voluntary disruptions (drain or taint eviction) denied by the "
    "shared PodDisruptionBudget gate (DisruptionController."
    "can_disrupt).",
))
# batched preemption waves (PR 11): device-chosen victims, budget-gated
# evictions, nomination lifecycle -- every wave outcome is counted by
# what ACTUALLY happened (victims book only after the eviction
# transaction lands; a wave aborted by a breaker, a fence, or a denied
# budget books nothing)
preemption_waves = registry.register(Counter(
    "scheduler_preemption_waves_total",
    "Batched device preemption waves run (one per flushed failed-pod "
    "group per profile).",
))
victims_selected = registry.register(Counter(
    "scheduler_preemption_victims_selected_total",
    "Victims actually evicted by preemption, by the solver tier that "
    "chose them (pallas / xla / host). Booked only after the eviction "
    "transaction succeeds -- an aborted wave un-books nothing because "
    "nothing was booked.",
    ("tier",),
))
nominations_set = registry.register(Counter(
    "scheduler_preemption_nominations_set_total",
    "nominatedNodeName reservations installed in the scheduling queue "
    "(update_nominated_pod_for_node with a concrete node).",
))
nominations_cleared = registry.register(Counter(
    "scheduler_preemption_nominations_cleared_total",
    "Nominations removed from the queue map: the nominee bound, was "
    "superseded, failed terminally, or its nominated node was deleted.",
))
preemption_budget_denials = registry.register(Counter(
    "scheduler_preemption_budget_denials_total",
    "Preemptors whose victim set was denied by the shared "
    "DisruptionController.can_disrupt PDB gate (grants taken for the "
    "attempt are refunded; the preemptor requeues without a "
    "nomination).",
))
node_removed_requeues = registry.register(Counter(
    "scheduler_node_removed_requeues_total",
    "In-flight assumed pods whose node was deleted mid-bind, expired "
    "immediately and routed by apiserver truth instead of waiting out "
    "the assume TTL.",
))
cache_drift = registry.register(Counter(
    "scheduler_cache_drift_total",
    "Cache<->apiserver divergences detected and healed by the drift "
    "checker, by object kind and healing action.",
    ("kind", "action"),
))
pods_adopted_on_restart = registry.register(Counter(
    "scheduler_pods_adopted_on_restart_total",
    "Pods found already bound by a previous incarnation and adopted "
    "into the cache at startup.",
))
pods_requeued_on_restart = registry.register(Counter(
    "scheduler_pods_requeued_on_restart_total",
    "Pending pods (including a previous incarnation's in-flight "
    "assume-but-never-bound pods) requeued at startup.",
))
watch_gone = registry.register(Counter(
    "scheduler_watch_gone_total",
    "Watch opens rejected with the 410 Gone analogue (replay window "
    "truncated past since_rv), by kind.",
    ("kind",),
))
ingest_native_fallbacks = registry.register(Counter(
    "scheduler_ingest_native_fallbacks_total",
    "Ingest-plane calls that ran the pure-Python twin while the native "
    "path was WANTED (KTPU_NATIVE_INGEST on) but unavailable (build/"
    "import failure), by site. KTPU_NATIVE_INGEST=0 runs the twins as "
    "the configured path and books nothing here.",
    ("site",),
))
commit_join_timeouts = registry.register(Counter(
    "scheduler_commit_thread_join_timeouts_total",
    "Committer threads that failed to join at shutdown.",
))
degraded_health = registry.register(Gauge(
    "scheduler_degraded_health",
    "1 when a component is operating degraded, by reason.",
    ("reason",),
))
# open-loop streaming subsystem (kubernetes_tpu_torch/streaming/): the
# SLO-adaptive batch controller, priority bands, and arrival-engine
# backpressure must be observable -- a controller that thrashes or an
# engine that stalls is a capacity signal, not an implementation detail
autobatch_decisions = registry.register(Counter(
    "scheduler_autobatch_decisions_total",
    "SLO-adaptive batch controller decisions that changed the window "
    "or dispatch cap, by direction (grow = throughput mode, shrink = "
    "latency mode).",
    ("direction",),
))
autobatch_window = registry.register(Gauge(
    "scheduler_autobatch_window_seconds",
    "Current adaptive batch window.",
))
autobatch_batch_cap = registry.register(Gauge(
    "scheduler_autobatch_batch_cap",
    "Current adaptive dispatch cap (pods per pop_batch drain; also "
    "floors the padded solve shape).",
))
autobatch_latched = registry.register(Gauge(
    "scheduler_autobatch_overload_latched",
    "1 while the controller's overload latch holds throughput mode "
    "(EWMA pressure crossed the grow threshold repeatedly; shrinks "
    "blocked until it calms).",
))
queue_band_wait = registry.register(Histogram(
    "scheduler_queue_band_wait_seconds",
    "ActiveQ wait (enqueue to drain) by priority band; only recorded "
    "when band_threshold is set.",
    ("band",),
))
backpressure_stalls = registry.register(Counter(
    "scheduler_arrival_backpressure_stalls_total",
    "Times the open-loop arrival engine stalled because the activeQ "
    "depth hit its bound (offered rate exceeded capacity).",
))
backpressure_stall_seconds = registry.register(Counter(
    "scheduler_arrival_backpressure_stall_seconds_total",
    "Cumulative wall clock the arrival engine spent stalled on the "
    "activeQ depth gate.",
))
# multi-active partitioned scheduling (scheduler/partition.py): N live
# stacks over one apiserver -- conflicts, spills, and takeovers are the
# rehearsed coordination paths and every one must be accounted (the
# conflict ledger: absorbed == requeued + satisfied, no silent loss)
bind_conflicts_absorbed = registry.register(Counter(
    "scheduler_bind_conflicts_absorbed_total",
    "Typed bind conflicts (already-bound / uid-mismatch / foreign-"
    "partition / partition-fence) absorbed by the committer through "
    "the requeue path instead of surfacing as scheduler errors, by "
    "conflict kind.",
    ("kind",),
))
pods_spilled = registry.register(Counter(
    "scheduler_pods_spilled_total",
    "Pods re-stamped to a sibling partition and forwarded through the "
    "apiserver because their feasible nodes live in a foreign "
    "partition.",
))
partition_takeovers = registry.register(Counter(
    "scheduler_partition_takeovers_total",
    "Foreign partitions seized after their holder's lease lapsed "
    "(stack crash, injected renew failures).",
))
partition_takeover_ms = registry.register(Histogram(
    "scheduler_partition_takeover_ms",
    "Lapsed-partition takeover latency: expiry detection to adoption "
    "complete (nodes in cache, orphaned pods requeued), milliseconds.",
    buckets=(5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
))
partitions_held = registry.register(Gauge(
    "scheduler_partitions_held",
    "Partitions currently held by this stack's coordinator.",
))
# tracing plane (ISSUE 13): the device-state counters that previously
# lived only as bench/solver labels become real series -- a live
# cluster sees what the bench sees -- plus the jit-cache watchdog and
# the streaming pod-to-bind quantile gauges. Booking follows the PR-5
# rule: link-traffic counters record what actually rode the link, so
# state_uploads/delta_rows book only after a device solve LANDED (the
# internal attributes un-book on ladder exhaustion / host-tier routing,
# and a Prometheus counter cannot).
state_uploads = registry.register(Counter(
    "scheduler_tpu_state_uploads_total",
    "Full [N, R] node-state uploads that reached the device (cold "
    "dispatches, layout changes, escalated churn, counted divergence "
    "resyncs).",
))
delta_rows_uploaded = registry.register(Counter(
    "scheduler_tpu_delta_rows_uploaded_total",
    "Changed node rows shipped as (indices, rows) scatters onto the "
    "device-resident carry instead of full [N, R] uploads.",
))
carry_divergences = registry.register(Counter(
    "scheduler_tpu_carry_divergences_total",
    "Generation-handshake mismatches: host node state not explained by "
    "our own mirrored placements (node churn, bind failures) -- "
    "resolved by a row scatter-fix or a counted full upload, never "
    "silently.",
))
tensor_full_repacks = registry.register(Counter(
    "scheduler_tpu_tensor_full_repacks_total",
    "NodeTensorCache full repacks (schema growth or slot-headroom "
    "exhaustion; steady membership churn scatters in place instead).",
))
tensor_rows_added = registry.register(Counter(
    "scheduler_tpu_tensor_rows_added_total",
    "Node rows claimed in place by incremental node adds (free or "
    "headroom slots; no layout move).",
))
tensor_rows_retired = registry.register(Counter(
    "scheduler_tpu_tensor_rows_retired_total",
    "Node rows freed in place by incremental node removals.",
))
spill_hint_hits = registry.register(Counter(
    "scheduler_spill_hint_hits_total",
    "Cross-partition spills routed straight to the owner partition by "
    "the feasibility hint (one hop) instead of walking the ring.",
))
jit_compiles = registry.register(Counter(
    "scheduler_tpu_jit_compiles_total",
    "Jitted-solver cache growth observed by the runtime jit-cache "
    "watchdog, by solver signature family. Growth after warmup sealed "
    "the cache is a MID-RUN recompile: it also fires a flight-recorder "
    "mark, because an unplanned multi-second compile inside a measured "
    "window is exactly what the warmup contract exists to prevent.",
    ("signature",),
))
gc_pause_seconds = registry.register(LockFreeCounter(
    "scheduler_tpu_gc_pause_seconds_total",
    "Seconds the cyclic garbage collector held the interpreter, on any "
    "thread, by generation (timed by a gc callback while a batch "
    "scheduler's run loop is up).",
    ("generation",),
))
# blast-radius containment (ISSUE 14): poison-pod bisection, the
# quarantine ledger, the carry integrity audit, and device-loss rebuild
# -- per-pod containment must be as observable as the tier fallback it
# replaces (a quarantined pod is VISIBLE, never silently dropped)
bisections = registry.register(Counter(
    "scheduler_tpu_bisections_total",
    "Ladder-exhausted batches taken down the poison-bisection path "
    "instead of failing whole to the sequential floor.",
))
bisect_subsolves = registry.register(Counter(
    "scheduler_tpu_bisect_subsolves_total",
    "Sub-batch solves dispatched by the bisection search (O(log B) per "
    "isolated pod; each reuses an already-warm pad rung).",
))
bisect_aborts = registry.register(Counter(
    "scheduler_tpu_bisect_aborts_total",
    "Bisection runs aborted to the sequential path because EVERY "
    "sub-solve failed (systemic device failure, not a poison "
    "signature).",
))
exhausted_crashloops = registry.register(Counter(
    "scheduler_ladder_exhausted_crashloops_total",
    "Identical batches that exhausted the solver ladder twice in a "
    "row: the retry is a crash loop, so containment (bisection / "
    "quarantine) takes over instead of a third full-batch retry.",
))
quarantine_pods = registry.register(Counter(
    "scheduler_quarantine_pods_total",
    "Pod isolation events booked by the quarantine ledger, by "
    "disposition (held = escalating out-of-queue backoff; parked = "
    "retry budget exhausted, PodQuarantined condition written) and "
    "isolation reason.",
    ("disposition", "reason"),
))
quarantine_parked = registry.register(Gauge(
    "scheduler_quarantine_parked",
    "Pods currently parked in the quarantine queue (terminal until an "
    "operator or a real spec update intervenes).",
))
quarantine_releases = registry.register(Counter(
    "scheduler_quarantine_releases_total",
    "Held pods released back to the activeQ after their quarantine "
    "hold expired (bounded retries before parking).",
))
quota_admissions = registry.register(Counter(
    "scheduler_quota_admissions_total",
    "ResourceQuota decisions at the scheduling gate: granted charges "
    "the namespace ledger (guaranteed_update check-and-increment); "
    "denied parks the pod typed-QuotaExceeded until a quota or usage "
    "event frees headroom.",
    ("result",),
))
quota_refunds = registry.register(Counter(
    "scheduler_quota_refunds_total",
    "Quota charges given back (exactly once per pod incarnation), by "
    "reason: requeue (scheduling/bind failure), spill (re-homed to a "
    "sibling partition), quarantine, delete.",
    ("reason",),
))
quota_parked = registry.register(Gauge(
    "scheduler_quota_parked",
    "Pods currently parked typed-QuotaExceeded (released by quota/"
    "usage events only, never polled).",
))
quota_releases = registry.register(Counter(
    "scheduler_quota_releases_total",
    "Quota-parked pods released back to the activeQ after a quota "
    "raise or a usage drop opened headroom for them.",
))
tenant_dominant_share = registry.register(Gauge(
    "scheduler_tenant_dominant_share",
    "DRF dominant share (max over cpu/memory of tenant-used / "
    "cluster-capacity) across tenants with usage, by stat: max = the "
    "most-served tenant; spread = max - min (the fairness gap the "
    "solve-order bias closes).",
    ("stat",),
))
carry_audit_sweeps = registry.register(Counter(
    "scheduler_tpu_carry_audit_sweeps_total",
    "Carry integrity audits run (cheap on-device checksum of the "
    "resident req/nzr/alloc/valid state against the host shadow), by "
    "disposition (clean / mismatch / busy / idle / raced).",
    ("disposition",),
))
carry_audit_mismatches = registry.register(Counter(
    "scheduler_tpu_carry_audit_mismatches_total",
    "Device-resident carry arrays whose audit checksum diverged from "
    "the host shadow (silent corruption caught before it mis-places "
    "pods), by array.",
    ("array",),
))
carry_audit_heals = registry.register(Counter(
    "scheduler_tpu_carry_audit_heals_total",
    "Corrupted device-resident state self-healed through the counted "
    "re-upload path after an audit mismatch.",
))
device_lost_events = registry.register(Counter(
    "scheduler_tpu_device_lost_total",
    "Device-loss events: all resident state dropped, in-flight batches "
    "recovered through the requeue machinery, state rebuilt from the "
    "host cache via the cold-upload path.",
))
device_rebuild_ms = registry.register(Histogram(
    "scheduler_tpu_device_rebuild_ms",
    "Device-loss rebuild latency: loss detection to the first jitted "
    "solve landing on the re-uploaded state, milliseconds.",
    buckets=(5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000),
))
pod_to_bind_quantile = registry.register(Gauge(
    "scheduler_pod_to_bind_quantile_seconds",
    "Live streaming estimate of the pod-to-bind latency quantile "
    "(P-squared sketch over every bound pod's first-attempt-to-bind "
    "wall clock), by quantile.",
    ("q",),
))

# hollow-node plane (ISSUE 17): the bind loop is closed -- a bind is
# only done when the node agent acks it into pod status -- so the ack
# path, the heartbeat plane, and the zombie-recovery arc each get their
# own families (README "Closing the bind loop" reads these)
hollow_acks = registry.register(Counter(
    "scheduler_hollow_acks_total",
    "Bindings acked into pod status (phase=Running) by the hollow-node "
    "fleet -- the kubelet syncLoop edge that closes the bind loop.",
))
hollow_heartbeats = registry.register(Counter(
    "scheduler_hollow_heartbeats_total",
    "Lease renewals written by the hollow-node fleet.",
))
bind_acks_observed = registry.register(Counter(
    "scheduler_bind_acks_total",
    "Bind acks observed by the scheduler's bind-ack tracker (the "
    "pod-Running transition arriving over the watch), by how: acked = "
    "the node confirmed in time; acked-late = the ack raced the "
    "rebind sweep and won at the store.",
    ("how",),
))
bind_ack_latency = registry.register(Histogram(
    "scheduler_bind_ack_latency_seconds",
    "Bind-to-ack latency: bulk bind commit to the pod-Running ack "
    "arriving over the watch.",
))
bind_ack_timeouts = registry.register(Counter(
    "scheduler_bind_ack_timeouts_total",
    "Bound pods whose ack never arrived within the ack timeout (the "
    "zombie-kubelet signal; each feeds the rebind path exactly once "
    "per pod incarnation).",
))
rebinds = registry.register(Counter(
    "scheduler_rebinds_total",
    "Bound-but-never-acked pods unbound back to the queue by the "
    "rebind-after-timeout sweep (uid-fenced: at most one per pod "
    "incarnation).",
))
bind_ack_pending = registry.register(Gauge(
    "scheduler_bind_ack_pending",
    "Bound pods currently awaiting their node's ack.",
))
suspect_nodes_tainted = registry.register(Counter(
    "scheduler_bind_ack_suspect_nodes_tainted_total",
    "Nodes tainted unschedulable by the bind-ack tracker after "
    "repeated ack timeouts (cleared when the node acks again).",
))
node_heartbeat_lapses = registry.register(Counter(
    "scheduler_node_heartbeat_lapses_total",
    "Nodes marked unreachable by the nodelifecycle monitor after their "
    "lease lapsed past the grace period.",
))
taint_evictions = registry.register(Counter(
    "scheduler_taint_evictions_total",
    "Pods evicted off unreachable nodes by the nodelifecycle monitor "
    "(every one granted through the shared can_disrupt PDB gate).",
))

# pipelined speculative dispatch (ISSUE 18): batch N+1 solves against
# the committer's shadow expectation while batch N is still committing;
# a commit-divergence rewinds only the divergent batch. The carry
# compression families book the int16 resident-carry A/B
# (KTPU_CARRY_COMPRESS=0 pins the int32 behavior)
speculative_launches = registry.register(Counter(
    "scheduler_speculative_launches_total",
    "Solves dispatched speculatively against the shadow-expected carry "
    "while at least one earlier batch was still in flight.",
))
speculative_rewinds = registry.register(Counter(
    "scheduler_speculative_rewinds_total",
    "Speculative-chain rewinds, by reason: row_patch = the expected "
    "deltas diverged (bind conflict, quota refund, conflict-requeue) "
    "and the carry was repaired in place with a row scatter; "
    "mirror_wait = the dispatcher paused for in-flight mirrors before "
    "renegotiating; drain = the chain fell back to a full pipeline "
    "drain + redispatch.",
    ("reason",),
))
carry_compressed = registry.register(Gauge(
    "scheduler_tpu_carry_compressed",
    "1 while the device-resident req/nzr carry is held int16 (the "
    "range-gated lossless compression engaged), else 0.",
))
carry_compress_bytes_saved = registry.register(Counter(
    "scheduler_tpu_carry_compress_bytes_saved_total",
    "Host-to-device link bytes saved by shipping req/nzr state and "
    "row deltas packed int16 instead of int32.",
))
carry_compress_disengages = registry.register(Counter(
    "scheduler_tpu_carry_compress_disengages_total",
    "Compressed-carry disengagements, by reason: range = a column sum "
    "approached the int16 ceiling; mode = the dispatch needed an "
    "uncompressed variant (constrained ladder, mesh, host tier).",
    ("reason",),
))

from kubernetes_tpu_torch.utils.quantiles import QuantileSet as _QuantileSet

#: the live pod-to-bind sketch the gauges read at scrape time; the
#: AutoBatchController can consume the same estimate
pod_to_bind_sketch = _QuantileSet((0.5, 0.99))
pod_to_bind_quantile.register_callback(
    lambda: pod_to_bind_sketch.value(0.5), q="0.5"
)
pod_to_bind_quantile.register_callback(
    lambda: pod_to_bind_sketch.value(0.99), q="0.99"
)


def observe_pod_to_bind(seconds) -> None:
    """Feed the live quantile sketch (accepts a scalar or a sequence);
    called from both bind paths next to pod_scheduling_duration."""
    if isinstance(seconds, (int, float)):
        pod_to_bind_sketch.observe(seconds)
    else:
        pod_to_bind_sketch.observe_many(seconds)


class SinceTimer:
    """Tiny helper: observe elapsed seconds into a histogram."""

    def __init__(self, hist: Histogram, **labels: str) -> None:
        self.hist = hist
        self.labels = labels
        self.start = time.perf_counter()

    def observe(self, **extra: str) -> float:
        elapsed = time.perf_counter() - self.start
        self.hist.observe(elapsed, **{**self.labels, **extra})
        return elapsed
