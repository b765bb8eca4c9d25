"""KubeSchedulerConfiguration validation.

Reference: /root/reference/pkg/scheduler/apis/config/validation/
validation.go (ValidateKubeSchedulerConfiguration) -- the same checks,
plus this build's tpuSolver block. Returns a list of error strings
(empty = valid); load_config raises on any.
"""

from __future__ import annotations

from typing import List

from kubernetes_tpu_torch.config.types import (
    KubeSchedulerConfiguration,
    Plugins,
)

MAX_WEIGHT = 64 * 1024  # framework/v1alpha1: MaxTotalScore guardrail


def validate_config(cfg: KubeSchedulerConfiguration) -> List[str]:
    errors: List[str] = []
    if not 0 <= cfg.percentage_of_nodes_to_score <= 100:
        errors.append(
            "percentageOfNodesToScore must be in [0, 100], got "
            f"{cfg.percentage_of_nodes_to_score}"
        )
    if cfg.pod_initial_backoff_seconds <= 0:
        errors.append("podInitialBackoffSeconds must be positive")
    if cfg.pod_max_backoff_seconds < cfg.pod_initial_backoff_seconds:
        errors.append(
            "podMaxBackoffSeconds must be >= podInitialBackoffSeconds"
        )

    le = cfg.leader_election
    if le.leader_elect:
        if le.lease_duration_seconds <= 0:
            errors.append("leaderElection.leaseDuration must be positive")
        if le.renew_deadline_seconds <= 0:
            errors.append("leaderElection.renewDeadline must be positive")
        if le.retry_period_seconds <= 0:
            errors.append("leaderElection.retryPeriod must be positive")
        if le.renew_deadline_seconds > le.lease_duration_seconds:
            errors.append(
                "leaderElection.renewDeadline must be <= leaseDuration"
            )
        if not le.resource_name:
            errors.append("leaderElection.resourceName is required")
        if not 0.0 <= le.renew_jitter_fraction <= 1.0:
            errors.append(
                "leaderElection.renewJitter must be in [0, 1]"
            )
        if le.clock_skew_tolerance_seconds < 0:
            errors.append(
                "leaderElection.clockSkewTolerance must be >= 0"
            )

    # profiles: unique scheduler names; all share one queue sort
    # (profile.go:120 validation)
    names = [p.scheduler_name for p in cfg.profiles]
    if len(set(names)) != len(names):
        errors.append("profile schedulerNames must be unique")
    queue_sorts = set()
    for prof in cfg.profiles:
        if not prof.scheduler_name:
            errors.append("profile schedulerName must not be empty")
        if prof.plugins is not None:
            qs = tuple(
                p.name for p in prof.plugins.queue_sort.enabled
            )
            if qs:
                queue_sorts.add(qs)
            errors.extend(_validate_plugins(prof.scheduler_name, prof.plugins))
    if len(queue_sorts) > 1:
        errors.append("all profiles must use the same queueSort plugins")

    for i, ext in enumerate(getattr(cfg, "extenders", [])):
        if not ext.url_prefix:
            errors.append(f"extenders[{i}].urlPrefix is required")
        if ext.weight <= 0 and ext.prioritize_verb:
            errors.append(f"extenders[{i}].weight must be positive")
        if ext.http_timeout_seconds <= 0:
            errors.append(f"extenders[{i}].httpTimeout must be positive")
    binders = sum(
        1 for ext in getattr(cfg, "extenders", []) if ext.bind_verb
    )
    if binders > 1:
        errors.append("only one extender may implement bind")

    ts = cfg.tpu_solver
    if ts.solver_mode not in ("greedy", "sinkhorn"):
        errors.append(
            f"tpuSolver.solverMode must be greedy|sinkhorn, got "
            f"{ts.solver_mode!r}"
        )
    if ts.max_batch <= 0:
        errors.append("tpuSolver.maxBatch must be positive")
    if ts.batch_window_seconds < 0:
        errors.append("tpuSolver.batchWindow must be >= 0")
    if ts.mesh_devices < 0:
        errors.append("tpuSolver.meshDevices must be >= 0")

    rb = getattr(cfg, "robustness", None)
    if rb is not None:
        if rb.solve_timeout_seconds < 0:
            errors.append("robustness.solveTimeout must be >= 0")
        if rb.failure_threshold < 1:
            errors.append("robustness.failureThreshold must be >= 1")
        if rb.cooloff_seconds < 0:
            errors.append("robustness.cooloff must be >= 0")
        if rb.probe_batches < 1:
            errors.append("robustness.probeBatches must be >= 1")
        if rb.retry_max_attempts < 1:
            errors.append("robustness.retryMaxAttempts must be >= 1")
        if rb.retry_backoff_seconds < 0:
            errors.append("robustness.retryBackoff must be >= 0")

    ct = getattr(cfg, "containment", None)
    if ct is not None:
        if ct.max_strikes < 1:
            errors.append("containment.maxStrikes must be >= 1")
        if ct.base_hold_seconds < 0:
            errors.append("containment.baseHold must be >= 0")
        if ct.max_hold_seconds < ct.base_hold_seconds:
            errors.append(
                "containment.maxHold must be >= containment.baseHold"
            )
        if ct.bisect_abort_after < 1:
            errors.append("containment.bisectAbortAfter must be >= 1")

    tn = getattr(cfg, "tenancy", None)
    if tn is not None and tn.enabled:
        if not tn.quota_enforcement and not tn.drf_bias:
            errors.append(
                "tenancy.enabled with both quotaEnforcement and "
                "drfBias off arms nothing; disable tenancy instead"
            )

    ba = getattr(cfg, "bind_ack", None)
    if ba is not None and ba.enabled:
        if ba.ack_timeout_seconds <= 0:
            errors.append("bindAck.ackTimeout must be positive")
        if ba.sweep_interval_seconds <= 0:
            errors.append("bindAck.sweepInterval must be positive")
        if ba.node_suspect_threshold < 1:
            errors.append("bindAck.nodeSuspectThreshold must be >= 1")

    rs = getattr(cfg, "resilience", None)
    if rs is not None:
        if rs.sweep_interval_seconds <= 0:
            errors.append("resilience.sweepInterval must be positive")
        if rs.drift_check_interval_seconds <= 0:
            errors.append("resilience.driftCheckInterval must be positive")

    st = getattr(cfg, "streaming", None)
    if st is not None:
        if st.trace not in ("poisson", "bursty", "diurnal", "replay"):
            errors.append(
                f"streaming.trace must be poisson|bursty|diurnal|replay, "
                f"got {st.trace!r}"
            )
        if st.trace == "replay" and not st.replay_path:
            errors.append("streaming.replayPath is required for replay")
        if st.slo_p99_seconds <= 0:
            errors.append("streaming.sloP99 must be positive")
        if st.min_window_seconds < 0:
            errors.append("streaming.minWindow must be >= 0")
        if st.max_window_seconds < st.min_window_seconds:
            errors.append("streaming.maxWindow must be >= minWindow")
        if st.latency_batch <= 0:
            errors.append("streaming.latencyBatch must be positive")
        if st.controller_interval_seconds <= 0:
            errors.append("streaming.controllerInterval must be positive")
        if st.rate_pods_per_sec <= 0:
            errors.append("streaming.rate must be positive")
        if st.max_queue_depth < 0:
            errors.append("streaming.maxQueueDepth must be >= 0")
        if not 0.0 <= st.trough_fraction <= 1.0:
            errors.append("streaming.troughFraction must be in [0, 1]")

    pt = getattr(cfg, "partition", None)
    if pt is not None and pt.enabled:
        if pt.num_partitions < 1:
            errors.append("partition.numPartitions must be >= 1")
        if pt.lease_duration_seconds <= 0:
            errors.append("partition.leaseDuration must be positive")
        if pt.retry_period_seconds <= 0:
            errors.append("partition.retryPeriod must be positive")
        if pt.retry_period_seconds >= pt.lease_duration_seconds:
            errors.append(
                "partition.retryPeriod must be < leaseDuration (a "
                "holder must be able to renew before it expires)"
            )
        if pt.clock_skew_tolerance_seconds < 0:
            errors.append("partition.clockSkewTolerance must be >= 0")
        if not pt.resource_prefix:
            errors.append("partition.resourcePrefix is required")
        le = cfg.leader_election
        if le.leader_elect:
            errors.append(
                "partition.enabled and leaderElection.leaderElect are "
                "mutually exclusive (partitioned stacks are all active)"
            )

    fi = getattr(cfg, "fault_injection", None)
    if fi is not None and fi.enabled:
        from kubernetes_tpu_torch.robustness.faults import (
            FaultPoint,
            builtin_profiles,
        )

        if fi.profile and fi.profile not in builtin_profiles():
            errors.append(
                f"faultInjection.profile {fi.profile!r} is not a known "
                f"profile ({', '.join(sorted(builtin_profiles()))})"
            )
        for name, p in fi.points.items():
            if name not in FaultPoint.ALL:
                errors.append(
                    f"faultInjection.points.{name} is not an injection "
                    f"point ({', '.join(FaultPoint.ALL)})"
                )
            if not 0.0 <= p.rate <= 1.0:
                errors.append(
                    f"faultInjection.points.{name}.rate must be in [0, 1]"
                )
            if p.hang_seconds < 0:
                errors.append(
                    f"faultInjection.points.{name}.hangSeconds must be "
                    f">= 0"
                )
    return errors


def _validate_plugins(profile: str, plugins: Plugins) -> List[str]:
    errors: List[str] = []
    for point in Plugins.EXTENSION_POINTS:
        ps = getattr(plugins, point)
        for p in ps.enabled:
            if not p.name:
                errors.append(f"profile {profile}: {point} plugin without name")
            if point == "score" and not 1 <= p.weight <= MAX_WEIGHT:
                errors.append(
                    f"profile {profile}: score plugin {p.name} weight "
                    f"{p.weight} outside [1, {MAX_WEIGHT}]"
                )
    return errors
