"""KubeSchedulerConfiguration loading: YAML/JSON -> typed config.

Reference: the layered config system (SURVEY.md section 5): versioned
ComponentConfig decoded with defaulting (apis/config/v1alpha2), feature
gates (component-base/featuregate), per-plugin args. Field names accept
the reference's camelCase wire form.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import yaml

from kubernetes_tpu_torch.config.types import (
    BindAckConfiguration,
    ContainmentConfiguration,
    FaultInjectionConfiguration,
    FaultPointConfiguration,
    KubeSchedulerConfiguration,
    KubeSchedulerProfile,
    LeaderElectionConfiguration,
    PartitionConfiguration,
    Plugin,
    PluginSet,
    Plugins,
    ResilienceConfiguration,
    RobustnessConfiguration,
    StreamingConfiguration,
    TenancyConfiguration,
    TPUSolverConfiguration,
)
from kubernetes_tpu_torch.scheduler.extender import ExtenderConfig

_POINT_KEYS = {
    "queueSort": "queue_sort",
    "preFilter": "pre_filter",
    "filter": "filter",
    "preScore": "pre_score",
    "score": "score",
    "reserve": "reserve",
    "permit": "permit",
    "preBind": "pre_bind",
    "bind": "bind",
    "postBind": "post_bind",
    "unreserve": "unreserve",
}


def _plugin_set(raw: Dict[str, Any]) -> PluginSet:
    def plugin(p: Dict[str, Any]) -> Plugin:
        return Plugin(name=p["name"], weight=int(p.get("weight", 1)))

    return PluginSet(
        enabled=[plugin(p) for p in raw.get("enabled", [])],
        disabled=[plugin(p) for p in raw.get("disabled", [])],
    )


def _plugins(raw: Optional[Dict[str, Any]]) -> Optional[Plugins]:
    if raw is None:
        return None
    out = Plugins()
    for wire_key, attr in _POINT_KEYS.items():
        if wire_key in raw:
            setattr(out, attr, _plugin_set(raw[wire_key]))
    return out


def _profile(raw: Dict[str, Any]) -> KubeSchedulerProfile:
    plugin_config = {
        pc["name"]: pc.get("args", {}) for pc in raw.get("pluginConfig", [])
    }
    return KubeSchedulerProfile(
        scheduler_name=raw.get("schedulerName", "default-scheduler"),
        plugins=_plugins(raw.get("plugins")),
        plugin_config=plugin_config,
    )


_DURATION_UNITS = {
    "ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
    "s": 1.0, "m": 60.0, "h": 3600.0,
}


def _duration_seconds(raw: Any) -> float:
    """Accept numeric seconds or Go-style duration strings ("30s",
    "1m30s", "500ms") -- the reference wire format expresses HTTPTimeout
    and the leader-election knobs as metav1.Duration."""
    if isinstance(raw, (int, float)):
        return float(raw)
    s = str(raw).strip()
    try:
        return float(s)
    except ValueError:
        pass
    total = 0.0
    m = re.fullmatch(r"(?:\d+(?:\.\d+)?(?:ns|us|µs|ms|s|m|h))+", s)
    if not m:
        raise ValueError(f"invalid duration {raw!r}")
    for num, unit in re.findall(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)", s):
        total += float(num) * _DURATION_UNITS[unit]
    return total


def _extender(raw: Dict[str, Any]) -> ExtenderConfig:
    return ExtenderConfig(
        url_prefix=raw.get("urlPrefix", ""),
        filter_verb=raw.get("filterVerb", ""),
        prioritize_verb=raw.get("prioritizeVerb", ""),
        bind_verb=raw.get("bindVerb", ""),
        preempt_verb=raw.get("preemptVerb", ""),
        weight=int(raw.get("weight", 1)),
        node_cache_capable=bool(raw.get("nodeCacheCapable", False)),
        ignorable=bool(raw.get("ignorable", False)),
        managed_resources=[
            r["name"] for r in raw.get("managedResources", [])
        ],
        http_timeout_seconds=_duration_seconds(raw.get("httpTimeout", 5.0)),
    )


def streaming_from_dict(st_raw: Dict[str, Any]) -> StreamingConfiguration:
    """Parse a ``streaming:`` block (camelCase wire form). Shared by
    the top-level config loader and the perf-matrix runner's
    workload-scoped blocks, so both speak the same schema."""
    return StreamingConfiguration(
        enabled=bool(st_raw.get("enabled", False)),
        slo_p99_seconds=_duration_seconds(st_raw.get("sloP99", 1.0)),
        min_window_seconds=_duration_seconds(st_raw.get("minWindow", 0.0)),
        max_window_seconds=_duration_seconds(st_raw.get("maxWindow", 0.25)),
        latency_batch=int(st_raw.get("latencyBatch", 512)),
        auto_rungs=bool(st_raw.get("autoRungs", False)),
        controller_interval_seconds=_duration_seconds(
            st_raw.get("controllerInterval", 0.25)
        ),
        band_priority_threshold=(
            int(st_raw["bandPriorityThreshold"])
            if "bandPriorityThreshold" in st_raw
            else None
        ),
        band_priority_class=st_raw.get("bandPriorityClass", ""),
        max_queue_depth=int(st_raw.get("maxQueueDepth", 20000)),
        trace=st_raw.get("trace", "poisson"),
        rate_pods_per_sec=float(st_raw.get("rate", 1000.0)),
        duration_seconds=_duration_seconds(st_raw.get("duration", 30.0)),
        seed=int(st_raw.get("seed", 0)),
        burst_rate_pods_per_sec=float(st_raw.get("burstRate", 0.0)),
        base_dwell_seconds=_duration_seconds(st_raw.get("baseDwell", 8.0)),
        burst_dwell_seconds=_duration_seconds(
            st_raw.get("burstDwell", 2.0)
        ),
        period_seconds=_duration_seconds(st_raw.get("period", 60.0)),
        trough_fraction=float(st_raw.get("troughFraction", 0.2)),
        replay_path=st_raw.get("replayPath", ""),
    )


def load_config_from_dict(raw: Dict[str, Any]) -> KubeSchedulerConfiguration:
    le_raw = raw.get("leaderElection", {})
    cfg = KubeSchedulerConfiguration(
        profiles=[_profile(p) for p in raw.get("profiles", [])],
        percentage_of_nodes_to_score=int(
            raw.get("percentageOfNodesToScore", 0)
        ),
        pod_initial_backoff_seconds=float(
            raw.get("podInitialBackoffSeconds", 1.0)
        ),
        pod_max_backoff_seconds=float(raw.get("podMaxBackoffSeconds", 10.0)),
        leader_election=LeaderElectionConfiguration(
            leader_elect=bool(le_raw.get("leaderElect", False)),
            lease_duration_seconds=_duration_seconds(le_raw.get("leaseDuration", 15.0)),
            renew_deadline_seconds=_duration_seconds(le_raw.get("renewDeadline", 10.0)),
            retry_period_seconds=_duration_seconds(le_raw.get("retryPeriod", 2.0)),
            resource_name=le_raw.get("resourceName", "kube-scheduler"),
            resource_namespace=le_raw.get("resourceNamespace", "kube-system"),
            renew_jitter_fraction=float(le_raw.get("renewJitter", 0.1)),
            clock_skew_tolerance_seconds=_duration_seconds(
                le_raw.get("clockSkewTolerance", 0.0)
            ),
        ),
        health_bind_address=raw.get("healthzBindAddress", ""),
        metrics_bind_address=raw.get("metricsBindAddress", ""),
        feature_gates=dict(raw.get("featureGates", {})),
    )
    solver_raw = raw.get("tpuSolver", {})
    cfg.tpu_solver = TPUSolverConfiguration(
        enabled=bool(solver_raw.get("enabled", True)),
        max_batch=int(solver_raw.get("maxBatch", 256)),
        solver_mode=solver_raw.get("solverMode", "greedy"),
        batch_window_seconds=_duration_seconds(
            solver_raw.get("batchWindow", 0.01)
        ),
        mesh_devices=int(solver_raw.get("meshDevices", 0)),
    )
    cfg.extenders = [_extender(e) for e in raw.get("extenders", [])]
    rb_raw = raw.get("robustness", {})
    cfg.robustness = RobustnessConfiguration(
        enabled=bool(rb_raw.get("enabled", True)),
        solve_timeout_seconds=_duration_seconds(
            rb_raw.get("solveTimeout", 60.0)
        ),
        failure_threshold=int(rb_raw.get("failureThreshold", 3)),
        cooloff_seconds=_duration_seconds(rb_raw.get("cooloff", 5.0)),
        probe_batches=int(rb_raw.get("probeBatches", 1)),
        retry_max_attempts=int(rb_raw.get("retryMaxAttempts", 2)),
        retry_backoff_seconds=_duration_seconds(
            rb_raw.get("retryBackoff", 0.05)
        ),
        retry_max_backoff_seconds=_duration_seconds(
            rb_raw.get("retryMaxBackoff", 1.0)
        ),
    )
    ct_raw = raw.get("containment", {})
    cfg.containment = ContainmentConfiguration(
        enabled=bool(ct_raw.get("enabled", True)),
        max_strikes=int(ct_raw.get("maxStrikes", 3)),
        base_hold_seconds=_duration_seconds(
            ct_raw.get("baseHold", 0.25)
        ),
        max_hold_seconds=_duration_seconds(ct_raw.get("maxHold", 5.0)),
        bisect_abort_after=int(ct_raw.get("bisectAbortAfter", 4)),
    )
    rs_raw = raw.get("resilience", {})
    cfg.resilience = ResilienceConfiguration(
        sweeper_enabled=bool(rs_raw.get("sweeperEnabled", True)),
        sweep_interval_seconds=_duration_seconds(
            rs_raw.get("sweepInterval", 1.0)
        ),
        drift_check_interval_seconds=_duration_seconds(
            rs_raw.get("driftCheckInterval", 5.0)
        ),
        commit_fencing=bool(rs_raw.get("commitFencing", True)),
    )
    cfg.streaming = streaming_from_dict(raw.get("streaming", {}))
    pt_raw = raw.get("partition", {})
    cfg.partition = PartitionConfiguration(
        enabled=bool(pt_raw.get("enabled", False)),
        num_partitions=int(pt_raw.get("numPartitions", 2)),
        lease_duration_seconds=_duration_seconds(
            pt_raw.get("leaseDuration", 1.0)
        ),
        retry_period_seconds=_duration_seconds(
            pt_raw.get("retryPeriod", 0.1)
        ),
        clock_skew_tolerance_seconds=_duration_seconds(
            pt_raw.get("clockSkewTolerance", 0.0)
        ),
        zone_aligned=bool(pt_raw.get("zoneAligned", False)),
        resource_namespace=pt_raw.get("resourceNamespace", "kube-system"),
        resource_prefix=pt_raw.get("resourcePrefix", "ksp-partition"),
    )
    tn_raw = raw.get("tenancy", {})
    cfg.tenancy = TenancyConfiguration(
        enabled=bool(tn_raw.get("enabled", False)),
        quota_enforcement=bool(tn_raw.get("quotaEnforcement", True)),
        drf_bias=bool(tn_raw.get("drfBias", True)),
    )
    ba_raw = raw.get("bindAck", {})
    cfg.bind_ack = BindAckConfiguration(
        enabled=bool(ba_raw.get("enabled", False)),
        ack_timeout_seconds=_duration_seconds(
            ba_raw.get("ackTimeout", 5.0)
        ),
        sweep_interval_seconds=_duration_seconds(
            ba_raw.get("sweepInterval", 0.5)
        ),
        node_suspect_threshold=int(ba_raw.get("nodeSuspectThreshold", 1)),
        taint_suspect_nodes=bool(ba_raw.get("taintSuspectNodes", True)),
    )
    fi_raw = raw.get("faultInjection", {})
    cfg.fault_injection = FaultInjectionConfiguration(
        enabled=bool(fi_raw.get("enabled", False)),
        profile=fi_raw.get("profile", ""),
        seed=int(fi_raw.get("seed", 0)),
        points={
            name: FaultPointConfiguration(
                rate=float(p.get("rate", 0.0)),
                max_fires=(
                    int(p["maxFires"]) if "maxFires" in p else None
                ),
                hang_seconds=_duration_seconds(p.get("hangSeconds", 0.0)),
            )
            for name, p in fi_raw.get("points", {}).items()
        },
    )
    return cfg


def load_config(path: str, validate: bool = True) -> KubeSchedulerConfiguration:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cfg = load_config_from_dict(raw)
    if validate:
        from kubernetes_tpu_torch.config.validation import validate_config

        errors = validate_config(cfg)
        if errors:
            raise ValueError(
                "invalid KubeSchedulerConfiguration: " + "; ".join(errors)
            )
    return cfg


class FeatureGate:
    """component-base/featuregate/feature_gate.go: thread-safe known-gate
    map with defaults + overrides."""

    def __init__(self, defaults: Optional[Dict[str, bool]] = None) -> None:
        self._known: Dict[str, bool] = dict(defaults or {})

    def add(self, name: str, default: bool) -> None:
        self._known.setdefault(name, default)

    def set_from_map(self, overrides: Dict[str, bool]) -> None:
        for name, value in overrides.items():
            if name not in self._known:
                raise ValueError(f"unknown feature gate {name!r}")
            self._known[name] = value

    def enabled(self, name: str) -> bool:
        if name not in self._known:
            raise ValueError(f"unknown feature gate {name!r}")
        return self._known[name]


# the gates the scheduler path consults (pkg/features/kube_features.go)
DEFAULT_FEATURE_GATES = {
    "EvenPodsSpread": True,
    "ResourceLimitsPriorityFunction": False,
    "NonPreemptingPriority": True,
    "BalanceAttachedNodeVolumes": False,
    "TPUBatchSolver": True,  # this build's fast path
}
