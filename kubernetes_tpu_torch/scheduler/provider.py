"""Default algorithm provider: the canonical plugin wiring.

Reference: /root/reference/pkg/scheduler/algorithmprovider/registry.go:77
(getDefaultConfig). Plugins not yet implemented in this build are noted and
appended as they land; the TPU profile overlays this set via
Plugins.apply().
"""

from __future__ import annotations

from kubernetes_tpu_torch.config.types import Plugin as P, PluginSet, Plugins


def default_plugins() -> Plugins:
    return Plugins(
        queue_sort=PluginSet(enabled=[P("PrioritySort")]),
        pre_filter=PluginSet(
            enabled=[
                P("NodeResourcesFit"),
                P("NodePorts"),
                P("PodTopologySpread"),
                P("InterPodAffinity"),
                P("Coscheduling"),
            ]
        ),
        filter=PluginSet(
            enabled=[
                P("NodeUnschedulable"),
                P("NodeResourcesFit"),
                P("NodeName"),
                P("NodePorts"),
                P("NodeAffinity"),
                P("VolumeRestrictions"),
                P("TaintToleration"),
                P("EBSLimits"),
                P("GCEPDLimits"),
                P("AzureDiskLimits"),
                P("NodeVolumeLimitsCSI"),
                P("VolumeBinding"),
                P("VolumeZone"),
                P("PodTopologySpread"),
                P("InterPodAffinity"),
                # no-op without the numa opt-in annotation
                P("NodeResourcesNumaAligned"),
            ]
        ),
        pre_score=PluginSet(
            enabled=[
                P("InterPodAffinity"),
                P("PodTopologySpread"),
                P("DefaultPodTopologySpread"),
                P("TaintToleration"),
            ]
        ),
        score=PluginSet(
            enabled=[
                P("NodeResourcesBalancedAllocation", weight=1),
                P("ImageLocality", weight=1),
                P("InterPodAffinity", weight=1),
                P("NodeResourcesLeastAllocated", weight=1),
                P("NodeAffinity", weight=1),
                P("NodePreferAvoidPods", weight=10000),
                P("DefaultPodTopologySpread", weight=1),
                P("PodTopologySpread", weight=2),
                P("TaintToleration", weight=1),
                P("NodeResourcesNumaAligned", weight=1),
            ]
        ),
        # v1.18 binds volumes via the scheduler's VolumeBinder call
        # (scheduler.go:693 bindVolumes); this build routes it through the
        # PreBind extension point of the same plugin (volumes.py docstring)
        reserve=PluginSet(enabled=[P("NodeResourcesNumaAligned")]),
        unreserve=PluginSet(enabled=[P("NodeResourcesNumaAligned")]),
        pre_bind=PluginSet(enabled=[P("VolumeBinding")]),
        # gang scheduling: the out-of-tree coscheduling pattern, enabled by
        # default in this build (no-op for pods without a pod-group label)
        permit=PluginSet(enabled=[P("Coscheduling")]),
        bind=PluginSet(enabled=[P("DefaultBinder")]),
    )


def minimal_plugins() -> Plugins:
    """The SchedulingBasic slice: resource fit + allocation scorers only
    (BASELINE.json config #1)."""
    return Plugins(
        queue_sort=PluginSet(enabled=[P("PrioritySort")]),
        pre_filter=PluginSet(enabled=[P("NodeResourcesFit"), P("NodePorts")]),
        filter=PluginSet(
            enabled=[
                P("NodeUnschedulable"),
                P("NodeResourcesFit"),
                P("NodeName"),
                P("NodePorts"),
                P("NodeAffinity"),
                P("TaintToleration"),
            ]
        ),
        pre_score=PluginSet(enabled=[P("TaintToleration")]),
        score=PluginSet(
            enabled=[
                P("NodeResourcesBalancedAllocation", weight=1),
                P("NodeResourcesLeastAllocated", weight=1),
                P("NodeAffinity", weight=1),
                P("TaintToleration", weight=1),
            ]
        ),
        bind=PluginSet(enabled=[P("DefaultBinder")]),
    )
