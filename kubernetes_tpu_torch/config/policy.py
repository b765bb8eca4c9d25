"""Legacy v1 Policy translation: predicate/priority names -> plugins.

Reference: /root/reference/pkg/scheduler/factory.go:239
(createFromConfig) + framework/plugins/legacy_registry.go -- the
pre-ComponentConfig Policy file/ConfigMap format ({"kind": "Policy",
"predicates": [...], "priorities": [...]}) mapped onto the plugin
framework, so operators migrating from a Policy keep their algorithm.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import yaml

from kubernetes_tpu_torch.config.types import (
    KubeSchedulerProfile,
    Plugin,
    PluginSet,
    Plugins,
)

# legacy_registry.go predicate name -> (filter plugin, also prefilter?)
PREDICATE_TO_PLUGIN: Dict[str, Tuple[str, bool]] = {
    "PodFitsResources": ("NodeResourcesFit", True),
    "PodFitsHostPorts": ("NodePorts", True),
    "HostName": ("NodeName", False),
    "MatchNodeSelector": ("NodeAffinity", False),
    "NoDiskConflict": ("VolumeRestrictions", False),
    "NoVolumeZoneConflict": ("VolumeZone", False),
    "PodToleratesNodeTaints": ("TaintToleration", False),
    "CheckNodeUnschedulable": ("NodeUnschedulable", False),
    "MaxEBSVolumeCount": ("EBSLimits", False),
    "MaxGCEPDVolumeCount": ("GCEPDLimits", False),
    "MaxAzureDiskVolumeCount": ("AzureDiskLimits", False),
    "MaxCSIVolumeCountPred": ("NodeVolumeLimitsCSI", False),
    "CheckVolumeBinding": ("VolumeBinding", False),
    "MatchInterPodAffinity": ("InterPodAffinity", True),
    "EvenPodsSpreadPred": ("PodTopologySpread", True),
    "TestServiceAffinity": ("ServiceAffinity", True),
    "CheckNodeLabelPresence": ("NodeLabel", False),
}

# legacy priority name -> score plugin (+ needs prescore?)
PRIORITY_TO_PLUGIN: Dict[str, Tuple[str, bool]] = {
    "LeastRequestedPriority": ("NodeResourcesLeastAllocated", False),
    "MostRequestedPriority": ("NodeResourcesMostAllocated", False),
    "BalancedResourceAllocation": ("NodeResourcesBalancedAllocation", False),
    "SelectorSpreadPriority": ("DefaultPodTopologySpread", True),
    "InterPodAffinityPriority": ("InterPodAffinity", True),
    "NodeAffinityPriority": ("NodeAffinity", False),
    "TaintTolerationPriority": ("TaintToleration", True),
    "ImageLocalityPriority": ("ImageLocality", False),
    "NodePreferAvoidPodsPriority": ("NodePreferAvoidPods", False),
    "RequestedToCapacityRatioPriority": ("RequestedToCapacityRatio", False),
    "EvenPodsSpreadPriority": ("PodTopologySpread", True),
    "ResourceLimitsPriority": ("NodeResourceLimits", True),
    "ServiceSpreadingPriority": ("DefaultPodTopologySpread", True),
}


def plugins_from_policy(raw: Dict[str, Any]) -> Plugins:
    """Translate one Policy dict into a Plugins wiring. Unknown names
    raise ValueError (the reference fails scheduler startup the same
    way)."""
    filter_names: List[str] = []
    pre_filter: List[str] = []
    pre_score: List[str] = []
    scores: List[Tuple[str, int]] = []

    def add_unique(lst: List[str], name: str) -> None:
        if name not in lst:
            lst.append(name)

    for pred in raw.get("predicates", []):
        name = pred["name"]
        mapped = PREDICATE_TO_PLUGIN.get(name)
        if mapped is None:
            raise ValueError(f"unknown Policy predicate {name!r}")
        plugin, wants_prefilter = mapped
        add_unique(filter_names, plugin)
        if wants_prefilter:
            add_unique(pre_filter, plugin)
    for prio in raw.get("priorities", []):
        name = prio["name"]
        mapped = PRIORITY_TO_PLUGIN.get(name)
        if mapped is None:
            raise ValueError(f"unknown Policy priority {name!r}")
        plugin, wants_prescore = mapped
        weight = int(prio.get("weight", 1))
        if all(plugin != p for p, _w in scores):
            scores.append((plugin, weight))
        if wants_prescore:
            add_unique(pre_score, plugin)

    return Plugins(
        queue_sort=PluginSet(enabled=[Plugin("PrioritySort")]),
        pre_filter=PluginSet(enabled=[Plugin(n) for n in pre_filter]),
        filter=PluginSet(enabled=[Plugin(n) for n in filter_names]),
        pre_score=PluginSet(enabled=[Plugin(n) for n in pre_score]),
        score=PluginSet(
            enabled=[Plugin(n, weight=w) for n, w in scores]
        ),
        bind=PluginSet(enabled=[Plugin("DefaultBinder")]),
    )


def profile_from_policy(
    raw: Dict[str, Any], scheduler_name: str = "default-scheduler"
) -> KubeSchedulerProfile:
    """One profile carrying the translated Policy wiring. The profile's
    plugins REPLACE the defaults wholesale (Policy semantics: the listed
    predicates/priorities are the whole algorithm, factory.go:239)."""
    plugins = plugins_from_policy(raw)
    # mark every extension point explicit: disable defaults with "*"
    for point in Plugins.EXTENSION_POINTS:
        ps: PluginSet = getattr(plugins, point)
        ps.disabled = [Plugin("*")]
    return KubeSchedulerProfile(
        scheduler_name=scheduler_name, plugins=plugins
    )


def load_policy(path: str) -> KubeSchedulerProfile:
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if raw.get("kind") not in (None, "Policy"):
        raise ValueError(f"not a Policy document: kind={raw.get('kind')!r}")
    return profile_from_policy(raw)
