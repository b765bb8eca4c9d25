"""In-tree plugins: the host-path (oracle) implementations.

Reference: /root/reference/pkg/scheduler/framework/plugins/. Every plugin
here has vectorized TPU equivalents in kubernetes_tpu_torch.ops (feasibility-mask
columns for Filter, score-matrix columns for Score); this sequential set is
the correctness oracle the TPU profile is differentially tested against.
"""

from kubernetes_tpu_torch.framework.registry import Registry


def new_in_tree_registry() -> Registry:
    """Reference framework/plugins/registry.go:45 NewInTreeRegistry."""
    from kubernetes_tpu_torch.plugins import (
        coscheduling,
        defaultbinder,
        imagelocality,
        interpodaffinity,
        nodeaffinity,
        nodename,
        nodeports,
        nodepreferavoidpods,
        noderesources,
        nodeunschedulable,
        podtopologyspread,
        queuesort,
        selectorspread,
        tainttoleration,
        volumes,
    )

    r = Registry()
    r.register(queuesort.PrioritySort.NAME, lambda a, h: queuesort.PrioritySort())
    r.register(noderesources.Fit.NAME, lambda a, h: noderesources.Fit(a))
    r.register(
        noderesources.LeastAllocated.NAME, lambda a, h: noderesources.LeastAllocated()
    )
    r.register(
        noderesources.MostAllocated.NAME, lambda a, h: noderesources.MostAllocated()
    )
    r.register(
        noderesources.BalancedAllocation.NAME,
        lambda a, h: noderesources.BalancedAllocation(),
    )
    r.register(
        noderesources.RequestedToCapacityRatio.NAME,
        lambda a, h: noderesources.RequestedToCapacityRatio(a),
    )
    r.register(
        noderesources.ResourceLimits.NAME, lambda a, h: noderesources.ResourceLimits()
    )
    r.register(nodename.NodeName.NAME, lambda a, h: nodename.NodeName())
    r.register(nodeports.NodePorts.NAME, lambda a, h: nodeports.NodePorts())
    r.register(
        nodeunschedulable.NodeUnschedulable.NAME,
        lambda a, h: nodeunschedulable.NodeUnschedulable(),
    )
    r.register(nodeaffinity.NodeAffinity.NAME, lambda a, h: nodeaffinity.NodeAffinity())
    r.register(
        tainttoleration.TaintToleration.NAME,
        lambda a, h: tainttoleration.TaintToleration(),
    )
    r.register(
        imagelocality.ImageLocality.NAME, lambda a, h: imagelocality.ImageLocality(h)
    )
    r.register(
        nodepreferavoidpods.NodePreferAvoidPods.NAME,
        lambda a, h: nodepreferavoidpods.NodePreferAvoidPods(),
    )
    r.register(
        defaultbinder.DefaultBinder.NAME, lambda a, h: defaultbinder.DefaultBinder(h)
    )
    r.register(
        podtopologyspread.PodTopologySpread.NAME,
        lambda a, h: podtopologyspread.PodTopologySpread(h),
    )
    r.register(
        interpodaffinity.InterPodAffinity.NAME,
        lambda a, h: interpodaffinity.InterPodAffinity(a, h),
    )
    r.register(
        volumes.VolumeRestrictions.NAME, lambda a, h: volumes.VolumeRestrictions()
    )
    r.register(volumes.VolumeZone.NAME, lambda a, h: volumes.VolumeZone(h))
    r.register(volumes.CSILimits.NAME, lambda a, h: volumes.CSILimits(h))
    from kubernetes_tpu_torch.plugins import numa

    r.register(
        numa.NodeResourcesNumaAligned.NAME,
        lambda a, h: numa.NodeResourcesNumaAligned(h),
    )
    r.register(volumes.EBSLimits.NAME, lambda a, h: volumes.EBSLimits(h))
    r.register(volumes.GCEPDLimits.NAME, lambda a, h: volumes.GCEPDLimits(h))
    r.register(
        volumes.AzureDiskLimits.NAME, lambda a, h: volumes.AzureDiskLimits(h)
    )
    r.register(volumes.VolumeBinding.NAME, lambda a, h: volumes.VolumeBinding(h))
    r.register(
        selectorspread.DefaultPodTopologySpread.NAME,
        lambda a, h: selectorspread.DefaultPodTopologySpread(h),
    )
    r.register(
        selectorspread.ServiceAffinity.NAME,
        lambda a, h: selectorspread.ServiceAffinity(a, h),
    )
    r.register(
        selectorspread.NodeLabel.NAME, lambda a, h: selectorspread.NodeLabel(a)
    )
    r.register(
        coscheduling.Coscheduling.NAME,
        lambda a, h: coscheduling.Coscheduling(a, h),
    )
    return r
