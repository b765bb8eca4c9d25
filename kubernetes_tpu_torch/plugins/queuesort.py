"""PrioritySort queue-sort plugin
(reference framework/plugins/queuesort/priority_sort.go)."""

from __future__ import annotations

from kubernetes_tpu_torch.framework.interface import Plugin, PodInfo


class PrioritySort(Plugin):
    NAME = "PrioritySort"

    def queue_sort_less(self, a: PodInfo, b: PodInfo) -> bool:
        """Higher priority first; ties broken by queue-entry time."""
        p1 = a.pod.spec.priority
        p2 = b.pod.spec.priority
        if p1 != p2:
            return p1 > p2
        return a.timestamp < b.timestamp

    def queue_sort_key(self, pi: PodInfo):
        """Total-order key equivalent to ``queue_sort_less`` -- lets the
        activeQ heap compare natively (C tuple compare) instead of calling
        back into Python per comparison."""
        return (-pi.pod.spec.priority, pi.timestamp)
