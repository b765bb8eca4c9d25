"""Scheduler cache: authoritative in-memory cluster state.

Reference: /root/reference/pkg/scheduler/internal/cache/ and
/root/reference/pkg/scheduler/nodeinfo/.
"""

from kubernetes_tpu_torch.cache.node_info import NodeInfo, Resource, new_resource
from kubernetes_tpu_torch.cache.cache import SchedulerCache
from kubernetes_tpu_torch.cache.snapshot import Snapshot

__all__ = ["NodeInfo", "Resource", "SchedulerCache", "Snapshot", "new_resource"]
