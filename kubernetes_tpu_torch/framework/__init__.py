"""Scheduling framework: the plugin runtime and its extension-point contract.

Reference: /root/reference/pkg/scheduler/framework/v1alpha1/. The 11
extension points (QueueSort, PreFilter, Filter, PreScore, Score, Reserve,
Permit, PreBind, Bind, PostBind, Unreserve), the Status codes, CycleState
and the out-of-tree registry merge are preserved verbatim: this is the
public API that lets the TPU solver ship as a selectable profile.
"""

from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    NodeScore,
    NodeToStatusMap,
    Status,
    StatusCode,
)
from kubernetes_tpu_torch.framework.registry import Registry
from kubernetes_tpu_torch.framework.runtime import Framework

__all__ = [
    "CycleState",
    "Framework",
    "MAX_NODE_SCORE",
    "MIN_NODE_SCORE",
    "NodeScore",
    "NodeToStatusMap",
    "Registry",
    "Status",
    "StatusCode",
]
