"""noderesources plugins: Fit filter and the allocation-based scorers.

Reference: /root/reference/pkg/scheduler/framework/plugins/noderesources/
(fit.go, least_allocated.go, most_allocated.go, balanced_allocation.go,
requested_to_capacity_ratio.go, resource_limits.go, resource_allocation.go).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    Pod,
    pod_resource_limits,
    pod_resource_requests,
)
from kubernetes_tpu_torch.cache.node_info import (
    DEFAULT_MEMORY_REQUEST,
    DEFAULT_MILLI_CPU_REQUEST,
    NodeInfo,
    Resource,
    new_resource,
    non_zero_requests,
)
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    MAX_NODE_SCORE,
    Plugin,
    Status,
)

_PRE_FILTER_FIT_STATE_KEY = "PreFilterNodeResourcesFit"


@dataclass
class _FitState:
    pod_request: Resource

    def clone(self) -> "_FitState":
        return _FitState(self.pod_request.clone())


class Fit(Plugin):
    """PreFilter+Filter (fit.go:99 computePodResourceRequest, :181
    fitsRequest)."""

    NAME = "NodeResourcesFit"

    def __init__(self, args: Optional[dict] = None) -> None:
        args = args or {}
        self.ignored_resources = set(args.get("ignored_resources", ()))
        self.ignored_resource_groups = set(args.get("ignored_resource_groups", ()))

    def pre_filter(self, state: CycleState, pod: Pod) -> Optional[Status]:
        state.write(
            _PRE_FILTER_FIT_STATE_KEY,
            _FitState(new_resource(pod_resource_requests(pod))),
        )
        return None

    def _get_state(self, state: CycleState) -> _FitState:
        try:
            return state.read(_PRE_FILTER_FIT_STATE_KEY)
        except KeyError:
            # Filter without PreFilter (preemption simulations recompute)
            raise

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        try:
            fit_state = self._get_state(state)
        except KeyError:
            fit_state = _FitState(new_resource(pod_resource_requests(pod)))
        insufficient = self._insufficient_resources(fit_state.pod_request, node_info)
        if insufficient:
            return Status.unschedulable(*insufficient)
        return None

    def _insufficient_resources(
        self, req: Resource, node_info: NodeInfo
    ) -> List[str]:
        """fit.go:181 fitsRequest."""
        out: List[str] = []
        allowed = node_info.allocatable.allowed_pod_number
        if len(node_info.pods) + 1 > allowed:
            out.append(f"Too many pods ({len(node_info.pods)}/{allowed})")
        if (
            req.milli_cpu == 0
            and req.memory == 0
            and req.ephemeral_storage == 0
            and not any(req.scalar.values())
        ):
            return out
        alloc = node_info.allocatable
        used = node_info.requested
        if req.milli_cpu > alloc.milli_cpu - used.milli_cpu:
            out.append("Insufficient cpu")
        if req.memory > alloc.memory - used.memory:
            out.append("Insufficient memory")
        if req.ephemeral_storage > alloc.ephemeral_storage - used.ephemeral_storage:
            out.append("Insufficient ephemeral-storage")
        for name, qty in req.scalar.items():
            if qty == 0 or name in self.ignored_resources:
                continue
            group = name.split("/", 1)[0] if "/" in name else ""
            if group in self.ignored_resource_groups:
                continue
            if qty > alloc.scalar.get(name, 0) - used.scalar.get(name, 0):
                out.append(f"Insufficient {name}")
        return out


def _pod_plus_node_requested(pod: Pod, node_info: NodeInfo) -> Tuple[int, int]:
    """(cpu, mem) = node's non-zero requested + this pod's non-zero request
    (reference resource_allocation.go:90 calculateResourceAllocatableRequest)."""
    pcpu, pmem = non_zero_requests(pod)
    return (
        node_info.non_zero_requested.milli_cpu + pcpu,
        node_info.non_zero_requested.memory + pmem,
    )


class LeastAllocated(Plugin):
    """Score (least_allocated.go): prefers emptier nodes."""

    NAME = "NodeResourcesLeastAllocated"

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        ni = _node_info_or_error(self, node_name, state)
        if isinstance(ni, Status):
            return 0, ni
        req_cpu, req_mem = _pod_plus_node_requested(pod, ni)
        cap_cpu = ni.allocatable.milli_cpu
        cap_mem = ni.allocatable.memory

        def least(cap: int, req: int) -> int:
            if cap == 0:
                return 0
            if req > cap:
                return 0
            return (cap - req) * MAX_NODE_SCORE // cap

        return (least(cap_cpu, req_cpu) + least(cap_mem, req_mem)) // 2, None


class MostAllocated(Plugin):
    """Score (most_allocated.go): bin-packing, prefers fuller nodes."""

    NAME = "NodeResourcesMostAllocated"

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        ni = _node_info_or_error(self, node_name, state)
        if isinstance(ni, Status):
            return 0, ni
        req_cpu, req_mem = _pod_plus_node_requested(pod, ni)
        cap_cpu = ni.allocatable.milli_cpu
        cap_mem = ni.allocatable.memory

        def most(cap: int, req: int) -> int:
            if cap == 0 or req > cap:
                return 0
            return req * MAX_NODE_SCORE // cap

        return (most(cap_cpu, req_cpu) + most(cap_mem, req_mem)) // 2, None


class BalancedAllocation(Plugin):
    """Score (balanced_allocation.go:83): 100 * (1 - |cpuFrac - memFrac|)."""

    NAME = "NodeResourcesBalancedAllocation"

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        ni = _node_info_or_error(self, node_name, state)
        if isinstance(ni, Status):
            return 0, ni
        req_cpu, req_mem = _pod_plus_node_requested(pod, ni)
        cap_cpu = ni.allocatable.milli_cpu
        cap_mem = ni.allocatable.memory
        cpu_frac = req_cpu / cap_cpu if cap_cpu else 1.0
        mem_frac = req_mem / cap_mem if cap_mem else 1.0
        if cpu_frac >= 1.0 or mem_frac >= 1.0:
            return 0, None
        diff = abs(cpu_frac - mem_frac)
        return int((1 - diff) * MAX_NODE_SCORE), None


@dataclass
class _FunctionShapePoint:
    utilization: int  # 0-100
    score: int  # 0-10 (scaled to 0-100 by the plugin)


class RequestedToCapacityRatio(Plugin):
    """Score (requested_to_capacity_ratio.go): user-defined piecewise-linear
    utilization -> score curve."""

    NAME = "RequestedToCapacityRatio"

    def __init__(self, args: Optional[dict] = None) -> None:
        args = args or {}
        shape = args.get("shape") or [
            {"utilization": 0, "score": 0},
            {"utilization": 100, "score": 10},
        ]
        self.points = [
            _FunctionShapePoint(p["utilization"], p["score"]) for p in shape
        ]
        resources = args.get("resources") or [
            {"name": RESOURCE_CPU, "weight": 1},
            {"name": RESOURCE_MEMORY, "weight": 1},
        ]
        self.resources = [(r["name"], r.get("weight", 1)) for r in resources]

    def _curve(self, utilization: float) -> float:
        """Piecewise linear through shape points, score scaled x10 -> 0-100."""
        pts = self.points
        if utilization <= pts[0].utilization:
            return pts[0].score * 10
        for a, b in zip(pts, pts[1:]):
            if utilization <= b.utilization:
                span = b.utilization - a.utilization
                t = (utilization - a.utilization) / span if span else 0.0
                return (a.score + (b.score - a.score) * t) * 10
        return pts[-1].score * 10

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        ni = _node_info_or_error(self, node_name, state)
        if isinstance(ni, Status):
            return 0, ni
        req_cpu, req_mem = _pod_plus_node_requested(pod, ni)
        values = {
            RESOURCE_CPU: (req_cpu, ni.allocatable.milli_cpu),
            RESOURCE_MEMORY: (req_mem, ni.allocatable.memory),
        }
        total_weight = sum(w for _, w in self.resources)
        if total_weight == 0:
            return 0, None
        acc = 0.0
        for name, weight in self.resources:
            req, cap = values.get(name, (0, 0))
            utilization = min(req * 100.0 / cap, 100.0) if cap else 100.0
            acc += self._curve(utilization) * weight
        return int(acc / total_weight), None


_RESOURCE_LIMITS_STATE_KEY = "PreScoreResourceLimits"


class ResourceLimits(Plugin):
    """PreScore+Score (resource_limits.go): score 1 if the node can satisfy
    the pod's resource *limits*, else 0."""

    NAME = "NodeResourceLimits"

    def pre_score(
        self, state: CycleState, pod: Pod, nodes: List[NodeInfo]
    ) -> Optional[Status]:
        state.write(
            _RESOURCE_LIMITS_STATE_KEY, new_resource(pod_resource_limits(pod))
        )
        return None

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        ni = _node_info_or_error(self, node_name, state)
        if isinstance(ni, Status):
            return 0, ni
        try:
            limits: Resource = state.read(_RESOURCE_LIMITS_STATE_KEY)
        except KeyError:
            return 0, None
        cpu_ok = limits.milli_cpu == 0 or limits.milli_cpu <= ni.allocatable.milli_cpu
        mem_ok = limits.memory == 0 or limits.memory <= ni.allocatable.memory
        has_any = limits.milli_cpu > 0 or limits.memory > 0
        return (1 if (has_any and cpu_ok and mem_ok) else 0), None


def _node_info_or_error(plugin: Plugin, node_name: str, state: CycleState):
    """Score plugins read NodeInfo through the snapshot placed into the
    cycle state by the generic scheduler."""
    try:
        snapshot = state.read("__snapshot__")
    except KeyError:
        return Status.error(f"{plugin.name()}: no snapshot in cycle state")
    ni = snapshot.get_node_info(node_name)
    if ni is None or ni.node is None:
        return Status.error(f"{plugin.name()}: node {node_name} not in snapshot")
    return ni
