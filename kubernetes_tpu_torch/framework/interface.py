"""Extension-point interfaces, Status codes, CycleState.

Reference: /root/reference/pkg/scheduler/framework/v1alpha1/interface.go
(Status codes :57-77, node score range :88, plugin interfaces :230-:407)
and cycle_state.go:44.

Plugins are duck-typed: a plugin registers for an extension point by
implementing the corresponding method (``filter``, ``score``, ...). The
``Framework`` runtime (runtime.py) discovers capability by attribute,
mirroring Go's interface satisfaction.
"""

from __future__ import annotations

import enum
import threading
from typing import Any, Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from kubernetes_tpu_torch.api.types import Pod
    from kubernetes_tpu_torch.cache.node_info import NodeInfo


class StatusCode(enum.IntEnum):
    """Reference interface.go:57-77."""

    SUCCESS = 0
    ERROR = 1
    UNSCHEDULABLE = 2
    UNSCHEDULABLE_AND_UNRESOLVABLE = 3
    WAIT = 4
    SKIP = 5


MIN_NODE_SCORE = 0  # interface.go:85
MAX_NODE_SCORE = 100  # interface.go:88
MAX_TOTAL_SCORE = (1 << 63) - 1


class Status:
    """Result of running a plugin. ``None`` is treated as Success everywhere
    (reference: a nil *Status means success)."""

    __slots__ = ("code", "reasons")

    def __init__(self, code: StatusCode, *reasons: str) -> None:
        self.code = code
        self.reasons: List[str] = list(reasons)

    # constructors ----------------------------------------------------------

    @staticmethod
    def success() -> Optional["Status"]:
        return None

    @staticmethod
    def error(msg: str) -> "Status":
        return Status(StatusCode.ERROR, msg)

    @staticmethod
    def unschedulable(*reasons: str) -> "Status":
        return Status(StatusCode.UNSCHEDULABLE, *reasons)

    @staticmethod
    def unschedulable_and_unresolvable(*reasons: str) -> "Status":
        return Status(StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE, *reasons)

    @staticmethod
    def wait() -> "Status":
        return Status(StatusCode.WAIT)

    @staticmethod
    def skip() -> "Status":
        return Status(StatusCode.SKIP)

    # predicates ------------------------------------------------------------

    def is_success(self) -> bool:
        return self.code == StatusCode.SUCCESS

    def is_unschedulable(self) -> bool:
        return self.code in (
            StatusCode.UNSCHEDULABLE,
            StatusCode.UNSCHEDULABLE_AND_UNRESOLVABLE,
        )

    def message(self) -> str:
        return ", ".join(self.reasons)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Status({self.code.name}, {self.message()!r})"


def is_success(status: Optional[Status]) -> bool:
    return status is None or status.is_success()


def is_unschedulable(status: Optional[Status]) -> bool:
    return status is not None and status.is_unschedulable()


class FitError(Exception):
    """Raised by the generic scheduler when no node fits
    (reference core/generic_scheduler.go:83 FitError)."""

    def __init__(self, pod: "Pod", num_nodes: int, statuses: "NodeToStatusMap"):
        self.pod = pod
        self.num_all_nodes = num_nodes
        self.filtered_nodes_statuses = statuses
        super().__init__(
            f"0/{num_nodes} nodes are available for pod {pod.key()}"
        )


NodeToStatusMap = Dict[str, Status]


class CycleState:
    """Per-scheduling-cycle key/value store (reference cycle_state.go:44).

    Thread-safe; cloned for preemption simulations."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._data: Dict[str, Any] = {}
        self.record_plugin_metrics = False

    def read(self, key: str) -> Any:
        with self._lock:
            if key not in self._data:
                raise KeyError(key)
            return self._data[key]

    def write(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def clone(self) -> "CycleState":
        cs = CycleState()
        with self._lock:
            for k, v in self._data.items():
                # StateData values may implement clone() (reference StateData
                # interface requires Clone); fall back to sharing.
                cs._data[k] = v.clone() if hasattr(v, "clone") else v
        cs.record_plugin_metrics = self.record_plugin_metrics
        return cs


class NodeScore:
    """Reference interface.go:94."""

    __slots__ = ("name", "score")

    def __init__(self, name: str, score: int) -> None:
        self.name = name
        self.score = score

    def __repr__(self) -> str:  # pragma: no cover
        return f"NodeScore({self.name}, {self.score})"


NodeScoreList = List[NodeScore]
PluginToNodeScores = Dict[str, NodeScoreList]


class PodInfo:
    """Pod wrapper kept in the scheduling queue (reference
    framework/v1alpha1/types.go:29: Pod, Timestamp, Attempts,
    InitialAttemptTimestamp)."""

    __slots__ = ("pod", "timestamp", "attempts", "initial_attempt_timestamp")

    def __init__(self, pod: "Pod", timestamp: float = 0.0) -> None:
        self.pod = pod
        self.timestamp = timestamp
        self.attempts = 0
        self.initial_attempt_timestamp = timestamp

    def deep_copy(self) -> "PodInfo":
        pi = PodInfo(self.pod, self.timestamp)
        pi.attempts = self.attempts
        pi.initial_attempt_timestamp = self.initial_attempt_timestamp
        return pi


class Plugin:
    """Base class for all plugins. Subclasses implement any subset of the
    extension-point methods below; the runtime dispatches by attribute.

    Extension-point method signatures (mirror interface.go):

      queue_sort_less(pod_info1, pod_info2) -> bool                 # :243
      pre_filter(state, pod) -> Optional[Status]                    # :256
      pre_filter_extensions() -> Optional[PreFilterExtensions]      # :233
      filter(state, pod, node_info) -> Optional[Status]             # :288
      pre_score(state, pod, nodes) -> Optional[Status]              # :309
      score(state, pod, node_name) -> (int, Optional[Status])       # :327
      normalize_score(state, pod, scores) -> Optional[Status]       # :317
      reserve(state, pod, node_name) -> Optional[Status]            # :344
      permit(state, pod, node_name) -> (Optional[Status], timeout_s)# :384
      pre_bind(state, pod, node_name) -> Optional[Status]           # :353
      bind(state, pod, node_name) -> Optional[Status]               # :397
      post_bind(state, pod, node_name) -> None                      # :362
      unreserve(state, pod, node_name) -> None                      # :375
    """

    NAME = "Plugin"

    def name(self) -> str:
        return self.NAME


class PreFilterExtensions:
    """Incremental PreFilter-state updates used by preemption and nominated
    pods (reference interface.go:230 AddPod/RemovePod)."""

    def add_pod(
        self,
        state: CycleState,
        pod_to_schedule: "Pod",
        pod_to_add: "Pod",
        node_info: "NodeInfo",
    ) -> Optional[Status]:
        return None

    def remove_pod(
        self,
        state: CycleState,
        pod_to_schedule: "Pod",
        pod_to_remove: "Pod",
        node_info: "NodeInfo",
    ) -> Optional[Status]:
        return None
