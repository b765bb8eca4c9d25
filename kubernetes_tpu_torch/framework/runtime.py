"""Framework runtime: configures and runs the plugin set.

Reference: /root/reference/pkg/scheduler/framework/v1alpha1/framework.go.
Where the reference parallelizes per-node Filter/Score with 16 goroutines
(workqueue.ParallelizeUntil, framework.go:516), the host path here runs
sequentially -- on TPU the whole pod x node plugin evaluation is replaced
by vectorized masks/scores (kubernetes_tpu_torch.ops), which is the point of the
design; the sequential host path is the correctness oracle.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.cache.node_info import NodeInfo
from kubernetes_tpu_torch.config.types import Plugins
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    MAX_NODE_SCORE,
    MIN_NODE_SCORE,
    NodeScore,
    Plugin,
    PodInfo,
    Status,
    StatusCode,
    is_success,
)
from kubernetes_tpu_torch.framework.registry import Registry
from kubernetes_tpu_torch.framework.waiting_pods import WaitingPod, WaitingPodsMap

# extension point name -> plugin method that marks capability
_POINT_METHODS = {
    "queue_sort": "queue_sort_less",
    "pre_filter": "pre_filter",
    "filter": "filter",
    "pre_score": "pre_score",
    "score": "score",
    "reserve": "reserve",
    "permit": "permit",
    "pre_bind": "pre_bind",
    "bind": "bind",
    "post_bind": "post_bind",
    "unreserve": "unreserve",
}

MAX_TIMEOUT_SECONDS = 15 * 60  # reference framework.go maxTimeout


class Framework:
    """A configured plugin pipeline for one profile
    (reference framework.go:61, implements FrameworkHandle)."""

    def __init__(
        self,
        registry: Registry,
        plugins: Plugins,
        plugin_config: Optional[Dict[str, Any]] = None,
        *,
        client: Any = None,
        snapshot_provider: Optional[Callable[[], Any]] = None,
        informers: Any = None,
        run_all_filters: bool = False,
        metrics_recorder: Any = None,
        recorder: Any = None,
    ) -> None:
        self.registry = registry
        self.plugins_config = plugins
        self.client = client
        self._snapshot_provider = snapshot_provider
        self.informers = informers
        self.run_all_filters = run_all_filters
        self.waiting_pods = WaitingPodsMap()
        self.metrics_recorder = metrics_recorder
        # profile-scoped API event recorder (profile.go:39); a null
        # recorder keeps unit tests wiring-free
        if recorder is None:
            from kubernetes_tpu_torch.utils.event_recorder import NullRecorder

            recorder = NullRecorder()
        self.recorder = recorder

        plugin_config = plugin_config or {}
        needed = {p.name for point in Plugins.EXTENSION_POINTS
                  for p in getattr(plugins, point).enabled}
        self._instances: Dict[str, Plugin] = {}
        for name in needed:
            factory = registry.get(name)
            if factory is None:
                raise ValueError(f"plugin {name!r} is not registered")
            self._instances[name] = factory(plugin_config.get(name), self)

        # per-point ordered plugin lists; score keeps weights
        self._by_point: Dict[str, List[Plugin]] = {}
        self._score_weights: Dict[str, int] = {}
        for point in Plugins.EXTENSION_POINTS:
            plist = []
            for ref in getattr(plugins, point).enabled:
                inst = self._instances[ref.name]
                method = _POINT_METHODS[point]
                if not hasattr(inst, method):
                    raise ValueError(
                        f"plugin {ref.name!r} does not implement {point}"
                    )
                plist.append(inst)
                if point == "score":
                    if ref.weight == 0:
                        raise ValueError(f"score plugin {ref.name!r} weight 0")
                    self._score_weights[ref.name] = ref.weight
            self._by_point[point] = plist
        if len(self._by_point["queue_sort"]) > 1:
            raise ValueError("only one queue sort plugin can be enabled")

        # per-point (plugin, relevance) pairs: a plugin may expose
        # ``<point>_relevant(pod) -> bool`` declaring its hook a no-op for
        # non-matching pods (Coscheduling without a group label,
        # VolumeBinding without PVCs) -- the bulk commit path skips the
        # whole extension point when nothing is relevant
        self._relevance: Dict[str, List] = {
            point: [
                (pl, getattr(pl, point + "_relevant", None))
                for pl in plist
            ]
            for point, plist in self._by_point.items()
        }

    # -- handle surface (reference FrameworkHandle, interface.go:499) -------

    def snapshot_shared_lister(self):
        return self._snapshot_provider() if self._snapshot_provider else None

    def client_set(self):
        return self.client

    def get_waiting_pod(self, uid: str) -> Optional[WaitingPod]:
        return self.waiting_pods.get(uid)

    def iterate_over_waiting_pods(self, fn) -> None:
        self.waiting_pods.iterate(fn)

    def reject_waiting_pod(self, uid: str) -> None:
        wp = self.waiting_pods.get(uid)
        if wp is not None:
            wp.reject("", "removed")

    def has_filter_plugins(self) -> bool:
        return bool(self._by_point["filter"])

    def has_plugins(self, point: str) -> bool:
        return bool(self._by_point[point])

    def plugin_instance(self, name: str) -> Optional[Plugin]:
        """The built plugin instance (device packers read plugin args
        like hard_pod_affinity_weight from it)."""
        return self._instances.get(name)

    def relevance_entries(self, point: str):
        """The (plugin, relevance) table behind ``plugins_relevant`` --
        an empty table means plugins_relevant is False for EVERY pod, so
        batch hot loops hoist the check and skip the per-pod call."""
        return self._relevance[point]

    def plugins_relevant(self, point: str, pod: Pod) -> bool:
        """True when at least one plugin at ``point`` may act on this pod
        (no relevance predicate counts as always-relevant)."""
        for pl, rel in self._relevance[point]:
            if rel is None or rel(pod):
                return True
        return False

    def score_plugin_weights(self) -> Dict[str, int]:
        """Enabled score plugin -> weight (the batch solver mirrors these
        on device, ops/scoring.py)."""
        return dict(self._score_weights)

    def uses_default_binder_only(self) -> bool:
        """True when the bind chain is exactly [DefaultBinder]: the batch
        committer may then coalesce the whole batch into one bulk binding
        transaction instead of one API round trip per pod."""
        bind = self._by_point["bind"]
        return len(bind) == 1 and bind[0].name() == "DefaultBinder"

    def has_score_plugins(self) -> bool:
        return bool(self._by_point["score"])

    def list_plugins(self) -> Dict[str, List[str]]:
        return {
            point: [p.name() for p in pl]
            for point, pl in self._by_point.items()
            if pl
        }

    # -- queue sort ---------------------------------------------------------

    def queue_sort_less_func(self) -> Callable[[PodInfo, PodInfo], bool]:
        plugins = self._by_point["queue_sort"]
        if not plugins:
            raise ValueError("no queue sort plugin enabled")
        return plugins[0].queue_sort_less

    def queue_sort_key_func(self) -> Optional[Callable[[PodInfo], Any]]:
        """Total-order sort key matching queue_sort_less, when the
        QueueSort plugin provides one (the activeQ heap fast path)."""
        plugins = self._by_point["queue_sort"]
        if not plugins:
            return None
        return getattr(plugins[0], "queue_sort_key", None)

    # -- prefilter ----------------------------------------------------------

    def run_pre_filter_plugins(
        self, state: CycleState, pod: Pod
    ) -> Optional[Status]:
        for pl in self._by_point["pre_filter"]:
            status = self._record(pl, "pre_filter", pl.pre_filter, state, pod)
            if not is_success(status):
                if status.is_unschedulable():
                    return status
                return Status.error(
                    f"error running PreFilter plugin {pl.name()}: {status.message()}"
                )
        return None

    def run_pre_filter_extension_add_pod(
        self, state: CycleState, pod: Pod, pod_to_add: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        for pl in self._by_point["pre_filter"]:
            ext = getattr(pl, "pre_filter_extensions", lambda: None)()
            if ext is None:
                continue
            status = ext.add_pod(state, pod, pod_to_add, node_info)
            if not is_success(status):
                return status
        return None

    def run_pre_filter_extension_remove_pod(
        self, state: CycleState, pod: Pod, pod_to_remove: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        for pl in self._by_point["pre_filter"]:
            ext = getattr(pl, "pre_filter_extensions", lambda: None)()
            if ext is None:
                continue
            status = ext.remove_pod(state, pod, pod_to_remove, node_info)
            if not is_success(status):
                return status
        return None

    # -- filter -------------------------------------------------------------

    def run_filter_plugins(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Dict[str, Status]:
        """Returns plugin-name -> non-success Status (empty dict == fits).
        Reference framework.go:447 RunFilterPlugins."""
        statuses: Dict[str, Status] = {}
        for pl in self._by_point["filter"]:
            status = self._record(pl, "filter", pl.filter, state, pod, node_info)
            if not is_success(status):
                if not status.is_unschedulable():
                    err = Status.error(
                        f"running {pl.name()} filter plugin for pod "
                        f"{pod.key()}: {status.message()}"
                    )
                    return {pl.name(): err}
                statuses[pl.name()] = status
                if not self.run_all_filters:
                    return statuses
        return statuses

    # -- score --------------------------------------------------------------

    def run_pre_score_plugins(
        self, state: CycleState, pod: Pod, nodes: List[Any]
    ) -> Optional[Status]:
        for pl in self._by_point["pre_score"]:
            status = self._record(pl, "pre_score", pl.pre_score, state, pod, nodes)
            if not is_success(status):
                return Status.error(
                    f"error running PreScore plugin {pl.name()}: {status.message()}"
                )
        return None

    def run_score_plugins(
        self, state: CycleState, pod: Pod, node_names: List[str]
    ) -> Tuple[Dict[str, List[NodeScore]], Optional[Status]]:
        """Reference framework.go:503: score each node per plugin, run
        NormalizeScore, then apply weights; validate [0,100] range."""
        results: Dict[str, List[NodeScore]] = {}
        for pl in self._by_point["score"]:
            scores: List[NodeScore] = []
            for name in node_names:
                s, status = self._record(
                    pl, "score", pl.score, state, pod, name
                )
                if not is_success(status):
                    return {}, Status.error(
                        f"error running Score plugin {pl.name()}: {status.message()}"
                    )
                scores.append(NodeScore(name, s))
            results[pl.name()] = scores
        for pl in self._by_point["score"]:
            normalize = getattr(pl, "normalize_score", None)
            if normalize is None:
                continue
            status = normalize(state, pod, results[pl.name()])
            if not is_success(status):
                return {}, Status.error(
                    f"error normalizing scores for {pl.name()}: {status.message()}"
                )
        for pl in self._by_point["score"]:
            weight = self._score_weights[pl.name()]
            for ns in results[pl.name()]:
                if ns.score > MAX_NODE_SCORE or ns.score < MIN_NODE_SCORE:
                    return {}, Status.error(
                        f"plugin {pl.name()} returns an invalid score "
                        f"{ns.score} for node {ns.name}"
                    )
                ns.score *= weight
        return results, None

    # -- reserve / unreserve ------------------------------------------------

    def run_reserve_plugins(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Optional[Status]:
        for pl in self._by_point["reserve"]:
            status = self._record(pl, "reserve", pl.reserve, state, pod, node_name)
            if not is_success(status):
                return Status.error(
                    f"error running Reserve plugin {pl.name()}: {status.message()}"
                )
        return None

    def run_unreserve_plugins(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> None:
        for pl in self._by_point["unreserve"]:
            self._record(pl, "unreserve", pl.unreserve, state, pod, node_name)

    # -- permit -------------------------------------------------------------

    def run_permit_plugins(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Optional[Status]:
        """Reference framework.go:645: returns Wait status after parking the
        pod in the waiting-pods map when any plugin asks to wait."""
        plugin_timeouts: Dict[str, float] = {}
        status_code = StatusCode.SUCCESS
        for pl in self._by_point["permit"]:
            status, timeout = self._record(
                pl, "permit", pl.permit, state, pod, node_name
            )
            if not is_success(status):
                if status.is_unschedulable():
                    return status
                if status.code == StatusCode.WAIT:
                    timeout = min(timeout or MAX_TIMEOUT_SECONDS, MAX_TIMEOUT_SECONDS)
                    plugin_timeouts[pl.name()] = timeout
                    status_code = StatusCode.WAIT
                else:
                    return Status.error(
                        f"error running Permit plugin {pl.name()}: "
                        f"{status.message()}"
                    )
        if status_code == StatusCode.WAIT:
            wp = WaitingPod(pod, plugin_timeouts)
            self.waiting_pods.add(wp)
            return Status(StatusCode.WAIT, f"one or more plugins asked to wait")
        return None

    def wait_on_permit(self, pod: Pod) -> Optional[Status]:
        wp = self.waiting_pods.get(pod.metadata.uid)
        if wp is None:
            return None
        from kubernetes_tpu_torch.utils import metrics

        start = time.perf_counter()
        try:
            return_status = wp.wait()
        finally:
            self.waiting_pods.remove(pod.metadata.uid)
            metrics.permit_wait_duration.observe(time.perf_counter() - start)
        if not return_status.is_success():
            return return_status
        return None

    # -- bind chain ---------------------------------------------------------

    def run_pre_bind_plugins(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Optional[Status]:
        for pl in self._by_point["pre_bind"]:
            status = self._record(pl, "pre_bind", pl.pre_bind, state, pod, node_name)
            if not is_success(status):
                return Status.error(
                    f"error running PreBind plugin {pl.name()}: {status.message()}"
                )
        return None

    def run_bind_plugins(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Optional[Status]:
        """First plugin not returning Skip handles the bind
        (reference framework.go:614)."""
        if not self._by_point["bind"]:
            return Status.error("no bind plugin enabled")
        status: Optional[Status] = Status.skip()
        for pl in self._by_point["bind"]:
            status = self._record(pl, "bind", pl.bind, state, pod, node_name)
            if status is not None and status.code == StatusCode.SKIP:
                continue
            if not is_success(status):
                return Status.error(
                    f"bind plugin {pl.name()} failed to bind pod "
                    f"{pod.key()}: {status.message()}"
                )
            return status
        return status

    def run_post_bind_plugins(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> None:
        for pl in self._by_point["post_bind"]:
            self._record(pl, "post_bind", pl.post_bind, state, pod, node_name)

    # -- metrics ------------------------------------------------------------

    def _record(self, plugin: Plugin, point: str, fn, *args):
        if self.metrics_recorder is None:
            return fn(*args)
        start = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.metrics_recorder.observe_plugin_duration(
                plugin.name(), point, time.perf_counter() - start
            )
