"""HTTP extenders: legacy webhook extension of filter/prioritize/bind/
preempt.

Reference: /root/reference/pkg/scheduler/core/extender.go (HTTPExtender
:91, Filter :334, Prioritize :404, Bind :446, send :473 JSON-over-HTTP,
IsInterested :503 managed-resources check, ProcessPreemption :243) and the
wire types in staging/src/k8s.io/kube-scheduler/extender/v1/types.go
(ExtenderArgs, ExtenderFilterResult, HostPriorityList,
ExtenderBindingArgs, ExtenderPreemptionArgs/Result).

Run after in-tree filters (generic_scheduler.go:502); scores are added to
the plugin totals weighted by ``weight`` (prioritizeNodes :664).
"""

from __future__ import annotations

import json
import logging
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod, pod_resource_requests
from kubernetes_tpu_torch.cache.node_info import NodeInfo

logger = logging.getLogger(__name__)

DEFAULT_EXTENDER_TIMEOUT_SECONDS = 5.0


@dataclass
class ExtenderConfig:
    """apis/config/types.go Extender (legacy_types.go in v1.18)."""

    url_prefix: str = ""
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    preempt_verb: str = ""
    weight: int = 1
    node_cache_capable: bool = False
    ignorable: bool = False
    managed_resources: List[str] = field(default_factory=list)
    http_timeout_seconds: float = DEFAULT_EXTENDER_TIMEOUT_SECONDS


from kubernetes_tpu_torch.api.serialization import (
    affinity_to_wire as _affinity_to_wire,
)


def _quantity_to_wire(name: str, qty: int) -> str:
    # internal base units: cpu milliCPU, memory/ephemeral bytes, extended
    # whole units (api/types.py ResourceList)
    if name == "cpu":
        return f"{qty}m"
    return str(qty)


def _resource_list_to_wire(rl: dict) -> dict:
    return {name: _quantity_to_wire(name, q) for name, q in rl.items()}


def _pod_to_wire(pod: Pod) -> dict:
    """Full Pod serialization for ExtenderArgs. The reference sends the
    whole v1.Pod (extender/v1/types.go ExtenderArgs), so real extenders
    inspect spec fields -- containers/resources, nodeSelector, affinity,
    tolerations -- not just metadata."""
    def container_to_wire(c) -> dict:
        return {
            "name": c.name,
            "image": c.image,
            "resources": {
                "requests": _resource_list_to_wire(c.resources.requests),
                "limits": _resource_list_to_wire(c.resources.limits),
            },
            "ports": [
                {
                    "containerPort": p.container_port,
                    "hostPort": p.host_port,
                    "hostIP": p.host_ip,
                    "protocol": p.protocol,
                }
                for p in c.ports
            ],
        }

    spec: dict = {
        "priority": pod.spec.priority,
        "schedulerName": pod.spec.scheduler_name,
        "containers": [container_to_wire(c) for c in pod.spec.containers],
    }
    if pod.spec.init_containers:
        spec["initContainers"] = [
            container_to_wire(c) for c in pod.spec.init_containers
        ]
    if pod.spec.overhead:
        spec["overhead"] = _resource_list_to_wire(pod.spec.overhead)
    if pod.spec.node_name:
        spec["nodeName"] = pod.spec.node_name
    if pod.spec.priority_class_name:
        spec["priorityClassName"] = pod.spec.priority_class_name
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    if pod.spec.tolerations:
        spec["tolerations"] = [
            {
                "key": t.key,
                "operator": t.operator,
                "value": t.value,
                "effect": t.effect,
                **(
                    {"tolerationSeconds": t.toleration_seconds}
                    if t.toleration_seconds is not None
                    else {}
                ),
            }
            for t in pod.spec.tolerations
        ]
    if pod.spec.affinity is not None:
        spec["affinity"] = _affinity_to_wire(pod.spec.affinity)
    return {
        "metadata": {
            "name": pod.metadata.name,
            "namespace": pod.metadata.namespace,
            "uid": pod.metadata.uid,
            "labels": dict(pod.metadata.labels),
        },
        "spec": spec,
        "status": {
            "nominatedNodeName": pod.status.nominated_node_name,
        },
    }


class HTTPExtender:
    def __init__(self, config: ExtenderConfig) -> None:
        self.config = config

    # -- protocol plumbing (extender.go:473 send) ---------------------------

    def _send(self, verb: str, args: dict) -> dict:
        url = self.config.url_prefix.rstrip("/") + "/" + verb
        data = json.dumps(args).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"}
        )
        with urllib.request.urlopen(
            req, timeout=self.config.http_timeout_seconds
        ) as resp:
            if resp.status != 200:
                raise RuntimeError(f"extender {url} returned {resp.status}")
            return json.loads(resp.read())

    # -- interest (extender.go:503) -----------------------------------------

    def is_interested(self, pod: Pod) -> bool:
        if not self.config.managed_resources:
            return True
        requested = pod_resource_requests(pod)
        return any(r in requested for r in self.config.managed_resources)

    def is_ignorable(self) -> bool:
        return self.config.ignorable

    # -- filter (extender.go:334) -------------------------------------------

    def filter(
        self, pod: Pod, nodes: List[NodeInfo]
    ) -> Tuple[List[NodeInfo], Dict[str, str]]:
        """Returns (feasible, failed{node: reason}). Raises on transport
        error unless ignorable (caller treats ignorable errors as
        pass-through, extender.go:509 comment / generic_scheduler.go:507)."""
        if not self.config.filter_verb:
            return nodes, {}
        # wire format (extender/v1 ExtenderArgs): cache-capable extenders
        # exchange bare node names; others exchange full node objects
        # (extender.go:356-377)
        args = {"pod": _pod_to_wire(pod)}
        if self.config.node_cache_capable:
            args["nodenames"] = [ni.node_name for ni in nodes]
        else:
            args["nodes"] = {
                "items": [
                    {"metadata": {"name": ni.node_name}} for ni in nodes
                ]
            }
        try:
            result = self._send(self.config.filter_verb, args)
        except Exception:
            if self.config.ignorable:
                logger.warning(
                    "ignoring failed ignorable extender %s",
                    self.config.url_prefix,
                )
                return nodes, {}
            raise
        if result.get("error"):
            raise RuntimeError(result["error"])
        failed = dict(result.get("failedNodes") or {})
        if self.config.node_cache_capable:
            kept = result.get("nodeNames")
        else:
            items = (result.get("nodes") or {}).get("items")
            kept = (
                [n["metadata"]["name"] for n in items]
                if items is not None
                else None
            )
        if kept is None:
            kept_set = {ni.node_name for ni in nodes} - set(failed)
        else:
            kept_set = set(kept)
        return [ni for ni in nodes if ni.node_name in kept_set], failed

    # -- prioritize (extender.go:404) ----------------------------------------

    def prioritize(self, pod: Pod, nodes: List[NodeInfo]) -> Dict[str, int]:
        """Returns {node: weighted_score} merged into the plugin totals."""
        if not self.config.prioritize_verb:
            return {}
        args = {"pod": _pod_to_wire(pod)}
        if self.config.node_cache_capable:
            args["nodenames"] = [ni.node_name for ni in nodes]
        else:
            args["nodes"] = {
                "items": [
                    {"metadata": {"name": ni.node_name}} for ni in nodes
                ]
            }
        try:
            result = self._send(self.config.prioritize_verb, args)
        except Exception:
            if self.config.ignorable:
                return {}
            raise
        return {
            hp["host"]: int(hp["score"]) * self.config.weight
            for hp in result or []
        }

    # -- bind (extender.go:446) ----------------------------------------------

    def is_binder(self) -> bool:
        return bool(self.config.bind_verb)

    def bind(self, pod: Pod, host: str) -> None:
        result = self._send(
            self.config.bind_verb,
            {
                "podName": pod.metadata.name,
                "podNamespace": pod.metadata.namespace,
                "podUID": pod.metadata.uid,
                "node": host,
            },
        )
        if result and result.get("error"):
            raise RuntimeError(result["error"])

    # -- preemption (extender.go:243 ProcessPreemption) -----------------------

    def supports_preemption(self) -> bool:
        return bool(self.config.preempt_verb)

    def process_preemption(
        self, pod: Pod, nodes_to_victims: Dict[str, object]
    ) -> Dict[str, object]:
        """Narrows the candidate victim map; values are Victims objects
        (preemption.py). Wire format uses node->metaVictims with pod uids."""
        args = {
            "pod": _pod_to_wire(pod),
            "nodeNameToMetaVictims": {
                node: {
                    "pods": [
                        {"uid": v.metadata.uid} for v in victims.pods
                    ],
                    "numPDBViolations": victims.num_pdb_violations,
                }
                for node, victims in nodes_to_victims.items()
            },
        }
        try:
            result = self._send(self.config.preempt_verb, args)
        except Exception:
            if self.config.ignorable:
                return nodes_to_victims
            raise
        kept = result.get("nodeNameToMetaVictims")
        if kept is None:
            return nodes_to_victims
        out = {}
        for node, meta in kept.items():
            if node not in nodes_to_victims:
                continue
            uids = {p["uid"] for p in meta.get("pods", [])}
            victims = nodes_to_victims[node]
            victims.pods = [v for v in victims.pods if v.metadata.uid in uids]
            out[node] = victims
        return out
