"""Pod/Node builder DSL for tests and benchmarks.

Reference: /root/reference/pkg/scheduler/testing/wrappers.go -- the fluent
fixture builders shared by unit, integration, and perf tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.resource import parse_cpu, parse_memory
from kubernetes_tpu_torch.api.types import (
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    LabelSelector,
    Node,
    NodeAffinity,
    NodeSelector,
    NodeSelectorRequirement,
    NodeSelectorTerm,
    ObjectMeta,
    Pod,
    PodAffinity,
    PodAffinityTerm,
    PodAntiAffinity,
    PodSpec,
    PreferredSchedulingTerm,
    ResourceRequirements,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
)


class PodWrapper:
    def __init__(self, name: str, namespace: str = "default"):
        self.pod = Pod(metadata=ObjectMeta(name=name, namespace=namespace))

    def obj(self) -> Pod:
        return self.pod

    def uid(self, uid: str) -> "PodWrapper":
        self.pod.metadata.uid = uid
        return self

    def node(self, name: str) -> "PodWrapper":
        self.pod.spec.node_name = name
        return self

    def scheduler_name(self, name: str) -> "PodWrapper":
        self.pod.spec.scheduler_name = name
        return self

    def priority(self, p: int) -> "PodWrapper":
        self.pod.spec.priority = p
        return self

    def labels(self, **labels: str) -> "PodWrapper":
        self.pod.metadata.labels.update(labels)
        return self

    def annotation(self, key: str, value: str) -> "PodWrapper":
        self.pod.metadata.annotations[key] = value
        return self

    def creation_timestamp(self, ts: float) -> "PodWrapper":
        self.pod.metadata.creation_timestamp = ts
        return self

    def container(
        self,
        cpu: str = "0",
        memory: str = "0",
        image: str = "pause",
        host_port: int = 0,
        protocol: str = "TCP",
        limits_cpu: str = "",
        limits_memory: str = "",
        **scalars: int,
    ) -> "PodWrapper":
        requests = {}
        c = parse_cpu(cpu)
        m = parse_memory(memory)
        if c:
            requests[RESOURCE_CPU] = c
        if m:
            requests[RESOURCE_MEMORY] = m
        for k, v in scalars.items():
            requests[k.replace("__", "/").replace("_", ".")] = v
        limits = {}
        if limits_cpu:
            limits[RESOURCE_CPU] = parse_cpu(limits_cpu)
        if limits_memory:
            limits[RESOURCE_MEMORY] = parse_memory(limits_memory)
        ports: List[ContainerPort] = []
        if host_port:
            ports.append(ContainerPort(host_port=host_port, protocol=protocol))
        self.pod.spec.containers.append(
            Container(
                name=f"c{len(self.pod.spec.containers)}",
                image=image,
                resources=ResourceRequirements(requests=requests, limits=limits),
                ports=ports,
            )
        )
        return self

    def req(self, cpu: str = "0", memory: str = "0", **scalars: int) -> "PodWrapper":
        return self.container(cpu=cpu, memory=memory, **scalars)

    def node_selector(self, **sel: str) -> "PodWrapper":
        self.pod.spec.node_selector.update(sel)
        return self

    def _affinity(self) -> Affinity:
        if self.pod.spec.affinity is None:
            self.pod.spec.affinity = Affinity()
        return self.pod.spec.affinity

    def node_affinity_in(self, key: str, values: List[str]) -> "PodWrapper":
        aff = self._affinity()
        if aff.node_affinity is None:
            aff.node_affinity = NodeAffinity()
        if aff.node_affinity.required_during_scheduling is None:
            aff.node_affinity.required_during_scheduling = NodeSelector()
        aff.node_affinity.required_during_scheduling.node_selector_terms.append(
            NodeSelectorTerm(
                match_expressions=[
                    NodeSelectorRequirement(key=key, operator="In", values=values)
                ]
            )
        )
        return self

    def preferred_node_affinity_in(
        self, key: str, values: List[str], weight: int = 1
    ) -> "PodWrapper":
        aff = self._affinity()
        if aff.node_affinity is None:
            aff.node_affinity = NodeAffinity()
        aff.node_affinity.preferred_during_scheduling.append(
            PreferredSchedulingTerm(
                weight=weight,
                preference=NodeSelectorTerm(
                    match_expressions=[
                        NodeSelectorRequirement(key=key, operator="In", values=values)
                    ]
                ),
            )
        )
        return self

    def pod_affinity(
        self, topology_key: str, match_labels: Dict[str, str], anti: bool = False
    ) -> "PodWrapper":
        aff = self._affinity()
        term = PodAffinityTerm(
            label_selector=LabelSelector(match_labels=dict(match_labels)),
            topology_key=topology_key,
        )
        if anti:
            if aff.pod_anti_affinity is None:
                aff.pod_anti_affinity = PodAntiAffinity()
            aff.pod_anti_affinity.required_during_scheduling.append(term)
        else:
            if aff.pod_affinity is None:
                aff.pod_affinity = PodAffinity()
            aff.pod_affinity.required_during_scheduling.append(term)
        return self

    def preferred_pod_affinity(
        self,
        topology_key: str,
        match_labels: Dict[str, str],
        weight: int = 1,
        anti: bool = False,
    ) -> "PodWrapper":
        aff = self._affinity()
        wterm = WeightedPodAffinityTerm(
            weight=weight,
            pod_affinity_term=PodAffinityTerm(
                label_selector=LabelSelector(match_labels=dict(match_labels)),
                topology_key=topology_key,
            ),
        )
        if anti:
            if aff.pod_anti_affinity is None:
                aff.pod_anti_affinity = PodAntiAffinity()
            aff.pod_anti_affinity.preferred_during_scheduling.append(wterm)
        else:
            if aff.pod_affinity is None:
                aff.pod_affinity = PodAffinity()
            aff.pod_affinity.preferred_during_scheduling.append(wterm)
        return self

    def spread_constraint(
        self,
        max_skew: int,
        topology_key: str,
        when_unsatisfiable: str = "DoNotSchedule",
        match_labels: Optional[Dict[str, str]] = None,
    ) -> "PodWrapper":
        self.pod.spec.topology_spread_constraints.append(
            TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable=when_unsatisfiable,
                label_selector=LabelSelector(match_labels=match_labels or {}),
            )
        )
        return self

    def pvc(self, claim_name: str) -> "PodWrapper":
        self.pod.spec.volumes.append(Volume(name=claim_name, pvc_claim_name=claim_name))
        return self

    def secret_volume(self, secret_name: str) -> "PodWrapper":
        self.pod.spec.volumes.append(
            Volume(name=secret_name, secret_name=secret_name)
        )
        return self

    def gce_pd(self, pd_name: str, read_only: bool = False) -> "PodWrapper":
        self.pod.spec.volumes.append(
            Volume(name=pd_name, gce_pd_name=pd_name, read_only=read_only)
        )
        return self

    def ebs(self, volume_id: str) -> "PodWrapper":
        self.pod.spec.volumes.append(
            Volume(name=volume_id, aws_ebs_volume_id=volume_id)
        )
        return self

    def toleration(
        self, key: str, value: str = "", operator: str = "Equal", effect: str = ""
    ) -> "PodWrapper":
        self.pod.spec.tolerations.append(
            Toleration(key=key, value=value, operator=operator, effect=effect)
        )
        return self


class NodeWrapper:
    def __init__(self, name: str):
        self.node_obj = Node(metadata=ObjectMeta(name=name, namespace=""))

    def obj(self) -> Node:
        return self.node_obj

    def labels(self, **labels: str) -> "NodeWrapper":
        self.node_obj.metadata.labels.update(labels)
        return self

    def label(self, key: str, value: str) -> "NodeWrapper":
        self.node_obj.metadata.labels[key] = value
        return self

    def capacity(
        self, cpu: str = "0", memory: str = "0", pods: int = 110, **scalars: int
    ) -> "NodeWrapper":
        cap = {
            RESOURCE_CPU: parse_cpu(cpu),
            RESOURCE_MEMORY: parse_memory(memory),
            RESOURCE_PODS: pods,
        }
        for k, v in scalars.items():
            cap[k.replace("__", "/").replace("_", ".")] = v
        self.node_obj.status.capacity = dict(cap)
        self.node_obj.status.allocatable = dict(cap)
        return self

    def unschedulable(self, value: bool = True) -> "NodeWrapper":
        self.node_obj.spec.unschedulable = value
        return self

    def taint(self, key: str, value: str = "", effect: str = "NoSchedule") -> "NodeWrapper":
        self.node_obj.spec.taints.append(Taint(key=key, value=value, effect=effect))
        return self

    def image(self, name: str, size_bytes: int) -> "NodeWrapper":
        self.node_obj.status.images.append(
            ContainerImage(names=[name], size_bytes=size_bytes)
        )
        return self


def make_pod(name: str, namespace: str = "default") -> PodWrapper:
    return PodWrapper(name, namespace)


def make_node(name: str) -> NodeWrapper:
    return NodeWrapper(name)
