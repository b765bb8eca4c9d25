"""Kubernetes wire-format (de)serialization for the scheduler-facing
objects.

Reference: the apimachinery scheme/codec layer
(staging/src/k8s.io/apimachinery/pkg/runtime) reduced to what this
control plane consumes -- camelCase YAML/JSON manifests for Pod, Node,
PodDisruptionBudget, PodGroup, and Service, with resource quantities
parsed through api/resource.py (the Quantity grammar). to_dict inverts
from_dict so objects round-trip.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import yaml

from kubernetes_tpu_torch.api.resource import (
    format_cpu,
    format_memory,
    parse_cpu,
    parse_memory,
    parse_quantity,
)
from kubernetes_tpu_torch.api.types import (
    Affinity,
    Container,
    ContainerImage,
    ContainerPort,
    LabelSelector,
    LabelSelectorRequirement,
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
    PodDisruptionBudget,
    PodGroup,
    PreferredSchedulingTerm,
    RESOURCE_CPU,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    ResourceRequirements,
    Service,
    Taint,
    Toleration,
    TopologySpreadConstraint,
    Volume,
    WeightedPodAffinityTerm,
)

# ---------------------------------------------------------------------------
# quantities
# ---------------------------------------------------------------------------


def _parse_resource_list(raw: Optional[Dict[str, Any]]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for name, qty in (raw or {}).items():
        if name == "cpu":
            out[RESOURCE_CPU] = parse_cpu(qty)
        elif name == "memory":
            out[RESOURCE_MEMORY] = parse_memory(qty)
        elif name == "pods":
            out[RESOURCE_PODS] = int(parse_quantity(qty))
        else:
            out[name] = int(parse_quantity(qty))
    return out


def _format_resource_list(rl: Dict[str, int]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, qty in rl.items():
        if name == RESOURCE_CPU:
            out["cpu"] = format_cpu(qty)
        elif name == RESOURCE_MEMORY:
            out["memory"] = format_memory(qty)
        elif name == RESOURCE_PODS:
            out["pods"] = qty
        else:
            out[name] = qty
    return out


# ---------------------------------------------------------------------------
# selectors / affinity
# ---------------------------------------------------------------------------


def _label_selector(raw: Optional[Dict[str, Any]]) -> Optional[LabelSelector]:
    if raw is None:
        return None
    return LabelSelector(
        match_labels=dict(raw.get("matchLabels") or {}),
        match_expressions=[
            LabelSelectorRequirement(
                key=e["key"],
                operator=e.get("operator", "In"),
                values=list(e.get("values") or []),
            )
            for e in raw.get("matchExpressions") or []
        ],
    )


def _label_selector_dict(sel: Optional[LabelSelector]):
    if sel is None:
        return None
    out: Dict[str, Any] = {}
    if sel.match_labels:
        out["matchLabels"] = dict(sel.match_labels)
    if sel.match_expressions:
        out["matchExpressions"] = [
            {"key": r.key, "operator": r.operator, "values": list(r.values)}
            for r in sel.match_expressions
        ]
    return out


def _node_selector_term(raw: Dict[str, Any]) -> NodeSelectorTerm:
    def reqs(key):
        return [
            NodeSelectorRequirement(
                key=e["key"],
                operator=e.get("operator", "In"),
                values=list(e.get("values") or []),
            )
            for e in raw.get(key) or []
        ]

    return NodeSelectorTerm(
        match_expressions=reqs("matchExpressions"),
        match_fields=reqs("matchFields"),
    )


def _pod_affinity_term(raw: Dict[str, Any]) -> PodAffinityTerm:
    return PodAffinityTerm(
        label_selector=_label_selector(raw.get("labelSelector")),
        namespaces=list(raw.get("namespaces") or []),
        topology_key=raw.get("topologyKey", ""),
    )


def _affinity(raw: Optional[Dict[str, Any]]) -> Optional[Affinity]:
    if raw is None:
        return None
    out = Affinity()
    na = raw.get("nodeAffinity")
    if na:
        node_aff = NodeAffinity()
        req = na.get("requiredDuringSchedulingIgnoredDuringExecution")
        if req:
            node_aff.required_during_scheduling = NodeSelector(
                node_selector_terms=[
                    _node_selector_term(t)
                    for t in req.get("nodeSelectorTerms") or []
                ]
            )
        for p in na.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
            node_aff.preferred_during_scheduling.append(
                PreferredSchedulingTerm(
                    weight=int(p.get("weight", 1)),
                    preference=_node_selector_term(p.get("preference") or {}),
                )
            )
        out.node_affinity = node_aff
    pa = raw.get("podAffinity")
    if pa:
        aff = PodAffinity()
        for t in pa.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
            aff.required_during_scheduling.append(_pod_affinity_term(t))
        for w in pa.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
            aff.preferred_during_scheduling.append(
                WeightedPodAffinityTerm(
                    weight=int(w.get("weight", 1)),
                    pod_affinity_term=_pod_affinity_term(
                        w.get("podAffinityTerm") or {}
                    ),
                )
            )
        out.pod_affinity = aff
    pan = raw.get("podAntiAffinity")
    if pan:
        anti = PodAntiAffinity()
        for t in pan.get("requiredDuringSchedulingIgnoredDuringExecution") or []:
            anti.required_during_scheduling.append(_pod_affinity_term(t))
        for w in pan.get("preferredDuringSchedulingIgnoredDuringExecution") or []:
            anti.preferred_during_scheduling.append(
                WeightedPodAffinityTerm(
                    weight=int(w.get("weight", 1)),
                    pod_affinity_term=_pod_affinity_term(
                        w.get("podAffinityTerm") or {}
                    ),
                )
            )
        out.pod_anti_affinity = anti
    if (
        out.node_affinity is None
        and out.pod_affinity is None
        and out.pod_anti_affinity is None
    ):
        return None
    return out


# ---------------------------------------------------------------------------
# objects
# ---------------------------------------------------------------------------


def _metadata(raw: Dict[str, Any], default_namespace: str = "default") -> ObjectMeta:
    md = raw.get("metadata") or {}
    meta = ObjectMeta(
        name=md.get("name", ""),
        namespace=md.get("namespace", default_namespace),
        labels=dict(md.get("labels") or {}),
        annotations=dict(md.get("annotations") or {}),
    )
    if md.get("uid"):
        meta.uid = md["uid"]
    return meta


def pod_from_dict(raw: Dict[str, Any]) -> Pod:
    pod = Pod(metadata=_metadata(raw))
    spec = raw.get("spec") or {}
    pod.spec.node_name = spec.get("nodeName", "")
    if spec.get("schedulerName"):
        pod.spec.scheduler_name = spec["schedulerName"]
    pod.spec.priority = int(spec.get("priority", 0))
    pod.spec.priority_class_name = spec.get("priorityClassName", "")
    pod.spec.node_selector = dict(spec.get("nodeSelector") or {})
    pod.spec.affinity = _affinity(spec.get("affinity"))
    if spec.get("preemptionPolicy"):
        pod.spec.preemption_policy = spec["preemptionPolicy"]
    pod.spec.overhead = _parse_resource_list(spec.get("overhead"))

    def container(c: Dict[str, Any]) -> Container:
        res = c.get("resources") or {}
        return Container(
            name=c.get("name", ""),
            image=c.get("image", ""),
            resources=ResourceRequirements(
                requests=_parse_resource_list(res.get("requests")),
                limits=_parse_resource_list(res.get("limits")),
            ),
            ports=[
                ContainerPort(
                    host_port=int(p.get("hostPort", 0)),
                    container_port=int(p.get("containerPort", 0)),
                    protocol=p.get("protocol", "TCP"),
                    host_ip=p.get("hostIP", ""),
                )
                for p in c.get("ports") or []
            ],
        )

    pod.spec.containers = [container(c) for c in spec.get("containers") or []]
    pod.spec.init_containers = [
        container(c) for c in spec.get("initContainers") or []
    ]
    pod.spec.tolerations = [
        Toleration(
            key=t.get("key", ""),
            operator=t.get("operator", "Equal"),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in spec.get("tolerations") or []
    ]
    pod.spec.topology_spread_constraints = [
        TopologySpreadConstraint(
            max_skew=int(c.get("maxSkew", 1)),
            topology_key=c.get("topologyKey", ""),
            when_unsatisfiable=c.get("whenUnsatisfiable", "DoNotSchedule"),
            label_selector=_label_selector(c.get("labelSelector")),
        )
        for c in spec.get("topologySpreadConstraints") or []
    ]
    pod.spec.volumes = [
        Volume(
            name=v.get("name", ""),
            pvc_claim_name=(
                (v.get("persistentVolumeClaim") or {}).get("claimName", "")
            ),
            gce_pd_name=(v.get("gcePersistentDisk") or {}).get("pdName", ""),
            aws_ebs_volume_id=(
                (v.get("awsElasticBlockStore") or {}).get("volumeID", "")
            ),
            secret_name=(v.get("secret") or {}).get("secretName", ""),
        )
        for v in spec.get("volumes") or []
    ]
    return pod


def node_from_dict(raw: Dict[str, Any]) -> Node:
    node = Node(metadata=_metadata(raw, default_namespace=""))
    spec = raw.get("spec") or {}
    node.spec.unschedulable = bool(spec.get("unschedulable", False))
    node.spec.taints = [
        Taint(
            key=t.get("key", ""),
            value=t.get("value", ""),
            effect=t.get("effect", ""),
        )
        for t in spec.get("taints") or []
    ]
    status = raw.get("status") or {}
    node.status.capacity = _parse_resource_list(status.get("capacity"))
    node.status.allocatable = _parse_resource_list(
        status.get("allocatable") or status.get("capacity")
    )
    node.status.images = [
        ContainerImage(
            names=list(i.get("names") or []),
            size_bytes=int(i.get("sizeBytes", 0)),
        )
        for i in status.get("images") or []
    ]
    return node


def pdb_from_dict(raw: Dict[str, Any]) -> PodDisruptionBudget:
    spec = raw.get("spec") or {}
    pdb = PodDisruptionBudget(
        metadata=_metadata(raw),
        selector=_label_selector(spec.get("selector")),
        min_available=spec.get("minAvailable"),
        max_unavailable=spec.get("maxUnavailable"),
    )
    return pdb


def pod_group_from_dict(raw: Dict[str, Any]) -> PodGroup:
    spec = raw.get("spec") or {}
    return PodGroup(
        metadata=_metadata(raw),
        min_member=int(spec.get("minMember", 1)),
        schedule_timeout_seconds=int(spec.get("scheduleTimeoutSeconds", 60)),
    )


def service_from_dict(raw: Dict[str, Any]) -> Service:
    spec = raw.get("spec") or {}
    return Service(
        metadata=_metadata(raw), selector=dict(spec.get("selector") or {})
    )


_DECODERS = {
    "Pod": pod_from_dict,
    "Node": node_from_dict,
    "PodDisruptionBudget": pdb_from_dict,
    "PodGroup": pod_group_from_dict,
    "Service": service_from_dict,
}


def object_from_dict(raw: Dict[str, Any]):
    kind = raw.get("kind")
    decoder = _DECODERS.get(kind)
    if decoder is None:
        raise ValueError(f"unsupported kind {kind!r}")
    return decoder(raw)


def load_manifest(path: str) -> List[Any]:
    """Multi-document YAML manifest -> typed objects."""
    with open(path) as f:
        docs = [d for d in yaml.safe_load_all(f) if d]
    return [object_from_dict(d) for d in docs]


# ---------------------------------------------------------------------------
# to_dict (round-trip)
# ---------------------------------------------------------------------------


def _metadata_dict(meta: ObjectMeta) -> Dict[str, Any]:
    out: Dict[str, Any] = {"name": meta.name}
    if meta.namespace:
        out["namespace"] = meta.namespace
    if meta.labels:
        out["labels"] = dict(meta.labels)
    if meta.annotations:
        out["annotations"] = dict(meta.annotations)
    return out


def _node_selector_term_dict(term: NodeSelectorTerm) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if term.match_expressions:
        out["matchExpressions"] = [
            {"key": r.key, "operator": r.operator, "values": list(r.values)}
            for r in term.match_expressions
        ]
    if term.match_fields:
        out["matchFields"] = [
            {"key": r.key, "operator": r.operator, "values": list(r.values)}
            for r in term.match_fields
        ]
    return out


def _pod_affinity_term_dict(term: PodAffinityTerm) -> Dict[str, Any]:
    out: Dict[str, Any] = {"topologyKey": term.topology_key}
    if term.label_selector is not None:
        out["labelSelector"] = _label_selector_dict(term.label_selector)
    if term.namespaces:
        out["namespaces"] = list(term.namespaces)
    return out


def _affinity_dict(aff: Optional[Affinity]) -> Optional[Dict[str, Any]]:
    if aff is None:
        return None
    out: Dict[str, Any] = {}
    na = aff.node_affinity
    if na is not None:
        na_out: Dict[str, Any] = {}
        if na.required_during_scheduling is not None:
            na_out["requiredDuringSchedulingIgnoredDuringExecution"] = {
                "nodeSelectorTerms": [
                    _node_selector_term_dict(t)
                    for t in na.required_during_scheduling.node_selector_terms
                ]
            }
        if na.preferred_during_scheduling:
            na_out["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {
                    "weight": p.weight,
                    "preference": _node_selector_term_dict(p.preference),
                }
                for p in na.preferred_during_scheduling
            ]
        out["nodeAffinity"] = na_out
    for attr, key in (
        (aff.pod_affinity, "podAffinity"),
        (aff.pod_anti_affinity, "podAntiAffinity"),
    ):
        if attr is None:
            continue
        sub: Dict[str, Any] = {}
        if attr.required_during_scheduling:
            sub["requiredDuringSchedulingIgnoredDuringExecution"] = [
                _pod_affinity_term_dict(t)
                for t in attr.required_during_scheduling
            ]
        if attr.preferred_during_scheduling:
            sub["preferredDuringSchedulingIgnoredDuringExecution"] = [
                {
                    "weight": w.weight,
                    "podAffinityTerm": _pod_affinity_term_dict(
                        w.pod_affinity_term
                    ),
                }
                for w in attr.preferred_during_scheduling
            ]
        out[key] = sub
    return out or None


def _container_dict(c: Container) -> Dict[str, Any]:
    return {
        "name": c.name,
        **({"image": c.image} if c.image else {}),
        "resources": {
            "requests": _format_resource_list(c.resources.requests),
            **(
                {"limits": _format_resource_list(c.resources.limits)}
                if c.resources.limits
                else {}
            ),
        },
        **(
            {
                "ports": [
                    {
                        "hostPort": p.host_port,
                        "containerPort": p.container_port,
                        "protocol": p.protocol,
                        **({"hostIP": p.host_ip} if p.host_ip else {}),
                    }
                    for p in c.ports
                ]
            }
            if c.ports
            else {}
        ),
    }


def pod_to_dict(pod: Pod) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if pod.spec.node_name:
        spec["nodeName"] = pod.spec.node_name
    spec["schedulerName"] = pod.spec.scheduler_name
    if pod.spec.priority:
        spec["priority"] = pod.spec.priority
    if pod.spec.priority_class_name:
        spec["priorityClassName"] = pod.spec.priority_class_name
    if pod.spec.preemption_policy != "PreemptLowerPriority":
        spec["preemptionPolicy"] = pod.spec.preemption_policy
    if pod.spec.node_selector:
        spec["nodeSelector"] = dict(pod.spec.node_selector)
    if pod.spec.overhead:
        spec["overhead"] = _format_resource_list(pod.spec.overhead)
    aff = _affinity_dict(pod.spec.affinity)
    if aff:
        spec["affinity"] = aff
    spec["containers"] = [_container_dict(c) for c in pod.spec.containers]
    if pod.spec.init_containers:
        spec["initContainers"] = [
            _container_dict(c) for c in pod.spec.init_containers
        ]
    if pod.spec.volumes:
        spec["volumes"] = [
            {
                "name": v.name,
                **(
                    {"persistentVolumeClaim": {"claimName": v.pvc_claim_name}}
                    if v.pvc_claim_name
                    else {}
                ),
                **(
                    {"gcePersistentDisk": {"pdName": v.gce_pd_name}}
                    if v.gce_pd_name
                    else {}
                ),
                **(
                    {
                        "awsElasticBlockStore": {
                            "volumeID": v.aws_ebs_volume_id
                        }
                    }
                    if v.aws_ebs_volume_id
                    else {}
                ),
                **(
                    {"secret": {"secretName": v.secret_name}}
                    if v.secret_name
                    else {}
                ),
            }
            for v in pod.spec.volumes
        ]
    if pod.spec.tolerations:
        spec["tolerations"] = [
            {
                "key": t.key,
                "operator": t.operator,
                **({"value": t.value} if t.value else {}),
                **({"effect": t.effect} if t.effect else {}),
            }
            for t in pod.spec.tolerations
        ]
    if pod.spec.topology_spread_constraints:
        spec["topologySpreadConstraints"] = [
            {
                "maxSkew": c.max_skew,
                "topologyKey": c.topology_key,
                "whenUnsatisfiable": c.when_unsatisfiable,
                **(
                    {"labelSelector": _label_selector_dict(c.label_selector)}
                    if c.label_selector is not None
                    else {}
                ),
            }
            for c in pod.spec.topology_spread_constraints
        ]
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": _metadata_dict(pod.metadata),
        "spec": spec,
    }


def node_to_dict(node: Node) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    if node.spec.unschedulable:
        spec["unschedulable"] = True
    if node.spec.taints:
        spec["taints"] = [
            {"key": t.key, "value": t.value, "effect": t.effect}
            for t in node.spec.taints
        ]
    status: Dict[str, Any] = {
        "capacity": _format_resource_list(node.status.capacity),
        "allocatable": _format_resource_list(node.status.allocatable),
    }
    if node.status.images:
        status["images"] = [
            {"names": list(i.names), "sizeBytes": i.size_bytes}
            for i in node.status.images
        ]
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": _metadata_dict(node.metadata),
        **({"spec": spec} if spec else {}),
        "status": status,
    }


# ---------------------------------------------------------------------------
# shared wire encoders (the extender payloads use the same camelCase
# forms; scheduler/extender.py imports these instead of keeping a
# parallel codec)
# ---------------------------------------------------------------------------

label_selector_to_wire = _label_selector_dict
node_selector_term_to_wire = _node_selector_term_dict
pod_affinity_term_to_wire = _pod_affinity_term_dict
affinity_to_wire = _affinity_dict
