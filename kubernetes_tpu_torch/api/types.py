"""Scheduler-relevant API object model.

Modeled on /root/reference/staging/src/k8s.io/api/core/v1/types.go (Pod,
Node, affinity, taints/tolerations, topology-spread) and
policy/v1beta1 (PodDisruptionBudget). ``PodGroup`` mirrors the out-of-tree
scheduler-plugins coscheduling CRD, which the reference enables via the
Permit extension point (framework/v1alpha1/interface.go:384).

Plain mutable dataclasses: cheap bulk construction, direct field access from
the tensor-packing path, and straightforward deep-copy semantics.
"""

from __future__ import annotations

import copy
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

try:
    from kubernetes_tpu_torch.native import cow_clone as _cow_clone
except Exception:  # noqa: BLE001 - pure-Python fallback
    _cow_clone = None

_SPEC_ONLY = ("spec",)

# ---------------------------------------------------------------------------
# metadata
# ---------------------------------------------------------------------------

_uid_counter = itertools.count(1)


def new_uid() -> str:
    return f"uid-{next(_uid_counter)}"


@dataclass
class OwnerReference:
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    resource_version: int = 0
    creation_timestamp: float = field(default_factory=time.time)
    owner_references: List[OwnerReference] = field(default_factory=list)
    deletion_timestamp: Optional[float] = None


# ---------------------------------------------------------------------------
# selectors
# ---------------------------------------------------------------------------


@dataclass
class LabelSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist
    values: List[str] = field(default_factory=list)


@dataclass
class LabelSelector:
    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: List[LabelSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelectorRequirement:
    key: str = ""
    operator: str = "In"  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: List[str] = field(default_factory=list)


@dataclass
class NodeSelectorTerm:
    match_expressions: List[NodeSelectorRequirement] = field(default_factory=list)
    match_fields: List[NodeSelectorRequirement] = field(default_factory=list)


@dataclass
class NodeSelector:
    node_selector_terms: List[NodeSelectorTerm] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


# ---------------------------------------------------------------------------
# affinity
# ---------------------------------------------------------------------------


@dataclass
class NodeAffinity:
    required_during_scheduling: Optional[NodeSelector] = None
    preferred_during_scheduling: List[PreferredSchedulingTerm] = field(
        default_factory=list
    )


@dataclass
class PodAffinityTerm:
    label_selector: Optional[LabelSelector] = None
    namespaces: List[str] = field(default_factory=list)
    topology_key: str = ""


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    pod_affinity_term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class PodAffinity:
    required_during_scheduling: List[PodAffinityTerm] = field(default_factory=list)
    preferred_during_scheduling: List[WeightedPodAffinityTerm] = field(
        default_factory=list
    )


@dataclass
class PodAntiAffinity:
    required_during_scheduling: List[PodAffinityTerm] = field(default_factory=list)
    preferred_during_scheduling: List[WeightedPodAffinityTerm] = field(
        default_factory=list
    )


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


# ---------------------------------------------------------------------------
# taints / tolerations
# ---------------------------------------------------------------------------

TAINT_EFFECT_NO_SCHEDULE = "NoSchedule"
TAINT_EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_EFFECT_NO_EXECUTE = "NoExecute"


@dataclass
class Taint:
    key: str = ""
    value: str = ""
    effect: str = TAINT_EFFECT_NO_SCHEDULE


@dataclass
class Toleration:
    key: str = ""  # empty key + Exists matches all taints
    operator: str = "Equal"  # Equal | Exists
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """Reference: staging/src/k8s.io/api/core/v1/toleration.go:30."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        if self.operator == "Exists":
            return True
        return False


# ---------------------------------------------------------------------------
# topology spread
# ---------------------------------------------------------------------------


@dataclass
class TopologySpreadConstraint:
    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # DoNotSchedule | ScheduleAnyway
    label_selector: Optional[LabelSelector] = None


# ---------------------------------------------------------------------------
# containers / resources
# ---------------------------------------------------------------------------

# ResourceList maps resource name -> base-unit integer quantity
# (cpu in milliCPU, memory/ephemeral-storage in bytes, extended resources in
# whole units). See api/resource.py for parsing.
ResourceList = Dict[str, int]

RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"
RESOURCE_PODS = "pods"


@dataclass
class ResourceRequirements:
    requests: ResourceList = field(default_factory=dict)
    limits: ResourceList = field(default_factory=dict)


@dataclass
class ContainerPort:
    container_port: int = 0
    host_port: int = 0
    host_ip: str = ""
    protocol: str = "TCP"


@dataclass
class Container:
    name: str = ""
    image: str = ""
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    ports: List[ContainerPort] = field(default_factory=list)


# ---------------------------------------------------------------------------
# volumes (scheduler-relevant subset)
# ---------------------------------------------------------------------------


@dataclass
class Volume:
    name: str = ""
    # Flattened source discriminators; only what volume filters consume.
    pvc_claim_name: str = ""  # persistentVolumeClaim.claimName
    gce_pd_name: str = ""
    aws_ebs_volume_id: str = ""
    iscsi_target: str = ""  # iqn+lun identity
    rbd_image: str = ""  # pool+image identity
    secret_name: str = ""  # secret.secretName (no filter reads it; the
    # SchedulingSecrets perf workload measures the object-graph weight,
    # reference scheduler_perf performance-config.yaml)
    read_only: bool = False


# ---------------------------------------------------------------------------
# Pod
# ---------------------------------------------------------------------------

DEFAULT_SCHEDULER_NAME = "default-scheduler"


@dataclass
class PodSpec:
    node_name: str = ""
    scheduler_name: str = DEFAULT_SCHEDULER_NAME
    priority: int = 0
    priority_class_name: str = ""
    containers: List[Container] = field(default_factory=list)
    init_containers: List[Container] = field(default_factory=list)
    overhead: ResourceList = field(default_factory=dict)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: List[Toleration] = field(default_factory=list)
    topology_spread_constraints: List[TopologySpreadConstraint] = field(
        default_factory=list
    )
    volumes: List[Volume] = field(default_factory=list)
    host_network: bool = False
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"


@dataclass
class PodCondition:
    type: str = ""
    status: str = ""
    reason: str = ""
    message: str = ""


POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"


@dataclass
class PodStatus:
    phase: str = POD_PENDING
    nominated_node_name: str = ""
    conditions: List[PodCondition] = field(default_factory=list)
    start_time: Optional[float] = None


@dataclass
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    kind: str = "Pod"

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"

    def deepcopy(self) -> "Pod":
        return copy.deepcopy(self)

    def assumed_clone(self) -> "Pod":
        """Copy-on-write clone for the assume path (scheduler.go:474): the
        only mutation downstream is ``spec.node_name``, so a shallow pod +
        shallow spec suffices; metadata/status/containers stay shared and
        MUST be treated read-only (the informer-cache contract). Routed
        through the native cow_clone (native/_hotpath.c) -- copy.copy's
        __reduce_ex__ dispatch was ~7x the cost of the dict copy it
        performs, and the burst commit clones every pod."""
        if _cow_clone is not None:
            return _cow_clone(self, _SPEC_ONLY)
        c = copy.copy(self)
        c.spec = copy.copy(self.spec)
        return c


# ---------------------------------------------------------------------------
# Node
# ---------------------------------------------------------------------------


@dataclass
class NodeSpec:
    unschedulable: bool = False
    taints: List[Taint] = field(default_factory=list)


@dataclass
class NodeCondition:
    type: str = ""  # Ready | MemoryPressure | DiskPressure | PIDPressure ...
    status: str = ""  # True | False | Unknown


@dataclass
class ContainerImage:
    names: List[str] = field(default_factory=list)
    size_bytes: int = 0


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: List[NodeCondition] = field(default_factory=list)
    images: List[ContainerImage] = field(default_factory=list)


@dataclass
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    kind: str = "Node"

    @property
    def name(self) -> str:
        return self.metadata.name

    def key(self) -> str:
        return self.metadata.name

    def deepcopy(self) -> "Node":
        return copy.deepcopy(self)


# ---------------------------------------------------------------------------
# Storage objects (scheduler-relevant subset of core/v1 + storage/v1;
# consumed by the volume plugins and the volume binder)
# ---------------------------------------------------------------------------

# zone/region label keys: GA topology labels plus the v1.18-era beta names
# (reference uses v1.LabelZoneFailureDomain = failure-domain.beta...)
LABEL_ZONE_KEYS = (
    "topology.kubernetes.io/zone",
    "failure-domain.beta.kubernetes.io/zone",
)
LABEL_REGION_KEYS = (
    "topology.kubernetes.io/region",
    "failure-domain.beta.kubernetes.io/region",
)

VOLUME_BINDING_IMMEDIATE = "Immediate"
VOLUME_BINDING_WAIT = "WaitForFirstConsumer"


@dataclass
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = VOLUME_BINDING_IMMEDIATE

    kind: str = "StorageClass"

    def key(self) -> str:
        return self.metadata.name


@dataclass
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    capacity_bytes: int = 0
    storage_class_name: str = ""
    # binding state
    claim_ref_namespace: str = ""
    claim_ref_name: str = ""
    # topology: required node affinity (VolumeNodeAffinity.Required)
    node_affinity: Optional[NodeSelector] = None
    # flattened sources for limit counting (csi driver or in-tree type)
    csi_driver: str = ""
    csi_volume_handle: str = ""
    gce_pd_name: str = ""
    aws_ebs_volume_id: str = ""
    azure_disk_name: str = ""

    kind: str = "PersistentVolume"

    def key(self) -> str:
        return self.metadata.name

    def is_bound_to(self, namespace: str, name: str) -> bool:
        return (
            self.claim_ref_namespace == namespace
            and self.claim_ref_name == name
        )


@dataclass
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    volume_name: str = ""  # set when bound
    storage_class_name: str = ""
    requested_bytes: int = 0
    phase: str = "Pending"  # Pending | Bound | Lost

    kind: str = "PersistentVolumeClaim"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class CSINodeDriver:
    name: str = ""
    node_id: str = ""
    allocatable_count: Optional[int] = None  # max attachable volumes


@dataclass
class CSINode:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: List[CSINodeDriver] = field(default_factory=list)

    kind: str = "CSINode"

    def key(self) -> str:
        return self.metadata.name


# ---------------------------------------------------------------------------
# Service / workload controllers (consumed by SelectorSpread +
# ServiceAffinity; reference defaultpodtopologyspread + serviceaffinity)
# ---------------------------------------------------------------------------


@dataclass
class Service:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)

    kind: str = "Service"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class Secret:
    """Opaque key/value secret (reference core/v1 Secret). The scheduler
    never reads one; pods referencing secret volumes ride the pipeline
    with the extra object weight the SchedulingSecrets perf workload
    measures (test/integration/scheduler_perf/config/
    performance-config.yaml)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    data: Dict[str, str] = field(default_factory=dict)

    kind: str = "Secret"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class ReplicationController:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Dict[str, str] = field(default_factory=dict)

    kind: str = "ReplicationController"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class ReplicaSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None

    kind: str = "ReplicaSet"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class StatefulSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None

    kind: str = "StatefulSet"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


# ---------------------------------------------------------------------------
# Binding (the pods/binding subresource payload,
# reference pkg/registry/core/pod/storage/storage.go:142)
# ---------------------------------------------------------------------------


@dataclass
class Binding:
    pod_namespace: str = "default"
    pod_name: str = ""
    pod_uid: str = ""
    target_node: str = ""


# ---------------------------------------------------------------------------
# Lease (coordination.k8s.io) -- leader election + node heartbeats
# (reference tools/leaderelection + kubelet.go:885)
# ---------------------------------------------------------------------------


@dataclass
class ResourceQuotaStatus:
    """core/v1 ResourceQuotaStatus: the ledger half of the object.
    ``hard`` echoes the enforced spec at last reconcile; ``used`` is the
    per-namespace consumption the QuotaController maintains through
    guaranteed_update check-and-increment (the multi-tenant admission
    gate's source of truth)."""

    hard: ResourceList = field(default_factory=dict)
    used: ResourceList = field(default_factory=dict)


@dataclass
class ResourceQuota:
    """core/v1 ResourceQuota (namespace-scoped hard caps). ``hard`` maps
    resource name -> base-unit integer limit in the same units as pod
    requests (cpu in milliCPU, memory in bytes, "pods" as a count,
    extended resources in whole units), so the admission arithmetic is
    pure integer adds against ``pod_resource_requests``. The scheduler
    enforces it at the scheduling gate (controllers/quota.py): a pod
    whose namespace has no headroom parks typed-QuotaExceeded instead of
    entering a batch."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    hard: ResourceList = field(default_factory=dict)
    status: ResourceQuotaStatus = field(default_factory=ResourceQuotaStatus)

    kind: str = "ResourceQuota"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class PriorityClass:
    """scheduling.k8s.io/v1 PriorityClass: a named priority value.
    Pods reference one by ``spec.priority_class_name``; the admission
    classifier resolves the effective priority from it when
    ``spec.priority`` was not stamped, and the streaming band threshold
    can be selected by a PriorityClass OBJECT instead of a raw integer
    (config streaming.bandPriorityClass)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    value: int = 0
    global_default: bool = False
    description: str = ""

    kind: str = "PriorityClass"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


@dataclass
class Lease:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    holder_identity: str = ""
    lease_duration_seconds: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_transitions: int = 0

    kind: str = "Lease"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


# ---------------------------------------------------------------------------
# PodDisruptionBudget (policy/v1beta1) -- consumed by preemption
# (reference generic_scheduler.go:885)
# ---------------------------------------------------------------------------


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0


@dataclass
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    selector: Optional[LabelSelector] = None
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    status: PodDisruptionBudgetStatus = field(
        default_factory=PodDisruptionBudgetStatus
    )

    kind: str = "PodDisruptionBudget"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


# ---------------------------------------------------------------------------
# PodGroup (coscheduling; out-of-tree CRD pattern)
# ---------------------------------------------------------------------------


@dataclass
class PodGroup:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    min_member: int = 1
    schedule_timeout_seconds: int = 60

    kind: str = "PodGroup"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


# Label used by pods to join a PodGroup (scheduler-plugins convention).
POD_GROUP_LABEL = "pod-group.scheduling.x-k8s.io/name"


# ---------------------------------------------------------------------------
# Event (core/v1 Event, the scheduler-emitted subset)
# ---------------------------------------------------------------------------


@dataclass
class ObjectReference:
    """core/v1 ObjectReference (the involvedObject of an Event)."""

    kind: str = ""
    namespace: str = ""
    name: str = ""
    uid: str = ""


@dataclass
class Event:
    """core/v1 Event as the scheduler's recorder emits it
    (reference profile.go:39 Recorder; "Scheduled" scheduler.go:544,
    "FailedScheduling" :378, "Preempted" on victims)."""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    involved_object: ObjectReference = field(default_factory=ObjectReference)
    reason: str = ""
    message: str = ""
    type: str = "Normal"  # Normal | Warning
    source: str = ""  # reporting component (schedulerName)
    count: int = 1
    first_timestamp: float = 0.0

    kind: str = "Event"

    def key(self) -> str:
        return f"{self.metadata.namespace}/{self.metadata.name}"


def pod_resource_requests(pod: Pod) -> ResourceList:
    """Effective resource request of a pod.

    Reference semantics (fit.go:99 computePodResourceRequest): sum of all
    app containers, element-wise max with each init container, plus
    pod overhead.

    Memoized per pod object: the result is recomputed for every cache
    add/remove and every tensor pack, and pod specs are immutable once
    in the informer cache (updates arrive as new objects). Callers that
    mutate ``spec.containers`` in place (test fixtures) must do so before
    the pod first flows through the scheduler.
    """
    memo = pod.__dict__.get("_req_memo")
    if memo is not None:
        return memo
    out: Dict[str, int] = {}
    for c in pod.spec.containers:
        for name, qty in c.resources.requests.items():
            out[name] = out.get(name, 0) + qty
    for c in pod.spec.init_containers:
        for name, qty in c.resources.requests.items():
            if qty > out.get(name, 0):
                out[name] = qty
    for name, qty in pod.spec.overhead.items():
        out[name] = out.get(name, 0) + qty
    pod.__dict__["_req_memo"] = out
    return out


def pod_resource_limits(pod: Pod) -> ResourceList:
    """Like ``pod_resource_requests`` but over limits
    (resource_limits.go semantics)."""
    out: Dict[str, int] = {}
    for c in pod.spec.containers:
        for name, qty in c.resources.limits.items():
            out[name] = out.get(name, 0) + qty
    for c in pod.spec.init_containers:
        for name, qty in c.resources.limits.items():
            if qty > out.get(name, 0):
                out[name] = qty
    return out
