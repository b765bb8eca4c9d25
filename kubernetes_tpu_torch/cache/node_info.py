"""NodeInfo: the per-node accumulator every filter/score reads.

Reference: /root/reference/pkg/scheduler/nodeinfo/node_info.go:47 (NodeInfo),
:143 (Resource), host_ports.go (HostPortInfo). This is exactly the structure
that gets lifted into the ``[N_nodes, R]`` resource tensor by
``kubernetes_tpu_torch.tensors.node_tensor``.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.api.types import (
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    Node,
    Pod,
    ResourceList,
    pod_resource_requests,
)

# Reference pkg/scheduler/util/non_zero.go: pods with no requests still count
# a default footprint toward spreading heuristics (NOT toward Fit).
DEFAULT_MILLI_CPU_REQUEST = 100  # 0.1 core
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024  # 200 MiB

# -- attachable-volume count resources --------------------------------------
# Countable volume limits ride the node tensor as synthetic scalar columns
# (the reference models in-tree limits the same way, as
# ``attachable-volumes-*`` node resources; nodevolumelimits/non_csi.go).
# CSI drivers get one column each (``attachable-volumes-csi-<driver>``,
# allocatable from CSINode); in-tree types use the reference's fixed
# per-cloud defaults. A node with no known limit for a column advertises
# VOLUME_UNLIMITED (csi.go:72: CSINode absent -> no limits known -> allow).
CSI_ATTACH_PREFIX = "attachable-volumes-csi-"
EBS_VOLUME_RESOURCE = "attachable-volumes-aws-ebs"
GCE_PD_VOLUME_RESOURCE = "attachable-volumes-gce-pd"
AZURE_DISK_VOLUME_RESOURCE = "attachable-volumes-azure-disk"
INTREE_VOLUME_LIMITS = {
    EBS_VOLUME_RESOURCE: 39,
    GCE_PD_VOLUME_RESOURCE: 16,
    AZURE_DISK_VOLUME_RESOURCE: 16,
}
VOLUME_UNLIMITED = 1 << 24  # "no limit known"; safely below int32 overflow


def pod_volume_counts(pod: Pod) -> Tuple:
    """Per-limit-resource attachable-volume counts for a pod, as a sorted
    ``((resource_name, count), ...)`` tuple. The counts are RESOLVED
    (PVC -> PV) by the scheduler's admission classifier / ingest hook
    (scheduler/admission.py), which stores them in ``_volcount_memo`` on
    the pod object; without that memo the counts are empty and volume
    columns stay zero (the standalone-cache behavior before this PR).

    The memo must be stable between ``add_pod`` and ``remove_pod`` for a
    cached pod object (the in-use accounting subtracts what it added);
    classification only rewrites the memo on pods that are not yet in
    the cache, and assumed clones freeze their own copy of it."""
    return pod.__dict__.get("_volcount_memo") or ()


_generation = itertools.count(1)


def next_generation() -> int:
    return next(_generation)


@dataclass
class Resource:
    """Aggregated resource vector (reference node_info.go:143)."""

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar: Dict[str, int] = field(default_factory=dict)

    def clone(self) -> "Resource":
        return Resource(
            self.milli_cpu,
            self.memory,
            self.ephemeral_storage,
            self.allowed_pod_number,
            dict(self.scalar),
        )

    def add(self, rl: ResourceList) -> None:
        for name, qty in rl.items():
            if name == RESOURCE_CPU:
                self.milli_cpu += qty
            elif name == RESOURCE_MEMORY:
                self.memory += qty
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                self.ephemeral_storage += qty
            elif name == RESOURCE_PODS:
                self.allowed_pod_number += qty
            else:
                self.scalar[name] = self.scalar.get(name, 0) + qty

    def sub(self, rl: ResourceList) -> None:
        for name, qty in rl.items():
            if name == RESOURCE_CPU:
                self.milli_cpu -= qty
            elif name == RESOURCE_MEMORY:
                self.memory -= qty
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                self.ephemeral_storage -= qty
            elif name == RESOURCE_PODS:
                self.allowed_pod_number -= qty
            else:
                self.scalar[name] = self.scalar.get(name, 0) - qty


def new_resource(rl: ResourceList) -> Resource:
    r = Resource()
    r.add(rl)
    return r


def non_zero_requests(pod: Pod) -> Tuple[int, int]:
    """(milliCPU, memory) with per-container defaults applied
    (reference util/non_zero.go GetNonzeroRequests). Memoized like
    ``pod_resource_requests`` (same immutability contract)."""
    memo = pod.__dict__.get("_nzr_memo")
    if memo is not None:
        return memo
    cpu = 0
    mem = 0
    for c in pod.spec.containers:
        ccpu = c.resources.requests.get(RESOURCE_CPU, 0)
        cmem = c.resources.requests.get(RESOURCE_MEMORY, 0)
        cpu += ccpu if ccpu else DEFAULT_MILLI_CPU_REQUEST
        mem += cmem if cmem else DEFAULT_MEMORY_REQUEST
    pod.__dict__["_nzr_memo"] = (cpu, mem)
    return cpu, mem


def pod_hot_info(pod: Pod) -> Tuple:
    """Per-pod accounting deltas, memoized once (same immutability
    contract as ``pod_resource_requests``): (milli_cpu, memory,
    ephemeral, scalar_items, nzr_cpu, nzr_mem, has_affinity,
    host_ports). NodeInfo.add_pod/remove_pod run once per pod per
    assume/evict, and re-deriving these from the spec dicts was the
    single largest slice of the burst's bulk-assume wall time."""
    memo = pod.__dict__.get("_hot_memo")
    if memo is not None:
        return memo
    r = new_resource(pod_resource_requests(pod))
    cpu, mem = non_zero_requests(pod)
    memo = (
        r.milli_cpu, r.memory, r.ephemeral_storage,
        tuple(r.scalar.items()), cpu, mem,
        pod_has_affinity_constraints(pod), tuple(pod_host_ports(pod)),
    )
    pod.__dict__["_hot_memo"] = memo
    return memo


def pod_has_affinity_constraints(pod: Pod) -> bool:
    a = pod.spec.affinity
    return a is not None and (
        a.pod_affinity is not None or a.pod_anti_affinity is not None
    )


def pod_host_ports(pod: Pod) -> List[Tuple[str, str, int]]:
    """[(ip, protocol, port)] for every container hostPort != 0."""
    out = []
    for c in pod.spec.containers:
        for p in c.ports:
            if p.host_port:
                ip = p.host_ip or "0.0.0.0"
                out.append((ip, p.protocol or "TCP", p.host_port))
    return out


class HostPortInfo:
    """Port-conflict bookkeeping (reference host_ports.go).

    A (ip, proto, port) conflicts with an existing entry when ports and
    protocols are equal and either ip is 0.0.0.0 or the ips are equal.
    """

    def __init__(self) -> None:
        self.ports: Set[Tuple[str, str, int]] = set()

    def clone(self) -> "HostPortInfo":
        hp = HostPortInfo()
        hp.ports = set(self.ports)
        return hp

    def add(self, ip: str, proto: str, port: int) -> None:
        self.ports.add((ip, proto, port))

    def remove(self, ip: str, proto: str, port: int) -> None:
        self.ports.discard((ip, proto, port))

    def conflicts(self, ip: str, proto: str, port: int) -> bool:
        for eip, eproto, eport in self.ports:
            if eport != port or eproto != proto:
                continue
            if ip == "0.0.0.0" or eip == "0.0.0.0" or eip == ip:
                return True
        return False


class NodeInfo:
    """Aggregated per-node state (reference node_info.go:47)."""

    def __init__(self, node: Optional[Node] = None) -> None:
        self.node: Optional[Node] = node
        self.pods: List[Pod] = []
        self.pods_with_affinity: List[Pod] = []
        self.used_ports = HostPortInfo()
        self.requested = Resource()
        self.non_zero_requested = Resource()
        self.allocatable = Resource()
        self.image_states: Dict[str, int] = {}  # image name -> size bytes
        # attachable-volume bookkeeping for the device columns:
        # per-resource limits from this node's CSINode (empty -> defaults/
        # unlimited) and the additive in-use counts from resident pods
        self.csi_volume_limits: Dict[str, int] = {}
        self.volume_in_use: Dict[str, int] = {}
        self.generation: int = next_generation()
        if node is not None:
            self.set_node(node)

    # -- node ---------------------------------------------------------------

    def set_node(self, node: Node) -> None:
        self.node = node
        self.allocatable = new_resource(node.status.allocatable)
        self.image_states = {
            name: img.size_bytes for img in node.status.images for name in img.names
        }
        self.generation = next_generation()

    def set_csi_node(self, csi_node) -> None:
        """Apply (or clear, with None) this node's CSINode attach limits
        (nodevolumelimits/csi.go:72 reads CSINode allocatable per
        driver)."""
        if csi_node is None:
            self.csi_volume_limits = {}
        else:
            self.csi_volume_limits = {
                CSI_ATTACH_PREFIX + d.name: d.allocatable_count
                for d in csi_node.drivers
                if d.allocatable_count is not None
            }
        self.generation = next_generation()

    def volume_limit(self, resource: str) -> int:
        """Allocatable for one volume-count column: CSINode-declared
        limit, else the in-tree per-cloud default, else unlimited."""
        lim = self.csi_volume_limits.get(resource)
        if lim is not None:
            return lim
        return INTREE_VOLUME_LIMITS.get(resource, VOLUME_UNLIMITED)

    @property
    def node_name(self) -> str:
        return self.node.metadata.name if self.node else ""

    # -- pods ---------------------------------------------------------------

    def add_pod(self, pod: Pod) -> None:
        (
            milli, mem_b, eph, scalars, cpu, mem, has_aff, ports,
        ) = pod_hot_info(pod)
        req = self.requested
        req.milli_cpu += milli
        req.memory += mem_b
        req.ephemeral_storage += eph
        if scalars:
            sc = req.scalar
            for name, qty in scalars:
                sc[name] = sc.get(name, 0) + qty
        self.non_zero_requested.milli_cpu += cpu
        self.non_zero_requested.memory += mem
        self.pods.append(pod)
        if has_aff:
            self.pods_with_affinity.append(pod)
        for ip, proto, port in ports:
            self.used_ports.add(ip, proto, port)
        vc = pod.__dict__.get("_volcount_memo")
        if vc:
            viu = self.volume_in_use
            for name, qty in vc:
                viu[name] = viu.get(name, 0) + qty
        self.generation = next_generation()

    def add_pods(self, pods: List[Pod]) -> None:
        """Bulk add for ONE node: identical accounting to N ``add_pod``
        calls with the resource accumulation held in locals and a single
        generation bump for the whole run (the batch committer lands
        node-grouped assume runs here; the tensor cache's
        generation-compare repack sees one change either way)."""
        req = self.requested
        nzr = self.non_zero_requested
        milli = mem_b = eph = 0
        nzr_cpu = nzr_mem = 0
        for pod in pods:
            (
                milli_i, mem_i, eph_i, scalars, cpu, mem, has_aff, ports,
            ) = pod_hot_info(pod)
            milli += milli_i
            mem_b += mem_i
            eph += eph_i
            nzr_cpu += cpu
            nzr_mem += mem
            if scalars:
                sc = req.scalar
                for name, qty in scalars:
                    sc[name] = sc.get(name, 0) + qty
            if has_aff:
                self.pods_with_affinity.append(pod)
            for ip, proto, port in ports:
                self.used_ports.add(ip, proto, port)
            vc = pod.__dict__.get("_volcount_memo")
            if vc:
                viu = self.volume_in_use
                for name, qty in vc:
                    viu[name] = viu.get(name, 0) + qty
        req.milli_cpu += milli
        req.memory += mem_b
        req.ephemeral_storage += eph
        nzr.milli_cpu += nzr_cpu
        nzr.memory += nzr_mem
        self.pods.extend(pods)
        self.generation = next_generation()

    def remove_pod(self, pod: Pod) -> bool:
        for i, p in enumerate(self.pods):
            if p.metadata.uid == pod.metadata.uid:
                del self.pods[i]
                break
        else:
            return False
        self.pods_with_affinity = [
            p for p in self.pods_with_affinity if p.metadata.uid != pod.metadata.uid
        ]
        (
            milli, mem_b, eph, scalars, cpu, mem, _has_aff, ports,
        ) = pod_hot_info(pod)
        req = self.requested
        req.milli_cpu -= milli
        req.memory -= mem_b
        req.ephemeral_storage -= eph
        if scalars:
            sc = req.scalar
            for name, qty in scalars:
                sc[name] = sc.get(name, 0) - qty
        self.non_zero_requested.milli_cpu -= cpu
        self.non_zero_requested.memory -= mem
        for ip, proto, port in ports:
            self.used_ports.remove(ip, proto, port)
        vc = pod.__dict__.get("_volcount_memo")
        if vc:
            viu = self.volume_in_use
            for name, qty in vc:
                viu[name] = viu.get(name, 0) - qty
        self.generation = next_generation()
        return True

    # -- snapshot support ---------------------------------------------------

    def clone(self) -> "NodeInfo":
        ni = NodeInfo.__new__(NodeInfo)
        ni.node = self.node
        ni.pods = list(self.pods)
        ni.pods_with_affinity = list(self.pods_with_affinity)
        ni.used_ports = self.used_ports.clone()
        ni.requested = self.requested.clone()
        ni.non_zero_requested = self.non_zero_requested.clone()
        ni.allocatable = self.allocatable.clone()
        ni.image_states = dict(self.image_states)
        ni.csi_volume_limits = dict(self.csi_volume_limits)
        ni.volume_in_use = dict(self.volume_in_use)
        ni.generation = self.generation
        return ni

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"NodeInfo(node={self.node_name!r}, pods={len(self.pods)}, "
            f"requested=cpu:{self.requested.milli_cpu}m mem:{self.requested.memory})"
        )
