"""Volume plugins: VolumeRestrictions, VolumeZone, NodeVolumeLimits
(CSI + in-tree), and VolumeBinding with a lite volume binder.

References:
- volumerestrictions/volume_restrictions.go (:46 isVolumeConflict, :121
  Filter): GCE-PD/EBS/ISCSI/RBD mount-conflict rules
- volumezone/volume_zone.go (:73 Filter): PV zone/region labels must match
  node labels; WaitForFirstConsumer claims are skipped
- nodevolumelimits/csi.go + non_csi.go: attachable-volume count limits per
  driver (CSINode allocatable) / per cloud type (fixed defaults)
- volumebinding/volume_binding.go + the binder
  pkg/controller/volume/scheduling/scheduler_binder.go:235 FindPodVolumes
  (bound PV node-affinity check; unbound WaitForFirstConsumer claims
  matched against available PVs or deemed provisionable), :320
  AssumePodVolumes / :397 BindPodVolumes collapsed into PreBind here.

The volume dimension stays host-side in the TPU design (string/topology
heavy, rarely the bottleneck); pods with PVCs take the sequential path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.selectors import node_matches_node_selector
from kubernetes_tpu_torch.api.types import (
    CSINode,
    LABEL_REGION_KEYS,
    LABEL_ZONE_KEYS,
    PersistentVolume,
    PersistentVolumeClaim,
    Pod,
    StorageClass,
    VOLUME_BINDING_WAIT,
    Volume,
)
from kubernetes_tpu_torch.cache.node_info import (
    AZURE_DISK_VOLUME_RESOURCE,
    CSI_ATTACH_PREFIX,
    EBS_VOLUME_RESOURCE,
    GCE_PD_VOLUME_RESOURCE,
    NodeInfo,
)
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status

ERR_REASON_DISK_CONFLICT = "node(s) had no available disk"
ERR_REASON_ZONE_CONFLICT = "node(s) had no available volume zone"
ERR_REASON_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"
ERR_REASON_BINDING = "node(s) didn't find available persistent volumes to bind"
ERR_REASON_NODE_CONFLICT = (
    "node(s) had volume node affinity conflict"
)
ERR_REASON_MAX_VOLUME_COUNT = "node(s) exceed max volume count"

# reference nodevolumelimits/non_csi.go default limits
DEFAULT_EBS_LIMIT = 39
DEFAULT_GCE_PD_LIMIT = 16
DEFAULT_AZURE_LIMIT = 16


class VolumeRestrictions(Plugin):
    """Filter (volume_restrictions.go:121)."""

    NAME = "VolumeRestrictions"

    @staticmethod
    def _conflicts(v: Volume, existing: Volume) -> bool:
        if v.gce_pd_name and v.gce_pd_name == existing.gce_pd_name:
            if not (v.read_only and existing.read_only):
                return True
        if (
            v.aws_ebs_volume_id
            and v.aws_ebs_volume_id == existing.aws_ebs_volume_id
        ):
            return True
        if v.iscsi_target and v.iscsi_target == existing.iscsi_target:
            if not (v.read_only and existing.read_only):
                return True
        if v.rbd_image and v.rbd_image == existing.rbd_image:
            if not (v.read_only and existing.read_only):
                return True
        return False

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        for v in pod.spec.volumes:
            if not (
                v.gce_pd_name or v.aws_ebs_volume_id or v.iscsi_target
                or v.rbd_image
            ):
                continue
            for existing_pod in node_info.pods:
                for ev in existing_pod.spec.volumes:
                    if self._conflicts(v, ev):
                        return Status.unschedulable(ERR_REASON_DISK_CONFLICT)
        return None


class _Listers:
    """Shared lister access for the PVC/PV/SC/CSINode-consuming plugins."""

    def __init__(self, handle=None) -> None:
        self.informers = getattr(handle, "informers", None)

    def _get(self, kind_accessor: str, namespace: str, name: str):
        if self.informers is None:
            return None
        return getattr(self.informers, kind_accessor)().get(namespace, name)

    def pvc(self, namespace: str, name: str) -> Optional[PersistentVolumeClaim]:
        return self._get("persistent_volume_claims", namespace, name)

    def pv(self, name: str) -> Optional[PersistentVolume]:
        return self._get("persistent_volumes", "", name)

    def storage_class(self, name: str) -> Optional[StorageClass]:
        return self._get("storage_classes", "", name)

    def csi_node(self, name: str) -> Optional[CSINode]:
        return self._get("csi_nodes", "", name)

    def list_pvs(self) -> List[PersistentVolume]:
        if self.informers is None:
            return []
        return self.informers.persistent_volumes().list()


def classify_pod_volumes(pod, listers: _Listers) -> Tuple[str, Tuple]:
    """Classify a pod's volumes for the device path. Returns
    ``(host_reason, counts)``:

    - ``host_reason == ""``: every volume filter is either provably
      node-independent OR a pure attachable-volume COUNT the ``[N, R]``
      tensor's volume columns enforce on device (tensors/node_tensor.py)
      -- the pod rides the batch solver. Previously any countable source
      fell off the device entirely (the 54 pods/s SchedulingCSIPVs
      cliff).
    - a non-empty reason keeps the pod on the exact host oracle: direct
      in-tree sources (VolumeRestrictions mount-CONFLICT rules are
      pairwise identity, not counts), unbound claims
      (WaitForFirstConsumer / missing), missing PVs, PV node affinity,
      or zonal PV labels (VolumeZone).

    ``counts`` is the sorted ``((limit_resource, n_unique_handles), ...)``
    tuple over the pod's countable volumes -- resolved through PVC -> PV
    for bound claims and read directly off in-tree sources -- and is
    returned even for host-routed pods: the node's in-use accounting
    (NodeInfo.volume_in_use) must see every attach regardless of which
    path placed the pod. Counting is per-pod-unique and additive across
    pods, i.e. conservative versus the oracle's per-node-unique handle
    sets: the device can under-admit a shared handle but never
    over-admit (the dispatcher re-checks device rejects of countable
    pods on the host path)."""
    reason = ""
    handles: Dict[str, set] = {}

    def count(resource: str, handle: str) -> None:
        handles.setdefault(resource, set()).add(handle)

    for v in pod.spec.volumes:
        if (
            v.gce_pd_name or v.aws_ebs_volume_id
            or v.iscsi_target or v.rbd_image
        ):
            # conflict semantics, not counts: host path. The attach
            # still consumes the node's in-tree limit budget.
            reason = reason or "direct-volume-source"
            if v.gce_pd_name:
                count(GCE_PD_VOLUME_RESOURCE, v.gce_pd_name)
            if v.aws_ebs_volume_id:
                count(EBS_VOLUME_RESOURCE, v.aws_ebs_volume_id)
            continue
        if not v.pvc_claim_name:
            continue
        pvc = listers.pvc(pod.metadata.namespace, v.pvc_claim_name)
        if pvc is None or not pvc.volume_name:
            reason = reason or "unbound-pvc"
            continue
        pv = listers.pv(pvc.volume_name)
        if pv is None:
            reason = reason or "pv-missing"
            continue
        if pv.node_affinity is not None:
            reason = reason or "pv-node-affinity"
        elif any(
            k in pv.metadata.labels
            for k in LABEL_ZONE_KEYS + LABEL_REGION_KEYS
        ):
            reason = reason or "pv-zonal"
        if pv.csi_driver:
            count(
                CSI_ATTACH_PREFIX + pv.csi_driver,
                pv.csi_volume_handle or pv.metadata.name,
            )
        elif pv.gce_pd_name:
            count(GCE_PD_VOLUME_RESOURCE, pv.gce_pd_name)
        elif pv.aws_ebs_volume_id:
            count(EBS_VOLUME_RESOURCE, pv.aws_ebs_volume_id)
        elif pv.azure_disk_name:
            count(AZURE_DISK_VOLUME_RESOURCE, pv.azure_disk_name)
    counts = tuple(
        sorted((name, len(hs)) for name, hs in handles.items())
    )
    return reason, counts


def volumes_device_safe(pod, listers: _Listers) -> bool:
    """True when the batch solver can place this pod without the host
    volume oracle (see ``classify_pod_volumes``). Since the
    volume-count device columns landed, countable bound PVs (CSI and
    in-tree via PVC) are device-safe too -- their limits solve as
    ``[N, R]`` columns; only conflict-bearing direct sources, unbound
    claims, and node-affine/zonal PVs keep the host path."""
    return not classify_pod_volumes(pod, listers)[0]


def _zone_values(value: str) -> set:
    """volumehelpers.LabelZonesToSet: multi-zone PV labels are
    '__'-separated."""
    return set(value.split("__"))


class VolumeZone(Plugin):
    """Filter (volume_zone.go:73)."""

    NAME = "VolumeZone"

    def __init__(self, handle=None) -> None:
        self.listers = _Listers(handle)

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        node = node_info.node
        if node is None:
            return Status.error("node not found")
        zone_keys = LABEL_ZONE_KEYS + LABEL_REGION_KEYS
        constraints = {
            k: v for k, v in node.metadata.labels.items() if k in zone_keys
        }
        if not constraints:
            return None
        for v in pod.spec.volumes:
            if not v.pvc_claim_name:
                continue
            pvc = self.listers.pvc(pod.metadata.namespace, v.pvc_claim_name)
            if pvc is None:
                return Status.error(
                    f"PersistentVolumeClaim {v.pvc_claim_name!r} not found"
                )
            if not pvc.volume_name:
                sc = self.listers.storage_class(pvc.storage_class_name)
                if sc is not None and sc.volume_binding_mode == VOLUME_BINDING_WAIT:
                    continue  # unbound wait-for-consumer: skip
                return Status.error("PersistentVolume had no name")
            pv = self.listers.pv(pvc.volume_name)
            if pv is None:
                return Status.error(
                    f"PersistentVolume {pvc.volume_name!r} not found"
                )
            for k, val in pv.metadata.labels.items():
                if k not in zone_keys:
                    continue
                node_v = constraints.get(k)
                if node_v is None or node_v not in _zone_values(val):
                    return Status.unschedulable_and_unresolvable(
                        ERR_REASON_ZONE_CONFLICT
                    )
        return None


class CSILimits(Plugin):
    """Filter (nodevolumelimits/csi.go): unique CSI volume handles per
    driver vs CSINode allocatable."""

    NAME = "NodeVolumeLimitsCSI"

    def __init__(self, handle=None) -> None:
        self.listers = _Listers(handle)

    def _pod_csi_volumes(self, pod: Pod) -> List[Tuple[str, str]]:
        """[(driver, handle)] via PVC -> PV."""
        out = []
        for v in pod.spec.volumes:
            if not v.pvc_claim_name:
                continue
            pvc = self.listers.pvc(pod.metadata.namespace, v.pvc_claim_name)
            if pvc is None or not pvc.volume_name:
                continue
            pv = self.listers.pv(pvc.volume_name)
            if pv is not None and pv.csi_driver:
                out.append((pv.csi_driver, pv.csi_volume_handle))
        return out

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        new_volumes = self._pod_csi_volumes(pod)
        if not new_volumes:
            return None
        csi_node = self.listers.csi_node(node_info.node_name)
        if csi_node is None:
            return None  # no limits known
        limits = {
            d.name: d.allocatable_count
            for d in csi_node.drivers
            if d.allocatable_count is not None
        }
        if not limits:
            return None
        in_use: Dict[str, set] = {}
        for existing in node_info.pods:
            for driver, handle in self._pod_csi_volumes(existing):
                in_use.setdefault(driver, set()).add(handle)
        for driver, handle in new_volumes:
            if driver not in limits:
                continue
            used = in_use.setdefault(driver, set())
            if handle not in used and len(used) + 1 > limits[driver]:
                return Status.unschedulable(ERR_REASON_MAX_VOLUME_COUNT)
            used.add(handle)
        return None


class _InTreeLimits(Plugin):
    """Filter (nodevolumelimits/non_csi.go): attachable in-tree volume
    count vs a fixed per-cloud limit."""

    VOLUME_ATTR = ""
    PV_ATTR = ""
    DEFAULT_LIMIT = 0

    def __init__(self, handle=None, limit: Optional[int] = None) -> None:
        self.listers = _Listers(handle)
        self.limit = limit if limit is not None else self.DEFAULT_LIMIT

    def _pod_volume_ids(self, pod: Pod) -> set:
        out = set()
        for v in pod.spec.volumes:
            direct = getattr(v, self.VOLUME_ATTR, "")
            if direct:
                out.add(direct)
            elif v.pvc_claim_name:
                pvc = self.listers.pvc(pod.metadata.namespace, v.pvc_claim_name)
                if pvc is not None and pvc.volume_name:
                    pv = self.listers.pv(pvc.volume_name)
                    if pv is not None:
                        via_pv = getattr(pv, self.PV_ATTR, "")
                        if via_pv:
                            out.add(via_pv)
        return out

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        new_ids = self._pod_volume_ids(pod)
        if not new_ids:
            return None
        attached = set()
        for existing in node_info.pods:
            attached |= self._pod_volume_ids(existing)
        if len(attached | new_ids) > self.limit:
            return Status.unschedulable(ERR_REASON_MAX_VOLUME_COUNT)
        return None


class EBSLimits(_InTreeLimits):
    NAME = "EBSLimits"
    VOLUME_ATTR = "aws_ebs_volume_id"
    PV_ATTR = "aws_ebs_volume_id"
    DEFAULT_LIMIT = DEFAULT_EBS_LIMIT


class GCEPDLimits(_InTreeLimits):
    NAME = "GCEPDLimits"
    VOLUME_ATTR = "gce_pd_name"
    PV_ATTR = "gce_pd_name"
    DEFAULT_LIMIT = DEFAULT_GCE_PD_LIMIT


class AzureDiskLimits(_InTreeLimits):
    NAME = "AzureDiskLimits"
    VOLUME_ATTR = ""  # no direct azure source in the flattened Volume
    PV_ATTR = "azure_disk_name"
    DEFAULT_LIMIT = DEFAULT_AZURE_LIMIT


class VolumeBinder:
    """Lite SchedulerVolumeBinder (scheduler_binder.go): feasibility at
    Filter, all-or-nothing bind at PreBind."""

    def __init__(self, handle=None) -> None:
        self.listers = _Listers(handle)
        self.client = getattr(handle, "client", None)

    def _claims(self, pod: Pod) -> List[Tuple[Volume, Optional[PersistentVolumeClaim]]]:
        return [
            (v, self.listers.pvc(pod.metadata.namespace, v.pvc_claim_name))
            for v in pod.spec.volumes
            if v.pvc_claim_name
        ]

    def _pv_matches_node(self, pv: PersistentVolume, node_info: NodeInfo) -> bool:
        if pv.node_affinity is None:
            return True
        node = node_info.node
        return node_matches_node_selector(
            node.metadata.labels, pv.node_affinity,
            {"metadata.name": node.metadata.name},
        )

    def _find_matching_pv(
        self,
        pvc: PersistentVolumeClaim,
        node_info: NodeInfo,
        reserved: Optional[set] = None,
    ) -> Optional[PersistentVolume]:
        """``reserved`` carries PV names already matched to earlier claims
        of the same pod in this call -- the assume-cache role of the
        reference binder (scheduler_binder.go:320), preventing one PV from
        satisfying two claims."""
        best = None
        for pv in self.listers.list_pvs():
            if reserved and pv.metadata.name in reserved:
                continue
            if pv.claim_ref_name and not pv.is_bound_to(
                pvc.metadata.namespace, pvc.metadata.name
            ):
                continue
            if pv.storage_class_name != pvc.storage_class_name:
                continue
            if pv.capacity_bytes < pvc.requested_bytes:
                continue
            if not self._pv_matches_node(pv, node_info):
                continue
            if best is None or pv.capacity_bytes < best.capacity_bytes:
                best = pv  # smallest fitting PV
        return best

    def find_pod_volumes(
        self, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        """FindPodVolumes (scheduler_binder.go:235)."""
        reserved: set = set()
        for v, pvc in self._claims(pod):
            if pvc is None:
                return Status.unschedulable_and_unresolvable(
                    f"persistentvolumeclaim {v.pvc_claim_name!r} not found"
                )
            if pvc.volume_name:
                pv = self.listers.pv(pvc.volume_name)
                if pv is None:
                    return Status.unschedulable_and_unresolvable(
                        f"persistentvolume {pvc.volume_name!r} not found"
                    )
                if not self._pv_matches_node(pv, node_info):
                    return Status.unschedulable_and_unresolvable(
                        ERR_REASON_NODE_CONFLICT
                    )
                continue
            # unbound claim
            sc = self.listers.storage_class(pvc.storage_class_name)
            if sc is None or sc.volume_binding_mode != VOLUME_BINDING_WAIT:
                return Status.unschedulable_and_unresolvable(
                    ERR_REASON_UNBOUND_IMMEDIATE
                )
            match = self._find_matching_pv(pvc, node_info, reserved)
            if match is not None:
                reserved.add(match.metadata.name)
                continue
            if sc.provisioner and sc.provisioner != "kubernetes.io/no-provisioner":
                continue  # dynamically provisionable on this node
            return Status.unschedulable(ERR_REASON_BINDING)
        return None

    def bind_pod_volumes(self, pod: Pod, node_info: NodeInfo) -> Optional[Status]:
        """AssumePodVolumes+BindPodVolumes collapsed: bind matched PVs."""
        if self.client is None:
            return None
        reserved: set = set()
        for v, pvc in self._claims(pod):
            if pvc is None or pvc.volume_name:
                continue
            pv = self._find_matching_pv(pvc, node_info, reserved)
            if pv is None:
                sc = self.listers.storage_class(pvc.storage_class_name)
                if sc is not None and sc.provisioner and \
                        sc.provisioner != "kubernetes.io/no-provisioner":
                    continue  # provisioning is the controller's job
                return Status.error(
                    f"no PV to bind for claim {pvc.key()}"
                )
            # guaranteed updates: never mutate the lister's shared objects
            # in place (the store's copy-on-write contract)
            reserved.add(pv.metadata.name)
            pv_name = pv.metadata.name
            ns, claim = pvc.metadata.namespace, pvc.metadata.name

            def bind_pv(obj) -> None:
                obj.claim_ref_namespace = ns
                obj.claim_ref_name = claim

            def bind_pvc(obj) -> None:
                obj.volume_name = pv_name
                obj.phase = "Bound"

            try:
                self.client.server.guaranteed_update(
                    "PersistentVolume", "", pv_name, bind_pv
                )
                self.client.server.guaranteed_update(
                    "PersistentVolumeClaim", ns, claim, bind_pvc
                )
            except KeyError as e:
                return Status.error(f"volume binding failed: {e}")
        return None


class VolumeBinding(Plugin):
    """Filter + PreBind (volume_binding.go)."""

    NAME = "VolumeBinding"

    def __init__(self, handle=None) -> None:
        self.binder = VolumeBinder(handle)

    def filter(
        self, state: CycleState, pod: Pod, node_info: NodeInfo
    ) -> Optional[Status]:
        if not any(v.pvc_claim_name for v in pod.spec.volumes):
            return None
        return self.binder.find_pod_volumes(pod, node_info)

    def pre_bind_relevant(self, pod: Pod) -> bool:
        """Bulk-commit fast-path predicate: pre_bind() is a no-op for
        pods without PVC volumes."""
        return any(v.pvc_claim_name for v in pod.spec.volumes)

    def pre_bind(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Optional[Status]:
        if not any(v.pvc_claim_name for v in pod.spec.volumes):
            return None
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None:
            return Status.error(f"node {node_name} not in snapshot")
        return self.binder.bind_pod_volumes(pod, ni)
