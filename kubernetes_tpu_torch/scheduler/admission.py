"""Hot-path admission classification for the batch dispatcher.

The round-5 regression (VERDICT.md: 24,544 -> 18,490 pods/s) came from
re-deriving the solver-admission decision per pod per dispatch cycle:
``solver_supported`` walked NUMA annotations, spread constraints, and
volume sources, and ``volumes_device_safe`` resolved PVC -> PV through
the listers, all inside ``schedule_batch``'s pop loop. This module
computes the whole classification ONCE -- at informer ingest
(scheduler/eventhandlers.py calls ``BatchScheduler.classify_pod`` when a
pending pod enters the queue) -- and caches the result on the pod object
(``pod.__dict__["_admission"]``), so pop -> dispatch is a memo read.

An ``Admission`` record carries three things:

- the routing decision: ``device_ok`` plus a ``reason`` string for the
  host path ("numa-aligned", "direct-volume-source", "unbound-pvc",
  "extender-interested", ...), and the derived ``klass`` ("device" /
  "constrained" / "host") for observability;
- the pod's resolved attachable-volume counts (``vol_counts``), which
  feed the ``[N, R]`` volume-limit columns (tensors/node_tensor.py) and
  the node in-use accounting (cache/node_info.py);
- per-pod feature bits (hard spread, host ports, required (anti-)
  affinity, scoring terms, gang membership) so ``_dispatch_solve``'s
  batch-level aggregates are ``any()`` over memo bits instead of
  repeated spec walks.

Staleness: the spec-derived bits are keyed by object identity (an
updated pod arrives as a NEW object from the informer, so it simply has
no memo). Volume classification additionally depends on PVC/PV/
StorageClass/CSINode state that mutates WITHOUT replacing the pod
object, so records for PVC-bearing pods stamp the scheduler's
volume-topology generation (bumped by every storage-object event) and
are re-classified at pop time when it moved -- a PVC binding landing
mid-queue re-routes the pod instead of dispatching it under the stale
class. Records are also pinned to a per-scheduler token so a memo from
another scheduler instance (different extenders, different dims
registry) is never trusted.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    POD_GROUP_LABEL,
    Pod,
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
)
from kubernetes_tpu_torch.cache.node_info import (
    DEFAULT_MEMORY_REQUEST,
    DEFAULT_MILLI_CPU_REQUEST,
    pod_hot_info,
)
from kubernetes_tpu_torch.plugins.numa import ALIGNED_ANNOTATION
from kubernetes_tpu_torch.tensors.node_tensor import _kib_ceil, stamp_pack_row


def solver_unsupported_reason(pod: Pod) -> str:
    """The pure-spec slice of admission: constraint shapes the device
    solver does not model (see scheduler/batch.py module docstring).
    Returns "" when the spec is solver-supported."""
    spec = pod.spec
    # single-NUMA-aligned extended resources keep the host path: the
    # per-node best-fit group bookkeeping (plugins/numa.py) is stateful
    # per placement in ways the batch replay does not model
    if pod.metadata.annotations.get(ALIGNED_ANNOTATION):
        return "numa-aligned"
    # soft spread with node scoping can't share score groups
    # (ops/topology._eligibility_sig covers only hard spread)
    if any(
        c.when_unsatisfiable != "DoNotSchedule"
        for c in spec.topology_spread_constraints
    ) and (
        spec.node_selector
        or (
            spec.affinity is not None
            and spec.affinity.node_affinity is not None
        )
    ):
        return "soft-spread-node-scoped"
    # direct in-tree sources carry VolumeRestrictions mount-CONFLICT
    # semantics (pairwise identity) the count columns can't express
    for v in spec.volumes:
        if (
            v.gce_pd_name or v.aws_ebs_volume_id
            or v.iscsi_target or v.rbd_image
        ):
            return "direct-volume-source"
    return ""


class Admission:
    """One pod's precomputed admission classification (see module
    docstring). Slotted: one record per pending pod on the hot path."""

    __slots__ = (
        "device_ok", "reason", "vol_counts", "has_pvc", "volume_gen",
        "pinned", "token", "hard_spread", "ports", "affinity_req",
        "required_anti", "scoring_terms", "score_pref", "score_soft",
        "gang",
    )

    def __init__(self) -> None:
        self.device_ok = True
        self.reason = ""
        self.vol_counts: Tuple = ()
        self.has_pvc = False
        self.volume_gen = 0
        self.pinned = False
        self.token: Optional[object] = None
        self.hard_spread = False
        self.ports = False
        self.affinity_req = False
        self.required_anti = False
        self.scoring_terms = False
        self.score_pref = False
        self.score_soft = False
        self.gang = False

    @property
    def klass(self) -> str:
        """Admission class for metrics/docs: "host" (sequential oracle),
        "constrained" (device, with constraint-family tensors), or
        "device" (plain resource solve)."""
        if not self.device_ok:
            return "host"
        if (
            self.hard_spread or self.ports or self.affinity_req
            or self.scoring_terms or self.score_soft
        ):
            return "constrained"
        return "device"

    def as_host_only(self, reason: str) -> "Admission":
        """A pinned host-only copy: used when a device solve rejects a
        countable-volume pod (the additive columns may under-admit a
        shared handle), so the retry runs the exact host oracle instead
        of bouncing device -> NO_NODE forever. Pinned records skip the
        volume-generation staleness check; a real pod update still
        replaces the object (and the memo) wholesale."""
        host = Admission()
        for slot in self.__slots__:
            setattr(host, slot, getattr(self, slot))
        host.device_ok = False
        host.reason = reason
        host.pinned = True
        return host


def classify_pod(
    pod: Pod,
    *,
    extenders,
    listers,
    volume_gen: int,
    token: object,
    priority_resolver=None,
) -> Admission:
    """Build (and memoize on the pod) the full admission record. Safe to
    call from informer threads: lister reads take the informers' own
    locks only, and NOTHING here touches the tensor schema -- volume
    columns are registered by the dispatcher thread at pop time
    (BatchScheduler._admission_of), so the dims registry never grows
    under a concurrently packing NodeTensorCache.update."""
    adm = Admission()
    adm.token = token
    adm.volume_gen = volume_gen
    adm.reason = solver_unsupported_reason(pod)

    spec = pod.spec
    if spec.volumes:
        adm.has_pvc = any(v.pvc_claim_name for v in spec.volumes)
        from kubernetes_tpu_torch.plugins.volumes import classify_pod_volumes

        vol_reason, counts = classify_pod_volumes(pod, listers)
        adm.vol_counts = counts
        # the in-use accounting memo: NodeInfo.add_pod reads it when
        # this pod (or its assume clone, which copies __dict__) lands
        pod.__dict__["_volcount_memo"] = counts
        if not adm.reason and vol_reason:
            adm.reason = vol_reason

    if not adm.reason and extenders:
        if any(e.is_interested(pod) for e in extenders):
            adm.reason = "extender-interested"
    adm.device_ok = not adm.reason

    # feature bits for the dispatch-time batch aggregates
    (_m, _b, _e, _s, _c, _mm, has_aff, host_ports) = pod_hot_info(pod)
    adm.ports = bool(host_ports)
    adm.gang = bool(pod.metadata.labels.get(POD_GROUP_LABEL))
    for c in spec.topology_spread_constraints:
        if c.when_unsatisfiable == "DoNotSchedule":
            adm.hard_spread = True
        else:
            adm.score_soft = True
    if has_aff or spec.affinity is not None:
        from kubernetes_tpu_torch.ops.affinity import (
            _required_affinity,
            _required_anti_affinity,
        )
        from kubernetes_tpu_torch.ops.scoring import (
            _preferred_aff_terms,
            _preferred_anti_terms,
            _required_aff_terms,
        )

        req_aff = bool(_required_affinity(pod))
        adm.required_anti = bool(_required_anti_affinity(pod))
        adm.affinity_req = req_aff or adm.required_anti
        adm.score_pref = bool(
            _preferred_aff_terms(pod) or _preferred_anti_terms(pod)
        )
        adm.scoring_terms = adm.score_pref or bool(_required_aff_terms(pod))

    # effective priority for the streaming band (stamped ONCE at ingest
    # next to the admission memo): pods that carry only a
    # priorityClassName get the PriorityClass object's value resolved
    # here, so the queue's band check stays a memo read -- PriorityClass
    # OBJECTS, not raw integers, select the band
    if priority_resolver is not None:
        try:
            pod.__dict__["_band_priority"] = int(priority_resolver(pod))
        except Exception:  # noqa: BLE001 - band is advisory, never block
            pod.__dict__.pop("_band_priority", None)

    pod.__dict__["_admission"] = adm
    # pack-ready row record (tensors/node_tensor.py): stamped HERE, at
    # ingest, after the volume classification resolved _volcount_memo --
    # pack_pod_batch's per-cycle loop is then a pure memo gather
    stamp_pack_row(pod)
    return adm


# -- the plain-pod fast path (native ingest_stamp + this Python twin) -----
#
# A burst is overwhelmingly PLAIN pods: no volumes, no affinity, no
# spread constraints, no NUMA annotation, no gang label, no host ports,
# and a priority that needs no PriorityClass resolution. For those the
# whole classification is a constant -- so one SHARED read-only
# Admission record serves every plain pod, and the per-pod ingest work
# reduces to building the spec memos (_req_memo/_nzr_memo/_hot_memo/
# _packrow/_band_priority), which native/_hotpath.c ``ingest_stamp``
# does in one C pass. ``stamp_plain_pods`` is the differential twin
# (tests/test_native_ingest.py); non-plain pods are returned by index
# for the full ``classify_pod``. Only valid with NO extenders (an
# extender's is_interested must see every pod).

_FIXED_RESOURCE_NAMES = (
    RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_PODS,
)


def plain_admission(token: object) -> Admission:
    """The shared Admission record every plain pod points at (read-only
    by contract: ``as_host_only`` copies before mutating)."""
    adm = Admission()
    adm.token = token
    return adm


def ingest_stamp_cfg(plain_adm: Admission) -> Tuple:
    """The constant tuple native ``ingest_stamp`` takes (one build per
    scheduler): the shared record, the gate keys, the fixed resource
    names, and the non-zero defaults."""
    return (
        plain_adm, ALIGNED_ANNOTATION, POD_GROUP_LABEL,
        RESOURCE_CPU, RESOURCE_MEMORY, RESOURCE_EPHEMERAL_STORAGE,
        RESOURCE_PODS, DEFAULT_MILLI_CPU_REQUEST, DEFAULT_MEMORY_REQUEST,
    )


def _is_plain_pod(pod: Pod) -> bool:
    meta = pod.metadata
    spec = pod.spec
    if not isinstance(meta.annotations, dict) or (
        ALIGNED_ANNOTATION in meta.annotations
    ):
        return False
    if not isinstance(meta.labels, dict) or POD_GROUP_LABEL in meta.labels:
        return False
    if spec.volumes or spec.affinity is not None:
        return False
    if spec.topology_spread_constraints:
        return False
    if not isinstance(spec.priority, int):
        return False
    if not spec.priority and spec.priority_class_name:
        return False  # bare priorityClassName needs the lister resolver
    for c in spec.containers:
        for p in c.ports:
            if p.host_port:
                return False
    return True


def _stamp_plain(pod: Pod, plain_adm: Admission) -> None:
    """Build the plain pod's full ingest record (semantics mirrored
    bit-for-bit by native ``ingest_stamp``)."""
    spec = pod.spec
    req: dict = {}
    nzr_cpu = 0
    nzr_mem = 0
    for c in spec.containers:
        requests = c.resources.requests
        for name, qty in requests.items():
            if not isinstance(qty, int):
                raise TypeError("non-int resource quantity")
            req[name] = req.get(name, 0) + qty
        ccpu = requests.get(RESOURCE_CPU, 0)
        cmem = requests.get(RESOURCE_MEMORY, 0)
        nzr_cpu += ccpu if ccpu else DEFAULT_MILLI_CPU_REQUEST
        nzr_mem += cmem if cmem else DEFAULT_MEMORY_REQUEST
    for c in spec.init_containers:
        for name, qty in c.resources.requests.items():
            if not isinstance(qty, int):
                raise TypeError("non-int resource quantity")
            if qty > req.get(name, 0):
                req[name] = qty
    for name, qty in spec.overhead.items():
        if not isinstance(qty, int):
            raise TypeError("non-int resource quantity")
        req[name] = req.get(name, 0) + qty
    scalar = tuple(
        (k, v) for k, v in req.items() if k not in _FIXED_RESOURCE_NAMES
    )
    d = pod.__dict__
    d["_req_memo"] = req
    d["_nzr_memo"] = (nzr_cpu, nzr_mem)
    d["_hot_memo"] = (
        req.get(RESOURCE_CPU, 0), req.get(RESOURCE_MEMORY, 0),
        req.get(RESOURCE_EPHEMERAL_STORAGE, 0), scalar,
        nzr_cpu, nzr_mem, False, (),
    )
    d["_packrow"] = (
        (tuple(req.items()), ()), nzr_cpu, _kib_ceil(nzr_mem),
        spec.priority,
    )
    d["_band_priority"] = spec.priority
    d["_admission"] = plain_adm


def stamp_plain_pods(pods: List[Pod], plain_adm: Admission) -> List[int]:
    """Python twin of native ``ingest_stamp``: stamp every plain pod's
    ingest record, return the indices of pods that need the full
    classifier (non-plain shapes, or anything that errored -- the fast
    path never half-stamps)."""
    rest: List[int] = []
    for i, pod in enumerate(pods):
        try:
            if not _is_plain_pod(pod):
                rest.append(i)
                continue
            _stamp_plain(pod, plain_adm)
        except Exception:  # noqa: BLE001 - route to the full classifier
            rest.append(i)
    return rest
