"""NodeTensor: the ``[N, R]`` packed cluster state + incremental updates.

This lifts the reference's NodeInfo aggregates
(/root/reference/pkg/scheduler/nodeinfo/node_info.go:47: allocatable,
requestedResource, nonzeroRequest) into dense int32 device-ready arrays,
and mirrors the generation-based incremental snapshot update
(internal/cache/cache.go:203 UpdateSnapshot: only changed nodes are
copied) as an incremental row repack.

Units (chosen so int32 masks are EXACT, matching the reference's integer
quantity comparisons; see Fit semantics fit.go:181-252):
  col 0: cpu          milliCPU
  col 1: memory       KiB (allocatable floored, requests ceiled --
                      conservative: never admits a pod the byte-exact
                      check would reject)
  col 2: ephemeral    KiB (same rounding)
  col 3: pods         pod count / allowed pod number
  col 4+: extended/scalar resources, whole units, in ``ResourceDims`` order

Capacity is padded to the next multiple of 128 (TPU lane width) so the
solver JITs once per bucket, not per node-count (SURVEY.md section 7
"hardest parts (b)": pad to buckets, mask).
"""

from __future__ import annotations

import heapq
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import (
    Pod,
    RESOURCE_CPU,
    RESOURCE_EPHEMERAL_STORAGE,
    RESOURCE_MEMORY,
    RESOURCE_PODS,
    ResourceList,
    pod_resource_requests,
)
from kubernetes_tpu_torch.cache.node_info import (
    NodeInfo,
    Resource,
    non_zero_requests,
    pod_hot_info,
)
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch import native as _native
from kubernetes_tpu_torch.tensors.encoding import TopologyEncoder
from kubernetes_tpu_torch.utils import metrics as _metrics

NODE_BUCKET = 128  # row padding granularity (TPU lane width)

#: extra row slots allocated past the live node count so membership
#: churn (autoscaler adds, spot replacements) claims pre-zeroed rows
#: instead of forcing a full repack + re-upload: max(NODE_BUCKET/2,
#: n/8) before bucket rounding, so a 5k-node cluster absorbs ~600 net
#: adds and a small cluster a full bucket before the layout moves
def _row_headroom(n: int) -> int:
    return max(NODE_BUCKET // 2, n // 8)

CPU, MEM, EPH, PODS = 0, 1, 2, 3
NUM_FIXED_DIMS = 4

VALUE_FLOOR = 128


def value_capacity(n_cap: int, floor: int = VALUE_FLOOR) -> int:
    """Interned topology-value slots per key for the device count
    tensors (affinity/spread/score families): label values come from
    node labels, so hostname-keyed terms (the canonical
    spread-replicas-across-nodes workload) need as many slots as nodes.
    The cap adapts to the padded node capacity -- n_cap is already
    bucketed, so the derived shapes are re-JIT-stable per cluster."""
    return max(floor, n_cap)


def _kib_floor(b: int) -> int:
    return b // 1024


def _kib_ceil(b: int) -> int:
    return -((-b) // 1024)


class ResourceDims:
    """Resource name -> tensor column. Fixed dims 0-3; scalar/extended
    resources get columns as they first appear. Growing the dim set bumps
    ``version`` which invalidates packed tensors.

    Attachable-volume count limits (``attachable-volumes-*``, see
    cache/node_info.py) register through ``volume_column``: they share
    the scalar column space -- the fit scan already treats any scalar
    column with a zero request as "not requested" -- but are tracked
    separately so the node packer knows to fill their allocatable from
    CSINode limits / in-tree defaults and their requested from the
    node's in-use counts rather than from the Resource aggregates.

    Registration is thread-safe: the admission classifier registers
    volume columns from informer threads while the dispatcher packs."""

    def __init__(self) -> None:
        self._scalar_cols: Dict[str, int] = {}
        self._volume_names: set = set()
        self._volume_cols_cache: Optional[Dict[str, int]] = None
        self._reg_lock = threading.Lock()
        self.version = 0

    @property
    def num_dims(self) -> int:
        return NUM_FIXED_DIMS + len(self._scalar_cols)

    def scalar_names(self) -> List[str]:
        return sorted(self._scalar_cols, key=self._scalar_cols.__getitem__)

    def column(self, resource: str) -> int:
        if resource == RESOURCE_CPU:
            return CPU
        if resource == RESOURCE_MEMORY:
            return MEM
        if resource == RESOURCE_EPHEMERAL_STORAGE:
            return EPH
        if resource == RESOURCE_PODS:
            return PODS
        col = self._scalar_cols.get(resource)
        if col is None:
            with self._reg_lock:
                col = self._scalar_cols.get(resource)
                if col is None:
                    col = NUM_FIXED_DIMS + len(self._scalar_cols)
                    self._scalar_cols[resource] = col
                    self.version += 1
        return col

    def volume_column(self, resource: str) -> int:
        """Register ``resource`` as an attachable-volume count column."""
        col = self.column(resource)
        if resource not in self._volume_names:
            with self._reg_lock:
                self._volume_names.add(resource)
                self._volume_cols_cache = None
        return col

    def existing_column(self, resource: str) -> Optional[int]:
        """Column for ``resource`` without growing the schema."""
        return self._scalar_cols.get(resource)

    def volume_columns(self) -> Dict[str, int]:
        """name -> column for every registered volume-count resource
        (cached; invalidated on registration). Built under the
        registration lock so a concurrent volume_column() can never
        mutate the name set mid-iteration; the returned dict is
        replaced atomically and safe to read lock-free."""
        cache = self._volume_cols_cache
        if cache is None:
            with self._reg_lock:
                cache = {
                    name: self._scalar_cols[name]
                    for name in self._volume_names
                }
                self._volume_cols_cache = cache
        return cache

    def encode_resource(self, r: Resource, *, ceil_bytes: bool) -> np.ndarray:
        kib = _kib_ceil if ceil_bytes else _kib_floor
        row = np.zeros(self.num_dims, dtype=np.int32)
        row[CPU] = r.milli_cpu
        row[MEM] = kib(r.memory)
        row[EPH] = kib(r.ephemeral_storage)
        row[PODS] = r.allowed_pod_number
        for name, qty in r.scalar.items():
            row[self.column(name)] = qty
        return row

    def encode_requests(
        self, rl: ResourceList, *, ceil_bytes: bool = True, grow: bool = True
    ) -> Tuple[np.ndarray, bool]:
        """Returns (row, unknown): ``unknown`` is True when ``grow=False``
        and the list names a scalar resource with no column -- i.e. a
        resource no node in the cluster advertises, so the request is
        unsatisfiable by definition (fit.go: allocatable 0 < request)."""
        kib = _kib_ceil if ceil_bytes else _kib_floor
        row = np.zeros(self.num_dims, dtype=np.int32)
        unknown = False
        for name, qty in rl.items():
            if name == RESOURCE_CPU:
                row[CPU] = qty
            elif name == RESOURCE_MEMORY:
                row[MEM] = kib(qty)
            elif name == RESOURCE_EPHEMERAL_STORAGE:
                row[EPH] = kib(qty)
            elif name == RESOURCE_PODS:
                row[PODS] = qty
            elif not grow and name not in self._scalar_cols:
                if qty > 0:
                    unknown = True
            else:
                row[self.column(name)] = qty
        return row, unknown


@dataclass
class TensorDelta:
    """What one ``NodeTensorCache.update`` actually changed, so callers
    can reconcile device-resident state in O(changed rows) instead of
    re-diffing the full ``[N, R]`` arrays.

    ``epoch`` is the cache's monotonic update counter after this update;
    every row repacked here carries it in the per-row epoch array (see
    ``rows_changed_since``). ``layout_epoch`` moves only when existing
    row identity can no longer be patched row-wise -- schema growth or
    slot-capacity exhaustion (full repack). Pure membership add/remove
    claims/retires SLOTS in place: the affected rows land in
    ``membership_rows`` (and ``changed_rows``) so device-state consumers
    patch them as O(changed) scatters instead of re-uploading [N, R]."""

    epoch: int
    layout_epoch: int
    changed_rows: np.ndarray  # int64 row indices repacked by THIS update
    full: bool  # True when every row was repacked (layout moved)
    # row slots whose IDENTITY changed this update (node added into the
    # slot, or the slot's node retired): expected resets for the device
    # handshake, never divergences
    membership_rows: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=np.int64)
    )


@dataclass
class NodeTensor:
    """The packed view handed to the solver. Rows are SLOTS: a retired
    node's slot stays in place (zeroed, ``valid`` False, name ``""``)
    until a later add reclaims it, so membership churn never moves the
    surviving rows. Rows [num_nodes:] are capacity padding; both padding
    and free slots are infeasible for any non-zero request (allocatable
    all-zero) and masked off for zero-request pods by ``valid``."""

    names: List[str]  # slot -> node name; "" marks a free (retired) slot
    allocatable: np.ndarray  # [N, R] int32
    requested: np.ndarray  # [N, R] int32 (col PODS = current pod count)
    non_zero_requested: np.ndarray  # [N, 2] int32 (milliCPU, KiB)
    valid: np.ndarray  # [N] bool (occupied slots only)
    topology: np.ndarray  # [N, K] int32 interned topology values
    dims: ResourceDims
    topology_encoder: TopologyEncoder
    #: tensor row per entry of the snapshot's node_info_list: packers
    #: iterating the snapshot MUST index node-dimension tensors through
    #: this (snapshot order stopped being row order when slots arrived)
    info_rows: Optional[np.ndarray] = field(default=None, repr=False)
    _row_of: Optional[Dict[str, int]] = field(default=None, repr=False)
    delta: Optional[TensorDelta] = field(default=None, repr=False)

    @property
    def capacity(self) -> int:
        return self.allocatable.shape[0]

    @property
    def num_nodes(self) -> int:
        """Slot count (the indexable prefix of ``names``): >= the live
        node count whenever retired slots exist."""
        return len(self.names)

    def row(self, name: str) -> int:
        if self._row_of is None:
            self._row_of = {
                n: i for i, n in enumerate(self.names) if n
            }
        return self._row_of[name]

    def rows_for(self, infos: List[NodeInfo]) -> np.ndarray:
        """Tensor row per entry of ``infos`` (the snapshot's
        node_info_list, the order every packer iterates in). Packers MUST
        index node-dimension tensors through this: with the slot layout,
        snapshot position j and tensor row diverge as soon as one
        membership change lands. Falls back to the identity map for
        tensors built without a row map (direct construction in
        tests/tools, where no slots have ever moved)."""
        if self.info_rows is not None and len(self.info_rows) == len(infos):
            return self.info_rows
        return np.arange(len(infos), dtype=np.int64)


class NodeTensorCache:
    """Incremental Snapshot -> NodeTensor packer.

    Mirrors cache.UpdateSnapshot's generation compare (cache.go:239): a row
    is repacked only when its NodeInfo.generation moved. Rows are SLOTS
    with pre-allocated headroom and a free-row list: node add/remove
    claims or retires a slot in place -- O(changed rows), no layout move
    -- and a pure ordering change is a no-op. A full repack (counted,
    layout_epoch bump) happens only for resource/topology schema growth
    or when adds exhaust the slot headroom."""

    def __init__(
        self,
        dims: Optional[ResourceDims] = None,
        topology_encoder: Optional[TopologyEncoder] = None,
    ) -> None:
        self.dims = dims or ResourceDims()
        self.topology = topology_encoder or TopologyEncoder()
        self._row_of: Dict[str, int] = {}
        self._generations: List[int] = []
        self._names: List[str] = []  # slot -> name, "" = free slot
        self._free_rows: List[int] = []  # min-heap of retired slots
        self._node_count = 0
        self._alloc = np.zeros((0, self.dims.num_dims), dtype=np.int32)
        self._req = np.zeros((0, self.dims.num_dims), dtype=np.int32)
        self._nzr = np.zeros((0, 2), dtype=np.int32)
        self._topo = np.zeros((0, 0), dtype=np.int32)
        self._occupied = np.zeros(0, dtype=bool)
        self._dims_version = self.dims.version
        self._topo_version = self.topology.version
        self.full_repacks = 0
        self.rows_repacked = 0
        self.rows_added = 0  # slots claimed by incremental node adds
        self.rows_retired = 0  # slots freed by incremental node removals
        self.reorders = 0  # ordering-only snapshot changes (zero work now)
        # monotonic update epoch: every repacked row is stamped with the
        # epoch of the update that repacked it, so device-state consumers
        # reconcile via rows_changed_since(epoch) instead of re-diffing;
        # membership (identity) changes additionally stamp the member
        # epoch so the handshake can tell expected slot resets apart
        # from divergences
        self._epoch = 0
        self._layout_epoch = 0
        self._row_epoch = np.zeros(0, dtype=np.int64)
        self._row_member_epoch = np.zeros(0, dtype=np.int64)
        # snapshot-position -> tensor row map handed to the packers via
        # NodeTensor.info_rows; rebuilt only when membership/order moved
        self._info_rows: Optional[np.ndarray] = None
        # change-tracking baseline: the snapshot whose change log we
        # follow and our private read cursor into it (O(changed) update
        # fast path; reads are cursor-based and never mutate the log, so
        # sibling caches sharing the snapshot cannot steal our notes)
        self._last_snapshot = None
        self._change_cursor = 0

    # -- packing one node ---------------------------------------------------

    def _pack_row(self, i: int, ni: NodeInfo) -> None:
        self._alloc[i] = self.dims.encode_resource(ni.allocatable, ceil_bytes=False)
        req = self.dims.encode_resource(ni.requested, ceil_bytes=True)
        req[PODS] = len(ni.pods)
        vol_cols = self.dims.volume_columns()
        if vol_cols:
            # attachable-volume columns: allocatable = CSINode limit /
            # in-tree default / unlimited; requested = additive in-use
            # count from resident pods (cache/node_info.py). Volume-free
            # pods skip these dims in the fit scan (zero request).
            viu = ni.volume_in_use
            alloc_row = self._alloc[i]
            for name, col in vol_cols.items():
                alloc_row[col] = ni.volume_limit(name)
                req[col] = viu.get(name, 0)
        self._req[i] = req
        self._nzr[i, 0] = ni.non_zero_requested.milli_cpu
        self._nzr[i, 1] = _kib_ceil(ni.non_zero_requested.memory)
        if self.topology.keys:
            self._topo[i] = self.topology.encode_node_labels(
                ni.node.metadata.labels if ni.node else {}
            )
        self._generations[i] = ni.generation
        self._occupied[i] = True
        self._row_epoch[i] = self._epoch

    def _grow(self, n: int) -> None:
        target = max(n + _row_headroom(n), NODE_BUCKET)
        cap = NODE_BUCKET * math.ceil(target / NODE_BUCKET)
        r = self.dims.num_dims
        k = len(self.topology.keys)
        self._alloc = np.zeros((cap, r), dtype=np.int32)
        self._req = np.zeros((cap, r), dtype=np.int32)
        self._nzr = np.zeros((cap, 2), dtype=np.int32)
        self._topo = np.zeros((cap, k), dtype=np.int32)
        self._occupied = np.zeros(cap, dtype=bool)
        self._row_epoch = np.zeros(cap, dtype=np.int64)
        self._row_member_epoch = np.zeros(cap, dtype=np.int64)

    # -- slot lifecycle (incremental membership) -----------------------------

    def _retire_row(self, i: int) -> None:
        """Free an occupied slot in place: zero its content (free slots
        must be infeasible exactly like capacity padding), stamp both
        epochs, and put it on the free list for the next add."""
        self._alloc[i] = 0
        self._req[i] = 0
        self._nzr[i] = 0
        if self._topo.shape[1]:
            self._topo[i] = 0
        self._generations[i] = 0
        self._occupied[i] = False
        self._row_epoch[i] = self._epoch
        self._row_member_epoch[i] = self._epoch
        heapq.heappush(self._free_rows, i)
        self.rows_retired += 1
        _metrics.tensor_rows_retired.inc()

    def _claim_row(self) -> Optional[int]:
        """A slot for a new node: lowest free slot first, else the next
        never-used slot inside the allocated capacity. None = headroom
        exhausted (caller must full-repack with fresh headroom)."""
        if self._free_rows:
            return heapq.heappop(self._free_rows)
        i = len(self._names)
        if i >= self._alloc.shape[0]:
            return None
        self._names.append("")
        self._generations.append(0)
        return i

    # -- epoch handshake support --------------------------------------------

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def layout_epoch(self) -> int:
        return self._layout_epoch

    def rows_changed_since(self, epoch: int) -> np.ndarray:
        """Row indices repacked since ``epoch`` (an ``update()``'s
        ``delta.epoch``), valid while ``layout_epoch`` is unchanged. An
        O(N) int compare -- never O(N*R) content work."""
        return np.flatnonzero(self._row_epoch[: len(self._names)] > epoch)

    def membership_rows_since(self, epoch: int) -> np.ndarray:
        """Row slots whose IDENTITY changed since ``epoch`` (a node was
        added into the slot or retired from it), valid while
        ``layout_epoch`` is unchanged. These are EXPECTED resets for the
        device-state handshake: their host content legitimately differs
        from the mirrored expectation and must be scatter-adopted, not
        counted as divergence. Same O(N) int compare as
        ``rows_changed_since``."""
        return np.flatnonzero(
            self._row_member_epoch[: len(self._names)] > epoch
        )

    def _register_columns(self, ni: NodeInfo) -> None:
        dims = self.dims
        for name in ni.allocatable.scalar:
            dims.column(name)
        for name in ni.requested.scalar:
            dims.column(name)
        for name in ni.csi_volume_limits:
            dims.volume_column(name)
        for name in ni.volume_in_use:
            dims.volume_column(name)

    def _build_tensor(self, delta: TensorDelta) -> NodeTensor:
        return NodeTensor(
            names=self._names,
            allocatable=self._alloc,
            requested=self._req,
            non_zero_requested=self._nzr,
            valid=self._occupied.copy(),
            topology=self._topo,
            dims=self.dims,
            topology_encoder=self.topology,
            info_rows=self._info_rows,
            delta=delta,
        )

    def _refresh_info_rows(self, infos: List[NodeInfo]) -> None:
        row_of = self._row_of
        self._info_rows = np.fromiter(
            (row_of[ni.node_name] for ni in infos),
            dtype=np.int64,
            count=len(infos),
        )

    # -- the update entry point --------------------------------------------

    def update(self, snapshot: Snapshot) -> NodeTensor:
        """Repack changed rows and return the tensor view plus a
        ``TensorDelta`` (``nt.delta``) naming exactly the rows this call
        repacked, so device-state consumers reconcile in O(changed rows).

        When the snapshot carries accumulated change notes (the
        scheduler's own snapshot, refreshed by ``cache.update_snapshot``),
        the update itself is O(changed): only the noted NodeInfos get the
        generation compare. Membership changes take an O(N) set diff and
        touch only the affected slots (retire into the free list / claim
        a free or headroom slot). Foreign snapshots (tests, tools) take
        the full generation walk -- same result, O(N) int compares."""
        self._epoch += 1
        tracked = None
        membership_hint = True
        if snapshot is self._last_snapshot:
            tracked, membership_hint, self._change_cursor = (
                snapshot.changes_since(self._change_cursor)
            )
        else:
            # new snapshot object: establish our cursor baseline and
            # take the full walk once (no ordering signal to count)
            self._last_snapshot = snapshot
            self._change_cursor = snapshot.change_cursor()
            membership_hint = False
        if (
            tracked is not None
            and not membership_hint
            and self._names
            and self._node_count == len(snapshot.node_info_list)
        ):
            nt = self._update_tracked(snapshot, tracked)
            if nt is not None:
                return nt
            tracked = None  # notes insufficient: full generation walk
        elif not membership_hint:
            tracked = None
        return self._update_full(snapshot, tracked, membership_hint)

    def _update_tracked(
        self, snapshot: Snapshot, tracked
    ) -> Optional[NodeTensor]:
        """O(changed) fast path: only the snapshot-noted NodeInfos are
        compared/repacked. Returns None when the notes turn out to need
        the full walk (unknown name, node-object transition, schema or
        topology growth)."""
        changed_infos = []
        row_of = self._row_of
        info_map = snapshot.node_info_map
        for name in tracked:
            i = row_of.get(name)
            ni = info_map.get(name)
            if i is None or ni is None or ni.node is None:
                return None  # membership drift the hint missed
            changed_infos.append((i, ni))
        for _i, ni in changed_infos:
            self._register_columns(ni)
        if (
            self.dims.version != self._dims_version
            or self.topology.version != self._topo_version
        ):
            return None  # schema grew: full repack
        changed_rows = []
        for i, ni in changed_infos:
            if self._generations[i] != ni.generation:
                self._pack_row(i, ni)
                self.rows_repacked += 1
                changed_rows.append(i)
        changed_rows.sort()
        return self._build_tensor(
            TensorDelta(
                epoch=self._epoch,
                layout_epoch=self._layout_epoch,
                changed_rows=np.asarray(changed_rows, dtype=np.int64),
                full=False,
            ),
        )

    def _update_full(
        self, snapshot: Snapshot, tracked=None, membership_hint=True
    ) -> NodeTensor:
        """Membership diff + generation compare. ``tracked`` (when the
        change log survived) limits the generation compare to the noted
        names; None means compare every row."""
        infos = snapshot.list_node_infos()
        info_map = snapshot.node_info_map
        # Register scalar-resource columns BEFORE sizing arrays: packing a
        # row must never grow the schema mid-update.
        if tracked is None:
            for ni in infos:
                self._register_columns(ni)
        else:
            for name in tracked:
                ni = info_map.get(name)
                if ni is not None and ni.node is not None:
                    self._register_columns(ni)
        schema_moved = (
            self.dims.version != self._dims_version
            or self.topology.version != self._topo_version
        )
        names_now = [ni.node_name for ni in infos]
        current = set(names_now)
        removed = [n for n in self._row_of if n not in current]
        added = [n for n in names_now if n not in self._row_of]
        slots_available = (
            len(self._free_rows)
            + len(removed)
            + (self._alloc.shape[0] - len(self._names))
        )
        if schema_moved or len(added) > slots_available:
            # full repack: schema grew, or adds exhausted the slot
            # headroom -- counted, layout moves, fresh headroom
            self._names = list(names_now)
            self._row_of = {n: i for i, n in enumerate(names_now)}
            self._generations = [0] * len(infos)
            self._free_rows = []
            self._node_count = len(infos)
            self._grow(len(infos))
            for i, ni in enumerate(infos):
                self._pack_row(i, ni)
            self.full_repacks += 1
            _metrics.tensor_full_repacks.inc()
            self.rows_repacked += len(infos)
            self._layout_epoch += 1
            self._row_member_epoch[:] = self._epoch
            self._refresh_info_rows(infos)
            self._dims_version = self.dims.version
            self._topo_version = self.topology.version
            return self._build_tensor(
                TensorDelta(
                    epoch=self._epoch,
                    layout_epoch=self._layout_epoch,
                    changed_rows=np.arange(len(infos), dtype=np.int64),
                    full=True,
                ),
            )
        member_rows: List[int] = []
        if removed or added:
            # copy-on-write: NodeTensors captured by in-flight batches
            # keep resolving assignment indices against the layout they
            # were dispatched with
            self._names = list(self._names)
            for n in removed:
                i = self._row_of.pop(n)
                self._names[i] = ""
                self._retire_row(i)
                member_rows.append(i)
            for n in added:
                i = self._claim_row()
                self._row_of[n] = i
                self._names[i] = n
                self._pack_row(i, info_map[n])
                self._row_member_epoch[i] = self._epoch
                self.rows_added += 1
                _metrics.tensor_rows_added.inc()
                self.rows_repacked += 1
                member_rows.append(i)
            self._node_count = len(infos)
        elif membership_hint and self._info_rows is not None:
            # ordering-only change: slots do not move, nothing repacks
            self.reorders += 1
        # snapshot positions may have shifted even without add/remove
        # (ordering change) -- refresh the packers' position->row map on
        # any full-path update (it is O(N) dict gets, and this path
        # already walked the list)
        self._refresh_info_rows(infos)
        changed: List[int] = []
        row_of = self._row_of
        if tracked is None:
            for ni in infos:
                i = row_of[ni.node_name]
                if self._generations[i] != ni.generation:
                    self._pack_row(i, ni)
                    self.rows_repacked += 1
                    changed.append(i)
        else:
            for name in tracked:
                ni = info_map.get(name)
                i = row_of.get(name)
                if ni is None or ni.node is None or i is None:
                    continue  # removed this update: already retired
                if self._generations[i] != ni.generation:
                    self._pack_row(i, ni)
                    self.rows_repacked += 1
                    changed.append(i)
        changed_rows = np.asarray(
            sorted(changed + member_rows), dtype=np.int64
        )
        self._dims_version = self.dims.version
        self._topo_version = self.topology.version
        return self._build_tensor(
            TensorDelta(
                epoch=self._epoch,
                layout_epoch=self._layout_epoch,
                changed_rows=changed_rows,
                full=False,
                membership_rows=np.asarray(
                    sorted(member_rows), dtype=np.int64
                ),
            ),
        )


@dataclass
class PodBatch:
    """A batch of pending pods packed for the solver."""

    pods: List[Pod]
    requests: np.ndarray  # [B, R] int32 (col PODS == 1)
    non_zero_requests: np.ndarray  # [B, 2] int32
    priorities: np.ndarray  # [B] int32
    order: np.ndarray  # [B] int32: solve order (priority desc, FIFO)
    unsatisfiable: np.ndarray  # [B] bool: requests a resource no node has

    @property
    def size(self) -> int:
        return len(self.pods)


def stamp_pack_row(pod: Pod) -> Tuple:
    """Build (and memoize as ``pod._packrow``) the pod's pack-ready row
    record: ``((request_items, vol_counts), nzr_cpu, nzr_mem_kib,
    priority)``. Stamped at informer ingest by the admission classifier
    (scheduler/admission.py -- natively for plain pods via
    ``ingest_stamp``), invalidated by the same paths that strip the
    other spec memos (apiserver ``_ALL_MEMOS``), so ``pack_pod_batch``
    and ``pack_preemption_state`` gather memoized rows instead of
    re-walking specs per pod per cycle. Also primes ``pod_hot_info`` so
    the commit path's clones carry the accounting memo -- ``_packrow``
    present implies ``_hot_memo`` present."""
    req = pod_resource_requests(pod)
    pod_hot_info(pod)
    # resolved attachable-volume counts (admission classifier memo):
    # they ride the request row as volume columns so the fit scan
    # enforces per-node attach limits
    vc = tuple(pod.__dict__.get("_volcount_memo") or ())
    cpu, mem = non_zero_requests(pod)
    memo = (
        (tuple(req.items()), vc), cpu, _kib_ceil(mem), pod.spec.priority,
    )
    pod.__dict__["_packrow"] = memo
    return memo


def _pack_gather_py(
    pods: List[Pod], stamp, row_cache: Dict, idx, nzr, prio,
) -> List[Tuple]:
    """Pure-Python twin of native ``pack_gather`` (identical semantics;
    tests/test_native_ingest.py fuzzes the two): gather each pod's
    ``_packrow`` memo (stamping on miss) into the preallocated int32
    buffers, dedup request keys through ``row_cache``, return the
    distinct keys first seen this call in order."""
    new_keys: List[Tuple] = []
    for i, pod in enumerate(pods):
        memo = pod.__dict__.get("_packrow")
        if memo is None:
            memo = stamp(pod)
        key = memo[0]
        u = row_cache.get(key)
        if u is None:
            u = len(row_cache)
            row_cache[key] = u
            new_keys.append(key)
        idx[i] = u
        nzr[i, 0] = memo[1]
        nzr[i, 1] = memo[2]
        prio[i] = memo[3]
    return new_keys


def pack_pod_batch(
    pods: List[Pod],
    dims: ResourceDims,
    timestamps: Optional[List[float]] = None,
) -> PodBatch:
    """Pack pending pods into a batch. Solve order matches the activeQ
    comparator (queuesort/priority_sort.go: priority desc, then enqueue
    time) so batched greedy assignment replays the sequential order.

    The per-pod spec walk lives at INGEST now (``stamp_pack_row``, run
    by the admission classifier when the pod enters the queue): the
    per-cycle work here is one gather over the ``_packrow`` memos into
    preallocated ``[B]``/``[B, 2]`` buffers -- a single C pass when the
    native ingest plane is available -- plus one schema encode per
    DISTINCT request row (a burst is overwhelmingly homogeneous).

    The schema is frozen here (``grow=False``): a pod requesting a scalar
    resource no node advertises is flagged ``unsatisfiable`` instead of
    growing the dim set mid-batch (which would shape-mismatch the
    already-packed node tensor)."""
    b = len(pods)
    if b == 0:  # empty batch: preserve the [0, R] contract
        return PodBatch(
            pods=[],
            requests=np.zeros((0, dims.num_dims), dtype=np.int32),
            non_zero_requests=np.zeros((0, 2), dtype=np.int32),
            priorities=np.zeros(0, dtype=np.int32),
            order=np.arange(0, dtype=np.int32),
            unsatisfiable=np.zeros(0, dtype=bool),
        )
    row_cache: Dict[Tuple, int] = {}
    idx = np.empty(b, dtype=np.int32)
    nzr = np.empty((b, 2), dtype=np.int32)
    prio = np.empty(b, dtype=np.int32)
    pods_l = pods if isinstance(pods, list) else list(pods)
    gather, expected = _native.ingest_fn("pack_gather")
    if gather is not None:
        new_keys = gather(pods_l, stamp_pack_row, row_cache, idx, nzr, prio)
    else:
        if expected:
            _metrics.ingest_native_fallbacks.inc(site="pack-gather")
        new_keys = _pack_gather_py(
            pods_l, stamp_pack_row, row_cache, idx, nzr, prio
        )
    # encode each DISTINCT request row once and gather vectorized
    uniq_rows: List[np.ndarray] = []
    uniq_unknown: List[bool] = []
    for req_items, vc in new_keys:
        row, unknown = dims.encode_requests(dict(req_items), grow=False)
        row[PODS] = 1
        for name, qty in vc:
            col = dims.existing_column(name)
            if col is not None:
                # unregistered names (a nominee classified by an older
                # scheduler instance) are skipped: the overlay
                # under-reserves rather than shape-mismatching
                row[col] += qty
        uniq_rows.append(row)
        uniq_unknown.append(unknown)
    requests = np.stack(uniq_rows)[idx]
    unsatisfiable = np.asarray(uniq_unknown, dtype=bool)[idx]
    ts = timestamps or [pod.metadata.creation_timestamp for pod in pods_l]
    # pop_batch already drains the activeQ in comparator order (priority
    # desc, enqueue time asc) -- detect the sorted common case and skip
    # the Python sort (vectorized: the old per-pod generator was O(B)
    # interpreter work per pack)
    ts_arr = np.asarray(ts, dtype=np.float64)
    if b <= 1 or bool(
        np.all(
            (prio[:-1] > prio[1:])
            | ((prio[:-1] == prio[1:]) & (ts_arr[:-1] <= ts_arr[1:]))
        )
    ):
        order = np.arange(b, dtype=np.int32)
    else:
        order = np.array(
            sorted(range(b), key=lambda i: (-int(prio[i]), ts[i])),
            dtype=np.int32,
        )
    return PodBatch(
        pods=list(pods_l),
        requests=requests,
        non_zero_requests=nzr,
        priorities=prio,
        order=order,
        unsatisfiable=unsatisfiable,
    )
