"""BatchScheduler: the device fast path -- drain the activeQ as a batch
and solve placement on the card.

This is the north-star replacement for the reference's serialized
scheduleOne loop (/root/reference/pkg/scheduler/scheduler.go:548): the
activeQ drain becomes the batch (SURVEY.md section 2.1 "TPU equivalent"),
the NodeInfo snapshot becomes an incrementally-updated NodeTensor, the
Filter/Score plugins become the device mask/score matrices + host static
mask, and selectHost becomes the argmax inside the assignment scan.

The scheduling-framework contract stays intact: Reserve, Permit
(gang-scheduling hook), PreBind, Bind and the failure/Unreserve paths run
through the same Framework pipeline per pod (finish_schedule). Required
(anti-)affinity, topology spread, the full default score family
(including preferred inter-pod affinity), host ports (static mask for
existing pods + synthetic anti rows for within-batch conflicts), gang
quorum masks, and batched preemption all solve on device; the few
remaining shapes the solver doesn't model (volume-bound pods,
spread+nodeSelector eligibility coupling -- see solver_supported) fall
back to the sequential oracle path (attempt_schedule), exactly like the
reference runs unsupported pods through extenders.

In this port each solve is ONE hand-written CUDA kernel on torch
tensors resident on the card: the greedy solve (ops/greedy_kernel.py)
and, for a batch with spread, affinity, host-port or score-dynamic
families, the constrained solve (ops/constrained_kernel.py). In the
sinkhorn mode an unconstrained batch computes its entropic-OT prior as
torch ops and commits through the greedy kernel's scored entry. On a
node-sharded mesh (``mesh=``, ops/mesh.py) the resident state lives
sharded and a greedy batch solves through K4, the mesh kernel
(ops/shard_kernel.py): one launch per batch when one device holds every
shard, one launch per pod step per device otherwise.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Binding, POD_GROUP_LABEL, Pod
from kubernetes_tpu_torch.apiserver.server import Conflict as ApiConflict
from kubernetes_tpu_torch.cache.node_info import pod_host_ports
from kubernetes_tpu_torch.scheduler.admission import (
    Admission,
    classify_pod as _classify_pod,
    solver_unsupported_reason,
)
from kubernetes_tpu_torch.framework.interface import (
    CycleState,
    FitError,
    PodInfo,
    Status,
)
from kubernetes_tpu_torch.device import synchronize
from kubernetes_tpu_torch.ops.assignment import (
    ConstPiece,
    GreedyConfig,
    NO_NODE,
    apply_assignment_delta,
    compress_carry,
    decompress_carry,
    solve_packed,
)
from kubernetes_tpu_torch.ops.affinity import (
    add_host_port_rows,
    cluster_has_required_anti_affinity,
    noop_affinity_tensors,
    pack_affinity_batch,
    pad_affinity_tensors,
)
from kubernetes_tpu_torch.ops.host_masks import (
    mask_rows_upload,
    static_mask_compact,
)
from kubernetes_tpu_torch.ops.mesh import ShardedRows, solve_device
from kubernetes_tpu_torch.ops.scoring import (
    ScoreEnvelopeExceeded,
    batch_selector_spread_live,
    cluster_has_affinity_scoring,
    noop_score_tensors,
    pack_score_batch,
    pad_score_tensors,
)
from kubernetes_tpu_torch.ops.topology import (
    noop_spread_tensors,
    pack_spread_batch,
    pad_spread_tensors,
)
from kubernetes_tpu_torch.queue import events as queue_events
from kubernetes_tpu_torch.robustness.circuit import SolveTimeout
from kubernetes_tpu_torch.robustness.containment import (
    ContainmentConfig,
    QuarantineManager,
)
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjected,
    FaultPoint,
    PoisonError,
    SchedulerCrashed,
    get_injector,
    pod_is_poisoned,
    poison_stamp_maybe,
)
from kubernetes_tpu_torch.robustness.ladder import (
    CARD_TIERS,
    DEVICE_TIERS,
    CardFault,
    LadderExhausted,
    RobustnessConfig,
    SolverLadder,
    TIER_CUDA,
    TIER_HOST_GREEDY,
    TIER_SEQUENTIAL,
    TIER_TORCH,
    host_greedy_assign,
)
from kubernetes_tpu_torch.scheduler.generic import SNAPSHOT_STATE_KEY
from kubernetes_tpu_torch.scheduler.scheduler import Scheduler
from kubernetes_tpu_torch.tensors import NodeTensorCache, pack_pod_batch
from kubernetes_tpu_torch.utils import flightrecorder
from kubernetes_tpu_torch.utils import metrics

try:
    from kubernetes_tpu_torch.native import assume_clones as _assume_clones
    from kubernetes_tpu_torch.native import commit_gather as _commit_gather
except Exception:  # noqa: BLE001 - pure-Python fallback
    _assume_clones = None
    _commit_gather = None


def _commit_gather_py(solver_infos, order, assigns, names):
    """Pure-Python fallback for native commit_gather: gather the placed
    slots' PodInfos, build their assumed clones with spec.node_name set,
    and resolve host names, in one pass (identical semantics to the C
    loop; differentially tested in tests/test_native_commit.py)."""
    pis, clones, hosts = [], [], []
    for oi, ci in zip(order, assigns):
        pi = solver_infos[oi]
        host = names[ci]
        assumed = pi.pod.assumed_clone()
        assumed.spec.node_name = host
        pis.append(pi)
        clones.append(assumed)
        hosts.append(host)
    return pis, clones, hosts


def _mirror_scatter_py(assignments, b, req, nzr, req_shadow, nzr_shadow):
    """Pure-Python twin of native mirror_scatter: compact the batch's
    placed rows and scatter-add them into the shadow expectation.
    Returns (rows [K] int64, req_rows [K, R], nzr_rows [K, 2]) or None
    when nothing placed -- identical semantics to the C loop
    (differentially tested in tests/test_native_mirror.py)."""
    placed = assignments[:b] != NO_NODE
    if not placed.any():
        return None
    rows_placed = assignments[:b][placed].astype(np.int64)
    req_rows = req[:b][placed]
    nzr_rows = nzr[:b][placed]
    np.add.at(req_shadow, rows_placed, req_rows)
    np.add.at(nzr_shadow, rows_placed, nzr_rows)
    return rows_placed, req_rows, nzr_rows


def _mirror_scatter(assignments, b, req, nzr, req_shadow, nzr_shadow):
    """The bind-echo -> shadow-mirror hot loop: one C pass
    (native/_hotpath.c mirror_scatter) over the batch's assignments
    compacts the placed rows AND applies the scatter-add, replacing
    three fancy-index materializations plus two np.add.at passes per
    batch on the committer thread. The C side validates every index
    BEFORE mutating, so a native failure can always fall back to the
    twin without double-applying."""
    from kubernetes_tpu_torch import native as _native

    fn, expected = _native.ingest_fn("mirror_scatter")
    if fn is not None:
        try:
            a = np.ascontiguousarray(assignments[:b], dtype=np.int32)
            req_b = np.ascontiguousarray(req[:b], dtype=np.int32)
            nzr_b = np.ascontiguousarray(nzr[:b], dtype=np.int32)
            rows_out = np.empty(b, dtype=np.int64)
            req_out = np.empty((b, req_b.shape[1]), dtype=np.int32)
            nzr_out = np.empty((b, 2), dtype=np.int32)
            k = fn(
                a, req_b, nzr_b, req_shadow, nzr_shadow,
                rows_out, req_out, nzr_out,
            )
            if k == 0:
                return None
            return rows_out[:k], req_out[:k], nzr_out[:k]
        except Exception:
            logger.exception("native mirror_scatter failed")
            metrics.ingest_native_fallbacks.inc(site="mirror-scatter")
    elif expected:
        metrics.ingest_native_fallbacks.inc(site="mirror-scatter")
    return _mirror_scatter_py(
        assignments, b, req, nzr, req_shadow, nzr_shadow
    )


class DeviceLostInFlight(RuntimeError):
    """A batch was in flight when an injected device loss dropped every
    resident buffer: its result is void and its pods requeue. A
    simulated fault, so it never stops the scheduler on the card."""


def _bump_carry_row(carry, row: int):
    """An injected corruption of one carry row: column 0 of ``row``
    bumped, on a copy (the resident tensor may still feed a queued
    solve); of a sharded carry only the shard holding the row is
    copied."""
    bump = 1 << 20 if carry.dtype == torch.int32 else 1 << 12
    if isinstance(carry, ShardedRows):
        k, local = carry.locate(row)
        shards = list(carry.shards)
        shards[k] = shards[k].clone()
        shards[k][local, 0] += bump
        return ShardedRows(carry.mesh, shards)
    corrupted = carry.clone()
    corrupted[row, 0] += bump
    return corrupted


def _to_host(arr) -> np.ndarray:
    """A solver output as numpy: a device tensor (or a sharded one,
    gathered) is copied to the host (blocking until the solve that
    produces it has run); host tiers already hand back numpy."""
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    if isinstance(arr, ShardedRows):
        return arr.numpy()
    return np.asarray(arr)


class _EagerDownload:
    """Device->host result copy started at DISPATCH time on its own
    daemon thread, so the transfer (and the numpy conversion) rides
    concurrently with the next batch's pop/pack instead of serializing
    inside the committer. ``result()`` blocks until the copy lands; the
    committer calls it under the same wall-clock watchdog that guarded
    the old in-committer ``np.asarray`` (a wedged serving link still
    times out and trips the breaker)."""

    __slots__ = ("_done", "_value", "_error")

    def __init__(self, dev) -> None:
        self._done = threading.Event()
        self._value = None
        self._error: Optional[BaseException] = None
        threading.Thread(
            target=self._run, args=(dev,), name="solve-download",
            daemon=True,
        ).start()

    def _run(self, dev) -> None:
        try:
            self._value = _to_host(dev)
        except BaseException as e:  # noqa: BLE001 - re-raised in result()
            self._error = e
        finally:
            self._done.set()

    def result(self):
        self._done.wait()
        if self._error is not None:
            raise self._error
        return self._value

logger = logging.getLogger(__name__)


class _JitCacheWatch:
    """Runtime kernel-build watchdog: diff the solver kernels' build
    counts (ops/assignment.kernel_build_counts) after each solve. Every
    growth books ``scheduler_tpu_jit_compiles_total{signature}``; growth
    after ``seal()`` (end of warmup) is a MID-RUN build and additionally
    fires a flight-recorder mark + warning. O(families) reads per
    batch."""

    __slots__ = ("_last", "_sealed")

    def __init__(self) -> None:
        self._last: dict = {}
        self._sealed = False

    def seal(self) -> None:
        """Warmup is done: from here, cache growth is unplanned."""
        self.refresh()
        self._sealed = True

    def refresh(self) -> None:
        from kubernetes_tpu_torch.ops.assignment import kernel_build_counts

        try:
            sizes = kernel_build_counts()
        except Exception:  # pragma: no cover - probe must never break solves
            return
        for sig, n in sizes.items():
            prev = self._last.get(sig, 0)
            if n > prev:
                metrics.jit_compiles.inc(n - prev, signature=sig)
                if self._sealed:
                    flightrecorder.mark(
                        "jit_recompile", signature=sig, cache_size=n,
                        compiles=n - prev,
                    )
                    logger.warning(
                        "mid-run kernel build: %s count grew %d -> %d",
                        sig, prev, n,
                    )
            self._last[sig] = n


POD_BUCKET = 64  # batch padded to a multiple of this to bound shapes
MASK_ROW_BUCKET = 8  # dedup static-mask rows padded to a multiple of this
#: solver batches in flight between dispatcher and committer. With the
#: result download riding its own thread from dispatch time
#: (_EagerDownload) extra slots keep the committer fed instead of idling
#: on the serving-link round trip -- but only when the host has cores to
#: run them: on a 2-core box a deeper pipeline steals GIL time from the
#: committer (measured ~10% slower at 4 in flight there), so the depth
#: scales with the host instead of being raised unconditionally.
MAX_INFLIGHT = max(3, min(6, (os.cpu_count() or 4) // 2))
#: eager result downloads need a core to run on; see _eager_download
_EAGER_DOWNLOAD_OK = (os.cpu_count() or 4) >= 4


def solver_supported(pod: Pod) -> bool:
    """Constraints the device solver models today. Anything else falls
    back to the sequential path (still fully correct, just not batched).

    Hard spread solves on device via the group-count scan
    (ops/topology.py), REQUIRED pod (anti-)affinity via the count-tensor
    replay (ops/affinity.py), preferred terms ride the ipa_* score
    family, host ports ride the static mask + synthetic anti rows, and
    attachable-volume COUNT limits ride the ``[N, R]`` volume columns
    (tensors/node_tensor.py) -- so the remaining host-only shapes are
    NUMA-aligned pods, soft spread with node scoping, and direct
    conflict-bearing volume sources. The per-shape reason strings (and
    the lister-dependent volume half of the decision) live in
    scheduler/admission.py, which computes the full classification once
    at informer ingest."""
    return not solver_unsupported_reason(pod)


#: padded row count of the (indices, rows) delta-scatter slot riding the
#: steady-state upload buffer: one fixed bucket keeps the steady solve at
#: ONE buffer layout regardless of churn; more than this many changed
#: rows per dispatch escalates to a (counted) full upload
DELTA_ROW_BUCKET = 64
#: per-batch expected-delta ring bound: the host can trail the device by
#: at most the in-flight batches plus the mirror/assume window. Overflow
#: drops the oldest delta, which at worst turns a later handshake into a
#: counted divergence (full upload) -- never a silent mismatch.
_SHADOW_RING_CAP = MAX_INFLIGHT + 2


#: int16 engage ceiling for the compressed carry: resident max + batch
#: load + in-flight load must stay under this (a guard band below 32767
#: absorbs row patches that land between the gate read and the solve)
_CARRY_COMPRESS_CEILING = 24576


def _batch_load16(req, nzr, b) -> int:
    """Worst-case per-column load this batch can add to any node row
    (every pod landing on one node): the range gate's per-dispatch
    term."""
    if not b:
        return 0
    return max(
        int(req[:b].sum(axis=0, dtype=np.int64).max(initial=0)),
        int(nzr[:b].sum(axis=0, dtype=np.int64).max(initial=0)),
    )


def _delta_slot_pieces(
    n_cap, r_dims, fix_rows=None, alloc_rows=None,
    node_requested=None, node_nzr=None, allocatable=None, valid=None,
    compress=False,
):
    """The fixed `DELTA_ROW_BUCKET`-sized (indices, rows) scatter slots
    every steady-state dispatch carries in the single upload buffer.
    Shapes/dtypes/padding here ARE the steady buffer layout the warmup
    runs -- the dispatch path and the warmup must build them through
    this one helper or they fork a second layout the warmup never ran.
    Empty slots carry index ``n_cap`` (out of bounds) and drop on
    device.

    ``svalid`` rides with the alloc scatter: membership churn retires /
    claims row slots in place, so the patched rows must also flip the
    device-resident valid mask (a retired slot with alloc zeroed is
    still choosable by a zero-request pod unless valid drops).

    ``compress`` ships the req/nzr delta rows packed int16 (the 'h'
    layout kind) -- only the dispatch gate engages it, and only when
    the row content is provably in range; the index/alloc slots stay
    int32 (allocatable KiB routinely exceeds int16)."""
    row_dt = np.int16 if compress else np.int32
    didx = np.full(DELTA_ROW_BUCKET, n_cap, dtype=np.int32)
    dreq = np.zeros((DELTA_ROW_BUCKET, r_dims), dtype=row_dt)
    dnzr = np.zeros((DELTA_ROW_BUCKET, 2), dtype=row_dt)
    sidx = np.full(DELTA_ROW_BUCKET, n_cap, dtype=np.int32)
    salloc = np.zeros((DELTA_ROW_BUCKET, r_dims), dtype=np.int32)
    svalid = np.zeros(DELTA_ROW_BUCKET, dtype=np.int32)
    if fix_rows is not None and fix_rows.size:
        didx[: fix_rows.size] = fix_rows
        dreq[: fix_rows.size] = node_requested[fix_rows]
        dnzr[: fix_rows.size] = node_nzr[fix_rows]
    if alloc_rows is not None and alloc_rows.size:
        sidx[: alloc_rows.size] = alloc_rows
        salloc[: alloc_rows.size] = allocatable[alloc_rows]
        svalid[: alloc_rows.size] = valid[alloc_rows]
    return [
        ("didx", didx), ("dreq", dreq), ("dnzr", dnzr),
        ("sidx", sidx), ("salloc", salloc), ("svalid", svalid),
    ]


def _garbage(head: np.ndarray, names) -> bool:
    """A downloaded assignment naming a node index out of range."""
    return bool(head.size) and bool(
        (head < NO_NODE).any() or (head >= len(names)).any()
    )


def _audit_checksum_host(arr: np.ndarray) -> Tuple[int, int]:
    """Order-independent wrapping checksum pair (plain sum + row-weighted
    sum, both mod 2^32) of a host array. Must match
    ``_audit_checksum_dev`` bit-for-bit: both sides compute in int32
    with C wrap semantics, and wrapped +/* form a ring, so reduction
    order never matters."""
    a = np.asarray(arr)
    if a.dtype != np.int32:
        a = a.astype(np.int32)
    if a.ndim == 1:
        a = a[:, None]
    w = (np.arange(a.shape[0], dtype=np.int32) + 1)[:, None]
    s = int(a.sum(dtype=np.int32))
    ws = int((a * w).sum(dtype=np.int32))
    return s, ws


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 value reduced mod 2^32 into the signed int32 range."""
    return ((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _audit_checksum_dev(arr):
    """Device twin of ``_audit_checksum_host``: two O(N*R) reductions ON
    the device -- the cheap per-sweep cost of the carry audit; the full
    [N, R] download happens only on mismatch. The sums run in int64
    (whose own wrap is mod 2^64) and reduce mod 2^32 at the end: the
    same ring as numpy's wrapping int32 sums, so the pair equals the
    host's bit for bit. Returns device scalars (the caller converts
    once, batching the sync). A sharded carry sums shard by shard with
    each row's GLOBAL weight, on the mesh's first device: the ring
    makes the per-shard int64 sums wrap to the host's pair too."""
    if isinstance(arr, ShardedRows):
        first = arr.mesh.first
        s = ws = torch.zeros((), dtype=torch.int64, device=first)
        for shard, (lo, hi) in zip(arr.shards, arr.bounds):
            a = shard.to(torch.int64)
            if a.ndim == 1:
                a = a[:, None]
            w = torch.arange(
                lo + 1, hi + 1, dtype=torch.int64, device=a.device
            )[:, None]
            s = s + a.sum().to(first)
            ws = ws + (a * w).sum().to(first)
        return _wrap_i32(s), _wrap_i32(ws)
    a = arr.to(torch.int64)
    if a.ndim == 1:
        a = a[:, None]
    w = (
        torch.arange(a.shape[0], dtype=torch.int64, device=a.device) + 1
    )[:, None]
    return _wrap_i32(a.sum()), _wrap_i32((a * w).sum())


class _Delta(tuple):
    """One mirrored batch's per-row adds in the pending ring,
    ``(node_rows [K], req_rows [K, R], nzr_rows [K, 2])``, with ``stamp``:
    a one-slot list, shared by every slice of the entry, that the
    committer sets to the commit ordinal (``BatchScheduler._commit_seq``)
    once the batch's commit has finished writing the host cache. A host
    pack taken after that ordinal shows the batch's assumes and whatever
    later forget undid one of them, so the handshake may no longer read
    the batch as host lag."""

    stamp = (None,)


def _slice_delta(entry, keep) -> _Delta:
    """``entry`` restricted to the rows ``keep`` selects, sharing its
    stamp."""
    out = _Delta(a[keep] for a in entry)
    out.stamp = getattr(entry, "stamp", _Delta.stamp)
    return out


def _host_shows(delta, committed_through) -> bool:
    """Did the host pack of a dispatch that read ``committed_through``
    before its snapshot see ``delta``'s commit land?"""
    done = getattr(delta, "stamp", _Delta.stamp)[0]
    return (
        committed_through is not None
        and done is not None
        and done <= committed_through
    )


class _DeviceNodeState:
    """Device-resident node tensors + the generation-handshake
    bookkeeping that validates their reuse.

    Every host->device transfer over the serving link pays a round trip
    (SURVEY.md section 7 "hardest parts (e)"), so the solver keeps node
    state ON DEVICE between batches: the scan already returns the
    post-batch (requested, nzr) on device, and the host mirrors the same
    integer updates into ``req_shadow``/``nzr_shadow`` at commit time.

    Reuse validation is a GENERATION HANDSHAKE, not an array sweep: the
    NodeTensorCache stamps every repacked row with a monotonic epoch, so
    at dispatch only ``rows_changed_since(validated_epoch)`` need a
    content compare against the expectation -- O(changed rows), while the
    old design re-swept the full [N, R] arrays against every shadow
    generation. The committer may trail the dispatcher by several
    batches; ``pending_deltas`` holds each mirrored batch's per-row adds
    so a host state that trails the shadow by a suffix of them still
    validates. Changed rows the expectation does NOT explain (node churn,
    bind failures) are divergences: they are scatter-patched onto the
    resident state as (indices, rows) -- or, with work in flight or too
    many rows, resolved by a counted full upload. Never silently wrong.

    Only a batch whose commit the host pack does not show yet is host
    lag. Once it shows, the batch's delta leaves the ring: a placement
    its commit then forgot (a bind that failed terminally, a fenced
    commit, a bind conflict) differs from the shadow at depth 0 and is
    a divergence, where peeling the delta would have read it as lag and
    left the placement in the carry for good.
    """

    def __init__(self) -> None:
        self.alloc_dev = None
        self.valid_dev = None
        self.req_dev = None
        self.nzr_dev = None
        # -- handshake bookkeeping ---------------------------------------
        # the NodeTensorCache layout epoch the device buffers were built
        # against: row identity is only comparable while it stands
        self.layout_epoch = -1
        # the cache update epoch the shadows were last reconciled to
        self.validated_epoch = -1
        # expected host state: alloc mirrors the packed allocatable
        # (patched row-wise); req/nzr mirror the packed requested state
        # plus every mirrored (committed) batch
        self.alloc_shadow: Optional[np.ndarray] = None
        self.valid_shadow: Optional[np.ndarray] = None
        self.req_shadow: Optional[np.ndarray] = None
        self.nzr_shadow: Optional[np.ndarray] = None
        # the last injected carry corruption: the resident req carry it
        # replaced, and the row it bumped (see _corrupt_carry_row)
        self.corrupted_from = None
        self.corrupt_row = 0
        # per-batch expected row deltas the host pack may not have shown
        # yet: (node_rows [K], req_rows [K, R], nzr_rows [K, 2]), newest
        # last (replaces the retired full-array shadow_gens ring); each
        # a _Delta stamped when its batch's commit lands
        self.pending_deltas: "collections.deque" = collections.deque(
            maxlen=_SHADOW_RING_CAP
        )
        # rows holding a mirrored placement that never reached the host
        # cache (the pod's assume or Reserve failed, e.g. a pod drained
        # twice into one batch): no cache change stamps them, so the
        # next negotiation compares them along with the changed rows
        self.recheck_rows: set = set()

    def invalidate_carry(self) -> None:
        self.req_dev = None
        self.nzr_dev = None
        self.req_shadow = None
        self.nzr_shadow = None
        self.pending_deltas.clear()
        self.recheck_rows.clear()


class BatchScheduler(Scheduler):
    def __init__(
        self,
        *args,
        max_batch: int = 256,
        solver_config: GreedyConfig = GreedyConfig(),
        tensor_cache: Optional[NodeTensorCache] = None,
        batch_window: float = 0.01,
        solver_mode: str = "greedy",
        mesh=None,
        robustness_config: Optional[RobustnessConfig] = None,
        containment_config: Optional[ContainmentConfig] = None,
        device=None,
        **kwargs,
    ) -> None:
        """``solver_mode``: "greedy" replays the sequential argmax exactly
        (parity mode); "sinkhorn" adds the entropic-OT global prior for
        the churn/rebalance regime (ops/sinkhorn.py) on unconstrained
        batches: the prior as torch ops, the commit scan through the
        greedy kernel's scored entry on the card.

        ``mesh``: an optional ``ops.mesh.NodeMesh``: the resident node
        state lives sharded over its devices (ShardedRows), a greedy
        batch solves through the shard-candidate kernel K4 with a
        best-of-shards combine per pod, a constrained batch through K2
        and a sinkhorn batch through its prior and K1's scored entry,
        both on the state gathered onto the first device (the function
        the JAX mesh computes on its GSPMD twin), and ``self.device`` is
        the mesh's first
        device (where assignments, the preemption wave and warmup's
        extra kernels run). The int16 carry is off on a mesh, as in the
        JAX package.

        ``device``: where the resident node state and the solve live --
        the card (``"cuda"``) unless the caller names the CPU; with no
        visible card the default raises. With a mesh it must be None or
        the mesh's first device."""
        if solver_mode not in ("greedy", "sinkhorn"):
            raise ValueError(f"unknown solver_mode {solver_mode!r}")
        self.mesh = mesh
        self.device = solve_device(device, mesh)
        super().__init__(*args, **kwargs)
        self.max_batch = max_batch
        self.solver_config = solver_config
        self.tensor_cache = tensor_cache or NodeTensorCache()
        self.batch_window = batch_window
        # SLO-adaptive batching (streaming/autobatch.py): when a
        # controller is attached it rewrites batch_window and
        # dispatch_batch_cap between batches -- the cap bounds how many
        # pods one pop_batch drains. None = static knobs (no overhead).
        self.autobatch = None
        self.dispatch_batch_cap: Optional[int] = None
        # seconds of one steady solve at each controller rung's batch
        # size, timed by warmup() when the controller sizes its ladder
        # from them (auto_rungs); feeds AutoBatchController.calibrate
        self.rung_solve_seconds: dict = {}
        self.solver_mode = solver_mode
        self.batches_solved = 0
        self.pods_solved_on_device = 0
        self.pods_fallback = 0
        # perf-matrix visibility (VERDICT r2: the drain cliff and the
        # envelope fallbacks were unmetered)
        self.envelope_fallbacks = 0  # whole batches sent to host by packers
        self.pipeline_drains = 0  # constrained dispatch drained the pipeline
        self.gang_resolves = 0  # quorum-failure re-solves (_gang_fixup)
        self.nominee_constrained_fallbacks = 0  # nominees + constraints
        self.state_reuses = 0
        self.state_uploads = 0
        # generation-handshake visibility: total changed node rows shipped
        # as (indices, rows) scatters instead of full [N, R] uploads, and
        # handshake mismatches (host state not explained by our own
        # mirrored placements -- node churn, bind failures)
        self.delta_rows_uploaded = 0
        self.carry_divergences = 0
        # membership churn absorbed as in-place slot scatters (node
        # add/remove rows patched onto the resident state without a
        # layout move, an upload, or a divergence)
        self.membership_row_patches = 0
        self._dev = _DeviceNodeState()
        self._shadow_lock = threading.Lock()
        # commits landed in the host cache (under _shadow_lock); a
        # dispatch reads it before its snapshot to tell host lag from a
        # commit the host already shows (see _Delta)
        self._commit_seq = 0
        # pipelined batches flow dispatcher -> committer through this
        # bounded FIFO; the committer thread owns download + commit so the
        # dispatcher never blocks on a serving-link round trip
        self._pending_q: "collections.deque" = collections.deque()
        self._pending_cv = threading.Condition()
        self._committer: Optional[threading.Thread] = None
        # failures parked across in-flight batches for one combined
        # preemption wave (touched only by the committing thread: the
        # committer loop, or the dispatcher on the synchronous paths,
        # which drain the pipeline first)
        self._deferred_preempt: List = []
        self._volume_listers = None
        self._deferred_since = 0.0
        self._prewarm_next_commit = False
        self._committer_stop = False
        # -- admission classifier state (scheduler/admission.py) ---------
        # volume-topology generation: bumped by every PV/PVC/StorageClass/
        # CSINode event (eventhandlers), compared against each PVC-bearing
        # pod's cached admission record at pop time
        self._volume_topo_gen = 0
        # memo ownership token: an admission record from another scheduler
        # instance (different extenders / dims registry) is re-classified
        self._admission_token = object()
        self.admissions_classified = 0
        self.reclassifications = 0
        self.volume_reject_retries = 0  # device NO_NODE -> host re-checks
        # the plain-pod fast path (native ingest_stamp / its twin): ONE
        # shared read-only Admission record serves every plain pod, and
        # the native cfg tuple is built once per scheduler
        self._plain_adm: Optional[Admission] = None
        self._ingest_cfg: Optional[tuple] = None
        # per-stage wall-clock accumulators, ALWAYS on (bench.py emits
        # profile_stage_seconds every round; only the per-pod classify
        # timer stays behind profile_stages). Per-THREAD dicts merged at
        # read: the dispatcher (pop/classify/pack/device_solve) and the
        # committer (download/commit) accumulate without sharing a
        # read-modify-write -- the old single dict dropped stage time
        # under pipelining whenever both threads raced the same key
        self.profile_stages = False
        self._stage_lock = threading.Lock()
        self._stage_local = threading.local()
        self._stage_dicts: List[dict] = []
        # flight-recorder spine (utils/flightrecorder.py): the pop-side
        # stage timings of the CURRENT drain, consumed by the first
        # span it dispatches (pop_batch drains before the flush loop
        # splits batches, so the pop cost belongs to the drain's head)
        # (drain-work seconds, arrival-wait seconds, pop-start
        # perf_counter, window-wait seconds, queue depth left behind) of
        # the current drain
        self._pop_note: Optional[
            Tuple[float, float, float, float, int]
        ] = None
        # runtime kernel-build watchdog: sealed at the end of warmup();
        # unsealed growth still counts builds, it just isn't flagged as
        # a mid-run build (tests that skip warmup stay quiet)
        self._jit_watch = _JitCacheWatch()
        # collect-at-idle gc policy, engaged only by the production run
        # loop (tests driving schedule_batch directly keep gc untouched)
        self._gc_guard = None
        # solver degradation ladder (robustness/): per-tier circuit
        # breakers + retry + watchdog around every device interaction,
        # so a sick device path steps down CUDA kernel -> host greedy
        # -> sequential oracle and the batch ALWAYS completes
        self.ladder = SolverLadder(robustness_config)
        # bind retries share the ladder's policy + injectable sleep
        self.bind_retry_policy = self.ladder.config.retry
        self._retry_sleep = self.ladder.config.sleep
        # set when the committer failed to join at shutdown (satellite:
        # the silent join(timeout=10) hang) -- surfaced via the
        # scheduler_degraded_health gauge and this flag
        self.commit_degraded = False
        # -- blast-radius containment (robustness/containment.py) --------
        # poison bisection + the quarantine ledger: a ladder-exhausted
        # batch is split O(log B)-wise into sub-solves instead of
        # failing whole to the sequential floor; isolated pods take
        # escalating holds and park with a typed PodQuarantined
        # condition when the strike budget runs out
        self.containment_config = containment_config or ContainmentConfig()
        self.quarantine = QuarantineManager(
            self.queue, self.client, self.containment_config
        )
        # a real spec update releasing a PARKED pod must also clear its
        # apiserver-visible PodQuarantined condition
        self.queue.on_quarantine_release = (
            self.quarantine.clear_condition_async
        )
        self.bisections = 0
        self.pods_quarantined = 0
        # ladder exhaustions whose cause is an injected solver fault
        # (FaultInjected): with ``injected_retries`` they account for
        # every DEVICE_SOLVE fire
        self.injected_exhaustions = 0
        # ladder_exhausted crash-loop detector: the uid signature of the
        # last exhausted batch and how many consecutive times it
        # exhausted (>= 2 books exhausted_crashloop and forces the
        # containment path over another identical full-batch retry)
        self._last_exhaust_sig: Optional[frozenset] = None
        self._exhaust_repeats = 0
        # carry integrity audit bookkeeping: the dispatch sequence lets
        # an audit detect that a dispatch/commit raced its checksum
        # window (bumped per dispatch AND per shadow mirror)
        self._dispatch_seq = 0
        self.carry_audits = 0
        self.carry_audit_heals = 0
        # device-loss rebuild: perf_counter at loss detection; cleared
        # (and metered into device_rebuild_ms) when the next device
        # solve lands on fully re-uploaded state
        self._device_lost_at: Optional[float] = None
        # -- pipelined speculative dispatch (ISSUE 18) --------------------
        # in-flight depth knob: the bench's serial arm pins 1 so the
        # pipelined/serial comparison runs the same code path
        self.max_inflight = MAX_INFLIGHT
        self.speculative_launches = 0
        self.speculative_rewinds = 0
        # dispatches redone because the resident state they negotiated
        # was dropped before they read it (the committer's recovery of a
        # failed batch invalidates the carry on its own thread)
        self.carry_drop_redispatches = 0
        # range-gated int16 carry compression: engaged per dispatch
        # while every resident column sum provably stays inside the int16
        # guard band, so the narrowed carry is bit-exact.
        # KTPU_CARRY_COMPRESS=0 pins the int32 carry (the A/B knob).
        self.carry_compress_enabled = (
            mesh is None
            and os.environ.get("KTPU_CARRY_COMPRESS", "1") != "0"
        )

    # -- one batch ----------------------------------------------------------

    def schedule_batch(
        self, timeout: Optional[float] = None, pipeline: bool = False
    ) -> int:
        """Pop up to max_batch pods, solve device-supported ones in one
        device solve, route the rest through the sequential path. Returns
        the number of pods processed.

        With ``pipeline=True`` (the production run loop) a pure-resource
        batch may be left in flight on device: the NEXT call dispatches
        its own solve against the device-resident carry BEFORE downloading
        and committing the previous result, so the serving link's
        round-trip latency is overlapped with host commit work instead of
        serializing with it."""
        ab = self.autobatch
        if ab is not None:
            # one controller decision per interval, taken between
            # batches on the dispatcher thread (deterministic ordering
            # with the drain; the callable window below lets a shrink
            # land mid-wait too)
            ab.maybe_step(self)
        cap = self.dispatch_batch_cap
        size = (
            self.max_batch
            if not cap
            else max(1, min(self.max_batch, cap))
        )
        t_pop = time.perf_counter()
        batch_infos = self.queue.pop_batch(
            size,
            timeout=timeout,
            window=(self._live_window if ab is not None
                    else self.batch_window),
        )
        dt_pop = time.perf_counter() - t_pop
        # split drain WORK from arrival wait: blocking on an empty queue
        # (burst still streaming in, or plain idle) is not hot-path time
        # and would drown the pop_batch share the profile exists to watch
        waited = getattr(self.queue, "last_pop_wait_seconds", 0.0)
        # the part of the wait spent inside the batch window, pods in hand
        window_waited = getattr(
            self.queue, "last_pop_window_wait_seconds", 0.0
        )
        self._stage_add("pop_batch", max(0.0, dt_pop - waited))
        if waited:
            self._stage_add("pop_wait", waited)
        if window_waited:
            self._stage_add("window_wait", window_waited)
        # the first span this drain dispatches claims the pop timings
        self._pop_note = (
            max(0.0, dt_pop - waited), waited, t_pop, window_waited,
            getattr(self.queue, "last_pop_queue_depth", 0),
        )
        guard = self._gc_guard
        if not batch_infos:
            # idle: finish whatever is still in flight
            self._drain_pending()
            if self._deferred_preempt:
                # safety net: a mixed burst whose tail took the fallback
                # path produces no further batch commits to trigger the
                # deferred wave
                self._flush_deferred_preemptions()
            if guard is not None:
                guard.idle()
            return 0
        if guard is not None:
            guard.active()
        pod_scheduling_cycle = self.queue.scheduling_cycle

        # Process in activeQ order: a fallback pod must not jump ahead of
        # higher-priority solver pods popped before it, so solver runs are
        # flushed at each fallback boundary (each flush re-snapshots and
        # re-checks cluster compatibility, so fallback capacity claims and
        # newly-placed anti-affinity pods are visible to later solver pods).
        solver_infos: List[PodInfo] = []

        def flush() -> None:
            if solver_infos:
                if pipeline:
                    self._solve_pipelined(solver_infos, pod_scheduling_cycle)
                else:
                    self._solve_and_commit(solver_infos, pod_scheduling_cycle)
                self.batches_solved += 1
                solver_infos.clear()

        # admission is a precomputed-field read here: the classifier ran
        # at informer ingest (eventhandlers), so the hot loop does one
        # memo get per pod instead of re-walking annotations, volume
        # sources, and NUMA hints per pod per cycle (the round-5
        # regression). Stale volume classifications re-check inside
        # _admission_of.
        profiling = self.profile_stages
        inj = get_injector()
        quota_gate = self.quota
        for pi in batch_infos:
            if self._skip_pod_schedule(pi.pod):
                continue
            if quota_gate is not None and not self._quota_admit(
                pi, pod_scheduling_cycle
            ):
                # parked typed-QuotaExceeded (woken by quota/usage
                # events) or routed to the backoff clock; either way it
                # never enters a batch uncharged
                continue
            if inj is not None:
                # one POISON_POD draw per pod ever (uid-keyed, so the
                # verdict survives informer object replacement): a
                # firing draw stamps the pod and the fault follows it
                # through every later batch
                poison_stamp_maybe(pi.pod)
            if profiling:
                t_cls = time.perf_counter()
                adm = self._admission_of(pi.pod)
                self._stage_add("classify", time.perf_counter() - t_cls)
            else:
                adm = self._admission_of(pi.pod)
            if adm.device_ok:
                # one profile per solver batch: score weights and owner
                # lookups are profile-scoped (the sequential path resolves
                # them per pod, scheduler.go:741)
                if solver_infos and (
                    solver_infos[0].pod.spec.scheduler_name
                    != pi.pod.spec.scheduler_name
                ):
                    flush()
                solver_infos.append(pi)
            else:
                flush()
                # the sequential path filters against the host cache,
                # which must include every in-flight placement
                self._drain_pending()
                self.pods_fallback += 1
                self.attempt_schedule(pi)
        flush()
        if not pipeline:
            self._drain_pending()
        return len(batch_infos)

    def _solve_and_commit(
        self, solver_infos: List[PodInfo], pod_scheduling_cycle: int
    ) -> None:
        """Synchronous solve: dispatch + download + commit in one call,
        with the gang quorum fixup between solve and commit."""
        pending = self._dispatch_solve(solver_infos, pod_scheduling_cycle)
        if pending is None:
            return
        try:
            if any(
                pi.pod.metadata.labels.get(POD_GROUP_LABEL)
                for pi in solver_infos
            ):
                pending = self._gang_fixup(solver_infos, pending)
                if pending is None:
                    return
            self._complete_solve(pending)
        except SchedulerCrashed:
            self._simulate_crash()  # no recovery: the process "died"
        except Exception as e:
            if self._halts_on_card(e):
                self._halt_on_card_fault(e)
                raise
            # a failed download/commit must not crash the dispatch loop:
            # requeue the batch's pods (they retry on whatever tier the
            # breakers now route to) and drop the stale carry
            logger.exception("synchronous batch completion failed")
            self._recover_failed_batch(pending, e)

    # -- gang all-or-nothing group masks (SURVEY stage 6) --------------------

    def _gang_fixup(self, solver_infos: List[PodInfo], pending):
        """All-or-nothing placement for PodGroups inside the solver: a
        group whose placed + potential outside members can't reach
        min_member is masked inactive and the batch re-solves, so a
        half-fitting gang reserves NOTHING (no Permit-timeout churn).
        Permit remains the cross-batch completion gate for groups that
        can still assemble (framework/v1alpha1/interface.go:384).

        Outside members (held or still pending) count optimistically --
        the same knowledge horizon as Coscheduling's PreFilter fail-fast
        (total known members vs min_member), sharpened with this batch's
        actual capacity outcome."""
        inactive: set = set()
        for _attempt in range(2):
            assignments = self._pending_assignments(pending)
            failed = self._gang_quorum_failures(pending, assignments)
            failed -= inactive
            if not failed:
                pending["gang_failed_uids"] = inactive
                return pending
            inactive |= failed
            self.gang_resolves += 1
            self._rewind_carry(pending)
            pending = self._dispatch_solve(
                solver_infos, pending["cycle"], inactive_uids=inactive
            )
            if pending is None:
                return None  # packers routed the batch to the host path
        # leftover failures after the final pass are committed as
        # NO_NODE without a re-solve: their capacity stays reserved in
        # the device output, so drop the carry
        assignments = self._pending_assignments(pending)
        leftover = self._gang_quorum_failures(pending, assignments)
        if leftover - inactive:
            inactive |= leftover
            with self._shadow_lock:
                self._dev.invalidate_carry()
        pending["gang_failed_uids"] = inactive
        return pending

    def _rewind_carry(self, pending) -> None:
        """Rewind the device carry to the given batch's pre-solve state:
        the gang quorum fixup re-solves the same batch, which must not
        see the first attempt's reservations. When the dispatch reused
        the carry, its pre-solve device refs are still alive
        (``carry_in``) and the rewind costs nothing on the serving link;
        otherwise the carry drops and the re-dispatch re-uploads."""
        ci = pending.get("carry_in")
        with self._shadow_lock:
            if ci is not None and self._dev.req_dev is not None:
                self._dev.req_dev, self._dev.nzr_dev = ci
            else:
                self._dev.invalidate_carry()

    def _pending_assignments(self, p):
        """The batch's downloaded assignments for the gang fixup: await
        the eager copy when one is in flight, else convert now -- under
        the same wall-clock watchdog that guards the committer's
        download, so a wedged serving link raises SolveTimeout (routed
        through _solve_and_commit's recovery) instead of hanging the
        dispatcher thread forever."""
        tier = p.get("tier", TIER_CUDA)
        timeout = (
            self.ladder.config.solve_timeout_seconds
            if tier in DEVICE_TIERS and self.ladder.config.enabled
            else 0.0
        )

        def download():
            eager = p.get("download")
            if eager is not None:
                return eager.result()
            return _to_host(p["assignments_dev"])

        try:
            return self.ladder.watchdog.call(download, timeout, tier=tier)
        except SolveTimeout:
            breaker = self.ladder.breakers.get(tier)
            if breaker is not None:
                breaker.force_open()
            raise

    def _gang_quorum_failures(self, pending, assignments) -> set:
        """UIDs of every member of a group that cannot reach min_member:
        placed-in-batch + ALL outside known members (held or pending)
        falls short."""
        solver_infos = pending["solver_infos"]
        order = pending["order"]
        b = pending["b"]
        groups = {}
        for k in range(b):
            pod = solver_infos[int(order[k])].pod
            g = pod.metadata.labels.get(POD_GROUP_LABEL)
            if g:
                groups.setdefault(
                    (pod.metadata.namespace, g), []
                ).append(k)
        if not groups:
            return set()
        prof = self.profiles.get(
            solver_infos[0].pod.spec.scheduler_name
        )
        cos = (
            prof.plugin_instance("Coscheduling") if prof is not None else None
        )
        if cos is None:
            # no Coscheduling plugin: the group label carries no gang
            # semantics in this profile -- never mask
            return set()
        failed: set = set()
        for (ns, g), ks in groups.items():
            pod0 = solver_infos[int(order[ks[0]])].pod
            min_member, total = cos.group_quorum_info(pod0, g)
            in_batch_uids = {
                solver_infos[int(order[k])].pod.metadata.uid for k in ks
            }
            placed = sum(
                1 for k in ks if int(assignments[k]) != NO_NODE
            )
            outside = max(0, total - len(in_batch_uids))
            if placed + outside < min_member:
                failed |= in_batch_uids
        return failed

    def _pending_exists(self) -> bool:
        with self._pending_cv:
            return bool(self._pending_q)

    def _pending_head(self):
        with self._pending_cv:
            return self._pending_q[0] if self._pending_q else None

    def _pending_first_unmirrored(self):
        """First pending record whose commit has NOT passed the
        shadow-mutation point (the mirror in ``_complete_solve``).
        Mirrors land in FIFO order, so this record's ``carry_in`` is
        the one snapshot that still equals the host shadows -- the
        under-load carry audit's comparand."""
        with self._pending_cv:
            for p in self._pending_q:
                if not p.get("mirrored"):
                    return p
        return None

    def _unmirrored_exists(self) -> bool:
        """Any dispatched batch whose shadow mirror has NOT landed yet?
        Once every pending record is mirrored the device carry equals
        the host shadow exactly (each dispatch rebinds the carry refs
        and the mirror is the only shadow writer), so the handshake can
        negotiate row-exact repairs with commits still in flight -- the
        speculative chain's cheap-rewind precondition."""
        with self._pending_cv:
            return any(not p.get("mirrored") for p in self._pending_q)

    def _inflight_load16(self) -> int:
        """Worst-case column load of every dispatched-but-unmirrored
        batch: their deltas live in the device carry but not yet in the
        shadow the compression range gate reads."""
        with self._pending_cv:
            return sum(
                int(p.get("load16", 0))
                for p in self._pending_q
                if not p.get("mirrored")
            )

    def _await_mirrors(self, timeout: float = 30.0) -> bool:
        """Block until every in-flight batch has mirrored its deltas
        into the shadow -- far cheaper than ``_drain_pending``, which
        also waits out the bind/commit API transactions. The committer
        notifies ``_pending_cv`` right after each mirror. Returns False
        on timeout or when no committer is running (the caller falls
        back to a full drain)."""
        if self._committer is None:
            return not self._pending_exists()
        deadline = time.monotonic() + timeout
        with self._pending_cv:
            while any(not p.get("mirrored") for p in self._pending_q):
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._pending_cv.wait(min(left, 0.5))
        return True

    def _device_tier(self) -> str:
        """The device tier's name, by where the solver's tensors live
        (ops/greedy_kernel.greedy_solve makes the choice itself: the
        kernel on the card, its plain PyTorch version on the CPU)."""
        return TIER_CUDA if self.device.type == "cuda" else TIER_TORCH

    @property
    def mesh_solver_tier(self) -> str:
        """The tier the mesh actually solved on ("cuda": K4 and K2 on
        the card; "torch": their plain versions on a CPU mesh) once any
        batch did; empty off-mesh or before the first device solve."""
        if self.mesh is None:
            return ""
        tier = self._device_tier()
        return tier if self.ladder.solves_by_tier.get(tier) else ""

    def _pending_has_required_anti(self) -> bool:
        with self._pending_cv:
            return any(p.get("has_required_anti") for p in self._pending_q)

    # -- admission classification (scheduler/admission.py) -------------------

    def _listers(self):
        """Lazily constructed shared PVC/PV/SC/CSINode lister access."""
        listers = self._volume_listers
        if listers is None:
            from kubernetes_tpu_torch.plugins.volumes import _Listers

            prof = next(iter(self.profiles.values()), None)
            listers = _Listers(prof)
            self._volume_listers = listers
        return listers

    def bump_volume_topology_gen(self) -> None:
        """A PV/PVC/StorageClass/CSINode mutation landed: cached
        admission records of PVC-bearing pods are stale from here."""
        self._volume_topo_gen += 1

    def classify_pod(self, pod: Pod) -> Admission:
        """Compute + memoize the pod's admission record (called at
        informer ingest by the event handlers, and lazily at pop time
        for pods that entered the queue some other way). Does NOT touch
        the tensor schema -- only the dispatcher thread registers volume
        columns (_ensure_vol_columns), so the dims registry never grows
        under a concurrently packing NodeTensorCache.update."""
        self.admissions_classified += 1
        return _classify_pod(
            pod,
            extenders=self.algorithm.extenders,
            listers=self._listers(),
            volume_gen=self._volume_topo_gen,
            token=self._admission_token,
            priority_resolver=self._effective_priority,
        )

    def _effective_priority(self, pod: Pod) -> int:
        """The pod's band priority: an explicit spec.priority wins; a
        bare priorityClassName resolves through the PriorityClass
        lister (stamped once at ingest -- the queue's band check is a
        memo read, never a lister lookup per drain)."""
        if pod.spec.priority:
            return pod.spec.priority
        name = pod.spec.priority_class_name
        if name:
            prof = next(iter(self.profiles.values()), None)
            informers = prof.informers if prof is not None else None
            if informers is not None:
                pc = informers.priority_classes().get("default", name)
                if pc is None:
                    pc = informers.priority_classes().get("", name)
                if pc is not None:
                    return int(pc.value)
        return pod.spec.priority

    def _plain_admission_record(self) -> Admission:
        adm = self._plain_adm
        if adm is None:
            from kubernetes_tpu_torch.scheduler.admission import plain_admission

            adm = plain_admission(self._admission_token)
            self._plain_adm = adm
        return adm

    def classify_pods_bulk(self, pods: List[Pod]) -> None:
        """One ingest pass over a watch frame's new pending pods (the
        event handlers' bulk classify): plain pods get their WHOLE
        ingest record -- spec memos, pack-ready row, band priority, and
        the shared Admission -- stamped in one native C pass
        (ingest_stamp; Python twin scheduler/admission.stamp_plain_pods
        behind KTPU_NATIVE_INGEST=0), and only the non-plain remainder
        runs the full per-pod classifier. With extenders configured the
        fast path is off: is_interested must see every pod."""
        if not pods:
            return
        rest_targets: List[Pod] = pods
        if not self.algorithm.extenders:
            from kubernetes_tpu_torch import native as _native
            from kubernetes_tpu_torch.scheduler.admission import (
                ingest_stamp_cfg,
                stamp_plain_pods,
            )

            plain = self._plain_admission_record()
            fn, expected = _native.ingest_fn("ingest_stamp")
            rest = None
            if fn is not None:
                cfg = self._ingest_cfg
                if cfg is None:
                    cfg = ingest_stamp_cfg(plain)
                    self._ingest_cfg = cfg
                try:
                    rest = fn(pods, cfg)
                except Exception:
                    # a fast-path failure must NEVER cost the frame its
                    # enqueue (the caller adds to the queue right after
                    # this): count it and run the twin
                    logger.exception("native ingest_stamp failed")
                    metrics.ingest_native_fallbacks.inc(
                        site="classify-stamp"
                    )
            elif expected:
                metrics.ingest_native_fallbacks.inc(site="classify-stamp")
            if rest is None:
                rest = stamp_plain_pods(pods, plain)
            self.admissions_classified += len(pods) - len(rest)
            rest_targets = [pods[i] for i in rest]
        for pod in rest_targets:
            try:
                self.classify_pod(pod)
            except Exception:
                logger.exception("classifying pod %s", pod.key())

    def attach_volume_counts(self, pod: Pod) -> None:
        """Resolve + memoize a BOUND pod's attachable-volume counts
        before it enters the cache (event handlers call this on the
        cache side of the frame): NodeInfo.add_pod reads the memo into
        the node's in-use accounting. Column registration for in-use
        names happens on the dispatcher thread inside
        NodeTensorCache.update (it scans NodeInfo.volume_in_use)."""
        if not pod.spec.volumes or "_volcount_memo" in pod.__dict__:
            return
        from kubernetes_tpu_torch.plugins.volumes import classify_pod_volumes

        try:
            _reason, counts = classify_pod_volumes(pod, self._listers())
        except Exception:  # noqa: BLE001 - never block the cache path
            logger.exception("volume counts for %s", pod.key())
            counts = ()
        pod.__dict__["_volcount_memo"] = counts

    def _ensure_vol_columns(self, adm: Admission) -> None:
        """Register the record's volume resources as tensor columns.
        Dispatcher-thread only: schema growth must never race the
        packer (registration bumps dims.version, so the next
        NodeTensorCache.update full-repacks with the new column)."""
        if adm.vol_counts:
            dims = self.tensor_cache.dims
            for name, _qty in adm.vol_counts:
                dims.volume_column(name)

    def _admission_of(self, pod: Pod) -> Admission:
        """The pop-time admission read: a memo hit is a dict get; a miss
        (new object, foreign token) or a stale volume classification
        (PVC binding landed mid-queue) re-classifies. Dispatcher-thread
        only (it registers volume columns)."""
        adm = pod.__dict__.get("_admission")
        if adm is not None and adm.token is self._admission_token:
            if adm.pinned or not adm.has_pvc:
                return adm
            if adm.volume_gen == self._volume_topo_gen:
                self._ensure_vol_columns(adm)
                return adm
            self.reclassifications += 1
        adm = self.classify_pod(pod)
        self._ensure_vol_columns(adm)
        return adm

    def _memo_admissions(self, solver_infos: List[PodInfo]) -> List[Admission]:
        """Admission records for a dispatched batch, without the
        staleness re-check: routing was decided at pop time, and the
        record's feature bits describe the same pod object either way."""
        out = []
        token = self._admission_token
        for pi in solver_infos:
            adm = pi.pod.__dict__.get("_admission")
            if adm is None or adm.token is not token:
                adm = self.classify_pod(pi.pod)
                self._ensure_vol_columns(adm)
            out.append(adm)
        return out

    def _live_window(self) -> float:
        """Window source handed to pop_batch when the adaptive
        controller is attached. The queue calls it at every window
        wakeup, so the controller is re-polled MID-WINDOW (still
        interval-gated, and re-entrant on the queue's RLock since this
        runs on the dispatcher thread): a shrink decided while a drain
        is waiting lands on that drain immediately, while the queue
        clamps the deadline so a grow never extends it."""
        ab = self.autobatch
        if ab is not None:
            ab.maybe_step(self)
        return self.batch_window

    def attach_autobatch(self, controller) -> None:
        """Wire an AutoBatchController (streaming/autobatch.py) into the
        dispatch loop and apply its current outputs now. A batch pads
        only to the next POD_BUCKET and every kernel takes any batch
        size, so no rung needs a build of its own; with ``auto_rungs``
        warmup() times one solve at each rung's size and the
        controller's ``calibrate`` prunes rungs that don't pay."""
        self.autobatch = controller
        self.batch_window = controller.window
        self.dispatch_batch_cap = controller.batch_cap

    def _stage_add(self, name: str, seconds: float) -> None:
        # lock-free on the hot path: each thread owns its accumulator
        # dict; the lock is only taken once per thread to register it
        d = getattr(self._stage_local, "d", None)
        if d is None:
            d = {}
            self._stage_local.d = d
            with self._stage_lock:
                self._stage_dicts.append(d)
        d[name] = d.get(name, 0.0) + seconds

    @property
    def stage_seconds(self) -> dict:
        """Merged per-stage wall-clock totals across every accumulating
        thread (dispatcher, committer, bind pool). dict.copy() is atomic
        under the GIL, so a concurrent _stage_add never corrupts the
        merge -- at worst the freshest increment lands in the next
        read."""
        with self._stage_lock:
            dicts = [d.copy() for d in self._stage_dicts]
        out: dict = {}
        for d in dicts:
            for k, v in d.items():
                out[k] = out.get(k, 0.0) + v
        return out

    def _pending_has_ports(self) -> bool:
        with self._pending_cv:
            return any(p.get("has_ports") for p in self._pending_q)

    def _pending_has_scoring_terms(self) -> bool:
        with self._pending_cv:
            return any(p.get("has_scoring_terms") for p in self._pending_q)

    def _ensure_committer(self) -> None:
        if self._committer is None:
            self._committer_stop = False
            self._committer = threading.Thread(
                target=self._committer_loop, name="batch-committer",
                daemon=True,
            )
            self._committer.start()

    def _stop_committer(self) -> None:
        with self._pending_cv:
            self._committer_stop = True
            self._pending_cv.notify_all()
        if self._committer is not None:
            self._committer.join(timeout=10)
            if self._committer.is_alive():
                # the join timed out: the committer is wedged (most
                # likely a hung result download over the serving link).
                # Silence here would strand in-flight batches invisibly
                # -- log, count, and raise the degraded-health flag so
                # operators and the health endpoint see it.
                logger.error(
                    "committer thread failed to join within 10s; "
                    "%d batch(es) may be stranded in flight",
                    len(self._pending_q),
                )
                metrics.commit_join_timeouts.inc()
                metrics.degraded_health.set(
                    1, reason="committer_join_timeout"
                )
                flightrecorder.dump_on_degraded("committer_join_timeout")
                self.commit_degraded = True
            self._committer = None

    def _committer_loop(self) -> None:
        """Completes dispatched batches in FIFO order: the ~100ms serving
        link round trip per result download happens here, off the
        dispatcher thread (which is already packing the next batch). A
        batch stays at the queue head until fully committed so
        _drain_pending and the dispatch-time pending checks see it."""
        while True:
            with self._pending_cv:
                while not self._pending_q and not self._committer_stop:
                    self._pending_cv.wait()
                if not self._pending_q and self._committer_stop:
                    return
                p = self._pending_q[0]
            try:
                p["committing"] = True
                self._complete_solve(p)
            except SchedulerCrashed:
                self._simulate_crash()  # no recovery: the process "died"
            except Exception as e:
                if self._halts_on_card(e):
                    self._halt_on_card_fault(e)
                    raise
                logger.exception("batch commit crashed")
                self._recover_failed_batch(p, e)
            finally:
                with self._pending_cv:
                    self._pending_q.popleft()
                    if self.card_fault is not None:
                        # the batches behind it are never completed:
                        # release _drain_pending's waiters
                        self._pending_q.clear()
                    self._pending_cv.notify_all()

    def _halts_on_card(self, err: BaseException) -> bool:
        """Whether a failed batch completion stops the scheduler: on the
        card it does, unless an injected device loss voided the batch or
        an injected fault outlasted its in-place retries (its pods
        requeue)."""
        return self.device.type == "cuda" and not isinstance(
            err, (DeviceLostInFlight, FaultInjected)
        )

    def _recover_failed_batch(self, p, err=None) -> None:
        """A committer crash (serving-link error mid-download, commit
        bug) must not strand the batch's pods as Pending-forever: every
        pod not already assumed goes back through the failure path
        (requeue with backoff + condition), and the device carry is
        dropped since the batch's true placements are unknown. On the
        card an injected fault ``err`` requeues the pods on the backoff
        clock for K1, as an exhausted solve does."""
        with self._shadow_lock:
            self._dev.invalidate_carry()
        try:
            if self._deferred_preempt:
                self._flush_deferred_preemptions()
        except Exception:
            logger.exception("flushing deferred preemptions on recovery")
        if self.device.type == "cuda" and isinstance(err, FaultInjected):
            self.injected_exhaustions += 1
            self._requeue_for_card(
                p["solver_infos"], p["cycle"], f"injected fault: {err}"
            )
            return
        self._requeue_unplaced(
            p["solver_infos"], p["cycle"], "batch commit failed"
        )

    def _requeue_unplaced(
        self, solver_infos: List[PodInfo], pod_scheduling_cycle: int,
        message: str,
    ) -> None:
        """Every pod of the batch not already assumed goes back through
        the failure path (requeue with backoff + condition)."""
        prof = self.profiles.get(solver_infos[0].pod.spec.scheduler_name)
        for pi in solver_infos:
            try:
                if prof is None or self.cache.is_assumed_pod(pi.pod):
                    continue
                self.record_scheduling_failure(
                    prof, pi, message, "SchedulerError", "",
                    pod_scheduling_cycle,
                )
            except Exception:
                logger.exception("recovering pod %s", pi.pod.key())

    def _requeue_for_card(
        self, solver_infos: List[PodInfo], pod_scheduling_cycle: int,
        message: str,
    ) -> None:
        """The card's floor for a batch the ladder gave up on: its pods
        requeue on the backoff clock (the fault was the solve's, not an
        unschedulable verdict) and K1 solves them at their next pop."""
        self._requeue_unplaced(solver_infos, pod_scheduling_cycle, message)
        self.queue.move_pods_to_active_or_backoff_queue(
            list(solver_infos), queue_events.ScheduleAttemptFailure
        )

    def _solve_pipelined(
        self, solver_infos: List[PodInfo], pod_scheduling_cycle: int
    ) -> None:
        """Dispatch this batch and enqueue it for the committer thread;
        blocks only when MAX_INFLIGHT batches are already in flight.
        Gang batches take the synchronous path: the quorum fixup
        (SURVEY stage 6 all-or-nothing group masks) may re-solve, which
        must not race in-flight batches."""
        if any(
            pi.pod.metadata.labels.get(POD_GROUP_LABEL)
            for pi in solver_infos
        ):
            self._drain_pending()
            self._solve_and_commit(solver_infos, pod_scheduling_cycle)
            return
        pending = self._dispatch_solve(solver_infos, pod_scheduling_cycle)
        if pending is None:
            return
        self._ensure_committer()
        with self._pending_cv:
            while len(self._pending_q) >= self.max_inflight:
                self._pending_cv.wait()
            if self._pending_q:
                # the solve launched against the shadow-EXPECTED state
                # of still-uncommitted batches: a speculative link in
                # the chain (a commit divergence rewinds it via the
                # row-patch path instead of a drain)
                self.speculative_launches += 1
                metrics.speculative_launches.inc()
            self._pending_q.append(pending)
            self._pending_cv.notify_all()

    def _drain_pending(self) -> None:
        """Block until every in-flight batch has committed (the host
        cache then reflects every dispatched placement)."""
        if self._committer is None:
            while self._pending_q:
                pend = self._pending_q.popleft()
                try:
                    self._complete_solve(pend)
                except Exception as e:
                    if self._halts_on_card(e):
                        self._halt_on_card_fault(e)
                        raise
                    logger.exception("drain commit failed")
                    self._recover_failed_batch(pend, e)
            return
        with self._pending_cv:
            while self._pending_q:
                self._pending_cv.wait()

    # -- device-state generation handshake ----------------------------------

    def _explain_rows(self, changed, host_req, host_nzr):
        """Under ``_shadow_lock``: is every changed row's host content
        explained by the shadow expectation at some committer-trail
        depth? The host may trail the shadow by a suffix of
        ``pending_deltas`` (batches mirrored but whose cache assume the
        host pack predates) -- peel them newest-first until the changed
        rows match. Returns ``(ok, divergent_rows, keep)``: on a match
        ``keep`` is the number of newest deltas still unconfirmed; on a
        mismatch ``divergent_rows`` holds the depth-0 mismatches and
        ``keep`` is 0 when NO pending delta touches them (the mismatch
        is genuinely external, so a row scatter-fix is exact -- the
        device carry always equals the shadow once every dispatched
        batch has mirrored) or None when one does (the row may merely
        be host-lagging; only a full resync is safe)."""
        ds = self._dev
        if changed.size == 0:
            # no repacked rows: nothing to confirm, keep every delta
            return True, None, len(ds.pending_deltas)
        exp_req = ds.req_shadow[changed]
        exp_nzr = ds.nzr_shadow[changed]
        h_req = host_req[changed]
        h_nzr = host_nzr[changed]
        row_ok = np.all(exp_req == h_req, axis=1) & np.all(
            exp_nzr == h_nzr, axis=1
        )
        if row_ok.all():
            return True, None, 0
        div_rows = changed[~row_ok]
        pos = {int(r): j for j, r in enumerate(changed)}
        keep = 0
        for rows, req_rows, nzr_rows in reversed(ds.pending_deltas):
            keep += 1
            for j, r in enumerate(rows.tolist()):
                jj = pos.get(int(r))
                if jj is not None:
                    exp_req[jj] -= req_rows[j]
                    exp_nzr[jj] -= nzr_rows[j]
            if (
                np.all(exp_req == h_req, axis=1)
                & np.all(exp_nzr == h_nzr, axis=1)
            ).all():
                return True, None, keep
        div_set = set(div_rows.tolist())
        lagging = any(
            int(r) in div_set
            for rows, _req_rows, _nzr_rows in ds.pending_deltas
            for r in rows
        )
        return False, div_rows, (None if lagging else 0)

    def _adopt_membership_rows(self, member, host_req, host_nzr):
        """Under ``_shadow_lock``, with nothing in flight (so the device
        carry equals the shadow): adopt host truth for churned row slots
        into the shadow expectation and scrub them from the pending
        ring (their pre-churn deltas can never be confirmed -- the slot
        belongs to a different node now). Returns the subset whose
        device content (== pre-adoption shadow) actually differs and
        therefore must ride the didx scatter."""
        ds = self._dev
        diff = ~(
            np.all(ds.req_shadow[member] == host_req[member], axis=1)
            & np.all(ds.nzr_shadow[member] == host_nzr[member], axis=1)
        )
        fix = member[diff]
        ds.req_shadow[member] = host_req[member]
        ds.nzr_shadow[member] = host_nzr[member]
        if ds.pending_deltas:
            mset = set(member.tolist())
            scrubbed = collections.deque(
                maxlen=ds.pending_deltas.maxlen
            )
            for entry in ds.pending_deltas:
                rows = entry[0]
                keepm = np.fromiter(
                    (int(r) not in mset for r in rows),
                    dtype=bool, count=len(rows),
                )
                if keepm.all():
                    scrubbed.append(entry)
                elif keepm.any():
                    scrubbed.append(_slice_delta(entry, keepm))
                # entries fully on churned slots drop: nothing left to
                # confirm
            ds.pending_deltas = scrubbed
        return fix

    def _negotiate_device_state(
        self, nt, node_requested, node_nzr, overlaid,
        pending_exists, unmirrored_exists=None, committed_through=None,
    ):
        """Decide how this dispatch's node state reaches the device and
        reconcile the handshake bookkeeping. Returns None when in-flight
        batches block the decision (caller drains and redispatches), else
        ``{"static_ok", "carry_ok", "didx", "sidx", "member"}``:

        - carry_ok + empty deltas: pure reuse, nothing node-sized rides
          the link.
        - carry_ok + didx/sidx rows: reuse, with externally changed rows
          (divergences / allocatable updates) patched onto the resident
          state by the in-buffer scatter (ops/assignment.py). Membership
          churn (node add/remove claiming/retiring slots in place, see
          NodeTensorCache) rides the same scatter -- sidx patches alloc
          AND valid, didx resets the slot's requested state -- and is an
          EXPECTED reset, never counted as a divergence.
        - not carry_ok: full [N, R] requested upload (``state_uploads``);
          not static_ok additionally re-uploads allocatable+valid.

        ``unmirrored_exists`` is the speculative-chain relaxation: the
        membership-adopt and scatter-fix paths only need the device
        carry to EQUAL the shadow, which holds as soon as every
        in-flight batch has mirrored -- commits may still be running.
        Only the full-upload path (which takes HOST truth as the new
        carry, so every placement must have landed in the cache) still
        gates on ``pending_exists``. Defaults to ``pending_exists``
        (the conservative pre-pipelining behavior) when not given.

        ``committed_through`` is ``_commit_seq`` as the dispatch read it
        before taking the snapshot ``nt`` was packed from: every pending
        delta whose commit had landed by then leaves the ring first, so
        only batches the host pack really trails are peeled as lag. None
        (a caller with no snapshot ordinal) keeps every delta.
        """
        if unmirrored_exists is None:
            unmirrored_exists = pending_exists
        ds = self._dev
        d = nt.delta
        empty = np.zeros(0, dtype=np.int64)
        with self._shadow_lock:
            ds.pending_deltas = collections.deque(
                (
                    e for e in ds.pending_deltas
                    if not _host_shows(e, committed_through)
                ),
                maxlen=ds.pending_deltas.maxlen,
            )
            layout_ok = (
                d is not None
                and ds.alloc_dev is not None
                and ds.alloc_shadow is not None
                and ds.layout_epoch == d.layout_epoch
                and ds.alloc_shadow.shape == nt.allocatable.shape
            )
            alloc_rows = empty
            member = empty
            member_fix = empty
            carry = "dead"
            div_rows = None
            keep = 0
            if layout_ok:
                changed = self.tensor_cache.rows_changed_since(
                    ds.validated_epoch
                )
                if ds.recheck_rows:
                    changed = np.union1d(changed, np.fromiter(
                        ds.recheck_rows, np.int64, len(ds.recheck_rows)))
                member = self.tensor_cache.membership_rows_since(
                    ds.validated_epoch
                )
                if member.size and unmirrored_exists:
                    # churned slots cannot be reconciled while an
                    # UNMIRRORED batch is in flight: it may have placed
                    # onto a now-retired slot, and adopting host truth
                    # under it would desync the mirror. Once every
                    # in-flight batch has mirrored the carry equals the
                    # shadow and the adopt+scatter is exact, so the
                    # caller only needs to await mirrors (cheap), not a
                    # full drain.
                    return None
                nonmember = changed
                if member.size:
                    nonmember = np.setdiff1d(changed, member)
                if nonmember.size:
                    diff = ~np.all(
                        nt.allocatable[nonmember]
                        == ds.alloc_shadow[nonmember],
                        axis=1,
                    )
                    alloc_rows = nonmember[diff]
                if member.size:
                    # membership rows always ride the static scatter:
                    # alloc content AND validity flip with slot identity
                    alloc_rows = np.union1d(alloc_rows, member)
                if (
                    not overlaid
                    and ds.req_dev is not None
                    and ds.req_shadow is not None
                ):
                    if member.size:
                        member_fix = self._adopt_membership_rows(
                            member, node_requested, node_nzr
                        )
                    ok, div_rows, keep = self._explain_rows(
                        nonmember, node_requested, node_nzr
                    )
                    carry = "reuse" if ok else "diverged"
            static_full = (
                not layout_ok or alloc_rows.size > DELTA_ROW_BUCKET
            )
            fix_rows = empty
            diverged = carry == "diverged"
            if diverged:
                if (
                    not static_full
                    and div_rows.size <= DELTA_ROW_BUCKET
                    and keep == 0  # no pending delta touches a div row
                    and not unmirrored_exists
                ):
                    # resolvable in place: with every in-flight batch
                    # mirrored the carry equals the shadow, so setting
                    # the divergent rows to host truth on device is
                    # exact even with commits still running -- the
                    # speculative chain's cheap rewind (a bind
                    # conflict / quota refund / conflict-requeue
                    # re-solves only against these patched rows)
                    fix_rows = div_rows
                else:
                    carry = "dead"  # resolve by full upload (or drain)
            didx_rows = member_fix
            if fix_rows.size:
                didx_rows = np.union1d(member_fix, fix_rows)
            if didx_rows.size > DELTA_ROW_BUCKET:
                # too many row patches: full upload. `diverged` keeps
                # its value -- a genuine divergence resolved by this
                # upload must still be counted, even when the overflow
                # came from the membership rows
                carry = "dead"
                fix_rows = empty
                didx_rows = empty
            reusable = not static_full and (
                carry == "reuse" or fix_rows.size > 0
            )
            if pending_exists and not reusable:
                # the device carry is ahead of the host by the in-flight
                # placements; uploading host state now would re-place
                # them. Land everything first, then redo the dispatch.
                return None
            if reusable:
                # the fix path requires an empty ring, so keep is only
                # meaningful (a match depth) on the pure-reuse path
                for _ in range(len(ds.pending_deltas) - (keep or 0)):
                    ds.pending_deltas.popleft()
                if alloc_rows.size:
                    ds.alloc_shadow[alloc_rows] = nt.allocatable[alloc_rows]
                    if ds.valid_shadow is not None:
                        ds.valid_shadow[alloc_rows] = nt.valid[alloc_rows]
                if fix_rows.size:
                    ds.req_shadow[fix_rows] = node_requested[fix_rows]
                    ds.nzr_shadow[fix_rows] = node_nzr[fix_rows]
                    self.carry_divergences += 1
                    metrics.carry_divergences.inc()
                    if pending_exists:
                        # the expected deltas diverged under an active
                        # speculative chain and the carry was repaired
                        # in place: the cheap rewind, not a drain
                        self.speculative_rewinds += 1
                        metrics.speculative_rewinds.inc(
                            reason="row_patch"
                        )
                if member.size:
                    self.membership_row_patches += int(member.size)
                ds.validated_epoch = d.epoch
                ds.recheck_rows.clear()
                self.state_reuses += 1
                self.delta_rows_uploaded += int(
                    alloc_rows.size + didx_rows.size
                )
                return {
                    "static_ok": True,
                    "carry_ok": True,
                    "didx": didx_rows,
                    "sidx": alloc_rows,
                    "member": int(member.size),
                }
            # upload path
            if diverged:
                self.carry_divergences += 1
                metrics.carry_divergences.inc()
            static_ok = not static_full and alloc_rows.size == 0
            if not static_ok:
                ds.layout_epoch = (
                    d.layout_epoch if d is not None else -1
                )
                ds.alloc_shadow = nt.allocatable.copy()
                ds.valid_shadow = np.array(nt.valid, dtype=bool)
            ds.req_shadow = node_requested.copy()
            ds.nzr_shadow = node_nzr.copy()
            ds.pending_deltas.clear()
            ds.recheck_rows.clear()
            ds.validated_epoch = d.epoch if d is not None else -1
            self.state_uploads += 1
            return {
                "static_ok": static_ok,
                "carry_ok": False,
                "didx": empty,
                "sidx": empty,
                "member": 0,
            }

    def _compress_decision(
        self, neg, constrained, overlaid, node_requested, node_nzr,
        batch_load16,
    ) -> bool:
        """Engage the int16 carry for THIS dispatch only when it is
        provably lossless: the largest resident column value (shadow
        maxima post-negotiate, or the upload source on a cold path)
        plus this batch's and every unmirrored in-flight batch's
        worst-case column load must stay inside the int16 guard band.
        Books the disengage reasons; the dispatch converts the resident
        carry on a mode flip when it reads it (one tiny on-device kernel
        each way, both warmed). Constrained/overlaid dispatches always
        run uncompressed -- the constrained ladder keeps its
        one-int32-signature contract."""
        ds = self._dev
        carry = ds.req_dev  # read once: the committer may drop it
        resident16 = (
            carry is not None
            and getattr(carry, "dtype", None) == torch.int16
        )
        want = not constrained and not overlaid
        if want:
            with self._shadow_lock:
                if neg["carry_ok"] and ds.req_shadow is not None:
                    resident = max(
                        int(ds.req_shadow.max(initial=0)),
                        int(ds.nzr_shadow.max(initial=0)),
                    )
                else:
                    resident = max(
                        int(node_requested.max(initial=0)),
                        int(node_nzr.max(initial=0)),
                    )
            load = batch_load16 + self._inflight_load16()
            want = resident + load <= _CARRY_COMPRESS_CEILING
            if not want and resident16:
                metrics.carry_compress_disengages.inc(reason="range")
        elif resident16:
            metrics.carry_compress_disengages.inc(reason="mode")
        metrics.carry_compressed.set(1.0 if want else 0.0)
        return want

    def _dispatch_solve(
        self,
        solver_infos: List[PodInfo],
        pod_scheduling_cycle: int,
        inactive_uids=None,
        raise_on_exhaust: bool = False,
    ):
        """Pack + upload + dispatch one solver batch. Returns a pending
        record for _complete_solve, or None when the batch was routed to
        the sequential path. Paths that read host-side cluster state the
        in-flight batch would change (spread counts, nominee overlays,
        incompatible clusters) drain the pipeline first.

        ``raise_on_exhaust`` (the bisection sub-solve mode): a ladder
        exhaustion re-raises to the caller -- after the carry-state
        un-booking -- instead of routing the batch to containment or
        the sequential floor (the bisection loop owns that batch's
        disposition)."""
        if not raise_on_exhaust:
            inj0 = get_injector()
            if inj0 is not None and inj0.should_fire(
                FaultPoint.DEVICE_LOST
            ):
                self._on_device_lost()
        with self._shadow_lock:
            # under the lock: the committer bumps this too, and a lost
            # increment would blind the carry audit's race detector
            self._dispatch_seq += 1
        t_pack = time.perf_counter()
        # -- flight-recorder span: one per dispatch (a gang re-solve or
        # drain-redispatch is honestly its own span), with the per-pod
        # linkage (uid -> batch id, queue-wait, attempts) that makes a
        # pod's whole pod-to-bind path one join
        if flightrecorder.ENABLED:
            now_m = time.monotonic()
            span = flightrecorder.begin_batch(
                len(solver_infos),
                pods=[
                    (pi.pod.metadata.uid,
                     max(0.0, now_m - pi.timestamp), pi.attempts)
                    for pi in solver_infos
                ],
            )
            pop_note = self._pop_note
            if pop_note is not None:
                self._pop_note = None
                work, pop_waited, t_pop0, window_waited, depth = pop_note
                # the drain blocks for arrivals first, then drains:
                # wait span at t_pop0 (the batch window's waits at its
                # end, a child span), work span after it
                if pop_waited:
                    span.stage("pop_wait", pop_waited, t0=t_pop0)
                    if window_waited:
                        span.stage(
                            "window_wait", window_waited,
                            t0=t_pop0 + pop_waited - window_waited,
                        )
                span.stage("pop_batch", work, t0=t_pop0 + pop_waited,
                           args={"queue_depth": depth})
            if inactive_uids:
                span.note(gang_redispatch=True)
            if raise_on_exhaust:
                span.note(bisect=True)
        else:
            span = flightrecorder.NULL_SPAN
        pods = [pi.pod for pi in solver_infos]
        # poison manifestation: any stamped pod in the dispatch fails
        # every ladder tier (PoisonError), driving the exhaustion the
        # bisection containment hangs off; a sub-batch WITHOUT the
        # stamped pod solves normally -- exactly the signature the
        # O(log B) search isolates on
        poison_key = None
        if get_injector() is not None:
            for pod_p in pods:
                if pod_is_poisoned(pod_p):
                    poison_key = pod_p.key()
                    break
        # batch-level constraint aggregates from the cached admission
        # feature bits (scheduler/admission.py): any() over memo reads
        # instead of re-walking every spec per dispatch
        adms = self._memo_admissions(solver_infos)
        has_hard_spread = any(a.hard_spread for a in adms)
        batch_ports = any(a.ports for a in adms)
        has_affinity_terms = any(a.affinity_req for a in adms)
        has_affinity = has_affinity_terms or batch_ports
        has_required_anti = any(a.required_anti for a in adms)
        prof0 = self.profiles.get(pods[0].spec.scheduler_name)
        # gated on the profile actually scoring with InterPodAffinity --
        # otherwise the ipa family packs nothing and draining for it
        # would serialize the pipeline for free
        ipa_weight = (
            prof0.score_plugin_weights().get("InterPodAffinity", 0)
            if prof0 is not None
            else 0
        )
        score_dynamic = (
            any(a.score_soft for a in adms)
            or (
                bool(ipa_weight)
                and any(a.score_pref for a in adms)
            )
            or batch_selector_spread_live(
                pods, prof0.informers if prof0 is not None else None
            )
        )
        # this batch's pods become symmetric scorers for later batches
        # once placed (preferred terms, and required affinity terms via
        # hardPodAffinityWeight)
        has_scoring_terms = bool(ipa_weight) and any(
            a.scoring_terms for a in adms
        )
        nominated_by_node = self.queue.all_nominated_pods_by_node()

        def drained(reason_predicate: bool) -> bool:
            """Land every in-flight batch when the predicate holds, then
            rebuild the drain-sensitive inputs (nominee overlay source;
            callers refresh the snapshot themselves when they hold one).
            Returns True when a drain happened."""
            nonlocal nominated_by_node
            if not reason_predicate or not self._pending_exists():
                return False
            self.pipeline_drains += 1
            # the dispatcher's wait for the in-flight batches to land: a
            # child of the pack stage, summed apart as drain_wait
            t_drain = time.perf_counter()
            self._drain_pending()
            dt_drain = time.perf_counter() - t_drain
            self._stage_add("drain_wait", dt_drain)
            span.stage("drain_wait", dt_drain, t0=t_drain)
            # the drain can assume previously nominated pods (dropping
            # their nomination) and nominate new ones via preemption --
            # rebuild the overlay source from the post-drain state
            nominated_by_node = self.queue.all_nominated_pods_by_node()
            return True

        nominee_uids = (
            {
                p.metadata.uid
                for noms in nominated_by_node.values()
                for p in noms
            }
            if nominated_by_node else set()
        )
        drained(
            has_hard_spread or has_affinity_terms or score_dynamic
            # a port batch must see in-flight PORT placements committed
            # into the static mask; port-free in-flight batches cannot
            # conflict, so they don't force the drain
            or (batch_ports and self._pending_has_ports())
            # an in-flight batch carrying required anti-affinity or
            # scoring-relevant terms imposes symmetric constraints this
            # batch can only see once its placements are committed
            or self._pending_has_required_anti()
            or self._pending_has_scoring_terms()
            # a batch RETRYING preemption nominees must see the fully
            # committed post-eviction state, or in-flight placements
            # race it onto the freed capacity and cascade re-preemption
            # (the old answer -- drain while ANY nomination lived --
            # serialized every post-preemption dispatch; this drains
            # only the nominees' own retry batches)
            or any(
                pi.pod.metadata.uid in nominee_uids
                for pi in solver_infos
            )
        )

        snapshot = self.algorithm.snapshot
        committed_through = self._commit_seq
        self.cache.update_snapshot(snapshot)
        # existing pods with required anti-affinity constrain EVERY
        # incoming pod symmetrically (filtering.go:404) -- such clusters
        # need the affinity tensors even for batches without affinity, and
        # their counts must include any in-flight placements
        if not has_affinity_terms and cluster_has_required_anti_affinity(
            snapshot
        ):
            has_affinity = True
            has_affinity_terms = True
            if drained(True):
                committed_through = self._commit_seq
                self.cache.update_snapshot(snapshot)
        # existing pods with symmetric scoring terms make EVERY batch's
        # preferred-affinity family live (scoring.go:111): the in-flight
        # counts must land before packing
        cluster_ipa = bool(ipa_weight) and cluster_has_affinity_scoring(
            snapshot
        )
        if not score_dynamic and cluster_ipa:
            score_dynamic = True
            if drained(True):
                committed_through = self._commit_seq
                self.cache.update_snapshot(snapshot)
                cluster_ipa = cluster_has_affinity_scoring(snapshot)
        if nominated_by_node and (
            has_hard_spread or has_affinity or score_dynamic
            # a CONSTRAINED nominee (required (anti-)affinity / spread)
            # imposes symmetric constraints the resource-only overlay
            # can't express even for a plain batch
            or any(
                p.spec.affinity is not None
                and (
                    p.spec.affinity.pod_affinity is not None
                    or p.spec.affinity.pod_anti_affinity is not None
                )
                or p.spec.topology_spread_constraints
                for noms in nominated_by_node.values()
                for p in noms
            )
        ):
            # ADVICE r2 (medium): nominees are overlaid as RESOURCES
            # only; the affinity/spread/score count tensors pack from
            # the snapshot, which excludes them, so a constrained device
            # batch could violate a nominee's symmetric constraints.
            # The host path runs _add_nominated_pods exactly
            # (generic_scheduler.go:535) -- take it for this rare
            # combination (active nominations + constraints on either
            # side).
            self._drain_pending()
            self.nominee_constrained_fallbacks += 1
            span.finish(
                tier=TIER_SEQUENTIAL, routed="nominee_constrained"
            )
            for pi in solver_infos:
                self.pods_fallback += 1
                self.attempt_schedule(pi)
            return None
        with flightrecorder.substep("nt.update", span):
            nt = self.tensor_cache.update(snapshot)
        with flightrecorder.substep("pack_pod_batch", span):
            batch = pack_pod_batch(
                pods, nt.dims,
                timestamps=[pi.timestamp for pi in solver_infos],
            )
        with flightrecorder.substep("static_mask", span):
            mask_rows, mask_index = static_mask_compact(pods, snapshot, nt)
        # pods requesting resources no node advertises are unsatisfiable:
        # point them at a dedicated all-False row
        if batch.unsatisfiable.any():
            mask_rows = np.concatenate(
                [mask_rows, np.zeros((1, nt.capacity), dtype=bool)]
            )
            mask_index = mask_index.copy()
            mask_index[batch.unsatisfiable] = mask_rows.shape[0] - 1

        # Nominated-pod overlay: reserve capacity for preemption nominees
        # (the batch analogue of _add_nominated_pods' virtual add,
        # generic_scheduler.go:535). Conservatively reserves for ALL
        # nominees EXCEPT pods already being placed: this batch's own
        # members and pods inside in-flight batches (their placement
        # rides the device carry; overlaying them too would double-count
        # and spuriously starve nodes -- the old answer was a full
        # pipeline drain per dispatch while ANY nomination lived, which
        # serialized the dispatcher against the committer for the whole
        # post-preemption burst).
        node_requested, node_nzr = nt.requested, nt.non_zero_requested
        # skip the overlay for pods being placed RIGHT NOW: this batch's
        # members and pods inside dispatched-but-not-yet-committing
        # batches (their placement rides the device carry; overlaying
        # them too over-reserves their nodes and cascades spurious
        # preemption). The mid-COMMIT head batch is NOT excluded: its
        # failures are being requeued with live nominations by the
        # deferred wave at this very moment, and their reservations
        # must stand.
        batch_uids = {pi.pod.metadata.uid for pi in solver_infos}
        with self._pending_cv:
            for pend in self._pending_q:
                if not pend.get("committing"):
                    batch_uids.update(
                        pi.pod.metadata.uid
                        for pi in pend["solver_infos"]
                    )
        overlay_pods = []
        overlay_rows = []
        for node_name, nominated in nominated_by_node.items():
            if node_name not in nt.names:
                continue
            j = nt.row(node_name)
            for npod in nominated:
                if npod.metadata.uid in batch_uids:
                    continue
                overlay_pods.append(npod)
                overlay_rows.append(j)
        overlaid = bool(overlay_pods)
        if overlaid:
            node_requested = node_requested.copy()
            node_nzr = node_nzr.copy()
            nbatch = pack_pod_batch(overlay_pods, nt.dims)
            np.add.at(
                node_requested, np.asarray(overlay_rows), nbatch.requests
            )
            np.add.at(
                node_nzr, np.asarray(overlay_rows),
                nbatch.non_zero_requests,
            )

        b = batch.size
        # the kernel takes any batch size without a rebuild, so a batch
        # pads only to the next POD_BUCKET: a short batch walks only its
        # own pods, not max_batch padding steps
        padded = POD_BUCKET * math.ceil(b / POD_BUCKET)
        order = batch.order
        # -- tenant fairness bias (scheduler/tenancy.py): within each
        # priority level, re-merge the solve order so the tenant with
        # the lowest virtual dominant share places next -- the solve
        # order IS the arbitration point of the sequential-replay scan,
        # so every mode (greedy, constrained, sinkhorn, mesh) honors the
        # bias with no kernel change. Single-tenant batches exit after
        # one namespace sweep.
        tt = self.tenant_shares
        if tt is not None and b > 1:
            from kubernetes_tpu_torch.scheduler.tenancy import fair_order

            tt.refresh_capacity(nt)
            order = fair_order(order, pods, batch.priorities, tt)
        req = np.zeros((padded, nt.dims.num_dims), dtype=np.int32)
        nzr = np.zeros((padded, 2), dtype=np.int32)
        midx = np.zeros(padded, dtype=np.int32)
        active = np.zeros(padded, dtype=bool)
        req[:b] = batch.requests[order]
        nzr[:b] = batch.non_zero_requests[order]
        midx[:b] = mask_index[order]
        active[:b] = True
        if inactive_uids:
            # gang quorum fixup: masked group members solve to NO_NODE
            for k in range(b):
                if (
                    solver_infos[int(order[k])].pod.metadata.uid
                    in inactive_uids
                ):
                    active[k] = False
        u = mask_rows.shape[0]
        u_padded = MASK_ROW_BUCKET * math.ceil(u / MASK_ROW_BUCKET)
        rows = np.zeros((u_padded, nt.capacity), dtype=bool)
        rows[:u] = mask_rows

        # hard topology-spread constraints solve on device via the
        # group-count scan (ops/topology.py); required (anti-)affinity via
        # the count-tensor replay (ops/affinity.py)
        # non-resource score plugins: pack when they can influence ranking
        # (dynamic families already forced a pipeline drain above, so the
        # snapshot these counts come from includes in-flight placements)
        ordered_pods = [pods[int(i)] for i in order]
        try:
            hard_w = 1
            if prof0 is not None:
                ipa_plugin = prof0.plugin_instance("InterPodAffinity")
                hard_w = getattr(
                    ipa_plugin, "hard_pod_affinity_weight", 1
                ) if ipa_plugin is not None else 1
            with flightrecorder.substep("pack_score_batch", span):
                score_batch = pack_score_batch(
                    ordered_pods, snapshot, nt,
                    prof0.informers if prof0 is not None else None,
                    prof0.score_plugin_weights()
                    if prof0 is not None else {},
                    hard_pod_affinity_weight=hard_w,
                    cluster_affinity_scoring=cluster_ipa,
                )
        except ScoreEnvelopeExceeded:
            # the sequential path filters against the host cache, which
            # must include every in-flight placement
            self.envelope_fallbacks += 1
            self._drain_pending()
            span.finish(tier=TIER_SEQUENTIAL, routed="score_envelope")
            for pi in solver_infos:
                self.pods_fallback += 1
                self.attempt_schedule(pi)
            return None

        spread = None
        affinity = None
        if has_hard_spread:
            with flightrecorder.substep("pack_spread_batch", span):
                spread = pack_spread_batch(ordered_pods, snapshot, nt)
            if spread is None:
                # envelope exceeded: host path keeps full correctness
                self.envelope_fallbacks += 1
                span.finish(
                    tier=TIER_SEQUENTIAL, routed="spread_envelope"
                )
                for pi in solver_infos:
                    self.pods_fallback += 1
                    self.attempt_schedule(pi)
                return None
        if has_affinity:
            with flightrecorder.substep("pack_affinity_batch", span):
                affinity = pack_affinity_batch(ordered_pods, snapshot, nt)
            if affinity is None and has_affinity_terms:
                # envelope exceeded (real affinity/exist rows expected
                # but the packer bailed): the host path keeps full
                # correctness -- port-only batches fall through to the
                # port-row builder instead
                self.envelope_fallbacks += 1
                span.finish(
                    tier=TIER_SEQUENTIAL, routed="affinity_envelope"
                )
                for pi in solver_infos:
                    self.pods_fallback += 1
                    self.attempt_schedule(pi)
                return None
            if batch_ports:
                # within-batch host-port conflicts ride synthetic anti
                # rows (ops/affinity.add_host_port_rows); existing-pod
                # conflicts are already in the static mask
                affinity = add_host_port_rows(
                    ordered_pods, snapshot, nt, affinity
                )
                if affinity is None:
                    # port-row envelope exceeded: the sequential filter
                    # must see every in-flight placement committed (a
                    # port-only batch may not have drained above)
                    self._drain_pending()
                    self.envelope_fallbacks += 1
                    span.finish(
                        tier=TIER_SEQUENTIAL, routed="port_envelope"
                    )
                    for pi in solver_infos:
                        self.pods_fallback += 1
                        self.attempt_schedule(pi)
                    return None

        dt_pack = time.perf_counter() - t_pack
        self._stage_add("pack", dt_pack)
        span.stage("pack", dt_pack, t0=t_pack)
        span.note(padded=padded)
        solve_timer = metrics.SinceTimer(metrics.batch_solve_duration)

        # preemption prewarm: when the batch's most demanding request
        # fits on NO node right now, failures (and a preemption wave)
        # are coming -- build + upload the victim pack on a helper
        # thread WHILE the solve runs, instead of paying the ~0.25s
        # pack + ~5MB upload inside the wave
        if self.preemptor is not None and b:
            free_nodes = nt.allocatable - node_requested  # [N, R]
            req_max = req[:b].max(axis=0)
            if not (
                (free_nodes >= req_max).all(axis=1) & nt.valid
            ).any():
                self.preemptor.prewarm_pack_async()

        constrained = (
            spread is not None
            or affinity is not None
            or score_batch is not None
        )

        # -- device-state generation handshake (see _DeviceNodeState) -------
        # Runs after every route-to-host bail-out above: it reconciles the
        # shadow bookkeeping on the assumption that the decided upload /
        # scatter actually reaches the device this dispatch.
        ds = self._dev
        neg = self._negotiate_device_state(
            nt, node_requested, node_nzr, overlaid,
            pending_exists=self._pending_exists(),
            unmirrored_exists=self._unmirrored_exists(),
            committed_through=committed_through,
        )
        if neg is None and self._await_mirrors():
            # the blocked path (membership adopt / divergence repair)
            # only needs the carry to equal the shadow, which holds the
            # moment every in-flight batch has MIRRORED -- so wait for
            # the mirrors (the committer signals them; typically a few
            # ms) and renegotiate before paying a full pipeline drain
            retry = self._negotiate_device_state(
                nt, node_requested, node_nzr, overlaid,
                pending_exists=self._pending_exists(),
                unmirrored_exists=False,
                committed_through=committed_through,
            )
            if retry is not None:
                self.speculative_rewinds += 1
                metrics.speculative_rewinds.inc(reason="mirror_wait")
            neg = retry
        if neg is None:
            # the handshake needs an upload but the device carry is ahead
            # of the host by the in-flight batches (node churn, bind
            # failure, dead carry): land them, then redo this dispatch
            # from the fresh host state
            if self._pending_exists():
                self.speculative_rewinds += 1
                metrics.speculative_rewinds.inc(reason="drain")
            self._drain_pending()
            span.finish(routed="drain_redispatch")
            return self._dispatch_solve(
                solver_infos, pod_scheduling_cycle,
                inactive_uids=inactive_uids,
            )
        static_ok = neg["static_ok"]
        carry_ok = neg["carry_ok"]
        span.note(
            carry=(
                "delta" if carry_ok and (
                    neg["didx"].size or neg["sidx"].size
                ) else "reuse" if carry_ok else "upload"
            ),
            delta_rows=int(neg["didx"].size + neg["sidx"].size),
        )
        compress = False
        batch_load16 = 0
        if self.carry_compress_enabled:
            batch_load16 = _batch_load16(req, nzr, b)
            compress = self._compress_decision(
                neg, constrained, overlaid, node_requested, node_nzr,
                batch_load16,
            )
            if compress:
                span.note(compressed=True)
        # the resident state this solve consumes, read once under the
        # lock (an injected corruption landing mid-dispatch is carried
        # into its output). The committer's recovery of a failed batch
        # drops the carry on its own thread, so what the handshake
        # negotiated may be gone by now: then the negotiation is undone
        # and the dispatch redone from the host state, as a drain is
        with self._shadow_lock:
            alloc_in, valid_in = (
                (ds.alloc_dev, ds.valid_dev) if static_ok else (None, None)
            )
            req_in, nzr_in = (
                (ds.req_dev, ds.nzr_dev) if carry_ok else (None, None)
            )
            dropped = (static_ok and alloc_in is None) or (
                carry_ok and (req_in is None or ds.req_shadow is None)
            )
            if dropped:
                self._unbook_dispatch(neg)
            elif carry_ok and (req_in.dtype == torch.int16) != compress:
                # the int16 mode flipped: convert the resident carry
                req_in, nzr_in = (
                    compress_carry if compress else decompress_carry
                )(req_in, nzr_in)
                ds.req_dev, ds.nzr_dev = req_in, nzr_in
        if dropped:
            self.carry_drop_redispatches += 1
            flightrecorder.mark("carry_dropped_mid_dispatch")
            if self._pending_exists():
                self.speculative_rewinds += 1
                metrics.speculative_rewinds.inc(reason="drain")
            self._drain_pending()
            span.finish(routed="carry_drop_redispatch")
            return self._dispatch_solve(
                solver_infos, pod_scheduling_cycle,
                inactive_uids=inactive_uids,
            )
        # single-buffer upload: the whole batch rides ONE int32 buffer and
        # ONE host->device copy, re-sliced (and bitcast for float
        # tensors) on the device (ops/assignment.py solve_packed)
        pieces = [
            ("req", req),
            ("nzr", nzr),
            ("midx", midx),
            ("active", active.astype(np.int32)),
            ("rows", mask_rows_upload(rows, self.mesh)),
        ]
        if not static_ok:
            pieces.append(("alloc", nt.allocatable))
            pieces.append(("valid", nt.valid.astype(np.int32)))
        if not carry_ok:
            if compress:
                # cold/refresh upload with the gate engaged: the carry
                # ships packed int16 ('h' kind, half the link bytes) and
                # stays int16 on the device
                pieces.append(
                    ("req_state", node_requested.astype(np.int16))
                )
                pieces.append(("nzr_state", node_nzr.astype(np.int16)))
            else:
                pieces.append(("req_state", node_requested))
                pieces.append(("nzr_state", node_nzr))
        else:
            # steady state: the resident [N, R] tensors stay on the
            # device; only the changed-row scatter rides the buffer
            pieces += _delta_slot_pieces(
                nt.capacity, nt.dims.num_dims,
                fix_rows=neg["didx"], alloc_rows=neg["sidx"],
                node_requested=node_requested, node_nzr=node_nzr,
                allocatable=nt.allocatable, valid=nt.valid,
                compress=compress,
            )
        if constrained:

            def fam_pieces(prefix, packed_arrs, noop_arrs):
                """Present families ride the buffer; absent ones become
                ConstPiece markers (constants made on the device instead
                of ~1MB of uploaded zeros/sentinels per batch)."""
                if packed_arrs is not None:
                    for i, a in enumerate(packed_arrs):
                        pieces.append((f"{prefix}{i}", np.asarray(a)))
                else:
                    for i, a in enumerate(noop_arrs):
                        pieces.append(
                            (f"{prefix}{i}", ConstPiece.from_uniform(a))
                        )

            fam_pieces(
                "sp",
                pad_spread_tensors(spread, padded)
                if spread is not None else None,
                noop_spread_tensors(padded, nt.capacity),
            )
            fam_pieces(
                "af",
                pad_affinity_tensors(affinity, padded)
                if affinity is not None else None,
                noop_affinity_tensors(padded, nt.capacity),
            )
            fam_pieces(
                "sc",
                pad_score_tensors(score_batch, padded)
                if score_batch is not None else None,
                noop_score_tensors(padded, nt.capacity),
            )
        solve_mode = "constrained" if constrained else self.solver_mode

        # the hang the injector handed each device attempt, newest last:
        # the ladder reads it to tell an injected hang from the card's
        hangs: List[float] = []
        on_card = self._device_tier() in CARD_TIERS
        watchdog_s = (
            self.ladder.config.solve_timeout_seconds
            if self.ladder.config.enabled else 0.0
        )

        # the kernel launches of the attempt that answered, as CUDA event
        # pairs (only while the trace is armed on the card): the
        # committer writes them onto the trace's device track
        launched: list = []

        def run_device():
            if poison_key is not None:
                raise PoisonError(poison_key)
            inj = get_injector()
            if inj is not None:
                hang = inj.hang_seconds_maybe(
                    FaultPoint.DEVICE_SOLVE_HANG
                )
                hangs.append(hang)
                if hang > 0:
                    time.sleep(hang)
                    if on_card and 0 < watchdog_s <= hang:
                        # the watchdog gave up on this attempt: a wedged
                        # device answers nothing, so no late launch
                        raise FaultInjected(FaultPoint.DEVICE_SOLVE_HANG)
                inj.raise_maybe(FaultPoint.DEVICE_SOLVE)
            sink = flightrecorder.collect_launches()
            try:
                return solve_packed(
                    pieces,
                    alloc_in,
                    valid_in,
                    req_in,
                    nzr_in,
                    config=self.solver_config,
                    mode=solve_mode,
                    compress=compress,
                    device=self.device,
                    mesh=self.mesh,
                )
            finally:
                if sink is not None:
                    flightrecorder.close_launches()
                    launched[:] = sink

        def run_host_greedy():
            if poison_key is not None:
                # the malformed row poisons the host replay too (it
                # packs from the same arrays); only the per-pod
                # sequential oracle fails it ALONE
                raise PoisonError(poison_key)
            a, r_out, z_out = host_greedy_assign(
                nt.allocatable, node_requested, node_nzr, nt.valid,
                req, nzr, rows, midx, active,
                config=self.solver_config,
            )
            return a, r_out, z_out, None, None

        attempts = [(self._device_tier(), run_device)]
        # the host tier needs host state that reflects EVERY placement;
        # with batches in flight the device carry is ahead of
        # node_requested, so the tier is only offered when nothing is
        # pending (exhaustion with pending batches drains and
        # redispatches from fresh host state instead). It is never
        # offered while the solver's tensors are on the card: a failure
        # there raises instead of moving the batch to the CPU. It
        # replays the unconstrained scan only, so a constrained batch
        # never gets it.
        if (
            self.device.type == "cpu"
            and not constrained
            and not self._pending_exists()
        ):
            attempts.append((TIER_HOST_GREEDY, run_host_greedy))
        # pre-solve carry refs: the gang quorum fixup restores these to
        # rewind a re-solved batch to its pre-batch device state without
        # a re-upload (only exact when no row fixes rode this dispatch;
        # the solve never writes its inputs, so the refs stay intact)
        carry_in = (
            (req_in, nzr_in)
            if carry_ok and not neg["didx"].size
            else None
        )
        try:
            t_solve = time.perf_counter()
            # only the card's tier reads the hangs (the CPU's ladder
            # answers a timeout as the JAX package does)
            hang_kw = (
                {"injected_hang": lambda: bool(hangs) and hangs[-1] > 0}
                if on_card else {}
            )
            tier, out = self.ladder.run(
                attempts, label=f"batch b={b}", **hang_kw
            )
            dt_solve = time.perf_counter() - t_solve
            self._stage_add("device_solve", dt_solve)
            span.stage("device_solve", dt_solve, t0=t_solve)
            self._jit_watch.refresh()
        except LadderExhausted as exhaust_err:
            injected = isinstance(exhaust_err.__cause__, FaultInjected)
            if injected:
                self.injected_exhaustions += 1
            with self._shadow_lock:
                self._unbook_dispatch(neg)
            if raise_on_exhaust:
                # bisection sub-solve: the caller owns this group's
                # disposition (split further or isolate)
                span.finish(routed="bisect_exhausted")
                raise
            if self._pending_exists():
                # in-flight batches blocked the host tier: land them
                # (the committer's own recovery handles their failures),
                # then redo this dispatch from fresh host state with the
                # breakers now routing around the sick tiers
                self._drain_pending()
                span.finish(routed="exhausted_redispatch")
                return self._dispatch_solve(
                    solver_infos, pod_scheduling_cycle,
                    inactive_uids=inactive_uids,
                )
            return self._contain_exhausted_batch(
                solver_infos, pod_scheduling_cycle, span,
                inactive_uids,
                poisoned=isinstance(
                    exhaust_err.__cause__, PoisonError
                ),
                injected=injected and on_card,
            )
        except (CardFault, SchedulerCrashed):
            raise
        except Exception as card_err:
            if not on_card:
                raise
            # a fault of the card's solve (a kernel that cannot launch,
            # a CUDA error, a hang no injector made): the scheduler
            # halts on it, it never requeues the work to meet it again
            span.finish(routed="card_fault")
            raise CardFault(
                f"the solve failed on the card: {card_err!r}"
            ) from card_err
        assignments_dev, req_out, nzr_out, alloc_out, valid_out = out
        if tier == TIER_HOST_GREEDY:
            # the host tier solved from host state and no device solve
            # ran: undo any bookkeeping that assumed the device saw this
            # dispatch (incl. the link-traffic counters -- no upload /
            # row scatter actually happened)
            with self._shadow_lock:
                if carry_ok:
                    self.delta_rows_uploaded -= int(
                        neg["didx"].size + neg["sidx"].size
                    )
                    self.membership_row_patches -= neg["member"]
                else:
                    self.state_uploads -= 1
                if neg["sidx"].size or not static_ok:
                    # alloc patch / full static upload never landed
                    ds.alloc_dev = None
                    ds.valid_dev = None
                if (
                    carry_ok
                    and not neg["didx"].size
                    and not overlaid
                    and ds.req_dev is not None
                ):
                    # the host tier was only offered with nothing in
                    # flight and a validated carry, so its input state
                    # EQUALS the device carry: scatter-add its own
                    # assignment output onto the resident state
                    # (ops/assignment.apply_assignment_delta) and keep
                    # the carry warm instead of dropping it
                    ds.req_dev, ds.nzr_dev = apply_assignment_delta(
                        ds.req_dev, ds.nzr_dev,
                        np.asarray(assignments_dev, dtype=np.int32),
                        req, nzr,
                    )
                else:
                    ds.invalidate_carry()
        else:
            # a device solve LANDED: the booked upload / scatter is
            # established device state -- mirror the internal counters
            # into the (monotonic) Prometheus series now, when the
            # booking is final (the host-tier / exhausted branches
            # un-book the attributes and book nothing here)
            if carry_ok:
                if neg["didx"].size or neg["sidx"].size:
                    metrics.delta_rows_uploaded.inc(
                        int(neg["didx"].size + neg["sidx"].size)
                    )
            else:
                metrics.state_uploads.inc()
                if self._device_lost_at is not None:
                    self._note_device_rebuilt()
            if compress:
                # link bytes the int16 packing kept off the wire this
                # dispatch (half of what the int32 form ships)
                metrics.carry_compress_bytes_saved.inc(
                    2 * DELTA_ROW_BUCKET * (nt.dims.num_dims + 2)
                    if carry_ok
                    else 2 * (node_requested.size + node_nzr.size)
                )
            if not static_ok:
                ds.alloc_dev, ds.valid_dev = alloc_out, valid_out
            elif neg["sidx"].size:
                # the in-buffer scatter patched the resident alloc (and,
                # for membership churn, the valid mask); keep the
                # patched tensors
                ds.alloc_dev, ds.valid_dev = alloc_out, valid_out
            if overlaid:
                ds.invalidate_carry()
            else:
                with self._shadow_lock:
                    if req_in is not None and ds.corrupted_from is req_in:
                        # CARRY_CORRUPT hit the carry this solve had
                        # already read: the corruption stays resident
                        # instead of vanishing under the solve's output
                        req_out = _bump_carry_row(req_out, ds.corrupt_row)
                        ds.corrupted_from = None
                    ds.req_dev, ds.nzr_dev = req_out, nzr_out
        span.note(tier=tier)
        return {
            "tier": tier,
            "carry_in": carry_in,
            "span": span,
            "solver_infos": list(solver_infos),
            "has_required_anti": has_required_anti,
            "has_ports": batch_ports,
            "has_scoring_terms": has_scoring_terms,
            "order": order,
            "assignments_dev": assignments_dev,
            "download": self._eager_download(assignments_dev),
            "launched": launched,
            "req": req,
            "nzr": nzr,
            "b": b,
            "names": nt.names,
            "num_nodes": nt.num_nodes,
            "snapshot": snapshot,
            "cycle": pod_scheduling_cycle,
            "overlaid": overlaid,
            "solve_timer": solve_timer,
            "mask_rows": mask_rows,
            "mask_index_solved": midx,
            "load16": batch_load16,
        }

    def _unbook_dispatch(self, neg) -> None:
        """No device solve LANDED for the negotiation ``neg``, so the
        booked upload / scatter never became device state: drop the carry
        and un-book the counters (a drain-and-redispatch would book the
        batch again). A device tier that uploaded and then failed still
        paid the link traffic; that cost is attributed by
        solves_by_tier/breaker metrics, not here -- state_uploads counts
        established state. The caller holds ``_shadow_lock``."""
        ds = self._dev
        ds.invalidate_carry()
        if neg["carry_ok"]:
            self.state_reuses -= 1
            self.delta_rows_uploaded -= int(
                neg["didx"].size + neg["sidx"].size
            )
            self.membership_row_patches -= neg["member"]
        else:
            self.state_uploads -= 1
        if neg["sidx"].size or not neg["static_ok"]:
            # the alloc row patch / full static upload never reached the
            # device (no solve ran) but the shadow already claims it:
            # drop the resident alloc so the next dispatch re-uploads
            # instead of trusting it
            ds.alloc_dev = None
            ds.valid_dev = None

    # -- blast-radius containment (robustness/containment.py) ----------------

    @property
    def injected_retries(self) -> int:
        """In-place retries of an injected solver fault (the ladder's
        count); with ``injected_exhaustions``, every DEVICE_SOLVE fire."""
        return self.ladder.injected_retries

    def _note_exhaust_sig(self, solver_infos: List[PodInfo]) -> bool:
        """Track the exhausted-batch uid signature; True when the SAME
        batch has now fallen whole at least twice in a row (a retry
        storm, not a transient)."""
        sig = frozenset(
            pi.pod.metadata.uid for pi in solver_infos
        )
        if sig and sig == self._last_exhaust_sig:
            self._exhaust_repeats += 1
        else:
            self._last_exhaust_sig = sig
            self._exhaust_repeats = 1
        return self._exhaust_repeats >= 2

    def _contain_exhausted_batch(
        self, solver_infos: List[PodInfo], pod_scheduling_cycle: int,
        span, inactive_uids, poisoned: bool = False, injected: bool = False,
    ):
        """Disposition of a ladder-exhausted batch with nothing in
        flight. Tracks the crash-loop signature (an identical batch
        exhausting twice in a row is a retry storm, not a transient),
        then: multi-pod batches take the bisection search, a
        crash-looping singleton goes straight to quarantine, and
        everything else (containment off, gang batches, first-time
        singletons) keeps the sequential-floor fallback. ``injected``
        (the card, an injected fault's exhaustion) is never a crash
        loop: the fault is the injector's, not the batch's, so no pod
        of it is quarantined for it."""
        crashloop = not injected and self._note_exhaust_sig(solver_infos)
        if crashloop:
            metrics.exhausted_crashloops.inc()
            flightrecorder.mark(
                "exhausted_crashloop", pods=len(solver_infos),
                repeats=self._exhaust_repeats,
            )
            logger.warning(
                "ladder_exhausted crash loop: the same %d-pod batch "
                "exhausted %d times in a row; engaging containment",
                len(solver_infos), self._exhaust_repeats,
            )
        cc = self.containment_config
        gang = any(
            pi.pod.metadata.labels.get(POD_GROUP_LABEL)
            for pi in solver_infos
        )
        if not cc.enabled or inactive_uids or gang:
            # gang batches never bisect (a split would break the
            # all-or-nothing quorum semantics); the sequential path
            # keeps full correctness for them
            return self._exhausted_sequential(
                solver_infos, pod_scheduling_cycle, span
            )
        if len(solver_infos) == 1:
            if crashloop or poisoned:
                # the singleton itself is the poison (typed cause, or
                # the same batch exhausting repeatedly): no batch left
                # to protect, but redispatching it forever is the
                # retry storm -- strike it into quarantine
                span.finish(routed="quarantine")
                self._quarantine_isolated(
                    solver_infos[0],
                    reason="poison" if poisoned else "crashloop",
                )
                return None
            # first exhaustion of a singleton may be transient (breaker
            # cool-offs, a blocked host tier): one sequential attempt
            return self._exhausted_sequential(
                solver_infos, pod_scheduling_cycle, span
            )
        span.finish(routed="bisect")
        self._bisect_batch(
            solver_infos, pod_scheduling_cycle, force=crashloop
        )
        return None

    def _exhausted_sequential(
        self, solver_infos: List[PodInfo], pod_scheduling_cycle: int,
        span,
    ):
        """The pre-containment floor: the whole batch runs the per-pod
        sequential oracle. On the card there is no CPU floor: the batch
        requeues, and K1 solves its pods at their next pop."""
        if self.device.type == "cuda":
            span.finish(routed="exhausted_requeue")
            self._requeue_for_card(
                solver_infos, pod_scheduling_cycle, "solver ladder exhausted"
            )
            return None
        metrics.solver_fallbacks.inc(
            tier=TIER_SEQUENTIAL, reason="ladder_exhausted"
        )
        flightrecorder.mark(
            "fallback", tier=TIER_SEQUENTIAL,
            reason="ladder_exhausted",
        )
        span.finish(
            tier=TIER_SEQUENTIAL, routed="ladder_exhausted"
        )
        self.ladder.record_sequential(len(solver_infos))
        logger.warning(
            "solver ladder exhausted; %d pods take the "
            "sequential oracle path", len(solver_infos),
        )
        for pi in solver_infos:
            self.pods_fallback += 1
            self.attempt_schedule(pi)
        return None

    def _bisect_batch(
        self, solver_infos: List[PodInfo], pod_scheduling_cycle: int,
        force: bool = False,
    ) -> None:
        """O(log B) poison isolation: split the exhausted batch and
        re-solve each half synchronously (the kernel takes any batch
        size, so no sub-solve builds anything). Halves that solve COMMIT
        at their normal device tier -- the healthy pods' blast radius
        ends here; halves that exhaust again split further until the
        offenders are singletons, which go to the quarantine ledger.

        Systemic-failure guard: ``bisect_abort_after`` isolated
        singletons with ZERO successful sub-solves means every subset
        fails -- a sick device, not a poison signature -- and the run
        aborts to the sequential floor. ``force`` (set by the
        crash-loop detector) disables the guard: a batch that already
        exhausted repeatedly must not keep redispatching."""
        cc = self.containment_config
        t0 = time.perf_counter()
        self.bisections += 1
        metrics.bisections.inc()
        flightrecorder.mark(
            "bisect_start", pods=len(solver_infos), force=force
        )
        mid = len(solver_infos) // 2
        work: "collections.deque" = collections.deque(
            [solver_infos[:mid], solver_infos[mid:]]
        )
        # (pod_info, typed_poison) -- a singleton isolated by a TYPED
        # PoisonError always quarantines; untyped isolations are only
        # trusted once some sibling sub-solve succeeded (else they are
        # indistinguishable from a systemic device failure). On the card
        # a singleton whose sub-solve an injected fault exhausted counts
        # as untyped for the abort guard, but is requeued for K1, never
        # quarantined: the fault was the injector's
        isolated: List[Tuple[PodInfo, bool]] = []
        injected_out: List[PodInfo] = []
        done_uids: set = set()
        successes = 0
        subsolves = 0
        aborted = False

        def untyped_isolated() -> int:
            return sum(1 for _pi, typed in isolated if not typed)

        while work:
            if (
                not force
                and successes == 0
                and untyped_isolated() >= cc.bisect_abort_after
            ):
                aborted = True
                break
            group = list(work.popleft())
            subsolves += 1
            metrics.bisect_subsolves.inc()
            try:
                pending = self._dispatch_solve(
                    group, pod_scheduling_cycle, raise_on_exhaust=True
                )
            except SchedulerCrashed:
                raise
            except Exception as sub_err:  # noqa: BLE001 - split again
                if self.device.type == "cuda" and not isinstance(
                    sub_err, (LadderExhausted, PoisonError)
                ):
                    raise  # a card fault, not the group's content
                if len(group) == 1:
                    # LadderExhausted-from-PoisonError, or a bare
                    # PoisonError
                    typed = isinstance(sub_err, PoisonError) or (
                        isinstance(sub_err, LadderExhausted)
                        and isinstance(sub_err.__cause__, PoisonError)
                    )
                    isolated.append((group[0], typed))
                    if (
                        self.device.type == "cuda"
                        and isinstance(sub_err, LadderExhausted)
                        and isinstance(sub_err.__cause__, FaultInjected)
                    ):
                        injected_out.append(group[0])
                    flightrecorder.mark(
                        "bisect_isolated",
                        pod=group[0].pod.metadata.uid,
                        typed=typed,
                    )
                else:
                    m = len(group) // 2
                    # left-first DFS: committed groups land in the
                    # original pod order, so healthy placements match
                    # the no-poison batch bit-for-bit
                    work.appendleft(group[m:])
                    work.appendleft(group[:m])
                continue
            if pending is None:
                # the dispatch itself routed the group (envelope bails,
                # nested containment): those paths already disposed of
                # every pod
                successes += 1
                done_uids.update(
                    pi.pod.metadata.uid for pi in group
                )
                continue
            try:
                self._complete_solve(pending)
            except SchedulerCrashed:
                raise
            except Exception as e:  # noqa: BLE001 - download/commit failure
                if self._halts_on_card(e):
                    self._halt_on_card_fault(e)
                    raise
                # not an exhaustion: the standard recovery requeues the
                # group (a genuinely poisoned member re-trips
                # containment on its next pass)
                logger.exception("bisect sub-solve completion failed")
                self._recover_failed_batch(pending, e)
                done_uids.update(
                    pi.pod.metadata.uid for pi in group
                )
                continue
            successes += 1
            done_uids.update(pi.pod.metadata.uid for pi in group)
        dt_ms = (time.perf_counter() - t0) * 1000.0
        # post-loop systemic check too: a batch SMALLER than the abort
        # threshold can drain the work deque with zero successes and
        # only untyped isolations -- that is still "every subset
        # failed", not a poison signature
        if (
            not aborted
            and not force
            and successes == 0
            and untyped_isolated() > 0
        ):
            aborted = True
        if aborted:
            metrics.bisect_aborts.inc()
            # typed-poison singletons quarantine even on an aborted
            # run (the cause is attributable); everything else --
            # untyped isolations and unprocessed work -- takes the
            # sequential floor
            typed_pis = [pi for pi, typed in isolated if typed]
            for pi in typed_pis:
                done_uids.add(pi.pod.metadata.uid)
            remaining = [
                pi for pi in solver_infos
                if pi.pod.metadata.uid not in done_uids
            ]
            flightrecorder.mark(
                "bisect_abort", pods=len(solver_infos),
                isolated=len(isolated), subsolves=subsolves,
                remaining=len(remaining), ms=round(dt_ms, 3),
            )
            logger.warning(
                "bisection aborted after %d failed sub-solves with no "
                "success (systemic failure); %d pods %s", subsolves,
                len(remaining),
                "requeued for K1" if self.device.type == "cuda"
                else "take the sequential path",
            )
            for pi in typed_pis:
                self._quarantine_isolated(pi, reason="poison")
            if remaining and self.device.type == "cuda":
                # no CPU floor on the card: requeue for K1
                self._requeue_for_card(
                    remaining, pod_scheduling_cycle, "bisection aborted"
                )
                return
            self.ladder.record_sequential(len(remaining))
            for pi in remaining:
                self.pods_fallback += 1
                self.attempt_schedule(pi)
            return
        flightrecorder.mark(
            "bisect_done", pods=len(solver_infos),
            isolated=len(isolated), subsolves=subsolves,
            ms=round(dt_ms, 3),
        )
        if injected_out:
            self._requeue_for_card(
                injected_out, pod_scheduling_cycle,
                "injected fault during bisection",
            )
        for pi, typed in isolated:
            if any(pi is q for q in injected_out):
                continue
            self._quarantine_isolated(
                pi, reason="poison" if typed else "bisect"
            )

    def _quarantine_isolated(self, pi: PodInfo, reason: str) -> None:
        """Route one isolated pod through the quarantine ledger and
        surface the event on the pod (Warning event; the PARK
        additionally writes the typed PodQuarantined condition)."""
        # a quarantined pod holds no capacity: its quota charge (taken
        # at pop) must not pin the namespace ledger while it sits out
        self._quota_refund(pi.pod, "quarantine")
        self.pods_quarantined += 1
        disposition = self.quarantine.isolate(pi, reason=reason)
        prof = self.profiles.get(pi.pod.spec.scheduler_name)
        if prof is not None:
            try:
                prof.recorder.eventf(
                    pi.pod, "Warning", "Quarantined",
                    f"pod isolated by blast-radius containment "
                    f"({reason}); disposition: {disposition}",
                )
            except Exception:  # noqa: BLE001 - events are best-effort
                logger.exception(
                    "quarantine event for %s", pi.pod.key()
                )

    # -- carry integrity audit + device-loss rebuild -------------------------

    def audit_carry(self) -> str:
        """One carry-integrity sweep: checksum the device-resident
        req/nzr (and alloc/valid when resident) against the host shadow
        with two cheap on-device int32 reductions per array; the full
        [N, R] download happens only on mismatch. Corruption heals
        through the counted-upload path (carry drop -> next dispatch
        re-uploads), never silently. Runs from the
        ControlPlaneReconciler sweep; safe to call from any thread.

        Returns the disposition: "idle" (nothing resident), "busy"
        (in-flight state with no auditable snapshot), "raced" (a
        dispatch/commit moved the state mid-sweep), "clean", or
        "mismatch" (healed).

        A SATURATED pipeline no longer defers the audit to quiescence:
        while batches are in flight, the FIRST UNMIRRORED pending
        record's ``carry_in`` refs are audited instead of the live
        carry. Those refs are device tensors no one writes (dispatch
        REASSIGNS ``ds.req_dev``, never mutates it, and the solve only
        writes fresh outputs) snapshotting the
        device state that record's solve consumed -- which must equal
        the host shadows exactly until that record's own commit passes
        the shadow-mutation point (the mirror, flagged ``mirrored``
        under this lock), because the committer lands batches in FIFO
        order and the req/nzr shadows mutate ONLY at the mirror. The
        coarse ``committing`` flag is deliberately NOT the gate: the
        committer raises it the instant it grabs the head, long before
        the mirror (the whole device download sits between), and gating
        on it would answer "busy" for nearly every sweep under
        saturation. Staleness is therefore bounded by pipeline depth,
        not by the arrival rate ever pausing: corruption stamped into
        the newest resident carry is seen when the batch that consumed
        it reaches the front of the unmirrored window, at most
        MAX_INFLIGHT commits later. Only req/nzr are audited under
        load (the alloc row patch CAN land on the resident alloc while
        batches are in flight); "busy" remains only for windows whose
        front record has no carry reuse (cold uploads, row-fix
        dispatches) or whose every record has already mirrored."""
        ds = self._dev
        under_load = False
        head = None
        seq = 0
        alloc_dev = valid_dev = None
        shadow_ref = None
        with self._shadow_lock:
            if ds.req_dev is None or ds.req_shadow is None:
                metrics.carry_audit_sweeps.inc(disposition="idle")
                return "idle"
            if self._pending_exists():
                head = self._pending_first_unmirrored()
                carry = (
                    head.get("carry_in") if head is not None else None
                )
                if head is None or carry is None:
                    metrics.carry_audit_sweeps.inc(disposition="busy")
                    return "busy"
                under_load = True
                shadow_ref = ds.req_shadow
                req_dev, nzr_dev = carry
                host = {
                    "req": _audit_checksum_host(ds.req_shadow),
                    "nzr": _audit_checksum_host(ds.nzr_shadow),
                }
            else:
                seq = self._dispatch_seq
                req_dev, nzr_dev = ds.req_dev, ds.nzr_dev
                alloc_dev, valid_dev = ds.alloc_dev, ds.valid_dev
                # host checksums under the lock: the shadows mutate in
                # place at commit time
                host = {
                    "req": _audit_checksum_host(ds.req_shadow),
                    "nzr": _audit_checksum_host(ds.nzr_shadow),
                }
                if alloc_dev is not None and ds.alloc_shadow is not None:
                    host["alloc"] = _audit_checksum_host(ds.alloc_shadow)
                if valid_dev is not None and ds.valid_shadow is not None:
                    host["valid"] = _audit_checksum_host(ds.valid_shadow)
        self.carry_audits += 1
        # device reductions OUTSIDE the lock (no one writes the refs; a
        # racing dispatch reassigns, never mutates)
        dev_handles = {"req": _audit_checksum_dev(req_dev),
                       "nzr": _audit_checksum_dev(nzr_dev)}
        if "alloc" in host:
            dev_handles["alloc"] = _audit_checksum_dev(alloc_dev)
        if "valid" in host:
            dev_handles["valid"] = _audit_checksum_dev(valid_dev)
        dev = {
            name: (int(s), int(ws))
            for name, (s, ws) in dev_handles.items()
        }
        with self._shadow_lock:
            if under_load:
                # the snapshot is comparable until OUR record's mirror
                # lands (the only in-order in-place writer of the
                # req/nzr shadows) or a cold upload reassigns the
                # shadow arrays -- both happen under this lock, so
                # either landing mid-reduction is caught here. The
                # coarse ``committing`` flag is irrelevant: the whole
                # download phase is audit-safe.
                raced = (
                    head.get("mirrored")
                    or ds.req_shadow is not shadow_ref
                )
            else:
                raced = (
                    self._dispatch_seq != seq
                    or self._pending_exists()
                    or ds.req_dev is not req_dev
                )
            if raced:
                metrics.carry_audit_sweeps.inc(disposition="raced")
                return "raced"
            mismatched = [n for n in dev if dev[n] != host[n]]
            if not mismatched:
                metrics.carry_audit_sweeps.inc(disposition="clean")
                return "clean"
            # full compare only on mismatch: name the divergent rows
            # for the flight record, then heal
            rows: List[int] = []
            try:
                if "req" in mismatched:
                    diff = ~np.all(
                        _to_host(req_dev) == ds.req_shadow, axis=1
                    )
                    rows = np.flatnonzero(diff)[:16].tolist()
                elif "nzr" in mismatched:
                    diff = ~np.all(
                        _to_host(nzr_dev) == ds.nzr_shadow, axis=1
                    )
                    rows = np.flatnonzero(diff)[:16].tolist()
            except Exception:  # noqa: BLE001 - row detail is best-effort
                logger.exception("carry audit row compare failed")
            for name in mismatched:
                metrics.carry_audit_mismatches.inc(array=name)
            flightrecorder.mark(
                "carry_audit", arrays=",".join(sorted(mismatched)),
                rows=rows, in_flight=len(self._pending_q),
            )
            if "req" in mismatched or "nzr" in mismatched:
                ds.invalidate_carry()
            if "alloc" in mismatched or "valid" in mismatched:
                ds.alloc_dev = None
                ds.valid_dev = None
            metrics.carry_audit_heals.inc()
            self.carry_audit_heals += 1
        metrics.carry_audit_sweeps.inc(disposition="mismatch")
        logger.warning(
            "carry integrity audit: device-resident %s diverged from "
            "the host shadow (rows %s); healed via the counted-upload "
            "path", ",".join(sorted(mismatched)), rows,
        )
        return "mismatch"

    def _corrupt_carry_row(self) -> None:
        """CARRY_CORRUPT fired: flip bits in one device-resident carry
        row WITHOUT touching the host shadow -- silent corruption only
        the integrity audit can see (the generation handshake compares
        host state against the shadow, never the device)."""
        inj = get_injector()
        with self._shadow_lock:
            ds = self._dev
            if ds.req_dev is None:
                return
            n = int(ds.req_dev.shape[0])
            if n == 0:
                return
            fired = (
                inj.fired_count(FaultPoint.CARRY_CORRUPT)
                if inj is not None else 1
            )
            row = (fired * 131) % n
            ds.corrupted_from, ds.corrupt_row = ds.req_dev, row
            ds.req_dev = _bump_carry_row(ds.req_dev, row)
        flightrecorder.mark("carry_corrupt", row=row)
        logger.warning(
            "injected carry corruption on resident row %d", row
        )

    def _on_device_lost(self) -> None:
        """DEVICE_LOST fired: every device-resident buffer is gone.
        Drop all resident state + shadows, flag the in-flight batches
        (their results are garbage; the committer's recovery requeues
        their pods through the PR-1 machinery), drain, and let the
        current dispatch rebuild from the host cache through the
        existing cold-upload path. Detection -> rebuilt is metered into
        ``scheduler_tpu_device_rebuild_ms``."""
        self._device_lost_at = time.perf_counter()
        metrics.device_lost_events.inc()
        metrics.degraded_health.set(1, reason="device_lost")
        flightrecorder.mark("device_lost")
        logger.error(
            "device lost: dropping resident state, requeueing "
            "in-flight batches, rebuilding from the host cache"
        )
        with self._pending_cv:
            for p in self._pending_q:
                p["device_lost"] = True
        with self._shadow_lock:
            ds = self._dev
            ds.alloc_dev = None
            ds.valid_dev = None
            ds.alloc_shadow = None
            ds.valid_shadow = None
            ds.layout_epoch = -1
            ds.invalidate_carry()
        self._drain_pending()

    def _note_device_rebuilt(self) -> None:
        """The first full upload after a device loss landed under a
        device solve: the resident state is rebuilt."""
        at = self._device_lost_at
        if at is None:
            return
        self._device_lost_at = None
        dt_ms = (time.perf_counter() - at) * 1000.0
        metrics.device_rebuild_ms.observe(dt_ms)
        metrics.degraded_health.set(0, reason="device_lost")
        flightrecorder.mark("device_rebuilt", ms=round(dt_ms, 3))
        logger.warning(
            "device state rebuilt from host cache %.1fms after loss",
            dt_ms,
        )

    @staticmethod
    def _eager_download(assignments_dev):
        """Start the device->host result copy at dispatch time (host
        tiers already hand back numpy -- nothing to transfer)."""
        if isinstance(assignments_dev, np.ndarray):
            return None
        if not _EAGER_DOWNLOAD_OK:
            # a starved host (<=2 cores) has no spare core to run the
            # copy thread: the overlap becomes pure GIL contention with
            # the dispatcher/committer (measured ~10% slower end-to-end)
            return None
        return _EagerDownload(assignments_dev)

    def _complete_solve(self, p) -> None:
        """Download the assignments, mirror the scan's node-state deltas
        into the host shadow (same int32 arithmetic), then run the batched
        commit pipeline.

        The download is the other blocking device interaction (a wedged
        link hangs the copy forever), so it runs under the same
        wall-clock watchdog as the solve, and the result is validated
        before it drives commits: garbage indices from a sick device
        (NaN-score argmax artifacts) must degrade, not bind pods to
        phantom nodes. Failures raise; the callers route the batch
        through _recover_failed_batch (requeue, never strand)."""
        if p.get("device_lost"):
            # the device died with this batch in flight: its result
            # buffers are gone/garbage. Raise so the caller's recovery
            # requeues every pod (the PR-1 machinery); the carry was
            # already dropped by _on_device_lost.
            sp = p.get("span") or flightrecorder.NULL_SPAN
            sp.finish(routed="device_lost")
            raise DeviceLostInFlight(
                "device lost with this batch in flight; requeueing"
            )
        tier = p.get("tier", TIER_CUDA)
        breaker = self.ladder.breakers.get(tier)
        timeout = (
            self.ladder.config.solve_timeout_seconds
            if tier in DEVICE_TIERS
            and self.ladder.config.enabled
            else 0.0
        )

        def download():
            eager = p.get("download")
            if eager is not None:
                # copy already in flight since dispatch; await it
                return eager.result()
            return _to_host(p["assignments_dev"])

        fspan = p.get("span") or flightrecorder.NULL_SPAN
        try:
            t_dl = time.perf_counter()
            assignments = self.ladder.watchdog.call(
                download, timeout, tier=tier
            )
            dt_dl = time.perf_counter() - t_dl
            self._stage_add("download", dt_dl)
            fspan.stage("download", dt_dl, t0=t_dl)
            # the result is on the host, so the launch's events have
            # completed: its device time goes onto the device track
            flightrecorder.device_spans(
                p.get("launched"), f"solve b={p['b']}",
                {"batch": getattr(fspan, "batch_id", None), "tier": tier},
            )
        except SolveTimeout:
            if breaker is not None:
                breaker.force_open()
            metrics.solver_fallbacks.inc(
                tier=TIER_SEQUENTIAL, reason=f"{tier}_download_timeout"
            )
            flightrecorder.mark(
                "fallback", tier=TIER_SEQUENTIAL,
                reason=f"{tier}_download_timeout",
            )
            fspan.finish(routed="download_timeout")
            raise
        except Exception:
            if breaker is not None:
                breaker.record_failure()
            raise
        inj = get_injector()
        injected = False
        if inj is not None:
            clean = assignments
            assignments = inj.corrupt_assignments_maybe(
                FaultPoint.SOLVE_GARBAGE, clean
            )
            injected = assignments is not clean
            if injected and tier in CARD_TIERS:
                # the card's answer to injected garbage: the solve's own
                # answer is intact on the device, so read it again under
                # the RetryPolicy (the injector may corrupt the re-read
                # too); spent attempts requeue the batch for K1
                policy = self.ladder.config.retry
                attempt = 1
                while (
                    assignments is not clean
                    and attempt < max(1, policy.max_attempts)
                    and _garbage(assignments[: p["b"]], p["names"])
                ):
                    metrics.solve_retries.inc(tier=tier)
                    self.ladder.injected_retries += 1
                    self.ladder.config.sleep(
                        policy.backoff_for_attempt(attempt)
                    )
                    attempt += 1
                    assignments = inj.corrupt_assignments_maybe(
                        FaultPoint.SOLVE_GARBAGE, clean
                    )
                injected = assignments is not clean
        head = assignments[: p["b"]]
        if _garbage(head, p["names"]):
            # out-of-range node indices: the solve result is garbage
            if injected and tier in CARD_TIERS:
                fspan.finish(routed="injected_garbage")
                raise FaultInjected(FaultPoint.SOLVE_GARBAGE)
            if breaker is not None:
                breaker.record_failure()
            metrics.solver_fallbacks.inc(
                tier=TIER_SEQUENTIAL, reason=f"{tier}_garbage_result"
            )
            flightrecorder.mark(
                "fallback", tier=TIER_SEQUENTIAL,
                reason=f"{tier}_garbage_result",
            )
            fspan.finish(routed="garbage_result")
            raise RuntimeError(
                f"solve on tier {tier!r} returned out-of-range "
                f"assignments; discarding the batch result"
            )
        p["solve_timer"].observe()
        b = p["b"]
        metrics.batch_size.observe(b)
        ds = self._dev
        delta = None
        with self._shadow_lock:
            # the audit race-detector: a commit moving the shadow (or
            # landing a batch) invalidates any checksum window spanning
            # this moment. ``mirrored`` marks THIS record as past the
            # shadow-mutation point -- the under-load audit compares the
            # first unmirrored record's carry_in against the shadows,
            # so the flag must flip under the same lock as the mirror.
            self._dispatch_seq += 1
            p["mirrored"] = True
            if not p["overlaid"] and ds.req_shadow is not None:
                # mirror the batch's own placements into the running
                # expectation (same int32 arithmetic as the scan carry)
                # and remember the per-row delta: the dispatcher's
                # handshake subtracts it while the host cache still
                # trails this commit. O(B*R) in-place -- the retired
                # shadow_gens ring copied the full [N, R] per batch.
                # The compact+scatter hot loop runs in native
                # _hotpath.c (mirror_scatter; numpy twin behind
                # KTPU_NATIVE_INGEST=0, differentially tested).
                delta = _mirror_scatter(
                    assignments, b, p["req"], p["nzr"],
                    ds.req_shadow, ds.nzr_shadow,
                )
                if delta is not None:
                    delta = _Delta(delta)
                    delta.stamp = [None]
                    ds.pending_deltas.append(delta)
        # wake dispatchers parked in _await_mirrors at MIRROR time: the
        # commit/bind API transactions below can be hundreds of ms away,
        # and the speculative renegotiation only needs the mirror
        with self._pending_cv:
            self._pending_cv.notify_all()
        if inj is not None and inj.should_fire(FaultPoint.CARRY_CORRUPT):
            self._corrupt_carry_row()
        t_commit = time.perf_counter()
        try:
            self._commit_batch(
                p["solver_infos"], p["order"], assignments, p["names"],
                p["num_nodes"], p["snapshot"], p["cycle"],
                mask_info=(p.get("mask_rows"), p.get("mask_index_solved")),
                gang_failed_uids=p.get("gang_failed_uids"),
                span=fspan,
            )
        finally:
            if delta is not None:
                # the host cache now holds what this commit assumed; a
                # later snapshot shows it, or a forget that undid it
                with self._shadow_lock:
                    self._commit_seq += 1
                    delta.stamp[0] = self._commit_seq
        dt_commit = time.perf_counter() - t_commit
        self._stage_add("commit", dt_commit)
        fspan.stage("commit", dt_commit, t0=t_commit)
        fspan.finish()
        if (
            self._prewarm_next_commit
            and not self._deferred_preempt
            and self.preemptor is not None
        ):
            # the wave's preemptors just bound: refresh the victim pack
            # in the background so the next contention burst finds it
            # (and its device upload) warm
            self._prewarm_next_commit = False
            self.preemptor.prewarm_pack_async()

    # -- batched commit ------------------------------------------------------

    def _commit_batch(
        self,
        solver_infos: List[PodInfo],
        order: np.ndarray,
        assignments: np.ndarray,
        names: List[str],
        num_nodes: int,
        snapshot,
        pod_scheduling_cycle: int,
        mask_info=None,
        gang_failed_uids=None,
        span=None,
    ) -> None:
        """Post-solve pipeline for the whole batch: Reserve -> assume ->
        Permit (scheduler.go:615-660 semantics preserved), then ONE async
        binding task that commits every default-binder pod in a single
        bulk transaction; non-default binds (extenders, custom bind
        plugins, Permit waiters) take the per-pod binding cycle.

        Pods for which every Reserve/Permit plugin is a declared no-op
        (Framework.plugins_relevant) skip the per-pod plugin pipeline and
        are assumed in one bulk cache transaction -- the batch commit is
        otherwise the profile-run hot loop of the 10k burst."""
        b = len(solver_infos)
        if span is None:
            span = flightrecorder.NULL_SPAN
        # schedule_batch flushes at profile boundaries, so the whole batch
        # shares one profile (batch.py:242)
        prof = self.profiles.get(solver_infos[0].pod.spec.scheduler_name)
        if prof is None:
            logger.error(
                "no profile for %s", solver_infos[0].pod.key()
            )
            return
        extenders = self.algorithm.extenders
        bulk_ok = (
            prof.uses_default_binder_only() and self._bind_pool is not None
        )
        # hoisted out of the per-pod loop: binder extenders (normally
        # none) and the relevance tables (empty table =>
        # plugins_relevant is False for every pod, no call needed)
        binder_extenders = [e for e in extenders if e.is_binder()]
        reserve_maybe = prof.relevance_entries("reserve")
        permit_maybe = prof.relevance_entries("permit")

        plain_pis: List[PodInfo] = []  # placed pods on the bulk path ...
        clones: List = []  # ... their assumed clones ...
        hosts: List[str] = []  # ... and target nodes (parallel lists)
        slow: List[Tuple[PodInfo, int, int]] = []  # (pod_info, choice, k)

        # -- fused fast path: when no per-pod gate can fire (default
        # binder only, no gang masking, no binder extenders, and no
        # reserve/permit plugin relevant to ANY pod in the batch -- one
        # any() probe instead of three checks per pod), the whole
        # classification collapses to numpy: one stable argsort over the
        # assignment row splits NO_NODE from placed AND groups the
        # placed slots by target node (the grouped order feeds the
        # cache's per-node bulk assume), and one native pass
        # (commit_gather) gathers PodInfos + assumed clones + hosts.
        fast = bulk_ok and not gang_failed_uids and not binder_extenders
        if fast and (reserve_maybe or permit_maybe):
            fast = not any(
                (
                    reserve_maybe
                    and prof.plugins_relevant("reserve", pi.pod)
                )
                or (
                    permit_maybe
                    and prof.plugins_relevant("permit", pi.pod)
                )
                for pi in solver_infos
            )
        if fast:
            with flightrecorder.substep("commit.gather", span):
                head = np.asarray(assignments[:b])
                grp = np.argsort(head, kind="stable")
                n_unplaced = int((head == NO_NODE).sum())
                placed = grp[n_unplaced:]
                order_np = np.asarray(order)
                order2 = order_np[placed].tolist()
                assign2 = head[placed].tolist()
                gather = (
                    _commit_gather
                    if _commit_gather is not None
                    else _commit_gather_py
                )
                plain_pis, clones, hosts = gather(
                    solver_infos, order2, assign2,
                    names if isinstance(names, list) else list(names),
                )
            if n_unplaced:
                slow = [
                    (solver_infos[int(order_np[k])], NO_NODE, k)
                    for k in grp[:n_unplaced].tolist()
                ]
        else:
            # numpy scalar -> int conversion in one C pass each (only
            # the per-pod loop reads them)
            order_l = order.tolist()
            assign_l = assignments.tolist()
            plain: List[Tuple[PodInfo, str]] = []  # (pod_info, host)
            for k in range(b):
                pi = solver_infos[order_l[k]]
                choice = assign_l[k]
                if (
                    gang_failed_uids
                    and pi.pod.metadata.uid in gang_failed_uids
                ):
                    # quorum-masked gang member: no placement, no
                    # preemption (the group chose not to place; a
                    # PodGroupMemberAdd wakeup retries once the group
                    # can assemble)
                    metrics.schedule_attempts.inc(result="unschedulable")
                    span.bump("gang_masked")
                    self.record_scheduling_failure(
                        prof, pi,
                        "pod group cannot reach minMember this cycle",
                        "Unschedulable", "", pod_scheduling_cycle,
                    )
                    self.pods_solved_on_device += 1
                    continue
                if choice == NO_NODE:
                    slow.append((pi, choice, k))
                    continue
                pod = pi.pod
                if (
                    bulk_ok
                    and not (
                        reserve_maybe
                        and prof.plugins_relevant("reserve", pod)
                    )
                    and not (
                        permit_maybe
                        and prof.plugins_relevant("permit", pod)
                    )
                    and not (
                        binder_extenders
                        and any(
                            e.is_interested(pod) for e in binder_extenders
                        )
                    )
                ):
                    plain.append((pi, names[choice]))
                else:
                    slow.append((pi, choice, k))
            if plain:
                if _assume_clones is not None:
                    clones = _assume_clones(
                        [pi.pod for pi, _ in plain],
                        [host for _, host in plain],
                    )
                else:
                    clones = []
                    for pi, host in plain:
                        assumed = pi.pod.assumed_clone()
                        assumed.spec.node_name = host
                        clones.append(assumed)
                plain_pis = [pi for pi, _ in plain]
                hosts = [host for _, host in plain]

        bulk: List[Tuple] = []
        deferred: List[Tuple] = []  # sync-mode Permit waiters
        unassumed: List[str] = []  # placed on the device, not in the cache
        if plain_pis:
            with flightrecorder.substep("commit.assume", span):
                # on the fast path the argsort grouped the clones by
                # target node, so the cache lands them as per-node runs
                # (one node lookup + one generation bump per run)
                errs = self.cache.assume_pods(clones)
            self.queue.delete_nominated_pods_if_exist(clones)
            # CycleState is built lazily in the binding cycle (only
            # pre_bind/unreserve/post_bind plugins and failure paths read
            # it; the plain burst has none)
            if any(errs):
                for pi, assumed, host, err in zip(
                    plain_pis, clones, hosts, errs
                ):
                    if err is not None:
                        unassumed.append(host)
                        self.record_scheduling_failure(
                            prof, pi, str(err), "SchedulerError", "",
                            pod_scheduling_cycle,
                        )
                        continue
                    bulk.append((prof, None, pi, assumed, host))
            else:
                bulk = [
                    (prof, None, pi, assumed, host)
                    for pi, assumed, host in zip(plain_pis, clones, hosts)
                ]
            self.pods_solved_on_device += len(plain_pis)
            span.bump("placed", len(plain_pis))

        failed_group: List[Tuple[PodInfo, FitError]] = []
        cluster_anti = None
        # live nodes only: with the slot layout, num_nodes counts free
        # (retired) slots too, and the "0/N nodes are available" message
        # must not claim more nodes than the cluster has
        live_nodes = sum(1 for n in names if n)
        # statuses are a pure function of the (deduplicated) mask row:
        # identical unschedulable pods share one dict
        statuses_by_row: dict = {}
        for pi, choice, k in slow:
            if choice == NO_NODE:
                adm = pi.pod.__dict__.get("_admission")
                if adm is not None and adm.vol_counts:
                    # the additive volume-count columns are CONSERVATIVE
                    # (a handle shared across resident pods counts once
                    # per pod), so a device reject of a countable-volume
                    # pod may be a false negative. Pin the pod host-only
                    # and requeue straight to the activeQ: the next
                    # cycle runs the exact per-node oracle (CSILimits /
                    # in-tree unique-handle sets), which either places
                    # it or produces the true unschedulable verdict.
                    pi.pod.__dict__["_admission"] = adm.as_host_only(
                        "volume-count-reject"
                    )
                    self.volume_reject_retries += 1
                    span.bump("volume_retries")
                    self.record_scheduling_failure(
                        prof, pi,
                        "countable-volume pod rejected by the device "
                        "solve; re-checking on the host path",
                        "Unschedulable", "", pod_scheduling_cycle,
                        skip_backoff=True,
                    )
                    continue
                coord = self.partition_coordinator
                if coord is not None and coord.try_spill(pi.pod):
                    # cross-partition spill: this stack's node slice has
                    # no room (or no feasible node) -- the pod is
                    # re-stamped to a sibling partition and forwarded
                    # through the apiserver, so preemption and backoff
                    # wait until every partition has had a look (its
                    # new home stack's quota gate re-charges it there)
                    self._quota_refund(pi.pod, "spill")
                    self.pods_solved_on_device += 1
                    span.bump("spilled")
                    continue
            state = CycleState()
            state.write(SNAPSHOT_STATE_KEY, snapshot)
            if choice == NO_NODE:
                metrics.schedule_attempts.inc(result="unschedulable")
                span.bump("no_node")
                # per-node reason codes (SURVEY section 7 hardest-part d,
                # generic_scheduler.go:1033): nodes rejected by the
                # STATIC mask (label/taint/name/unschedulable mismatch)
                # can never be helped by preemption -- mark them
                # UnschedulableAndUnresolvable so
                # nodes_where_preemption_might_help prunes like the
                # reference instead of scanning every node
                statuses = {}
                # host-port pods: the static row folds NodePorts in, and
                # a port conflict IS resolvable by evicting the holder
                # (generic_scheduler.go:940 re-runs filters with victims
                # removed) -- leave statuses empty so preemption scans
                # every node instead of wrongly pruning them
                if (
                    mask_info is not None
                    and mask_info[0] is not None
                    and not pod_host_ports(pi.pod)
                ):
                    m_rows, m_idx = mask_info
                    ridx = int(m_idx[k])
                    statuses = statuses_by_row.get(ridx)
                    if statuses is None:
                        statuses = {
                            names[int(j)]:
                            Status.unschedulable_and_unresolvable(
                                "node(s) didn't match the static "
                                "feasibility mask"
                            )
                            for j in np.flatnonzero(
                                ~m_rows[ridx][:num_nodes]
                            )
                            # free (retired) slots are masked off too
                            # but are not nodes
                            if names[int(j)]
                        }
                        statuses_by_row[ridx] = statuses
                fit_err = FitError(pi.pod, live_nodes, statuses)
                self.pods_solved_on_device += 1
                # device-eligible failures preempt as ONE group (one
                # device round trip via Preemptor.preempt_batch); the
                # rest take the per-pod host path
                if self.preemptor is not None:
                    if cluster_anti is None:
                        from kubernetes_tpu_torch.ops.affinity import (
                            cluster_has_required_anti_affinity,
                        )

                        cluster_anti = cluster_has_required_anti_affinity(
                            snapshot
                        )
                    if self.preemptor.device_eligible(
                        prof, pi.pod, cluster_anti=cluster_anti
                    ):
                        failed_group.append((pi, fit_err))
                        continue
                # populate PreFilter state so host preemption's victim
                # simulation can run the full filter pipeline (the
                # sequential path gets this from algorithm.schedule)
                prof.run_pre_filter_plugins(state, pi.pod)
                self.handle_fit_error(
                    prof, state, pi, fit_err, pod_scheduling_cycle
                )
                continue
            host = names[choice]
            assumed = self.reserve_assume_permit(
                prof, state, pi, host, pod_scheduling_cycle
            )
            self.pods_solved_on_device += 1
            if assumed is None:
                unassumed.append(host)
                continue
            span.bump("placed")
            waiting = prof.get_waiting_pod(assumed.metadata.uid) is not None
            binder_extender = any(
                e.is_binder() and e.is_interested(assumed)
                for e in extenders
            )
            if (
                waiting
                or binder_extender
                or not prof.uses_default_binder_only()
                or self._bind_pool is None
            ):
                # per-pod binding cycle (wait-on-permit / custom binds)
                if self._bind_pool is not None:
                    with self._inflight_lock:
                        self._inflight_binds += 1
                    self._bind_pool.submit(
                        self._binding_cycle_safe, prof, state, pi, assumed,
                        host, pod_scheduling_cycle,
                    )
                elif waiting:
                    # synchronous binding + a Permit waiter: running the
                    # cycle inline would block THIS loop on
                    # wait_on_permit while the quorum it waits for is
                    # later in the same batch (deadlock until the permit
                    # timeout); defer until every pod is assumed
                    deferred.append(
                        (prof, state, pi, assumed, host)
                    )
                else:
                    self._binding_cycle(
                        prof, state, pi, assumed, host, pod_scheduling_cycle
                    )
            else:
                bulk.append((prof, state, pi, assumed, host))
        if unassumed:
            # the carry and the shadow hold these placements; the host
            # cache never did, so no row change will point at them
            row_of = {n: i for i, n in enumerate(names)}
            with self._shadow_lock:
                self._dev.recheck_rows.update(row_of[h] for h in unassumed)
        if failed_group:
            # a burst that overflows the cluster fails across SEVERAL
            # in-flight batches; preempting per batch pays the wave's
            # fixed costs (state pack, result round trip) repeatedly and
            # fragments the nomination replay. While more solver batches
            # are queued behind this one (FIFO committer), park the
            # failures; the LAST in-flight batch preempts the whole
            # accumulated group in one device wave.
            if not self._deferred_preempt:
                self._deferred_since = time.monotonic()
            self._deferred_preempt.extend(
                (prof, pi, fe, pod_scheduling_cycle)
                for pi, fe in failed_group
            )
        if self._deferred_preempt:
            with self._pending_cv:
                more_inflight = len(self._pending_q) > 1
            # the burst is still streaming when the activeQ holds more
            # pods or batches are in flight; hold the wave for them --
            # bounded by age and size so a trickle of unschedulable
            # pods cannot starve preemption
            burst_live = (
                more_inflight or self.queue.active_count() > 0
            )
            flush_anyway = (
                len(self._deferred_preempt) >= self.max_batch
                or time.monotonic() - self._deferred_since > 0.3
            )
            if not burst_live or flush_anyway:
                self._flush_deferred_preemptions()
        if bulk:
            with self._inflight_lock:
                self._inflight_binds += 1
            self._bind_pool.submit(
                self._bulk_binding_cycle_safe, bulk, pod_scheduling_cycle,
                snapshot, span,
            )
        for prof_d, state_d, pi_d, assumed_d, host_d in deferred:
            self._binding_cycle(
                prof_d, state_d, pi_d, assumed_d, host_d,
                pod_scheduling_cycle,
            )

    def _flush_deferred_preemptions(self) -> None:
        """Run one preemption wave for every parked failure, grouped by
        profile (preempt_batch is profile-scoped), then requeue the pods
        with their nominations."""
        parked = self._deferred_preempt
        self._deferred_preempt = []
        # preempt_batch (and the host-side nomination fold inside the
        # device wave) require priority-DESC order; parked failures from
        # several batches can interleave priorities
        parked.sort(key=lambda t: (-t[1].pod.spec.priority, t[1].timestamp))
        by_prof: dict = {}
        for prof, pi, fe, cycle in parked:
            by_prof.setdefault(id(prof), (prof, []))[1].append(
                (pi, fe, cycle)
            )
        for prof, items in by_prof.values():
            victim_uids: Optional[List[str]] = []
            try:
                nominated, victim_uids = self.preemptor.preempt_batch(
                    prof, [(pi.pod, fe) for pi, fe, _ in items]
                )
            except CardFault as e:
                # a fault of the card's victim search (K3) is not
                # answered by an empty wave that requeues and retries
                # it: the scheduler halts, whichever caller flushed. An
                # injected fault that spent its attempts is not one:
                # preempt_batch returns that wave with no nomination,
                # and the requeue below retries it
                self._halt_on_card_fault(e)
                raise
            except Exception:
                logger.exception("batched device preemption failed")
                nominated = [""] * len(items)
            evict_ok = victim_uids is not None
            flightrecorder.mark(
                "preemption_wave", pods=len(items),
                nominated=sum(1 for n in nominated if n),
                victims=len(victim_uids or ()),
                tier=getattr(self.preemptor, "wave_solver_tier", ""),
            )
            # wait (bounded) for the evictions to propagate from the
            # watch into the cache: the nominated pods retry WITHOUT
            # backoff below -- their failure was just resolved by this
            # wave's evictions, so backing off would only add the full
            # 1s initial-backoff round trip to every preemption -- and
            # an instant retry against a cache that still holds the
            # victims would waste a scheduling cycle
            if victim_uids:
                deadline = time.monotonic() + 0.5
                pending = list(victim_uids)
                while pending and time.monotonic() < deadline:
                    pending = [
                        u for u in pending
                        if self.cache.has_pod_uid(u)
                    ]
                    if pending:
                        time.sleep(0.002)
            for (pi, fe, cycle), node in zip(items, nominated):
                if self.cache.has_pod_uid(pi.pod.metadata.uid):
                    # stale parked record: the pod bound during the
                    # deferral window (an informer update re-added
                    # it); requeueing it would double-place a
                    # running pod
                    continue
                self.record_scheduling_failure(
                    prof, pi, str(fe), "Unschedulable", node, cycle,
                    # no-backoff retry only when the wave actually
                    # evicted: otherwise the failure is persistent
                    # and the 1s backoff must damp it
                    skip_backoff=bool(node) and evict_ok,
                )
            if any(nominated):
                # once these preemptors bind, the cluster is full again:
                # refresh the victim pack so the NEXT contention wave
                # finds it (and its device upload) already warm
                self._prewarm_next_commit = True

    def _bind_bulk_with_retry(self, assumed_list):
        """bind_assumed_bulk with retry-with-backoff around TRANSACTION
        failures (apiserver unavailable, injected conflict burst).
        Per-slot errors are the API's answer, not a transport failure --
        they return to the caller, whose per-slot handling already does
        forget + Unreserve + requeue. On terminal transaction failure
        every slot becomes an error so no pod is silently stranded
        assumed."""
        policy = self.ladder.config.retry
        coord = self.partition_coordinator
        binder = coord.identity if coord is not None else None
        attempt = 0
        while True:
            attempt += 1
            try:
                inj = get_injector()
                if inj is not None:
                    inj.raise_maybe(FaultPoint.BIND_CONFLICT)
                if binder is not None:
                    return self.client.bind_assumed_bulk(
                        assumed_list, binder=binder
                    )
                # keyword omitted off the partitioned path: test/bench
                # doubles that stub the client keep their old signature
                return self.client.bind_assumed_bulk(assumed_list)
            except Exception as e:  # noqa: BLE001 - transaction failure
                # max_attempts counts TOTAL attempts (ladder semantics)
                if attempt >= max(1, policy.max_attempts):
                    logger.exception(
                        "bulk bind failed terminally after %d attempts",
                        attempt,
                    )
                    return [(i, e) for i in range(len(assumed_list))]
                metrics.bind_retries.inc()
                self.ladder.config.sleep(
                    policy.backoff_for_attempt(attempt)
                )

    def _absorb_bind_conflict(
        self, prof, state, pi, assumed, host, err, pod_scheduling_cycle,
        span=None,
    ) -> None:
        """Absorb one typed bind conflict into the ledger: forget the
        optimistic reservation, release plugin state, then route by
        apiserver truth -- a pod that turned out ALREADY bound (a
        sibling stack won the race, or our own retried commit landed)
        is satisfied and records nothing; anything else requeues for
        another attempt. Exactly one disposition bucket per conflict:
        ``bind_conflicts_absorbed == conflict_requeues +
        conflict_stale_binds`` is a tier-1 invariant."""
        kind = getattr(err, "kind", "already-bound")
        self.bind_conflicts_absorbed += 1
        metrics.bind_conflicts_absorbed.inc(kind=kind)
        if span is not None:
            span.bump("conflicts")
        flightrecorder.mark(
            "bind_conflict", conflict=kind, pod=assumed.metadata.uid,
        )
        self._forget(assumed)
        prof.run_unreserve_plugins(state, assumed, host)
        live = None
        try:
            live = self.client.get_pod(
                assumed.metadata.namespace, assumed.metadata.name
            )
        except KeyError:
            pass  # deleted: nothing left to place
        except Exception:
            logger.exception(
                "conflict disposition read for %s", assumed.key()
            )
        if (
            live is not None
            and live.spec.node_name
            and live.metadata.uid == assumed.metadata.uid
        ):
            # satisfied elsewhere: the informer delivers the bound pod
            # into the cache; requeueing would double-schedule it
            self.conflict_stale_binds += 1
            return
        self.conflict_requeues += 1
        if live is None:
            return  # deleted while conflicting: requeue bucket, no add
        try:
            self.record_scheduling_failure(
                prof, pi, str(err), "BindConflict", "",
                pod_scheduling_cycle,
            )
            # a typed conflict is a TRANSIENT coordination race (fence
            # window, sibling overlap), not a cluster-state failure: no
            # future cluster event is guaranteed to wake the pod, so
            # parking it unschedulable could strand it for the 60s
            # flush. Route it to the backoff queue instead -- it retries
            # on the exponential backoff clock.
            self.queue.move_pods_to_active_or_backoff_queue(
                [pi], "BindConflictRetry"
            )
        except Exception:
            logger.exception("requeueing conflicted pod %s", pi.pod.key())

    def _bulk_binding_cycle_safe(
        self, items, pod_scheduling_cycle, snapshot=None, span=None
    ) -> None:
        try:
            self._bulk_binding_cycle(
                items, pod_scheduling_cycle, snapshot, span
            )
        except SchedulerCrashed:
            # simulated process death: halt with NO cleanup (the items
            # stay assumed-but-unbound; the next incarnation recovers)
            self._simulate_crash()
        except Exception:
            logger.exception("bulk binding cycle crashed")
        finally:
            with self._inflight_lock:
                self._inflight_binds -= 1
                self._inflight_lock.notify_all()

    def _bulk_binding_cycle(
        self, items, pod_scheduling_cycle, snapshot=None, span=None
    ) -> None:
        """One API transaction commits the batch (the pipelined bulk
        analogue of BindingREST.Create, storage.go:142). PreBind still
        runs per pod (skipped when every PreBind plugin declares itself
        a no-op for the pod); per-binding conflicts fail only their own
        pod.

        Plain pods arrive with ``state is None``: a CycleState is built
        only on the paths that read one (relevant pre_bind/post_bind
        plugins, unreserve on failure) -- the framework contract is
        per-pod state, and a fresh snapshot-seeded state is exactly what
        the eager path carried for these pods."""
        # the pre_bind gate must consider every profile in the bulk:
        # schedule_batch flushes on scheduler_name change today, but a
        # mixed bulk silently skipping another profile's PreBind plugins
        # would be a correctness bug, not a perf loss
        profs = {id(t[0]): t[0] for t in items}
        any_pre_bind = any(
            prof.relevance_entries("pre_bind") for prof in profs.values()
        )

        def mk_state():
            state = CycleState()
            state.write(SNAPSHOT_STATE_KEY, snapshot)
            return state

        if any_pre_bind:
            ready = []
            for prof, state, pi, assumed, host in items:
                if prof.plugins_relevant("pre_bind", assumed):
                    if state is None:
                        state = mk_state()
                    status = prof.run_pre_bind_plugins(state, assumed, host)
                else:
                    status = None
                if status is not None and not status.is_success():
                    self._forget(assumed)
                    prof.run_unreserve_plugins(state, assumed, host)
                    self.record_scheduling_failure(
                        prof, pi, status.message(), "SchedulerError", "",
                        pod_scheduling_cycle,
                    )
                    continue
                ready.append((prof, state, pi, assumed, host))
            if not ready:
                return
        else:
            ready = items
        inj = get_injector()
        if inj is not None:
            # the whole bulk is assumed but not yet bound -- the window
            # a process death strands (restart e2e drives this point)
            inj.crash_maybe(FaultPoint.CRASH_BETWEEN_ASSUME_AND_BIND)
        # commit-time lease fencing: verify ownership IMMEDIATELY before
        # the bulk transaction. A deposed leader (failed renews, standby
        # already holds the lease) must not commit placements computed
        # under its stale view -- abort and requeue; the pods are already
        # in the new leader's queue via its informers.
        if not self._fence_ok():
            metrics.fencing_aborts.inc()
            flightrecorder.mark("fencing_abort", pods=len(ready))
            logger.warning(
                "lease lost before bulk bind; fencing %d pod(s)",
                len(ready),
            )
            for prof, state, pi, assumed, host in ready:
                self._forget(assumed)
                prof.run_unreserve_plugins(
                    state if state is not None else mk_state(),
                    assumed, host,
                )
                self.record_scheduling_failure(
                    prof, pi, "lease lost before commit; fenced",
                    "SchedulerError", "", pod_scheduling_cycle,
                )
            return
        # partitioned commit fencing: the multi-lease holds_lease()
        # probe, run IMMEDIATELY before the bulk transaction. Pods on
        # partitions this stack no longer holds (handoff, lapsed lease
        # mid-dispatch) are absorbed as typed conflicts -- requeued,
        # never committed under a stale ownership view.
        coord = self.partition_coordinator
        if coord is not None and ready:
            fenced = coord.fence_hosts([t[4] for t in ready])
            if fenced:
                metrics.fencing_aborts.inc(len(fenced))
                flightrecorder.mark(
                    "fencing_abort", pods=len(fenced),
                    fence="partition",
                )
                kept = []
                fenced_pis = []
                for i, item in enumerate(ready):
                    if i not in fenced:
                        kept.append(item)
                        continue
                    prof_f, state_f, pi_f, assumed_f, host_f = item
                    self.bind_conflicts_absorbed += 1
                    self.conflict_requeues += 1
                    metrics.bind_conflicts_absorbed.inc(
                        kind="partition-fence"
                    )
                    if span is not None:
                        span.bump("conflicts")
                    flightrecorder.mark(
                        "bind_conflict", conflict="partition-fence",
                        pod=assumed_f.metadata.uid,
                    )
                    self._forget(assumed_f)
                    prof_f.run_unreserve_plugins(
                        state_f if state_f is not None else mk_state(),
                        assumed_f, host_f,
                    )
                    self.record_scheduling_failure(
                        prof_f, pi_f,
                        f"partition of node {host_f} not held at "
                        f"commit; fenced", "BindConflict", "",
                        pod_scheduling_cycle,
                    )
                    fenced_pis.append(pi_f)
                # fence conflicts are transient (a lease mid-handoff):
                # retry on the backoff clock instead of parking
                # unschedulable with no wake event in sight
                self.queue.move_pods_to_active_or_backoff_queue(
                    fenced_pis, "BindConflictRetry"
                )
                ready = kept
                if not ready:
                    return
        if self.crashed:
            # the process died (a simulated crash on another bind thread)
            # while this commit was on its way: a dead process sends no
            # bind and cleans nothing up
            return
        assumed_list = [t[3] for t in ready]
        bind_timer = metrics.SinceTimer(metrics.binding_duration)
        with flightrecorder.substep("bind_bulk", span):
            errors = self._bind_bulk_with_retry(assumed_list)
        bind_timer.observe()
        if errors:
            failed = dict(errors)
            bound = []
            for i, item in enumerate(ready):
                err = failed.get(i)
                if err is None:
                    bound.append(item)
                    continue
                prof, state, pi, assumed, host = item
                if isinstance(err, ApiConflict):
                    # typed conflict (already-bound / uid-mismatch /
                    # foreign-partition): the optimistic-concurrency
                    # answer of a multi-active control plane, absorbed
                    # through the requeue path -- never a scheduler
                    # error, never silently dropped
                    self._absorb_bind_conflict(
                        prof,
                        state if state is not None else mk_state(),
                        pi, assumed, host, err, pod_scheduling_cycle,
                        span=span,
                    )
                    continue
                metrics.schedule_attempts.inc(result="error")
                self._forget(assumed)
                prof.run_unreserve_plugins(
                    state if state is not None else mk_state(),
                    assumed, host,
                )
                self.record_scheduling_failure(
                    prof, pi, str(err), "SchedulerError", "",
                    pod_scheduling_cycle,
                )
            bound_assumed = [t[3] for t in bound]
        else:
            bound = ready
            bound_assumed = assumed_list
        if not bound:
            return
        self.cache.finish_binding_bulk(bound_assumed)
        if any(p.has_plugins("post_bind") for p in profs.values()):
            for prof, state, pi, assumed, host in bound:
                if prof.has_plugins("post_bind"):
                    prof.run_post_bind_plugins(
                        state if state is not None else mk_state(),
                        assumed, host,
                    )
        # single-profile bulks take the batched-recorder fast path; a
        # mixed bulk passes recorder=None so _emit_bound's fallback
        # routes each event through the pod's own profile recorder
        recorder = bound[0][0].recorder if len(profs) == 1 else None
        self._emit_bound(recorder, bound)
        # arm the bind-ack ledger: each committed bind is pending until
        # its Running ack arrives over the watch (zombie-kubelet
        # detection -- scheduler/bindack.py)
        tracker = getattr(self, "bind_ack_tracker", None)
        if tracker is not None:
            tracker.track_bound([
                (
                    assumed.metadata.namespace, assumed.metadata.name,
                    assumed.metadata.uid, host,
                )
                for _, _, _, assumed, host in bound
            ])

    def _emit_bound(self, recorder, bound) -> None:
        if hasattr(recorder, "scheduled_many"):
            recorder.scheduled_many([a for _, _, _, a, _ in bound])
        elif hasattr(recorder, "eventf_many"):
            recorder.eventf_many(
                [
                    (
                        assumed, "Normal", "Scheduled",
                        f"Successfully assigned "
                        f"{assumed.metadata.namespace}/"
                        f"{assumed.metadata.name} to {host}",
                    )
                    for _, _, _, assumed, host in bound
                ]
            )
        else:
            for prof, state, pi, assumed, host in bound:
                prof.recorder.eventf(
                    assumed, "Normal", "Scheduled",
                    f"Successfully assigned "
                    f"{assumed.metadata.namespace}/"
                    f"{assumed.metadata.name} to {host}",
                )
        # batched success metrics (one lock hold per histogram)
        metrics.schedule_attempts.inc(len(bound), result="scheduled")
        metrics.pod_scheduling_attempts.observe_many(
            [pi.attempts for _, _, pi, _, _ in bound]
        )
        now = time.monotonic()
        durations = [
            max(0.0, now - pi.initial_attempt_timestamp)
            for _, _, pi, _, _ in bound
            if pi.initial_attempt_timestamp
        ]
        metrics.pod_scheduling_duration.observe_many(durations)
        # live pod-to-bind quantile sketch (P-squared): the same stream
        # the histogram sees, but queryable as p50/p99 gauges
        metrics.observe_pod_to_bind(durations)

    # -- warmup --------------------------------------------------------------

    def warmup(self) -> None:
        """Build the solver kernels and run the three packed-upload
        layouts the run loop can hit (cold: static + carry ride the
        buffer; carry refresh; steady carry reuse with the delta-scatter
        slots) once each, for the solver mode (greedy, or sinkhorn: its
        prior and K1's scored entry) and the constrained solve, and
        the victim search once (when a Preemptor is wired), so no
        measured batch pays a kernel build or a first-use cost (the
        reference harness similarly schedules warm-up pods before
        b.ResetTimer, scheduler_perf_test.go:130). The kernels take any
        batch size and any combination of families without a rebuild,
        so one small pad serves every batch. All pods are inactive
        padding, so every solve leaves the state unchanged. A kernel
        that fails to build or launch raises here; warmup swallows
        nothing.

        On a mesh the same layouts run through the sharded solve, with
        ONE active pod that no node admits (its mask row is all False),
        so K4 builds and launches on every shard while the state stays
        unchanged (an inactive pod never reaches K4 on a mesh).

        With an adaptive controller that sizes its ladder from measured
        cost (``auto_rungs``), one steady solve is timed at each rung's
        batch size and handed to the controller's ``calibrate``."""
        snapshot = self.algorithm.snapshot
        self.cache.update_snapshot(snapshot)
        nt = self.tensor_cache.update(snapshot)
        if nt.capacity == 0:
            return
        n = nt.capacity
        r = nt.dims.num_dims
        dev = self.device
        kw = dict(
            config=self.solver_config, mode=self.solver_mode, device=dev,
            mesh=self.mesh,
        )
        active = np.zeros(POD_BUCKET, dtype=np.int32)
        midx = np.zeros(POD_BUCKET, dtype=np.int32)
        if self.mesh is not None:
            active[0] = 1
            midx[0] = MASK_ROW_BUCKET - 1  # an all-False row
        base = [
            ("req", np.zeros((POD_BUCKET, r), dtype=np.int32)),
            ("nzr", np.zeros((POD_BUCKET, 2), dtype=np.int32)),
            ("midx", midx),
            ("active", active),
            ("rows", mask_rows_upload(
                np.zeros((MASK_ROW_BUCKET, n), dtype=bool), self.mesh
            )),
        ]
        static_pieces = [
            ("alloc", np.zeros((n, r), dtype=np.int32)),
            ("valid", np.zeros(n, dtype=np.int32)),
        ]
        carry_pieces = [
            ("req_state", np.zeros((n, r), dtype=np.int32)),
            ("nzr_state", np.zeros((n, 2), dtype=np.int32)),
        ]
        _, _, _, alloc_d, valid_d = solve_packed(
            base + static_pieces + carry_pieces, None, None, None, None, **kw
        )
        _, req_d, nzr_d, _, _ = solve_packed(
            base + carry_pieces, alloc_d, valid_d, None, None, **kw
        )
        # steady-state dispatches always carry the (indices, rows)
        # delta-scatter slots (empty slots drop on the device)
        delta_slots = _delta_slot_pieces(n, r)
        solve_packed(
            base + delta_slots, alloc_d, valid_d, req_d, nzr_d, **kw
        )
        ab = self.autobatch
        if ab is not None and ab.auto_rungs:
            # the controller sizes its rung ladder from measured solve
            # cost: one steady solve at each rung's batch size, every pod
            # active on an all-False mask row (each walks the whole step,
            # no node admits it, the state stays unchanged); the median
            # of 3, so one noisy sample cannot make the ladder (and the
            # controller's trajectory) differ from run to run
            for rung in ab.rungs:
                pods = [
                    ("req", np.zeros((rung, r), dtype=np.int32)),
                    ("nzr", np.zeros((rung, 2), dtype=np.int32)),
                    ("midx", np.zeros(rung, dtype=np.int32)),
                    ("active", np.ones(rung, dtype=np.int32)),
                    base[-1],
                ]
                samples = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    solve_packed(
                        pods + delta_slots, alloc_d, valid_d, req_d, nzr_d,
                        **kw,
                    )
                    synchronize(dev)
                    samples.append(time.perf_counter() - t0)
                self.rung_solve_seconds[rung] = sorted(samples)[1]
        # the constrained kernel and its layouts: cold, refresh and steady
        # with all three families live, then the steady layout with each
        # family alone (the others ride as ConstPiece device constants, as
        # an absent family does in dispatch)
        kw["mode"] = "constrained"
        noops = {
            "sp": noop_spread_tensors(POD_BUCKET, n),
            "af": noop_affinity_tensors(POD_BUCKET, n),
            "sc": noop_score_tensors(POD_BUCKET, n),
        }

        def families(live):
            return [
                (f"{prefix}{i}", np.asarray(a) if prefix in live
                 else ConstPiece.from_uniform(a))
                for prefix, arrs in noops.items()
                for i, a in enumerate(arrs)
            ]

        fam = families(noops)
        solve_packed(
            base + static_pieces + carry_pieces + fam,
            None, None, None, None, **kw,
        )
        solve_packed(
            base + carry_pieces + fam, alloc_d, valid_d, None, None, **kw
        )
        for live in (noops, ("sp",), ("af",), ("sc",)):
            solve_packed(
                base + delta_slots + families(live),
                alloc_d, valid_d, req_d, nzr_d, **kw,
            )
        if self.preemptor is not None:
            # the victim search (K3): a one-node wave of an inactive pod
            from kubernetes_tpu_torch.ops.preempt_kernel import preempt_solve
            from kubernetes_tpu_torch.ops.preemption import to_device

            z = np.zeros
            preempt_solve(*to_device((
                z((1, r), np.int32), z((1, r), np.int32), z((1, 1), np.int32),
                z((1, 1), np.float32), z((1, 1, r), np.int32),
                z((1, 1), bool), z((1, 1, 0), bool), z(0, np.int32),
                z((0, r), np.int32), z(0, np.int32), z(0, np.int32),
                z((1, r), np.int32), z(1, np.int32), z((1, 1), bool),
                z(1, np.int32), z(1, bool),
            ), dev))
        synchronize(dev)
        # seal the build watchdog: every kernel build from here on is a
        # mid-run build (counted AND flight-recorded)
        self._jit_watch.seal()
        if ab is not None:
            # the controller drops candidate rungs whose measured solve
            # is not meaningfully cheaper than the rung above (a no-op
            # unless it sized its ladder from them: auto_rungs)
            ab.calibrate(dict(self.rung_solve_seconds))

    # -- loop ---------------------------------------------------------------

    def run(self) -> None:
        from kubernetes_tpu_torch.utils.gc_tuning import (
            PAUSE_HOOK,
            GCBatchGuard,
        )

        self.queue.run()
        self._gc_guard = GCBatchGuard()
        self._loop_lands_inflight = True
        # every collection while the loop is up, on any thread: the
        # pause counter, and a gc span in an armed trace
        PAUSE_HOOK.install()
        try:
            while not self._stop.is_set():
                # in-flight batches land on the committer thread, so the
                # dispatcher can always block for the next arrivals
                try:
                    self.schedule_batch(timeout=0.5, pipeline=True)
                except CardFault as e:
                    # the card's solve failed (not an injected fault):
                    # stop, and land what is already in flight
                    self._halt_on_card_fault(e)
            self._drain_pending()
            self._stop_committer()
        finally:
            self._loop_lands_inflight = False
            if self._stop.is_set() and self._bind_pool is not None:
                # stop() left the pool to this loop, whose last batches
                # have now been handed to it
                self._bind_pool.shutdown(wait=False)
            guard, self._gc_guard = self._gc_guard, None
            guard.close()
            PAUSE_HOOK.remove()
