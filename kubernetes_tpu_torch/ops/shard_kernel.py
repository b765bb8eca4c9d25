"""K4: the node-sharded mesh tier's greedy solve, hand-written CUDA for
Hopper.

Replaces ``kubernetes_tpu/ops/pallas_solver.py::_shard_candidate_kernel``
(entry ``pallas_shard_candidate``): one pod's fit + score + masked
lowest-index argmax over one shard's node rows, returning (best score
f32, shard-local index i32), and (-inf, 0) when nothing is feasible --
and, around it, the scan body of the JAX package's ``_mesh_shard_solver``
(per pod step the shards' candidates, the best-of-shards combine and the
winner's bump). The source is ``csrc/shard_candidate.cu``; its header
says what bounds each entry and how the batch entry's cluster works.

``ShardCandidates`` holds the shards of ONE device for one batch and has
two entries, which the mesh solve (``ops/assignment._mesh_greedy``)
picks by the mesh's layout:

- ``batch(active)``: when the device holds every shard of the mesh, the
  whole batch in ONE launch of one thread-block cluster (planned by
  ``plan_for_batch``): every step's candidates, the combine and the
  bump on the card, req/nzr updated in place;
- ``step(t)``: on a mesh over several devices, one launch per pod step
  covering the device's shards, the combine and the bump left to the
  caller.

``shard_candidate_plain`` (one step, the JAX package's jnp step of
``_mesh_shard_solver``, assignment.py:642-657, in torch, built from the
port's ``_fits`` and ``_combined_score``) and ``mesh_batch_plain`` (a
batch: its step loop, the combine and the bump) are the plain PyTorch
versions. They serve shards on the CPU and the checks; on the card the
wrapper launches the kernel or raises.

Build: ``ops/kernel_build.build_library`` (nvcc for ``sm_90a`` into a
library with a plain C interface, loaded with ctypes, at first use).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence, Tuple

import torch

from kubernetes_tpu_torch.ops.assignment import (
    GreedyConfig,
    _combined_score,
    _fits,
)
from kubernetes_tpu_torch.ops.cluster_plan import (
    LaunchPlan,
    card_admits,
    choose_plan,
    plan_shards,
)
from kubernetes_tpu_torch.ops.kernel_build import (
    KernelError,
    build_library,
    check_tensor as _check,
)

__all__ = [
    "KernelError", "ShardCandidates", "build", "mesh_batch_plain",
    "plan_for_batch", "shard_candidate", "shard_candidate_cuda",
    "shard_candidate_plain",
]

#: shards one launch covers (csrc/shard_candidate.cu kMaxShards)
MAX_SHARDS_PER_LAUNCH = 16
_CHUNK = 32  # pods staged at once (solve_common.cuh kChunk)


def plan_for_batch(
    n_loc: Sequence[int], r: int, cluster: int, static_bytes: int = 0,
) -> LaunchPlan:
    """The batch entry's plan for shards of ``n_loc`` rows of R dims on at
    most ``cluster`` CTAs, every CTA inside one shard. A resident row
    holds alloc, req and nzr and one word of mask bits; every CTA stages
    a chunk's pod requests, nzr, mask rows and flags (as K1's plan_for;
    csrc/solve_common.cuh greedy_smem_bytes)."""
    return plan_shards(
        n_loc, cluster, node_bytes=4 * (2 * r + 3),
        fixed_bytes=4 * _CHUNK * (r + 4), static_bytes=static_bytes,
    )

#: times the kernel library was built (or loaded) in this process --
#: the cache watchdog's "compile" count
builds = 0
#: kernel launches (either entry): incremented where the kernel is
#: launched, nowhere else
launches = 0
#: what the last build did: {"seconds", "command", "log", "library"}
last_build: dict = {}
#: the plan of the last batch launch
last_plan: Optional[LaunchPlan] = None

_lib = None
_lib_lock = threading.Lock()
_static_bytes = 0
#: batch clusters the card holds at once, per planned shape
_admitted: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per process and source hash) and load the kernel
    library. Raises KernelError when nvcc fails."""
    global _lib, builds, _static_bytes
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = build_library("shard_candidate")
        fn = lib.shard_candidate_launch
        fn.restype = ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ints = ctypes.POINTER(ctypes.c_int)
        fn.argtypes = (
            [ctypes.c_int] + [ptrs] * 5 + [ints]
            + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 3
        )
        fn = lib.shard_batch_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int] + [ptrs] * 5 + [ints] * 4
            + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        )
        lib.shard_batch_max_clusters.restype = ctypes.c_int
        lib.shard_batch_max_clusters.argtypes = [ctypes.c_int] * 4
        lib.shard_batch_static_smem.restype = ctypes.c_int
        lib.shard_batch_static_smem.argtypes = [ctypes.c_int]
        static = [lib.shard_batch_static_smem(k) for k in (0, 1)]
        if min(static) < 0:
            raise KernelError("cannot read shard_batch_kernel's attributes")
        _static_bytes = max(static)
        last_build.update(info)
        builds += 1
        _lib = lib
        return lib


def shard_candidate_plain(
    alloc, req, nzr, valid, rows, pod_req, pod_nzr, mask_index,
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function for ONE shard: alloc/req [n, R], nzr [n, 2],
    valid [n] bool, rows [U, n] bool (the shard's mask columns), pod_req
    [R], pod_nzr [2], mask_index [] or [1]. Returns (best [] f32, index
    [] i32): the masked maximum and the lowest shard-local index that
    holds it, (-inf, 0) when no row is feasible."""
    dev = alloc.device
    n = alloc.shape[0]
    u = rows.shape[0]
    if n == 0 or u == 0:
        return (
            torch.tensor(-torch.inf, dtype=torch.float32, device=dev),
            torch.tensor(0, dtype=torch.int32, device=dev),
        )
    m = mask_index.reshape(-1)[0].long().clamp(0, u - 1)
    feasible = _fits(alloc - req, pod_req) & rows[m] & valid
    score = _combined_score(alloc[:, :2], nzr, pod_nzr, config)
    masked = torch.where(feasible, score, -torch.inf)
    # argmax keeps the first maximum; with nothing feasible every entry
    # is -inf and the first column wins, as the TPU kernel's does
    return masked.max(), torch.argmax(masked).to(torch.int32)


def mesh_batch_plain(
    alloc, req, nzr, valid, rows, pod_req, pod_nzr, mask_index, active,
    config: GreedyConfig = GreedyConfig(), score=None, index=None,
    col: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batch entry's function on the shards of one device, which hold
    every shard of the mesh (alloc..rows: one tensor per shard, as
    ``ShardCandidates`` takes them; pod_req [B, R], pod_nzr [B, 2],
    mask_index [B], active [B] bool). Per active pod t in order: each
    shard's candidate (``shard_candidate_plain``) into ``score[t, col +
    k]`` / ``index[t, col + k]``; the best-of-shards combine, max score
    and then min global index (shard offset + local index, the shards'
    rows stacked in order); the winner's req/nzr rows bumped IN PLACE.
    An inactive pod places nowhere and writes nothing. Returns
    (assignment [B] int32, -1 for no node; score [B, C] f32; index
    [B, C] i32), the last two fresh [B, P] tensors unless given."""
    p = len(alloc)
    dev = pod_req.device
    b = pod_req.shape[0]
    if score is None:
        score = torch.empty((b, p), dtype=torch.float32, device=dev)
        index = torch.empty((b, p), dtype=torch.int32, device=dev)
    offs = [0]
    for a in alloc:
        offs.append(offs[-1] + int(a.shape[0]))
    assignment = torch.full((b,), -1, dtype=torch.int32, device=dev)
    for t in torch.nonzero(active).flatten().tolist():
        for k in range(p):
            best, idx = shard_candidate_plain(
                alloc[k], req[k], nzr[k], valid[k], rows[k], pod_req[t],
                pod_nzr[t], mask_index[t], config,
            )
            score[t, col + k] = best
            index[t, col + k] = idx
        cands = [(float(score[t, col + k]), offs[k] + int(index[t, col + k]))
                 for k in range(p)]
        top = max(c[0] for c in cands)
        if top == -float("inf"):
            continue
        win = min(g for sc, g in cands if sc == top)
        k = max(k for k in range(p) if offs[k] <= win)
        local = win - offs[k]
        req[k][local] += pod_req[t]
        nzr[k][local] += pod_nzr[t]
        assignment[t] = win
    return assignment, score, index


class ShardCandidates:
    """The shards of ONE device, for one batch: ``step(t)`` writes pod
    t's (best, shard-local index) of shard k into ``score[t, col + k]``
    f32 and ``index[t, col + k]`` i32; ``batch(active)`` runs the whole
    batch when these shards are every shard of the mesh.

    alloc/req/nzr/valid/rows: one tensor per shard, all on one device.
    pod_req [B, R], pod_nzr [B, 2], mask_index [B] int32 on that device.
    ``score``/``index``: contiguous [B, C] output tensors on that device
    with C >= col + P (by default fresh [B, P] ones and col 0), so a
    caller may gather several devices' candidates in one buffer. The
    shard tensors are read at every step, so a caller that bumps its
    req/nzr views in place between steps is seen by the next one (on the
    card they must be contiguous: the kernel holds their addresses).
    Shards on the card launch K4 (one launch per step or per batch, no
    host sync; at most 16 shards per device, else KernelError); shards on
    the CPU run the plain versions."""

    def __init__(
        self, alloc: Sequence[torch.Tensor], req, nzr, valid, rows,
        pod_req, pod_nzr, mask_index, config: GreedyConfig = GreedyConfig(),
        score=None, index=None, col: int = 0,
    ) -> None:
        self.device = alloc[0].device
        self.p = len(alloc)
        self.config = config
        b = pod_req.shape[0]
        if score is None:
            score = torch.empty((b, self.p), dtype=torch.float32,
                                device=self.device)
            index = torch.empty((b, self.p), dtype=torch.int32,
                                device=self.device)
        if index is None or col < 0 or score.shape[1] < col + self.p:
            raise ValueError(
                f"output columns [{col}, {col + self.p}) do not fit "
                f"{tuple(score.shape)}"
            )
        self.score, self.index, self.col = score, index, col
        self._shards = list(zip(alloc, req, nzr, valid, rows))
        self._pods = (pod_req, pod_nzr, mask_index)
        if self.device.type == "cuda":
            self._prepare_cuda()
        elif self.device.type != "cpu":
            raise KernelError(
                f"no shard-candidate solver for device type "
                f"{self.device.type!r}"
            )

    def _prepare_cuda(self) -> None:
        device = self.device
        i32, bl = torch.int32, torch.bool
        if self.p > MAX_SHARDS_PER_LAUNCH:
            raise KernelError(
                f"{self.p} shards on {device}: one K4 launch covers at most "
                f"{MAX_SHARDS_PER_LAUNCH} shards per device"
            )
        pod_req, pod_nzr, midx = self._pods
        b, r = pod_req.shape
        u = self._shards[0][4].shape[0] if self._shards else 0
        pods = (
            _check(pod_req, "pod_req", i32, (b, r), device),
            _check(pod_nzr, "pod_nzr", i32, (b, 2), device),
            _check(midx, "mask_index", i32, (b,), device),
        )
        shards = []
        for k, (a, q, z, v, rw) in enumerate(self._shards):
            n = a.shape[0]
            for t, name in ((q, "req"), (z, "nzr")):
                if not t.is_contiguous():
                    raise KernelError(f"shard {k} {name} is not contiguous")
            shards.append((
                _check(a, f"alloc[{k}]", i32, (n, r), device),
                _check(q, f"req[{k}]", i32, (n, r), device),
                _check(z, f"nzr[{k}]", i32, (n, 2), device),
                _check(v, f"valid[{k}]", bl, (n,), device),
                _check(rw, f"rows[{k}]", bl, (u, n), device),
            ))
        c = self.score.shape[1]
        for t, name, dtype in ((self.score, "score", torch.float32),
                               (self.index, "index", i32)):
            _check(t, name, dtype, (b, c), device)
            if not t.is_contiguous():
                raise KernelError(f"{name} is not contiguous")
        self._keep = (pods, shards)  # the checked tensors own the addresses
        self._r, self._u = r, u
        self._pod_ptrs = tuple(t.data_ptr() for t in pods)
        self._arrays = tuple(
            (ctypes.c_void_p * self.p)(*(s[j].data_ptr() for s in shards))
            for j in range(5)
        )
        self._n_loc = (ctypes.c_int * self.p)(*(s[0].shape[0] for s in shards))
        self._lib = build()
        self._fn = self._lib.shard_candidate_launch
        self._stream = torch.cuda.current_stream(device).cuda_stream
        w = self.config
        self._weights = (
            int(w.least_allocated_weight), int(w.balanced_allocation_weight),
            int(w.most_allocated_weight),
        )

    def step(self, t: int) -> None:
        """Pod t's candidates on every shard (the card: no host sync)."""
        global launches
        if self.device.type == "cpu":
            pod_req, pod_nzr, midx = self._pods
            for k, (a, q, z, v, rw) in enumerate(self._shards):
                best, idx = shard_candidate_plain(
                    a, q, z, v, rw, pod_req[t], pod_nzr[t], midx[t],
                    self.config,
                )
                self.score[t, self.col + k] = best
                self.index[t, self.col + k] = idx
            return
        if self.p == 0 or self._u == 0:
            self.score[t, self.col:self.col + self.p].fill_(-torch.inf)
            self.index[t, self.col:self.col + self.p].zero_()
            return
        req_p, nzr_p, midx_p = self._pod_ptrs
        r, p = self._r, self.p
        at = (t * self.score.shape[1] + self.col) * 4
        err = self._fn(
            p, *self._arrays, self._n_loc,
            req_p + t * r * 4, nzr_p + t * 8, midx_p + t * 4,
            r, self._u, *self._weights,
            self.score.data_ptr() + at, self.index.data_ptr() + at,
            self._stream,
        )
        if err != 0:
            raise KernelError(
                f"shard_candidate_kernel launch failed: cudaError {err}"
            )
        launches += 1


    def batch(self, active) -> torch.Tensor:
        """The whole batch when these shards are every shard of the mesh:
        per active pod t, the shards' candidates into ``score[t, col +
        k]`` / ``index[t, col + k]`` (as ``step(t)`` writes them), the
        best-of-shards combine (max score, then min index in the shards'
        stacked rows) and the winner's bump, applied to the shards'
        req/nzr IN PLACE. ``active``: [B] bool on the device. Returns the
        assignment [B] int32 (the stacked row, -1 for no node or an
        inactive pod). The card: ONE K4 launch, one thread-block cluster
        (no host sync); the CPU: ``mesh_batch_plain``."""
        global launches, last_plan
        pod_req, pod_nzr, midx = self._pods
        if self.device.type == "cpu":
            cols = [list(x) for x in zip(*self._shards)]
            return mesh_batch_plain(
                *cols, pod_req, pod_nzr, midx, active, self.config,
                score=self.score, index=self.index, col=self.col,
            )[0]
        device = self.device
        b, r = pod_req.shape
        act = _check(active, "active", torch.bool, (b,), device)
        asg = torch.empty(b, dtype=torch.int32, device=device)
        n_loc = list(self._n_loc)
        if b == 0:
            return asg
        if self.p == 0 or self._u == 0 or sum(n_loc) == 0:
            asg.fill_(-1)
            cols = slice(self.col, self.col + self.p)
            self.score[:, cols][act] = -torch.inf
            self.index[:, cols][act] = 0
            return asg
        offs = [sum(n_loc[:k]) for k in range(self.p)]
        with torch.cuda.device(device):
            plan = choose_plan(
                lambda c: plan_for_batch(n_loc, r, c, _static_bytes),
                card_admits(self._lib.shard_batch_max_clusters, _admitted,
                            torch.cuda.current_device()),
            )
            bounds = plan.slice_bounds
            cta = [ctypes.c_int * plan.cluster for _ in range(3)]
            shard = cta[0](*plan.shards)
            lo = cta[1](*(bounds[c] - offs[k] for c, k in enumerate(plan.shards)))
            hi = cta[2](*(bounds[c + 1] - offs[k]
                          for c, k in enumerate(plan.shards)))
            req_p, nzr_p, midx_p = self._pod_ptrs
            err = self._lib.shard_batch_launch(
                self.p, *self._arrays, self._n_loc, shard, lo, hi,
                req_p, nzr_p, midx_p, act.data_ptr(), asg.data_ptr(),
                self.score.data_ptr(), self.index.data_ptr(),
                self.score.shape[1], self.col, r, b, self._u,
                *self._weights, plan.cluster, plan.threads,
                int(plan.resident), plan.smem_bytes, self._stream,
            )
        if err != 0:
            raise KernelError(f"shard_batch_kernel launch failed: cudaError {err}")
        launches += 1
        last_plan = plan
        return asg


def _one_pod(alloc, req, nzr, valid, rows, pod_req, pod_nzr, mask_index,
             config):
    step = ShardCandidates(
        alloc, req, nzr, valid, rows, pod_req.reshape(1, -1),
        pod_nzr.reshape(1, 2), mask_index.reshape(1).to(torch.int32),
        config,
    )
    step.step(0)
    return step.score[0], step.index[0]


def shard_candidate_cuda(
    alloc, req, nzr, valid, rows, pod_req, pod_nzr, mask_index,
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K4 launch on the current stream (no synchronize) for one pod
    over the shards of one card: alloc..rows are sequences (one tensor
    per shard), pod_req [R], pod_nzr [2], mask_index [] or [1], all on
    the card with the kernel's dtypes. Returns fresh (best [P] f32,
    shard-local index [P] i32)."""
    if alloc[0].device.type != "cuda":
        raise KernelError(
            f"shard_candidate_cuda needs CUDA tensors, got {alloc[0].device}"
        )
    return _one_pod(alloc, req, nzr, valid, rows, pod_req, pod_nzr,
                    mask_index, config)


def shard_candidate(
    alloc, req, nzr, valid, rows, pod_req, pod_nzr, mask_index,
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """shard_candidate_cuda's function for shards on the card, the plain
    version per shard for shards on the CPU, an error otherwise."""
    kind = alloc[0].device.type
    if kind == "cuda":
        return shard_candidate_cuda(alloc, req, nzr, valid, rows, pod_req,
                                    pod_nzr, mask_index, config)
    if kind == "cpu":
        return _one_pod(alloc, req, nzr, valid, rows, pod_req, pod_nzr,
                        mask_index, config)
    raise KernelError(f"no shard-candidate solver for device type {kind!r}")
