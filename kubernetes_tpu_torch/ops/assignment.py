"""Batched assignment: priority-ordered greedy with on-device capacity
replay.

This is the device replacement for the serialized scheduleOne loop
(/root/reference/pkg/scheduler/scheduler.go:548): instead of popping one
pod, filtering/scoring all nodes, assuming, and repeating, a whole batch
of pods is solved in one call. Each step is one pod's cycle --
feasibility mask, score row, argmax -- and the carry replays the cache
``assume`` (internal/cache/cache.go:344 AssumePod): the chosen node's
requested/non-zero-requested accumulators are bumped before the next pod
is considered, so a batch can never double-book capacity
(sequential-consistency inside the batch; SURVEY.md section 7 "hardest
parts (a)").

Pods must arrive in activeQ order (priority desc, then FIFO --
queuesort/priority_sort.go) so the device replay equals the sequential
order. Ties in the score argmax pick the lowest node index; the reference
reservoir-samples among ties (generic_scheduler.go:242), so decisions are
identical modulo tie-break RNG.

On the card the whole batch runs as ONE hand-written CUDA kernel
(ops/greedy_kernel.py, csrc/greedy_solve.cu). ``_greedy_assign_impl``
below is its plain PyTorch version: a Python loop over pods, each step
parallel over nodes, taken only for tensors on the CPU.

All state, indices and outputs are int32 (torch defaults ``arange`` and
integer sums to int64, so every such call names its dtype).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.ops.scores import (
    balanced_allocation_score,
    least_allocated_score,
    most_allocated_score,
)
from kubernetes_tpu_torch.tensors.node_tensor import NUM_FIXED_DIMS, PODS

NO_NODE = -1

_PODS_COL = PODS  # the pod-count dimension of the node tensor


def _fits(free: torch.Tensor, pod_req: torch.Tensor) -> torch.Tensor:
    """Fit semantics (fit.go:181-252): the pod-count dimension is always
    checked; when every OTHER request is zero the reference short-circuits
    after it; otherwise EVERY dimension is checked strictly -- a zero
    request on an over-committed dimension (requested > allocatable,
    reachable via the nominated-pod overlay) still rejects, because the
    reference test is ``allocatable < requested + request``.

    free: [N, R] (allocatable - requested), pod_req: [R]. Returns [N] bool.
    """
    cols = torch.arange(pod_req.shape[0], device=pod_req.device)
    dim_ok = pod_req[None, :] <= free  # [N, R]
    # scalar/extended columns (>= NUM_FIXED_DIMS) are only checked when the
    # pod actually requests them: fit.go iterates podRequest.ScalarResources,
    # unlike the fixed cpu/memory/ephemeral checks which are unconditional
    scalar_skip = (cols >= NUM_FIXED_DIMS) & (pod_req == 0)
    dim_ok = dim_ok | scalar_skip[None, :]
    nonpods = cols != _PODS_COL
    all_zero = torch.max(torch.where(nonpods, pod_req, 0)) == 0
    return torch.where(all_zero, dim_ok[:, _PODS_COL], dim_ok.all(dim=-1))


@dataclass(frozen=True)
class GreedyConfig:
    """Device resource-scorer weights (LeastAllocated/BalancedAllocation
    at the default provider's weight 1, MostAllocated for bin-packing
    profiles)."""

    least_allocated_weight: int = 1
    balanced_allocation_weight: int = 1
    most_allocated_weight: int = 0


def _combined_score(caps, nzr_state, p_nzr, config) -> torch.Tensor:
    """Weighted resource score for one pod against node state of any
    leading shape: caps/nzr_state [..., 2], p_nzr [2]. Elementwise ops
    only; the terms add in the order least, balanced, most."""
    score = None
    for weight, scorer in (
        (config.least_allocated_weight, least_allocated_score),
        (config.balanced_allocation_weight, balanced_allocation_score),
        (config.most_allocated_weight, most_allocated_score),
    ):
        if weight:
            s = weight * scorer(caps, nzr_state, p_nzr[None, :])[0]
            score = s if score is None else score + s
    if score is None:
        score = torch.zeros(
            caps.shape[:-1], dtype=torch.float32, device=caps.device
        )
    return score


def _greedy_assign_impl(
    allocatable: torch.Tensor,  # [N, R] int32
    requested: torch.Tensor,  # [N, R] int32 (batch-start state)
    nzr: torch.Tensor,  # [N, 2] int32 non-zero requested (cpu, memKiB)
    valid: torch.Tensor,  # [N] bool
    pod_requests: torch.Tensor,  # [B, R] int32, in solve order
    pod_nzr: torch.Tensor,  # [B, 2] int32, in solve order
    static_mask: torch.Tensor,  # [B, N] bool host-side label filters
    active: torch.Tensor,  # [B] bool (False for padding rows)
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the greedy solve kernel: one node-parallel
    step per pod, in order. Returns (assignment [B] int32 node index or
    NO_NODE, requested' [N, R], nzr' [N, 2]) -- the post-batch node
    state so the host can incrementally reconcile instead of repacking.
    The inputs are never written."""
    caps = allocatable[:, :2]  # (milliCPU, memKiB) capacities for scorers
    n = allocatable.shape[0]
    node_iota = torch.arange(n, dtype=torch.int32, device=allocatable.device)
    no_node = torch.tensor(
        NO_NODE, dtype=torch.int32, device=allocatable.device
    )
    req_state, nzr_state = requested, nzr
    assignments = []
    for t in range(pod_requests.shape[0]):
        pod_req = pod_requests[t]
        p_nzr = pod_nzr[t]
        free = allocatable - req_state
        fits = _fits(free, pod_req)
        feasible = fits & static_mask[t] & valid
        score = _combined_score(caps, nzr_state, p_nzr, config)

        score = torch.where(feasible, score, -torch.inf)
        choice = torch.argmax(score).to(torch.int32)  # first max wins
        placed = feasible.any() & active[t]
        assignments.append(torch.where(placed, choice, no_node))

        chosen = ((node_iota == choice) & placed).to(torch.int32)
        req_state = req_state + chosen[:, None] * pod_req[None, :]
        nzr_state = nzr_state + chosen[:, None] * p_nzr[None, :]
    if assignments:
        out = torch.stack(assignments)
    else:
        out = torch.zeros(0, dtype=torch.int32, device=allocatable.device)
    return out, req_state, nzr_state


greedy_assign = _greedy_assign_impl


def greedy_assign_compact(
    allocatable: torch.Tensor,
    requested: torch.Tensor,
    nzr: torch.Tensor,
    valid: torch.Tensor,
    pod_requests: torch.Tensor,
    pod_nzr: torch.Tensor,
    mask_rows: torch.Tensor,  # [U, N] deduplicated static-mask rows
    mask_index: torch.Tensor,  # [B] int32 row index per pod
    active: torch.Tensor,
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """greedy_assign with the static mask shipped deduplicated (see
    host_masks.static_mask_compact) and expanded by a gather. Row
    indices clamp into range, as JAX's gather does."""
    midx = mask_index.long().clamp(0, max(mask_rows.shape[0] - 1, 0))
    return _greedy_assign_impl(
        allocatable, requested, nzr, valid, pod_requests, pod_nzr,
        mask_rows[midx], active, config=config,
    )


def _unpack_buffer(buf: torch.Tensor, layout: Tuple) -> dict:
    """Re-slice the single uploaded int32 buffer into named arrays.
    ``kind`` restores dtypes: 'i' int32, 'b' bool, 'f' float32 (bitcast
    -- float tensors ride the int32 buffer bit-exactly), 'h' int16
    values packed two per int32 word (halves the link bytes for
    range-gated carry state; decoded back to int32 values here);
    ``("Z*", fill)`` marks a ConstPiece materialized on the device."""
    arrs = {}
    off = 0
    for name, shape, kind in layout:
        if isinstance(kind, tuple):
            base, fill = kind
            dt = {"Zi": torch.int32, "Zf": torch.float32, "Zb": torch.bool}[
                base
            ]
            arrs[name] = torch.full(shape, fill, dtype=dt, device=buf.device)
            continue
        size = 1
        for d in shape:
            size *= d
        if kind == "h":
            nw = (size + 1) // 2
            w = buf[off:off + nw]
            lo = w & 0xFFFF
            lo = torch.where(lo >= 0x8000, lo - 0x10000, lo)  # sign-extend
            hi = w >> 16  # arithmetic shift sign-extends the high half
            a = torch.stack([lo, hi], dim=1).reshape(-1)[:size]
            arrs[name] = a.reshape(shape)
            off += nw
            continue
        a = buf[off:off + size].reshape(shape)
        if kind == "b":
            a = a.to(torch.bool)
        elif kind == "f":
            a = a.view(torch.float32)
        arrs[name] = a
        off += size
    return arrs


def _row_set(state: torch.Tensor, idx: torch.Tensor, rows: torch.Tensor):
    """``state.at[idx].set(rows, mode="drop")`` without a host sync and
    without touching ``state``: negative indices wrap once, as in JAX;
    anything still out of range lands on a scratch row that is cut off.
    (torch's index_put_ has no drop mode: an out-of-range index raises,
    on the card as a device-side assert.)"""
    n = state.shape[0]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx)
    idx = torch.where((idx < 0) | (idx >= n), n, idx)
    ext = torch.cat([state, state.new_zeros((1,) + tuple(state.shape[1:]))])
    ext[idx] = rows.to(state.dtype)
    return ext[:n]


def _apply_row_patches(arrs, alloc, valid, req_state, nzr_state):
    """Row-delta scatter (the steady-state patch path): changed node rows
    ride the same single upload buffer as (indices, rows) and are
    scattered onto copies of the device-RESIDENT state here, so external
    churn costs O(changed rows) on the link instead of a full [N, R]
    re-upload. Padding slots carry index >= N and drop."""
    if "didx" in arrs:
        didx = arrs["didx"]
        req_state = _row_set(req_state, didx, arrs["dreq"])
        nzr_state = _row_set(nzr_state, didx, arrs["dnzr"])
    if "sidx" in arrs:
        alloc = _row_set(alloc, arrs["sidx"], arrs["salloc"])
        if "svalid" in arrs:
            # membership churn: retired/claimed row slots also flip the
            # resident valid mask (padding slots carry index >= N, drop)
            valid = _row_set(valid, arrs["sidx"], arrs["svalid"] != 0)
    return alloc, valid, req_state, nzr_state


def _solve_packed(
    buf: torch.Tensor,  # [T] int32: every uploaded piece, concatenated
    alloc_in,  # [N, R] int32 device-resident, or None when in buf
    valid_in,  # [N] bool device-resident, or None when in buf
    req_in,  # [N, R] int32/int16 carried device state, or None when in buf
    nzr_in,  # [N, 2] int32/int16 carried device state, or None when in buf
    layout: Tuple,  # ((name, shape, kind), ...) describing buf slices
    config: GreedyConfig = GreedyConfig(),
    compress: bool = False,  # int16 resident carry: widen in, narrow out
):
    """Solve from a SINGLE uploaded buffer. Returns (assignment,
    requested', nzr', allocatable, valid) -- the last two so the caller
    can keep device-resident refs when they rode the buffer. Resident
    inputs are never written: every output is a fresh tensor."""
    arrs = _unpack_buffer(buf, layout)
    alloc = arrs["alloc"] if "alloc" in arrs else alloc_in
    valid = arrs["valid"].to(torch.bool) if "valid" in arrs else valid_in
    req_state = arrs["req_state"] if "req_state" in arrs else req_in
    nzr_state = arrs["nzr_state"] if "nzr_state" in arrs else nzr_in
    # a compressed carry normalizes to int32 at entry (lossless: the
    # engage gate bounds every resident value to int16 range), so the
    # solver sees ONE dtype regardless of how the state is held
    req_state = req_state.to(torch.int32)
    nzr_state = nzr_state.to(torch.int32)
    alloc, valid, req_state, nzr_state = _apply_row_patches(
        arrs, alloc, valid, req_state, nzr_state
    )
    assignment, req_out, nzr_out, alloc, valid = _packed_solve_tail(
        arrs, alloc, valid, req_state, nzr_state, config
    )
    if compress:
        req_out = req_out.to(torch.int16)
        nzr_out = nzr_out.to(torch.int16)
    return assignment, req_out, nzr_out, alloc, valid


def _packed_solve_tail(arrs, alloc, valid, req_state, nzr_state, config):
    """The greedy solve on the (possibly row-patched) node state: the
    hand-written kernel for tensors on the card, its plain version for
    tensors on the CPU (ops/greedy_kernel.greedy_solve decides)."""
    from kubernetes_tpu_torch.ops.greedy_kernel import greedy_solve

    assignment, req_out, nzr_out = greedy_solve(
        alloc, req_state, nzr_state, valid, arrs["req"], arrs["nzr"],
        arrs["rows"].to(torch.bool), arrs["midx"],
        arrs["active"].to(torch.bool), config=config,
    )
    return assignment, req_out, nzr_out, alloc, valid


def kernel_build_counts() -> dict:
    """Kernel builds per family in this process, keyed by a stable name:
    the runtime cache watchdog (scheduler/batch.py) diffs this per batch,
    so a build after warmup shows up as a mid-run recompile."""
    from kubernetes_tpu_torch.ops import greedy_kernel

    return {"greedy_kernel": greedy_kernel.builds}


def apply_assignment_delta(
    req_state: torch.Tensor,  # [N, R] int32 device-resident
    nzr_state: torch.Tensor,  # [N, 2] int32 device-resident
    assignments,  # [B] int32 node index or NO_NODE (host or device)
    pod_req,  # [B, R] int32, solve order
    pod_nzr,  # [B, 2] int32, solve order
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter-add one solve's own assignment output onto the
    device-resident node state: every placed pod's request row lands on
    its chosen node row; NO_NODE / out-of-range slots drop (onto a
    scratch row, so no index ever reaches the scatter out of range).
    Keeps the carry warm when the assignments were produced OFF device
    (the host-greedy ladder tier). Dtype-preserving: an int16
    compressed carry accumulates in int32 and narrows back. The inputs
    are never written."""
    dev = req_state.device
    n = req_state.shape[0]
    a = torch.as_tensor(np.asarray(assignments), device=dev).long()
    idx = torch.where((a < 0) | (a >= n), n, a)

    def scatter(state, rows):
        rows = torch.as_tensor(np.asarray(rows), device=dev).to(torch.int32)
        ext = torch.cat([
            state.to(torch.int32),
            torch.zeros((1, state.shape[1]), dtype=torch.int32, device=dev),
        ])
        ext.index_add_(0, idx, rows)
        return ext[:n].to(state.dtype)

    return scatter(req_state, pod_req), scatter(nzr_state, pod_nzr)


def compress_carry(req_state, nzr_state):
    """Narrow the device-resident carry to int16 (lossless under the
    engage gate's range guarantee; scheduler/batch.py books the gate)."""
    return req_state.to(torch.int16), nzr_state.to(torch.int16)


def decompress_carry(req_state, nzr_state):
    """Widen an int16 resident carry back to int32."""
    return req_state.to(torch.int32), nzr_state.to(torch.int32)


class ConstPiece:
    """Marker operand: uniformly filled with one value (absent
    constraint families are all-zero counts / all -1 sentinel ids).
    Materialized on the device as a constant instead of riding the
    upload buffer."""

    __slots__ = ("shape", "kind")

    def __init__(self, shape, dtype, fill) -> None:
        self.shape = tuple(shape)
        if dtype == np.float32:
            base = "f"
            fill = float(fill)
        elif dtype == np.bool_:
            base = "b"
            fill = bool(fill)
        else:
            base = "i"
            fill = int(fill)
        self.kind = ("Z" + base, fill)

    @staticmethod
    def from_uniform(arr):
        """ConstPiece for a uniformly-filled array (asserts uniformity:
        a non-uniform 'noop' tensor silently changing semantics is
        exactly the bug this guards against)."""
        arr = np.asarray(arr)
        fill = arr.flat[0] if arr.size else 0
        assert (arr == fill).all(), "ConstPiece source is not uniform"
        return ConstPiece(arr.shape, arr.dtype, fill)


def _piece_kind(arr):
    if isinstance(arr, ConstPiece):
        return arr.kind
    if arr.dtype == np.float32:
        return "f"
    if arr.dtype == np.bool_:
        return "b"
    if arr.dtype == np.int16:
        return "h"
    return "i"


def _as_i32(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.float32:
        return np.ascontiguousarray(arr).view(np.int32)
    if arr.dtype == np.int16:
        # pack two int16 values per int32 word (the 'h' layout kind):
        # halves the link bytes; _unpack_buffer sign-extends the halves
        flat = arr.ravel().astype(np.int32)
        if flat.size % 2:
            flat = np.concatenate([flat, np.zeros(1, dtype=np.int32)])
        return (flat[0::2] & 0xFFFF) | (flat[1::2] << 16)
    if arr.dtype == np.int32:
        return arr
    return arr.astype(np.int32)


def solve_packed(
    pieces,  # ordered [(name, ndarray)] to ride the buffer
    alloc_in,
    valid_in,
    req_in,
    nzr_in,
    config: GreedyConfig = GreedyConfig(),
    mode: str = "greedy",
    compress: bool = False,
    device=None,
):
    """Host-side companion of _solve_packed: concatenates the pieces
    (int32 / bool / float32 / packed int16 -- see _unpack_buffer's kind
    codes) and dispatches ONE host->device copy + one solve on
    ``device`` (the card unless the caller names the CPU). A kernel
    that fails to build or launch raises: nothing here retries on
    another path."""
    if mode != "greedy":
        raise ValueError(
            f"solve mode {mode!r} is not ported yet: the constrained "
            "and sinkhorn solves arrive in a later slice of the port"
        )
    device = resolve_device(device)
    layout = tuple(
        (name, arr.shape, _piece_kind(arr)) for name, arr in pieces
    )
    buf = np.concatenate(
        [
            _as_i32(arr).ravel()
            for _, arr in pieces
            if not isinstance(arr, ConstPiece)
        ]
    )
    buf_d = torch.from_numpy(buf).to(device)
    return _solve_packed(
        buf_d, alloc_in, valid_in, req_in, nzr_in,
        layout=layout, config=config, compress=compress,
    )


def carry_from_numpy(alloc, valid, req, nzr, config, device):
    """The port's resident carry from the arrays the JAX package's
    ``_DeviceNodeState``/``NodeTensor`` hold (anything ``np.asarray``
    takes) and a GreedyConfig's weights. Returns ((alloc, valid, req,
    nzr) tensors on ``device`` -- int32, valid bool -- , GreedyConfig)."""
    device = resolve_device(device)

    def i32(a):  # np.array copies: the source may be read-only
        return torch.as_tensor(np.array(a, dtype=np.int32), device=device)

    carry = (
        i32(alloc),
        torch.as_tensor(np.array(valid, dtype=bool), device=device),
        i32(req),
        i32(nzr),
    )
    cfg = GreedyConfig(
        least_allocated_weight=int(config.least_allocated_weight),
        balanced_allocation_weight=int(config.balanced_allocation_weight),
        most_allocated_weight=int(config.most_allocated_weight),
    )
    return carry, cfg
