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

On the card the whole batch runs as ONE hand-written CUDA kernel: the
greedy solve (ops/greedy_kernel.py, csrc/greedy_solve.cu) or, for a
batch with constraint or score-dynamic families, the constrained solve
(ops/constrained_kernel.py, csrc/constrained_solve.cu).
``_greedy_assign_impl`` and ``greedy_assign_constrained`` below are
their plain PyTorch versions: a Python loop over pods, each step
parallel over nodes, taken only for tensors on the CPU.

The sinkhorn mode (``sinkhorn_assign``) computes an entropic-OT prior
over the batch as torch ops (``sinkhorn_prior``, ops/sinkhorn.py), then
commits through the greedy kernel's scored entry on the card (its plain
version: ``sinkhorn_commit``).

On a node-sharded mesh (ops/mesh.py ``NodeMesh``; ``solve_packed(...,
mesh=)``) a greedy batch goes to the mesh kernel K4 instead
(``_mesh_greedy``; ops/shard_kernel.py, csrc/shard_candidate.cu): when one
device holds every shard, ONE launch solves the batch with the
best-of-shards combine and the winner's bump on the card; a mesh over
several devices steps through its pods here, each step one K4 launch per
device plus the combine and the bump in torch.

All state, indices and outputs are int32 (torch defaults ``arange`` and
integer sums to int64, so every such call names its dtype).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.ops import sinkhorn
from kubernetes_tpu_torch.ops.mesh import (
    NodeMesh,
    ShardedRows,
    shard_local_row_set,
)
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
    prior=None,  # [B, N] float32: the sinkhorn commit scan's prior
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the greedy solve kernel: one node-parallel
    step per pod, in order. Returns (assignment [B] int32 node index or
    NO_NODE, requested' [N, R], nzr' [N, 2]) -- the post-batch node
    state so the host can incrementally reconcile instead of repacking.
    The inputs are never written. With ``prior`` a feasible node's score
    is ``prior[t] + the resource score`` (the kernel's scored entry)."""
    caps = allocatable[:, :2]  # (milliCPU, memKiB) capacities for scorers
    n = allocatable.shape[0]
    if n == 0:
        # no node (a partitioned stack holding none): every pod NO_NODE
        # and the state unchanged, as the kernel answers
        return (
            torch.full((pod_requests.shape[0],), NO_NODE, dtype=torch.int32,
                       device=allocatable.device),
            requested, nzr,
        )
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
        if prior is not None:  # the reference's `row + score_dyn`
            score = prior[t] + score

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
    prior=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """greedy_assign with the static mask shipped deduplicated (see
    host_masks.static_mask_compact) and expanded by a gather. Row
    indices clamp into range, as JAX's gather does."""
    midx = mask_index.long().clamp(0, max(mask_rows.shape[0] - 1, 0))
    return _greedy_assign_impl(
        allocatable, requested, nzr, valid, pod_requests, pod_nzr,
        mask_rows[midx], active, config=config, prior=prior,
    )


def _greedy_assign_scored_impl(
    allocatable: torch.Tensor,  # [N, R] int32
    requested: torch.Tensor,  # [N, R] int32
    valid: torch.Tensor,  # [N] bool
    pod_requests: torch.Tensor,  # [B, R] int32, solve order
    static_mask: torch.Tensor,  # [B, N] bool
    active: torch.Tensor,  # [B] bool
    score_matrix: torch.Tensor,  # [B, N] float32 precomputed (e.g. Sinkhorn)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-replay commit scan over a PRECOMPUTED score matrix:
    feasibility is re-checked exactly per step, only the ranking comes
    from the matrix. Returns (assignment, requested'); the inputs are
    never written."""
    n = allocatable.shape[0]
    dev = allocatable.device
    node_iota = torch.arange(n, dtype=torch.int32, device=dev)
    no_node = torch.tensor(NO_NODE, dtype=torch.int32, device=dev)
    req_state = requested
    assignments = []
    for t in range(pod_requests.shape[0]):
        pod_req = pod_requests[t]
        feasible = _fits(allocatable - req_state, pod_req) & static_mask[t] & valid
        score = torch.where(feasible, score_matrix[t], -torch.inf)
        choice = torch.argmax(score).to(torch.int32)  # first max wins
        placed = feasible.any() & active[t]
        assignments.append(torch.where(placed, choice, no_node))
        chosen = ((node_iota == choice) & placed).to(torch.int32)
        req_state = req_state + chosen[:, None] * pod_req[None, :]
    if assignments:
        out = torch.stack(assignments)
    else:
        out = torch.zeros(0, dtype=torch.int32, device=dev)
    return out, req_state


greedy_assign_scored = _greedy_assign_scored_impl

#: the skew rule's "no eligible value" minimum (the reference's ``big``)
_SPREAD_BIG = 1 << 20


def greedy_assign_spread(
    allocatable: torch.Tensor,  # [N, R] int32
    requested: torch.Tensor,  # [N, R] int32
    nzr: torch.Tensor,  # [N, 2] int32
    valid: torch.Tensor,  # [N] bool
    pod_requests: torch.Tensor,  # [B, R] int32, solve order
    pod_nzr: torch.Tensor,  # [B, 2] int32
    static_mask: torch.Tensor,  # [B, N] bool
    active: torch.Tensor,  # [B] bool
    group_counts: torch.Tensor,  # [G, V] int32 initial spread counts
    value_valid: torch.Tensor,  # [G, V] bool
    node_value: torch.Tensor,  # [G, N] int32 (-1 = ineligible)
    pod_groups: torch.Tensor,  # [B, C] int32 (-1 pad)
    pod_max_skew: torch.Tensor,  # [B, C] int32
    pod_self: torch.Tensor,  # [B, C] int32
    pod_match: torch.Tensor,  # [B, G] int32
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """greedy_assign plus hard topology-spread filtering with the
    within-batch count replay (ops/topology.py), one pod step at a time.
    A node passes constraint slot c of group g when its value v is
    eligible (>= 0) and ``counts[g, v] + self - min_v <= max_skew``,
    ``min_v`` the least count over the group's valid values (2^20 when
    none is valid); a slot of -1 passes every node. A placed pod bumps
    every group it matches at the chosen node's value. Int32 throughout,
    the lowest index wins ties, and the inputs are never written.
    Returns (assignment, requested', nzr', group_counts')."""
    caps = allocatable[:, :2]
    n = allocatable.shape[0]
    dev = allocatable.device
    g_count, v_count = group_counts.shape
    node_iota = torch.arange(n, dtype=torch.int32, device=dev)
    group_iota = torch.arange(g_count, device=dev)
    no_node = torch.tensor(NO_NODE, dtype=torch.int32, device=dev)
    big = torch.tensor(_SPREAD_BIG, dtype=torch.int32, device=dev)
    req_state, nzr_state, counts = requested, nzr, group_counts
    assignments = []
    for t in range(pod_requests.shape[0]):
        pod_req = pod_requests[t]
        p_nzr = pod_nzr[t]
        feasible = (
            _fits(allocatable - req_state, pod_req) & static_mask[t] & valid
        )
        groups = pod_groups[t]  # [C]
        safe = groups.clamp(min=0).long()
        counts_g = counts[safe]  # [C, V]
        min_v = torch.where(value_valid[safe], counts_g, big).amin(dim=1)
        vals = node_value[safe]  # [C, N]
        node_count = torch.gather(counts_g, 1, vals.clamp(0, v_count - 1).long())
        ok = (vals >= 0) & (
            node_count + pod_self[t][:, None] - min_v[:, None]
            <= pod_max_skew[t][:, None]
        )
        ok = ok | (groups < 0)[:, None]
        feasible = feasible & ok.all(dim=0)
        score = _combined_score(caps, nzr_state, p_nzr, config)
        score = torch.where(feasible, score, -torch.inf)
        choice = torch.argmax(score).to(torch.int32)  # first max wins
        placed = feasible.any() & active[t]
        assignments.append(torch.where(placed, choice, no_node))

        chosen = ((node_iota == choice) & placed).to(torch.int32)
        req_state = req_state + chosen[:, None] * pod_req[None, :]
        nzr_state = nzr_state + chosen[:, None] * p_nzr[None, :]
        vals_at_choice = node_value[:, choice.long()]  # [G]
        bump = (
            placed & (vals_at_choice >= 0) & (pod_match[t] > 0)
        ).to(torch.int32)
        counts = counts.index_put(
            (group_iota, vals_at_choice.clamp(0, v_count - 1).long()),
            bump, accumulate=True,
        )
    if assignments:
        out = torch.stack(assignments)
    else:
        out = torch.zeros(0, dtype=torch.int32, device=dev)
    return out, req_state, nzr_state, counts


def _fits_batch(free: torch.Tensor, pod_requests: torch.Tensor) -> torch.Tensor:
    """``_fits`` for every pod of a batch at once: [N, R] free x [B, R]
    requests -> [B, N] bool, one dimension at a time, so no [B, N, R]
    tensor is ever made (at 1,024 pods x 50,048 rows x R=4 that would be
    ~800 MB of int32)."""
    r = pod_requests.shape[1]
    cols = torch.arange(r, device=pod_requests.device)
    nonpods = torch.where(cols[None, :] != _PODS_COL, pod_requests, 0)
    all_zero = nonpods.amax(dim=1) == 0
    fits_all = None
    fits_pods = None
    for d in range(r):
        ok = pod_requests[:, d, None] <= free[None, :, d]
        if d >= NUM_FIXED_DIMS:
            # scalar columns are checked only when the pod requests them
            ok = ok | (pod_requests[:, d] == 0)[:, None]
        fits_all = ok if fits_all is None else fits_all & ok
        if d == _PODS_COL:
            fits_pods = ok
    return torch.where(all_zero[:, None], fits_pods, fits_all)


def sinkhorn_plan_inputs(
    allocatable: torch.Tensor,  # [N, R] int32
    requested: torch.Tensor,  # [N, R] int32
    nzr: torch.Tensor,  # [N, 2] int32
    valid: torch.Tensor,  # [N] bool
    pod_requests: torch.Tensor,  # [B, R] int32, solve order
    pod_nzr: torch.Tensor,  # [B, 2] int32
    mask_rows: torch.Tensor,  # [U, N] deduplicated static-mask rows
    mask_index: torch.Tensor,  # [B] int32
    active: torch.Tensor,  # [B] bool
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the sinkhorn plan is computed from (the first part of the JAX
    package's ``sinkhorn_assign``): the batch-start resource scores [B,
    N] f32, the batch-start feasibility [B, N] bool, and the column
    capacities [N] f32 -- the free pod slots cut to a fair share of the
    batch's mass over the columns it can use (2 x mass / usable columns,
    at least 1). Plain torch ops on the inputs' device."""
    midx = mask_index.long().clamp(0, max(mask_rows.shape[0] - 1, 0))
    sm = mask_rows[midx]  # [B, N]
    caps = allocatable[:, :2]
    # batch-start scores + feasibility feed the global plan; the commit
    # scan re-checks fit exactly per step
    base = torch.zeros(sm.shape, dtype=torch.float32, device=sm.device)
    for weight, scorer in (
        (config.least_allocated_weight, least_allocated_score),
        (config.balanced_allocation_weight, balanced_allocation_score),
        (config.most_allocated_weight, most_allocated_score),
    ):
        if weight:
            base = base + weight * scorer(caps, nzr, pod_nzr)
    feasible0 = (
        _fits_batch(allocatable - requested, pod_requests) & sm & valid[None, :]
    )
    slots = torch.clamp(
        (allocatable[:, _PODS_COL] - requested[:, _PODS_COL]).to(torch.float32),
        min=0.0,
    )
    # Balance-seeking column marginals: raw free pod slots are ~110 per
    # node, so with pods << slots the capacity cap never binds and the
    # score prior concentrates mass. Capping each column near the uniform
    # share of the columns THIS batch can use makes the plan spread,
    # while 2x headroom keeps genuinely better nodes attractive.
    batch_mass = active.to(torch.float32).sum()
    usable = (slots > 0) & feasible0.any(dim=0)
    fair_share = 2.0 * batch_mass / torch.clamp(
        usable.to(torch.float32).sum(), min=1.0
    )
    slots = torch.minimum(slots, torch.clamp(fair_share, min=1.0))
    return base, feasible0, slots


def sinkhorn_prior(
    allocatable: torch.Tensor,
    requested: torch.Tensor,
    nzr: torch.Tensor,
    valid: torch.Tensor,
    pod_requests: torch.Tensor,
    pod_nzr: torch.Tensor,
    mask_rows: torch.Tensor,
    mask_index: torch.Tensor,
    active: torch.Tensor,
    config: GreedyConfig = GreedyConfig(),
    iters: int = sinkhorn.ITERS,
) -> torch.Tensor:
    """The sinkhorn mode's prior: the entropic-OT plan over the whole
    batch (ops/sinkhorn.py) from ``sinkhorn_plan_inputs``, returned
    1e4-scaled as [B, N] float32 on the inputs' device."""
    score, feasible, slots = sinkhorn_plan_inputs(
        allocatable, requested, nzr, valid, pod_requests, pod_nzr,
        mask_rows, mask_index, active, config=config,
    )
    return sinkhorn.refine_scores(score, feasible, slots, active, iters=iters)


def sinkhorn_commit(
    allocatable: torch.Tensor,  # [N, R] int32
    requested: torch.Tensor,  # [N, R] int32
    nzr: torch.Tensor,  # [N, 2] int32
    valid: torch.Tensor,  # [N] bool
    pod_requests: torch.Tensor,  # [B, R] int32, solve order
    pod_nzr: torch.Tensor,  # [B, 2] int32
    mask_rows: torch.Tensor,  # [U, N] deduplicated static-mask rows
    mask_index: torch.Tensor,  # [B] int32
    active: torch.Tensor,  # [B] bool
    prior: torch.Tensor,  # [B, N] float32 (sinkhorn_prior)
    config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sinkhorn commit scan, the plain version of the greedy-solve
    kernel's scored entry (ops/greedy_kernel.py): the greedy scan with
    the score ``prior[t] + the dynamic resource score`` over the feasible
    rows, the lowest index winning ties. The dynamic score breaks the
    ties of near-uniform plans with within-batch load feedback. Returns
    (assignment [B] int32, requested' [N, R], nzr' [N, 2]); the inputs
    are never written."""
    return greedy_assign_compact(
        allocatable, requested, nzr, valid, pod_requests, pod_nzr,
        mask_rows, mask_index, active, config=config, prior=prior,
    )


def sinkhorn_assign(
    allocatable: torch.Tensor,
    requested: torch.Tensor,
    nzr: torch.Tensor,
    valid: torch.Tensor,
    pod_requests: torch.Tensor,
    pod_nzr: torch.Tensor,
    mask_rows: torch.Tensor,  # [U, N] deduplicated static-mask rows
    mask_index: torch.Tensor,  # [B] int32
    active: torch.Tensor,
    config: GreedyConfig = GreedyConfig(),
    iters: int = sinkhorn.ITERS,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Globally-aware assignment for the churn/rebalance regime
    (BASELINE config #5): the entropic-OT prior over the whole batch
    (``sinkhorn_prior``) replaces the myopic per-step ranking, then the
    EXACT capacity-replay commit scan enforces feasibility step by step
    -- on the card the greedy-solve kernel's scored entry, on the CPU
    ``sinkhorn_commit`` (ops/greedy_kernel.greedy_solve decides). Same
    signature family as greedy_assign_compact."""
    from kubernetes_tpu_torch.ops.greedy_kernel import greedy_solve

    common = (
        allocatable, requested, nzr, valid, pod_requests, pod_nzr,
        mask_rows, mask_index, active,
    )
    prior = sinkhorn_prior(*common, config=config, iters=iters)
    return greedy_solve(*common, config=config, prior=prior)


#: family tuple sizes for the packed constrained layout (the order
#: matches greedy_assign_constrained's spread/affinity/scoring tuples)
_N_SPREAD = 7
_N_AFFINITY = 14
_N_SCORING = 20

_BIG = 1 << 20  # "no value" sentinel of the spread minimum and soft min
#: f32 constants of the SelectorSpread zone blend ``f_node / 3.0 + (2.0 /
#: 3.0) * f_zone`` as the reference's compiler (XLA) evaluates it: the
#: division by the constant becomes a multiply by its f32 reciprocal,
#: fused with the add into one FMA; the other product rounds on its own
_THIRD = float(np.float32(1.0 / 3.0))
_TWO_THIRDS = float(np.float32(2.0 / 3.0))


def _fma32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (a fused multiply-add), for f32
    tensors a, c and an f32-representable constant b. The product is exact
    in float64; the float64 sum's rounding error is recovered (TwoSum) and
    decides the one case where rounding the float64 sum to f32 would round
    twice: a sum that lands exactly halfway between two f32 values."""
    p = a.to(torch.float64) * b
    c64 = c.to(torch.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    toward = torch.where(s > r64, torch.inf, -torch.inf).to(torch.float32)
    other = torch.nextafter(r, toward)
    halfway = (s != r64) & ((r64 + other.to(torch.float64)) * 0.5 == s)
    # exactly halfway in float64 but not in truth: round toward the error
    fix = halfway & (err != 0)
    pick_other = fix & ((other.to(torch.float64) > r64) == (err > 0))
    return torch.where(pick_other, other, r)


def row_node_values(node_value: torch.Tensor, row_key: torch.Tensor):
    """[R, N] per-row node values: -1 where the node lacks the row's
    topology key or the row is padding."""
    k = node_value.shape[0]
    vals = node_value[row_key.long().clamp(0, max(k - 1, 0))]
    return torch.where(row_key[:, None] >= 0, vals, -1)


def _gather_values(counts: torch.Tensor, vals: torch.Tensor):
    """counts[row, vals[row, node]] with the value clamped into range,
    as JAX's gather clamps: [R, V] x [R, N] -> [R, N]."""
    v = counts.shape[1]
    return counts.gather(1, vals.long().clamp(0, v - 1))


def affinity_node_ok(
    counts_aff,  # [Ra, V]
    counts_anti,  # [Rt, V]
    counts_exist,  # [Re, V]
    vals_aff,  # [Ra, N] per-row node values (-1 absent)
    vals_anti,  # [Rt, N]
    vals_exist,  # [Re, N]
    aff_rows,  # [C] the pod's affinity rows (-1 pad)
    self_match,  # [] bool
    anti_rows,  # [C]
    exist_match,  # [Re] bool
) -> torch.Tensor:
    """The three required-affinity Filter checks for ONE pod against all
    nodes, straight from interpodaffinity/filtering.go. Returns [N] bool.
    A family with no rows checks nothing."""
    n = vals_aff.shape[1]
    ok = torch.ones(n, dtype=torch.bool, device=vals_aff.device)
    if counts_aff.shape[0]:
        # incoming affinity: every term's pair positive
        # (nodeMatchesAllTopologyTerms :420)
        aff_pos = (vals_aff >= 0) & (_gather_values(counts_aff, vals_aff) > 0)
        live = aff_rows >= 0
        safe_rows = aff_rows.long().clamp(0, counts_aff.shape[0] - 1)
        aff_all = torch.where(live[:, None], aff_pos[safe_rows], True).all(0)
        # first-pod escape (filtering.go:494): no match anywhere for the
        # pod's term-set AND the pod matches its own terms
        row_tot = counts_aff.sum(dim=1, dtype=torch.int32)
        total = (row_tot[safe_rows] * live).sum(dtype=torch.int32)
        ok = aff_all | ((total == 0) & self_match)
    if counts_anti.shape[0]:
        # incoming anti-affinity: any positive pair blocks
        # (nodeMatchesAnyTopologyTerm :437)
        anti_bad = (vals_anti >= 0) & (
            _gather_values(counts_anti, vals_anti) > 0
        )
        safe_anti = anti_rows.long().clamp(0, counts_anti.shape[0] - 1)
        bad = torch.where(
            (anti_rows >= 0)[:, None], anti_bad[safe_anti], False
        ).any(0)
        ok = ok & ~bad
    if counts_exist.shape[0]:
        # existing pods' anti-affinity (:404)
        exist_bad = (vals_exist >= 0) & (
            _gather_values(counts_exist, vals_exist) > 0
        )
        ok = ok & ~(exist_match[:, None] & exist_bad).any(0)
    return ok


def greedy_assign_constrained(
    allocatable: torch.Tensor,  # [N, R] int32
    requested: torch.Tensor,  # [N, R] int32
    nzr: torch.Tensor,  # [N, 2] int32
    valid: torch.Tensor,  # [N] bool
    pod_requests: torch.Tensor,  # [B, R] int32, solve order
    pod_nzr: torch.Tensor,  # [B, 2] int32
    mask_rows: torch.Tensor,  # [U, N] deduplicated static-mask rows
    mask_index: torch.Tensor,  # [B] int32
    active: torch.Tensor,  # [B] bool
    spread: Tuple[torch.Tensor, ...],
    affinity: Tuple[torch.Tensor, ...],
    scoring: Tuple[torch.Tensor, ...],
    config: GreedyConfig = GreedyConfig(),
    pair_counts=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the constrained solve kernel (K2,
    ops/constrained_kernel.py): NodeResourcesFit + static label mask +
    hard topology spread (ops/topology.py) + required pod (anti-)affinity
    (ops/affinity.py) + the full default score plugin set
    (ops/scoring.py), one node-parallel step per pod in solve order, with
    every constraint family's count tensors replayed as pods place so
    within-batch interactions match the sequential addNominatedPods
    semantics (interpodaffinity/filtering.go:75 updateWithPod,
    podtopologyspread/filtering.go:127 updateWithPod).

    ``spread``: (group_counts [G,V], value_valid [G,V], node_value [G,N],
    pod_groups [B,C], pod_max_skew [B,C], pod_self [B,C], pod_match [B,G]).
    ``affinity``: the AffinityBatch arrays (ops/affinity.py docstring).
    ``scoring``: the ScoreBatch arrays (ops/scoring.py docstring); the
    zone one-hot is read through ``zone_id``, the one map both are packed
    from. All-zero / -1 tensors make a family a no-op.

    Normalizations (max-scale for preferred NodeAffinity, reversed for
    TaintToleration, zone-blended inversion for SelectorSpread,
    flipped-linear for soft spread, [min, max] for preferred inter-pod
    affinity) run per step over THAT step's feasible set, the reference's
    normalize-over-filtered-nodes semantics. Every f32 expression keeps
    the reference scan's operation order and constants. An inactive pod
    is skipped: it never places, so it changes no state. Returns
    (assignment [B] int32, requested' [N, R], nzr' [N, 2]); the inputs
    are never written. ``pair_counts``, when a list, receives for each
    active pod the number of nodes that pass fit, mask and valid, and the
    number that are feasible (an int tensor of 2)."""
    (sp_counts, sp_value_valid, sp_node_value,
     sp_pod_groups, sp_pod_max_skew, sp_pod_self, sp_pod_match) = spread
    (af_node_value, counts_aff, af_row_key_aff, af_pod_aff_rows,
     af_pod_self_match, af_pod_bump_aff,
     counts_anti, af_row_key_anti, af_pod_anti_rows, af_pod_bump_anti,
     counts_exist, af_row_key_exist, af_pod_exist_match,
     af_pod_bump_exist) = affinity
    (sc_direct, sc_nodeaff, sc_taint, sc_pod_sig,
     sel_counts, sc_zone_onehot, sc_zone_id, sc_pod_sel_group,
     sc_pod_sel_match, soft_counts, sc_soft_node_value,
     sc_pod_soft_groups, sc_pod_soft_match,
     sc_ipa_node_value, ipa_counts, ipa_wcounts,
     sc_pod_ipa_weight, sc_pod_ipa_match, sc_pod_ipa_bump,
     sc_weights) = scoring
    dev = allocatable.device
    i32, f32 = torch.int32, torch.float32
    n = allocatable.shape[0]
    w_na, w_tt, w_sel, w_soft, w_ipa = (
        sc_weights.to(f32)[k] for k in range(5)
    )
    # the count tensors are replayed in place on copies
    sp_counts = sp_counts.to(i32).clone()
    counts_aff = counts_aff.to(i32).clone()
    counts_anti = counts_anti.to(i32).clone()
    counts_exist = counts_exist.to(i32).clone()
    sel_counts = sel_counts.to(i32).clone()
    soft_counts = soft_counts.to(i32).clone()
    ipa_counts = ipa_counts.to(f32).clone()
    ipa_wcounts = ipa_wcounts.to(f32).clone()
    g_sp = sp_counts.shape[0]
    g_sel = sel_counts.shape[0]
    g_soft = soft_counts.shape[0]
    r_ipa, v_ipa = ipa_counts.shape
    z = sc_zone_onehot.shape[1]

    # per-row node values are static for the batch (rows bind to one
    # topology key each); -1 marks "node lacks the key" / padding rows
    vals_aff = row_node_values(af_node_value, af_row_key_aff)
    vals_anti = row_node_values(af_node_value, af_row_key_anti)
    vals_exist = row_node_values(af_node_value, af_row_key_exist)
    ipa_has_val = sc_ipa_node_value >= 0
    ipa_live = bool(r_ipa) and ipa_has_val.any()
    ipa_idx = sc_ipa_node_value.long().clamp(0, max(v_ipa - 1, 0))
    zone_ok = sc_zone_id >= 0
    zone_idx = sc_zone_id.long().clamp(0, max(z - 1, 0))

    def replay(counts, vals, bump, c, pi):
        """A placed pod (``pi`` 1) bumps every row it matches at the
        chosen node ``c``'s value of that row's topology key
        (updateWithPod generalized to the batch); rows where the node
        lacks the key take no bump."""
        v = vals[:, c]
        counts.index_put_(
            (torch.arange(counts.shape[0], device=dev),
             v.long().clamp(0, counts.shape[1] - 1)),
            (bump * (v >= 0) * pi).to(counts.dtype),
            accumulate=True,
        )

    static_mask = mask_rows[mask_index.long().clamp(0, mask_rows.shape[0] - 1)]
    caps = allocatable[:, :2]
    n_sig = sc_direct.shape[0]
    req_state, nzr_state = requested, nzr
    no_node = torch.tensor(NO_NODE, dtype=i32, device=dev)
    node_iota = torch.arange(n, dtype=i32, device=dev)
    assignments = []
    for t, is_active in enumerate(active.tolist()):
        if not is_active:
            assignments.append(no_node)
            continue
        pod_req = pod_requests[t]
        p_nzr = pod_nzr[t]
        fit_ok = (
            _fits(allocatable - req_state, pod_req) & static_mask[t] & valid
        )
        feasible = fit_ok

        # -- topology spread (filtering.go:322 skew rule) ---------------
        if g_sp:
            groups = sp_pod_groups[t]
            safe_g = groups.long().clamp(0, g_sp - 1)
            counts_g = sp_counts[safe_g]  # [C, V]
            min_v = torch.where(
                sp_value_valid[safe_g], counts_g, _BIG
            ).min(dim=1).values
            vals = sp_node_value[safe_g]  # [C, N]
            node_count = _gather_values(counts_g, vals)
            ok = (vals >= 0) & (
                node_count + sp_pod_self[t][:, None] - min_v[:, None]
                <= sp_pod_max_skew[t][:, None]
            )
            feasible = feasible & torch.where(
                (groups >= 0)[:, None], ok, True
            ).all(0)

        feasible = feasible & affinity_node_ok(
            counts_aff, counts_anti, counts_exist,
            vals_aff, vals_anti, vals_exist,
            af_pod_aff_rows[t], af_pod_self_match[t].to(torch.bool),
            af_pod_anti_rows[t], af_pod_exist_match[t].to(torch.bool),
        )

        score = _combined_score(caps, nzr_state, p_nzr, config)

        # -- non-resource score plugins (ops/scoring.py) ----------------
        sig = sc_pod_sig[t].long().clamp(0, n_sig - 1)
        # static direct rows (ImageLocality + NodePreferAvoidPods,
        # pre-weighted, no normalize)
        score = score + sc_direct[sig].to(f32)
        # preferred NodeAffinity: max-scale normalize over the feasible set
        na_raw = sc_nodeaff[sig]
        na_max = torch.where(feasible, na_raw, 0).max()
        score = score + torch.where(
            na_max > 0,
            w_na * torch.floor(
                100.0 * na_raw.to(f32) / na_max.clamp(min=1).to(f32)
            ),
            0.0,
        )
        # TaintToleration: reversed normalize (fewer intolerable
        # PreferNoSchedule taints => higher; max 0 => all 100)
        tt_raw = sc_taint[sig]
        tt_max = torch.where(feasible, tt_raw, 0).max()
        tt_scaled = torch.floor(
            100.0 * tt_raw.to(f32) / tt_max.clamp(min=1).to(f32)
        )
        score = score + w_tt * torch.where(
            tt_max > 0, 100.0 - tt_scaled, 100.0
        )
        # SelectorSpread: inverted counts, zone-blended 2/3
        # (default_pod_topology_spread.go:107)
        sel_group = sc_pod_sel_group[t]
        if g_sel:
            sel_raw = sel_counts[sel_group.long().clamp(0, g_sel - 1)]
            sel_feas = torch.where(feasible, sel_raw, 0)
            sel_max_node = sel_feas.max()
            zsum = torch.zeros(z, dtype=i32, device=dev).index_add_(
                0, zone_idx, torch.where(zone_ok, sel_feas, 0)
            )
            have_zones = (feasible & zone_ok).any()
            sel_max_zone = zsum.max()
            f_node = torch.where(
                sel_max_node > 0,
                100.0 * (sel_max_node - sel_raw).to(f32)
                / sel_max_node.clamp(min=1).to(f32),
                100.0,
            )
            zs_n = zsum[zone_idx]
            f_zone = torch.where(
                sel_max_zone > 0,
                100.0 * (sel_max_zone - zs_n).to(f32)
                / sel_max_zone.clamp(min=1).to(f32),
                100.0,
            )
            blended = torch.where(
                have_zones & zone_ok,
                _fma32(f_node, _THIRD, _TWO_THIRDS * f_zone),
                f_node,
            )
            score = score + torch.where(
                sel_group >= 0, w_sel * torch.floor(blended), 0.0
            )
        # soft topology spread: flipped-linear against (total - min) over
        # feasible eligible nodes (podtopologyspread/scoring.go:199)
        if g_soft:
            soft_groups = sc_pod_soft_groups[t]
            sg_safe = soft_groups.long().clamp(0, g_soft - 1)
            soft_nv = sc_soft_node_value[sg_safe]  # [C, N]
            soft_cnt = _gather_values(soft_counts[sg_safe], soft_nv)
            rows_live = (soft_groups >= 0)[:, None]
            soft_raw = torch.where(
                rows_live & (soft_nv >= 0), soft_cnt, 0
            ).sum(0, dtype=i32)
            soft_eligible = torch.where(rows_live, soft_nv >= 0, True).all(0)
            has_soft = (soft_groups >= 0).any()
            dom = feasible & soft_eligible
            soft_total = torch.where(dom, soft_raw, 0).sum(dtype=i32)
            soft_min = torch.where(
                dom.any(), torch.where(dom, soft_raw, _BIG).min(), _BIG
            )
            soft_diff = (soft_total - soft_min).to(f32)
            soft_score = torch.where(
                soft_diff == 0,
                100.0,
                torch.where(
                    ~soft_eligible,
                    0.0,
                    torch.floor(
                        100.0 * (soft_total - soft_raw).to(f32)
                        / torch.where(soft_diff == 0, 1.0, soft_diff)
                    ),
                ),
            )
            score = score + torch.where(has_soft, w_soft * soft_score, 0.0)
        # preferred inter-pod affinity (interpodaffinity/scoring.go):
        # raw(node) = sum_r weight_r * counts_r[val] (incoming terms)
        #           + sum_r match_r * wcounts_r[val] (existing pods'
        #             symmetric terms), normalized [min,max] -> [0,100]
        # over the feasible set with zero-seeded extremes (:294). Every
        # term is an integer below 2^24, so the f32 sum is exact in any
        # order.
        if r_ipa:
            ipa_raw = (
                torch.where(ipa_has_val, ipa_counts.gather(1, ipa_idx), 0.0)
                * sc_pod_ipa_weight[t][:, None]
                + torch.where(
                    ipa_has_val, ipa_wcounts.gather(1, ipa_idx), 0.0
                ) * sc_pod_ipa_match[t][:, None]
            ).sum(0)
            ipa_mn = torch.clamp(
                torch.where(feasible, ipa_raw, 0.0).min(), max=0.0
            )
            ipa_mx = torch.clamp(
                torch.where(feasible, ipa_raw, 0.0).max(), min=0.0
            )
            ipa_diff = ipa_mx - ipa_mn
            ipa_score = torch.where(
                ipa_diff > 0,
                torch.floor(
                    100.0 * (ipa_raw - ipa_mn) / ipa_diff.clamp(min=1e-9)
                    + 1e-4
                ),
                0.0,
            )
            score = score + torch.where(ipa_live, w_ipa * ipa_score, 0.0)

        score = torch.where(feasible, score, -torch.inf)
        choice = torch.argmax(score).to(i32)  # first max wins
        placed = feasible.any()
        if pair_counts is not None:
            pair_counts.append(torch.stack((fit_ok.sum(), feasible.sum())))
        assignments.append(torch.where(placed, choice, no_node))

        pi = placed.to(i32)
        chosen = ((node_iota == choice) & placed).to(i32)
        req_state = req_state + chosen[:, None] * pod_req[None, :]
        nzr_state = nzr_state + chosen[:, None] * p_nzr[None, :]
        c = choice.long()
        replay(sp_counts, sp_node_value, sp_pod_match[t] > 0, c, pi)
        sel_counts[:, c] += sc_pod_sel_match[t] * pi
        replay(soft_counts, sc_soft_node_value, sc_pod_soft_match[t], c, pi)
        replay(counts_aff, vals_aff, af_pod_bump_aff[t], c, pi)
        replay(counts_anti, vals_anti, af_pod_bump_anti[t], c, pi)
        replay(counts_exist, vals_exist, af_pod_bump_exist[t], c, pi)
        # preferred-affinity replay: the placed pod is an "existing pod"
        # for every later batch pod -- it bumps each row's match count
        # where it matches, and contributes its own terms' signed mass
        replay(ipa_counts, sc_ipa_node_value, sc_pod_ipa_match[t], c, pi)
        replay(ipa_wcounts, sc_ipa_node_value, sc_pod_ipa_bump[t], c, pi)
    if assignments:
        out = torch.stack(assignments)
    else:
        out = torch.zeros(0, dtype=i32, device=dev)
    return out, req_state, nzr_state


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
    mode: str = "greedy",
    rows=None,  # constrained_kernel.Rows: each family's live rows
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
        arrs, alloc, valid, req_state, nzr_state, config, mode, rows
    )
    if compress:
        req_out = req_out.to(torch.int16)
        nzr_out = nzr_out.to(torch.int16)
    return assignment, req_out, nzr_out, alloc, valid


def _packed_solve_tail(
    arrs, alloc, valid, req_state, nzr_state, config, mode, rows,
):
    """The solve on the (possibly row-patched) node state: the
    hand-written kernel for tensors on the card, its plain version for
    tensors on the CPU (ops/greedy_kernel.greedy_solve and
    ops/constrained_kernel.constrained_solve decide). A constrained
    batch's family tensors ride the buffer as ``sp0..sp6``,
    ``af0..af13`` and ``sc0..sc19``; absent families arrive as
    ConstPiece constants. A sinkhorn batch computes its prior as torch
    ops, then commits through K1's scored entry (``sinkhorn_assign``)."""
    common = (
        alloc, req_state, nzr_state, valid, arrs["req"], arrs["nzr"],
        arrs["rows"].to(torch.bool), arrs["midx"],
        arrs["active"].to(torch.bool),
    )
    if mode == "constrained":
        from kubernetes_tpu_torch.ops.constrained_kernel import (
            constrained_solve,
        )

        assignment, req_out, nzr_out = constrained_solve(
            *common,
            tuple(arrs[f"sp{i}"] for i in range(_N_SPREAD)),
            tuple(arrs[f"af{i}"] for i in range(_N_AFFINITY)),
            tuple(arrs[f"sc{i}"] for i in range(_N_SCORING)),
            config=config, rows=rows,
        )
    elif mode == "sinkhorn":
        assignment, req_out, nzr_out = sinkhorn_assign(*common, config=config)
    else:
        from kubernetes_tpu_torch.ops.greedy_kernel import greedy_solve

        assignment, req_out, nzr_out = greedy_solve(*common, config=config)
    return assignment, req_out, nzr_out, alloc, valid


def kernel_build_counts() -> dict:
    """Kernel builds per family in this process, keyed by a stable name:
    the runtime cache watchdog (scheduler/batch.py) diffs this per batch,
    so a build after warmup shows up as a mid-run recompile. The
    counterpart of the JAX package's ``jit_cache_sizes(mesh)``: the mesh
    tier's one kernel is K4 (``shard_kernel``)."""
    from kubernetes_tpu_torch.ops import (
        constrained_kernel,
        greedy_kernel,
        preempt_kernel,
        shard_kernel,
    )

    return {
        "greedy_kernel": greedy_kernel.builds,
        "constrained_kernel": constrained_kernel.builds,
        "preempt_kernel": preempt_kernel.builds,
        "shard_kernel": shard_kernel.builds,
    }


#: "no index" of the best-of-shards combine's minimum (JAX's ``big``)
_NO_INDEX = 1 << 30


class _DeviceWork(NamedTuple):
    """One device's part of a mesh solve: its shards, its working carry
    (the shards' rows stacked in shard order plus one scratch row), each
    shard's rows in it, its ShardCandidates, its first column of the
    combine's candidates, and its row map (``NodeMesh.row_map``)."""

    device: torch.device
    shards: list
    req: torch.Tensor
    nzr: torch.Tensor
    views: list
    cands: object
    col: int
    row_map: torch.Tensor
    pod_req: torch.Tensor
    pod_nzr: torch.Tensor


def _mesh_work(mesh, alloc, req, nzr, valid, rows, pods, config):
    """Every device's ``_DeviceWork`` for one batch, and the combine's
    candidates (score [B, P] f32, index [B, P] i32) on the first device,
    one column per shard in group order: the first group's K4 writes its
    columns directly, every other group's are copied in."""
    from kubernetes_tpu_torch.ops.shard_kernel import ShardCandidates

    first = mesh.first
    n = sum(int(a.shape[0]) for a in alloc)
    bounds = mesh.bounds(n)
    b = int(pods[0][0].shape[0])
    score = torch.empty((b, mesh.size), dtype=torch.float32, device=first)
    index = torch.empty((b, mesh.size), dtype=torch.int32, device=first)
    work, col = [], 0
    for g, ((dev, ks), (pod_req, pod_nzr, midx)) in enumerate(
        zip(mesh.groups(), pods)
    ):
        r = pod_req.shape[1]
        # cat copies, so the resident carry is never written
        rq = torch.cat([req[k].to(torch.int32) for k in ks]
                       + [torch.zeros((1, r), dtype=torch.int32, device=dev)])
        nz = torch.cat([nzr[k].to(torch.int32) for k in ks]
                       + [torch.zeros((1, 2), dtype=torch.int32, device=dev)])
        views, off = [], 0
        for k in ks:
            m = bounds[k][1] - bounds[k][0]
            views.append((off, off + m))
            off += m
        out = dict(score=score, index=index, col=0) if g == 0 else {}
        cands = ShardCandidates(
            [alloc[k] for k in ks], [rq[lo:hi] for lo, hi in views],
            [nz[lo:hi] for lo, hi in views], [valid[k] for k in ks],
            [rows[k] for k in ks], pod_req, pod_nzr, midx, config, **out,
        )
        work.append(_DeviceWork(dev, ks, rq, nz, views, cands, col,
                                mesh.row_map(n, dev, ks), pod_req, pod_nzr))
        col += len(ks)
    return work, score, index


def _mesh_step_loop(mesh, work, score, index, active: np.ndarray):
    """The route of a mesh over several devices: per ACTIVE pod step, K4
    on every device (``ShardCandidates.step``), every other device's
    candidates copied next to the first's, the combine (max score, then
    min global index: JAX's pmax/pmin) and the winner's bump on its own
    device, as plain torch ops with no host sync. Returns the assignment
    [B] int32 on the first device."""
    first = mesh.first
    n = sum(hi - lo for w in work for lo, hi in w.views)
    bounds = mesh.bounds(n)
    offs = torch.tensor(
        [bounds[k][0] for w in work for k in w.shards],
        dtype=torch.int64, device=first,
    )
    # chosen global row per step; n (the row maps' "no node") when the
    # pod placed nowhere or was skipped
    chosen = torch.full((active.shape[0],), n, dtype=torch.int64, device=first)
    for t in np.flatnonzero(active).tolist():
        for w in work:
            w.cands.step(t)
        for w in work[1:]:
            c0 = w.col
            score[t, c0:c0 + len(w.shards)].copy_(w.cands.score[t])
            index[t, c0:c0 + len(w.shards)].copy_(w.cands.index[t])
        s, gidx = score[t], index[t] + offs
        best = s.max()
        win = torch.where(s == best, gidx, _NO_INDEX).min()
        chosen[t] = torch.where(best > -torch.inf, win, n)
        row = chosen[t:t + 1]
        for w in work:
            local = w.row_map.index_select(0, row.to(w.device))
            w.req.index_add_(0, local, w.pod_req[t:t + 1])
            w.nzr.index_add_(0, local, w.pod_nzr[t:t + 1])
    return torch.where(chosen == n, NO_NODE, chosen).to(torch.int32)


def _mesh_greedy(
    mesh: NodeMesh,
    alloc,  # [P] shard tensors [n_k, R] int32
    req,  # [P] [n_k, R] int32
    nzr,  # [P] [n_k, 2] int32
    valid,  # [P] [n_k] bool
    rows,  # [P] [U, n_k] bool: each shard's own mask columns
    pods,  # per mesh.groups() entry: (pod_req [B, R], pod_nzr [B, 2],
    #        midx [B]) int32 on that group's device
    active: np.ndarray,  # [B] bool, host
    config: GreedyConfig,
):
    """The mesh tier's greedy solve (``_mesh_shard_solver`` of the JAX
    package): per ACTIVE pod step, every shard's candidate (K4), the
    best-of-shards combine -- max score, then min global index among the
    shards holding it (JAX's pmax/pmin) -- and the winner's bump on its
    own shard. Inactive pods place nowhere and change nothing (the
    ``active`` gate of the JAX combine). Routed by the mesh's layout:
    when one device holds every shard, the whole batch is ONE K4 launch
    (``ShardCandidates.batch``; on the CPU its plain version); a mesh
    over several devices runs the step loop (``_mesh_step_loop``).
    Returns (assignment [B] int32 on the first device, req' ShardedRows,
    nzr' ShardedRows); the inputs are never written."""
    work, score, index = _mesh_work(
        mesh, alloc, req, nzr, valid, rows, pods, config
    )
    if len(work) == 1:
        assignment = work[0].cands.batch(
            torch.from_numpy(np.ascontiguousarray(active, dtype=bool))
            .to(mesh.first)
        )
    else:
        assignment = _mesh_step_loop(mesh, work, score, index, active)
    req_out: list = [None] * mesh.size
    nzr_out: list = [None] * mesh.size
    for w in work:
        for k, (lo, hi) in zip(w.shards, w.views):
            req_out[k] = w.req[lo:hi]
            nzr_out[k] = w.nzr[lo:hi]
    return (
        assignment, ShardedRows(mesh, req_out), ShardedRows(mesh, nzr_out)
    )


def _solve_packed_mesh(
    pieces, alloc_in, valid_in, req_in, nzr_in, config, mode, mesh,
):
    """``solve_packed`` on a NodeMesh (the JAX package's
    ``make_mesh_packed_solver``): ONE host->device copy per device of
    the pieces plus the ``[U, N]`` mask rows' columns of that device's
    shards (shards on one device share it; each shard views only its own
    columns). The resident state (ShardedRows, or node-sized pieces in
    the buffer on a cold upload) stays on its devices; row patches apply
    shard by shard (``shard_local_row_set``). A greedy batch runs K4
    (``_mesh_greedy``). A constrained or sinkhorn batch gathers the
    state onto the first device, runs ``constrained_solve`` (K2 on the
    card) or ``sinkhorn_assign`` (the prior, then K1's scored entry on
    the card) and splits req'/nzr' back: the function the JAX mesh
    computes on its GSPMD twin. Returns (assignment [B] int32 on the
    first device, req', nzr', alloc, valid as ShardedRows)."""
    by_name = dict(pieces)
    rows_host = np.ascontiguousarray(np.asarray(by_name["rows"]).astype(bool))
    u, n = rows_host.shape
    rest = [(name, arr) for name, arr in pieces if name != "rows"]
    layout = tuple((name, arr.shape, _piece_kind(arr)) for name, arr in rest)
    words = [
        _as_i32(arr).ravel() for _, arr in rest
        if not isinstance(arr, ConstPiece)
    ]
    buf = np.concatenate(words) if words else np.zeros(0, np.int32)
    t_words = buf.size
    bounds = mesh.bounds(n)
    groups = mesh.groups()
    arrs_by_group = []  # the unpacked buffer of each group's device
    group_of = [0] * mesh.size
    shard_rows: list = [None] * mesh.size
    for g, (dev, ks) in enumerate(groups):
        cols = np.concatenate(
            [rows_host[:, lo:hi].ravel() for lo, hi in (bounds[k] for k in ks)]
        ).view(np.uint8)
        cols = np.concatenate([cols, np.zeros((-cols.size) % 4, np.uint8)])
        buf_d = torch.from_numpy(
            np.concatenate([buf, cols.view(np.int32)])
        ).to(dev)
        arrs_by_group.append(_unpack_buffer(buf_d[:t_words], layout))
        col_bytes = buf_d[t_words:].view(torch.uint8).view(torch.bool)
        off = 0
        for k in ks:
            m = bounds[k][1] - bounds[k][0]
            shard_rows[k] = col_bytes[off:off + u * m].view(u, m)
            group_of[k] = g
            off += u * m

    def state(name, resident, dtype):
        """Each shard's rows of a node-sized array: from this batch's
        buffer when it rode the upload, else the resident shard."""
        out = []
        for k, g in enumerate(group_of):
            arrs = arrs_by_group[g]
            lo, hi = bounds[k]
            a = arrs[name][lo:hi] if name in arrs else resident.shards[k]
            out.append(a.to(dtype))
        return out

    alloc = state("alloc", alloc_in, torch.int32)
    valid = state("valid", valid_in, torch.bool)
    req = state("req_state", req_in, torch.int32)
    nzr = state("nzr_state", nzr_in, torch.int32)
    for k, g in enumerate(group_of):
        arrs = arrs_by_group[g]
        lo, hi = bounds[k]
        if "didx" in arrs:
            req[k] = shard_local_row_set(req[k], arrs["didx"], arrs["dreq"], lo, hi)
            nzr[k] = shard_local_row_set(nzr[k], arrs["didx"], arrs["dnzr"], lo, hi)
        if "sidx" in arrs:
            alloc[k] = shard_local_row_set(
                alloc[k], arrs["sidx"], arrs["salloc"], lo, hi
            )
            if "svalid" in arrs:
                valid[k] = shard_local_row_set(
                    valid[k], arrs["sidx"], arrs["svalid"] != 0, lo, hi
                )
    alloc_out = ShardedRows(mesh, alloc)
    valid_out = ShardedRows(mesh, valid)
    if mode in ("constrained", "sinkhorn"):
        first = mesh.first
        live = None
        if mode == "constrained":
            from kubernetes_tpu_torch.ops.constrained_kernel import (
                constrained_rows,
            )

            live = constrained_rows(by_name)
        arrs = dict(arrs_by_group[0])  # the first shard's device
        arrs["rows"] = torch.cat([r.to(first) for r in shard_rows], dim=1)
        assignment, req_full, nzr_full, _, _ = _packed_solve_tail(
            arrs, alloc_out.gather(), valid_out.gather(),
            ShardedRows(mesh, req).gather(), ShardedRows(mesh, nzr).gather(),
            config, mode, live,
        )
        return (
            assignment, ShardedRows.split(mesh, req_full),
            ShardedRows.split(mesh, nzr_full), alloc_out, valid_out,
        )
    pods = [(arrs["req"], arrs["nzr"], arrs["midx"]) for arrs in arrs_by_group]
    active = np.asarray(by_name["active"]) != 0
    assignment, req_out, nzr_out = _mesh_greedy(
        mesh, alloc, req, nzr, valid, shard_rows, pods, active, config,
    )
    return assignment, req_out, nzr_out, alloc_out, valid_out


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def make_sharded_solver(mesh: NodeMesh, config: GreedyConfig = GreedyConfig()):
    """The stateless node-sharded greedy solve (the JAX package's
    ``make_sharded_solver``, which ``__graft_entry__.dryrun_multichip``
    drives): every ``[N, ...]`` operand is split over the mesh's shards,
    the pod batch goes to every device, and K4 solves it with the
    best-of-shards combine (``_mesh_greedy``).

    ``solve(allocatable [N, R], requested [N, R], nzr [N, 2], valid [N],
    pod_requests [B, R], pod_nzr [B, 2], static_mask [B, N], active [B])``
    (anything ``np.asarray`` takes, or tensors) returns (assignment [B]
    int32 on the first device, requested' and nzr' as ShardedRows)."""

    def solve(allocatable, requested, nzr, valid, pod_requests, pod_nzr,
              static_mask, active):
        def i32(x):
            return _host(x).astype(np.int32)

        mask = _host(static_mask).astype(bool)
        b, n = mask.shape
        bounds = mesh.bounds(n)
        pods = [
            tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (i32(pod_requests), i32(pod_nzr),
                          np.arange(b, dtype=np.int32))
            )
            for dev, _ in mesh.groups()
        ]
        # the [B, N] mask is the mask rows, pod t on row t; each shard
        # takes its own columns
        rows = [
            torch.from_numpy(np.ascontiguousarray(mask[:, lo:hi])).to(dev)
            for dev, (lo, hi) in zip(mesh.devices, bounds)
        ]
        return _mesh_greedy(
            mesh,
            ShardedRows.split(mesh, i32(allocatable)).shards,
            ShardedRows.split(mesh, i32(requested)).shards,
            ShardedRows.split(mesh, i32(nzr)).shards,
            ShardedRows.split(mesh, _host(valid).astype(bool)).shards,
            rows, pods, _host(active).astype(bool), config,
        )

    return solve


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
    are never written. A sharded carry (ShardedRows) takes each placed
    row on the shard that holds it."""
    if isinstance(req_state, ShardedRows):
        a = _host(assignments).astype(np.int64)
        req_sh, nzr_sh = [], []
        for k, (lo, hi) in enumerate(req_state.bounds):
            local = np.where((a >= lo) & (a < hi), a - lo, NO_NODE)
            r_k, z_k = apply_assignment_delta(
                req_state.shards[k], nzr_state.shards[k],
                local.astype(np.int32), pod_req, pod_nzr,
            )
            req_sh.append(r_k)
            nzr_sh.append(z_k)
        return (
            ShardedRows(req_state.mesh, req_sh),
            ShardedRows(req_state.mesh, nzr_sh),
        )
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
    mesh=None,
):
    """Host-side companion of _solve_packed: concatenates the pieces
    (int32 / bool / float32 / packed int16 -- see _unpack_buffer's kind
    codes) and dispatches ONE host->device copy + one solve on
    ``device`` (the card unless the caller names the CPU). A
    constrained batch's live row counts (constrained_kernel.Rows) come
    from its host-side family pieces. A kernel that fails to build or launch raises:
    nothing here retries on another path.

    ``mesh``: a NodeMesh routes the solve through the node-sharded tier
    (``_solve_packed_mesh``): the resident inputs and the returned
    req'/nzr'/alloc/valid are ShardedRows, and ``device`` is the mesh's
    own. The int16 carry is off on a mesh, as in the JAX package."""
    if mode not in ("greedy", "constrained", "sinkhorn"):
        raise ValueError(f"unknown solve mode {mode!r}")
    if mesh is not None:
        if compress:
            raise ValueError("the int16 carry is off on a mesh")
        return _solve_packed_mesh(
            pieces, alloc_in, valid_in, req_in, nzr_in, config, mode, mesh,
        )
    rows = None
    if mode == "constrained":
        from kubernetes_tpu_torch.ops.constrained_kernel import (
            constrained_rows,
        )

        rows = constrained_rows(dict(pieces))
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
        layout=layout, config=config, compress=compress, mode=mode,
        rows=rows,
    )


def carry_from_numpy(alloc, valid, req, nzr, config, device, mesh=None):
    """The port's resident carry from the arrays the JAX package's
    ``_DeviceNodeState``/``NodeTensor`` hold (anything ``np.asarray``
    takes: a sharded JAX array gathers) and a GreedyConfig's weights.
    Returns ((alloc, valid, req, nzr) -- int32, valid bool -- ,
    GreedyConfig): tensors on ``device``, or with ``mesh`` ShardedRows
    split over the NodeMesh (``device`` is then ignored)."""
    if mesh is None:
        device = resolve_device(device)

    def put(a, dtype):  # np.array copies: the source may be read-only
        a = np.array(a, dtype=dtype)
        if mesh is not None:
            return ShardedRows.split(mesh, a)
        return torch.as_tensor(a, device=device)

    carry = (
        put(alloc, np.int32),
        put(valid, bool),
        put(req, np.int32),
        put(nzr, np.int32),
    )
    cfg = GreedyConfig(
        least_allocated_weight=int(config.least_allocated_weight),
        balanced_allocation_weight=int(config.balanced_allocation_weight),
        most_allocated_weight=int(config.most_allocated_weight),
    )
    return carry, cfg
