"""Launch plans of the cluster kernels K1-K4.

K1 (``csrc/greedy_solve.cu``), K2 (``csrc/constrained_solve.cu``) and K3
(``csrc/preempt_solve.cu``) each run a batch as ONE thread-block cluster
of C CTAs, CTA k owning the contiguous node rows ``[k * N // C, (k + 1)
* N // C)`` (``plan_launch``). K4's batch entry
(``csrc/shard_candidate.cu``) runs the shards of one device as one
cluster whose slices follow the shard boundaries (``plan_shards``). A
plan fixes C, the threads per CTA, the side of the shape gate and the
dynamic shared memory of one CTA:

- *resident*: a CTA's node state (and, per kernel, its per-row scratch)
  lives in shared memory for the whole launch. Chosen whenever the
  slice's bytes fit beside the kernel's fixed and static shared memory
  in the ``SMEM_PER_CTA`` bytes one CTA may use on the card;
- *streaming*: above that, the same kernel reads the state from device
  memory (L2) instead.

Pure Python: the wrappers call ``choose_plan`` for tensors on the card
only, with the card's own answer to "does a cluster of this shape fit"
(``cudaOccupancyMaxActiveClusters``); the CPU tests call
``plan_launch`` directly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

from kubernetes_tpu_torch.ops.kernel_build import KernelError

__all__ = [
    "CLUSTER_SIZES", "LaunchPlan", "MAX_THREADS", "SMEM_PER_CTA",
    "card_admits", "choose_plan", "plan_launch", "plan_shards",
    "slice_bounds",
]

#: shared memory one CTA may use on sm_90 (the opt-in maximum)
SMEM_PER_CTA = 232_448
#: cluster sizes tried, largest first (16 is sm_90's non-portable maximum)
CLUSTER_SIZES = (16, 8, 4, 2, 1)
#: most threads per CTA (solve_common.cuh kClusterThreads)
MAX_THREADS = 512
#: a CTA gets at least this many rows: smaller clusters for small N
MIN_ROWS_PER_CTA = 32
_ALIGN = 16


class LaunchPlan(NamedTuple):
    cluster: int                   # CTAs in the one cluster
    threads: int                   # threads per CTA
    resident: bool                 # the side of the shape gate
    smem_bytes: int                # dynamic shared memory per CTA
    static_bytes: int              # the kernel's static shared memory
    slice_bounds: Tuple[int, ...]  # cluster + 1 row bounds, 0 .. N
    shards: Tuple[int, ...] = ()   # plan_shards: the shard of each CTA


def slice_bounds(n: int, cluster: int) -> Tuple[int, ...]:
    """The rows of each CTA, as the kernels compute them
    (solve_common.cuh slice_lo): CTA k owns [b[k], b[k + 1])."""
    return tuple(k * n // cluster for k in range(cluster + 1))


def _align(nbytes: int) -> int:
    return -(-nbytes // _ALIGN) * _ALIGN


def _plan(
    bounds: Tuple[int, ...], node_bytes: int, fixed_bytes: int,
    static_bytes: int, extra_warps: int, smem_limit: int,
    shards: Tuple[int, ...] = (), min_threads: int = 32,
    odd_stride: bool = False,
) -> LaunchPlan:
    """Threads (one per row of the largest slice, in whole warps, at
    least ``min_threads`` and at most ``MAX_THREADS`` with the extra
    warps), the gate side and the shared memory of the CTAs whose rows
    ``bounds`` gives. ``odd_stride``: a resident slice takes ``cap | 1``
    rows (K3's layout)."""
    cap = max(hi - lo for lo, hi in zip(bounds, bounds[1:]))
    row_threads = min(
        MAX_THREADS - 32 * extra_warps,
        max(min_threads, 32 * -(-cap // 32)),
    )
    rows = cap | 1 if odd_stride else cap
    resident_bytes = _align(fixed_bytes + rows * node_bytes)
    resident = static_bytes + resident_bytes <= smem_limit
    smem = resident_bytes if resident else _align(fixed_bytes)
    if static_bytes + smem > smem_limit:
        raise KernelError(
            f"{static_bytes + smem} bytes of shared memory per CTA exceed "
            f"{smem_limit}"
        )
    return LaunchPlan(
        len(bounds) - 1, row_threads + 32 * extra_warps, resident, smem,
        static_bytes, bounds, shards,
    )


def plan_launch(
    n: int, cluster: int, node_bytes: int, fixed_bytes: int,
    static_bytes: int = 0, extra_warps: int = 0,
    smem_limit: int = SMEM_PER_CTA, min_threads: int = 32,
    odd_stride: bool = False,
) -> LaunchPlan:
    """The plan for N node rows on at most ``cluster`` CTAs.

    ``node_bytes``: the dynamic shared memory one resident row takes;
    ``fixed_bytes``: what a CTA takes on either side of the gate;
    ``static_bytes``: the kernel's static shared memory;
    ``extra_warps``: warps per CTA that own no rows (K2's parameter
    warp). Threads: one per row of the largest slice, in whole warps, at
    least ``min_threads`` (K3's warps build keys one node each) and at
    most ``MAX_THREADS`` with the extra warps. ``odd_stride``: a resident
    slice is laid out at an odd row stride, ``cap | 1`` rows (K3); the
    streaming side holds no row in shared memory."""
    if n < 1 or cluster < 1:
        raise ValueError(f"no plan for {n} rows on {cluster} CTAs")
    c = min(cluster, max(1, -(-n // MIN_ROWS_PER_CTA)))
    return _plan(slice_bounds(n, c), node_bytes, fixed_bytes, static_bytes,
                 extra_warps, smem_limit, min_threads=min_threads,
                 odd_stride=odd_stride)


def plan_shards(
    n_loc: Sequence[int], cluster: int, node_bytes: int, fixed_bytes: int,
    static_bytes: int = 0, smem_limit: int = SMEM_PER_CTA,
) -> LaunchPlan:
    """The plan for P shards of ``n_loc[k]`` rows, stacked in shard order
    on one device, on at most ``cluster`` CTAs whose slices follow the
    shard boundaries: every shard gets at least one CTA and every CTA's
    rows lie inside one shard; the other CTAs go one at a time to the
    shard whose longest slice is longest (the lower shard on a tie), and
    a shard's q CTAs split its rows as ``slice_bounds(n_k, q)``.
    ``shards`` names each CTA's shard, ``slice_bounds`` its rows in the
    stacked order. Raises KernelError for more shards than CTAs."""
    p = len(n_loc)
    n = sum(n_loc)
    if p < 1 or n < 1 or cluster < 1 or min(n_loc) < 0:
        raise ValueError(f"no plan for shards {list(n_loc)} on {cluster} CTAs")
    if p > cluster:
        raise KernelError(
            f"{p} shards need a cluster of at least {p} CTAs, not {cluster}"
        )
    c = min(cluster, max(p, -(-n // MIN_ROWS_PER_CTA)))
    q = [1] * p
    for _ in range(c - p):
        k = max(range(p), key=lambda k: (-(-n_loc[k] // q[k]), -k))
        q[k] += 1
    bounds, shards, off = [0], [], 0
    for k, (m, qk) in enumerate(zip(n_loc, q)):
        bounds += [off + b for b in slice_bounds(m, qk)[1:]]
        shards += [k] * qk
        off += m
    return _plan(tuple(bounds), node_bytes, fixed_bytes, static_bytes, 0,
                 smem_limit, tuple(shards))


def choose_plan(
    plan_at: Callable[[int], LaunchPlan],
    admitted: Callable[[LaunchPlan], int],
) -> LaunchPlan:
    """The plan at the largest cluster size whose shape the card admits
    (``admitted``: clusters of that plan the card holds at once). Raises
    KernelError when it admits none."""
    for c in CLUSTER_SIZES:
        plan = plan_at(c)
        if admitted(plan) >= 1:
            return plan
    raise KernelError("the card admits no cluster of this kernel")


def card_admits(max_clusters, cache: dict, device: int):
    """``admitted`` for choose_plan from a kernel library's
    ``<kernel>_max_clusters(cluster, threads, smem, resident)`` (the
    card's cudaOccupancyMaxActiveClusters), asked once per device and
    shape: ``cache`` keeps the answers."""

    def admitted(plan: LaunchPlan) -> int:
        key = (device, plan.cluster, plan.threads, plan.resident,
               plan.smem_bytes)
        if key not in cache:
            cache[key] = max_clusters(
                plan.cluster, plan.threads, plan.smem_bytes,
                int(plan.resident),
            )
        return cache[key]

    return admitted
