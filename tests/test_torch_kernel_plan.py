"""The launch plans of the cluster kernels K1 and K2, and numpy models of
their two exact tricks.

The kernels themselves run only on the card (chip_smoke.py holds them
bit-equal to their plain versions there); on the CPU the plans are pure
Python and the wrappers take the plain versions without ever planning.
The models mirror csrc/solve_common.cuh's cluster step (the sliced
(score, index) combine) and csrc/constrained_solve.cu's incremental
hard-spread minimum, and are held against the obvious computation.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops import cluster_plan
from kubernetes_tpu_torch.ops import constrained_kernel as ck
from kubernetes_tpu_torch.ops import greedy_kernel as gk
from kubernetes_tpu_torch.ops.cluster_plan import SMEM_PER_CTA, plan_launch

PLANS = {"k1": gk.plan_for, "k2": ck.plan_for}
# static shared memory of the kernels, as ptxas lays them out (slots,
# per-pod parameters, exchange buffers), rounded up
STATIC = {"k1": 4096, "k2": 16384}
INT_MAX = 2**31 - 1
NO_INDEX = 0x7FFFFFFF


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize(
    "n, cluster",
    [(1, 16), (5, 16), (33, 16), (100, 8), (5000, 16), (5632, 16),
     (5633, 4), (40960, 16), (131071, 16), (131072, 2)],
)
def test_plan_slices_cover_the_rows_in_order(kernel, n, cluster):
    plan = PLANS[kernel](n, 4, cluster, STATIC[kernel])
    b = plan.slice_bounds
    assert len(b) == plan.cluster + 1
    assert b[0] == 0 and b[-1] == n
    assert all(lo <= hi for lo, hi in zip(b, b[1:]))
    assert 1 <= plan.cluster <= cluster
    assert plan.threads % 32 == 0
    # every row has exactly one owner: CTA k, thread (row - b[k]) % rows
    row_threads = plan.threads - (32 if kernel == "k2" else 0)
    owners = np.zeros(n, int)
    for k in range(plan.cluster):
        for tid in range(row_threads):
            owners[b[k] + tid:b[k + 1]:row_threads] += 1
    assert (owners == 1).all()
    # the slices are balanced: sizes differ by at most one row
    sizes = np.diff(b)
    assert sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("r", [4, 6, 12])
def test_shared_memory_never_exceeds_the_cta_limit(kernel, r):
    for n in (1, 77, 5632, 40960, 82000, 90000, 131072, 1 << 20):
        for cluster in cluster_plan.CLUSTER_SIZES:
            plan = PLANS[kernel](n, r, cluster, STATIC[kernel])
            assert plan.smem_bytes + STATIC[kernel] <= SMEM_PER_CTA == 232_448
            assert plan.smem_bytes % 16 == 0


@pytest.mark.parametrize(
    "kernel, node_bytes, fixed_bytes, rows_held",
    [("k1", 4 * (2 * 4 + 3), 4 * 32 * (4 + 4), (70_000, 100_000)),
     ("k2", 4 * (2 * 4 + 4) + 1, 4 * 2 * 4, (60_000, 80_000))],
)
def test_the_gate_flips_where_the_byte_count_says(kernel, node_bytes,
                                                   fixed_bytes, rows_held):
    """At R=4 on 16 CTAs: the largest slice whose bytes fit beside the
    fixed and static shared memory is resident, one row more streams."""
    static = STATIC[kernel]
    per_cta = 0
    while static + -(-(fixed_bytes + (per_cta + 1) * node_bytes) // 16) * 16 \
            <= SMEM_PER_CTA:
        per_cta += 1
    plan = PLANS[kernel]
    at = plan(16 * per_cta, 4, 16, static)
    above = plan(16 * per_cta + 1, 4, 16, static)
    assert at.resident and not above.resident
    assert at.smem_bytes >= fixed_bytes + per_cta * node_bytes
    assert above.smem_bytes < at.smem_bytes
    # the burst's 5,632 rows are resident; K1's 131,072-row case streams
    assert plan(5632, 4, 16, static).resident
    assert not plan(131072, 4, 16, static).resident
    # what 16 CTAs hold: K1 ~83k rows, K2 ~70k
    assert rows_held[0] < 16 * per_cta < rows_held[1]


def test_plan_raises_when_even_the_fixed_bytes_do_not_fit():
    with pytest.raises(gk.KernelError):
        plan_launch(10, 16, node_bytes=8, fixed_bytes=SMEM_PER_CTA + 1)
    with pytest.raises(ValueError):
        plan_launch(0, 16, node_bytes=8, fixed_bytes=0)


def test_choose_plan_takes_the_largest_admitted_cluster_or_raises():
    def plan_at(c):
        return gk.plan_for(5632, 4, c, STATIC["k1"])

    assert cluster_plan.choose_plan(plan_at, lambda p: 1).cluster == 16
    got = cluster_plan.choose_plan(plan_at, lambda p: int(p.cluster <= 8))
    assert got.cluster == 8
    with pytest.raises(gk.KernelError):
        cluster_plan.choose_plan(plan_at, lambda p: 0)
    # the card is asked once per device and shape
    asked = []

    def max_clusters(cluster, threads, smem, resident):
        asked.append((cluster, threads, smem, resident))
        return int(cluster <= 8)

    cache = {}
    for _ in range(2):
        admitted = cluster_plan.card_admits(max_clusters, cache, 0)
        assert cluster_plan.choose_plan(plan_at, admitted).cluster == 8
    assert [a[0] for a in asked] == [16, 8]
    assert asked[1] == (8, 512, plan_at(8).smem_bytes, 1)


def _cpu_problem(seed, n=48, b=12, r=4):
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = rng.choice([4000, 32000], n)
    alloc[:, 1] = rng.choice([8, 64], n) * 1024 * 1024
    alloc[:, 3] = 110
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = 250
    pod_req[:, 1] = 512 * 1024
    pod_req[:, 3] = 1
    return [
        torch.from_numpy(a) for a in (
            alloc, np.zeros_like(alloc), np.zeros((n, 2), np.int32),
            np.ones(n, bool), pod_req, pod_req[:, :2].copy(),
            np.ones((2, n), bool), np.zeros(b, np.int32), np.ones(b, bool),
        )
    ]


def test_a_cpu_tensor_never_gets_a_kernel_plan(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("planned a launch for CPU tensors")

    for mod in (gk, ck, cluster_plan):
        monkeypatch.setattr(mod, "choose_plan", refuse, raising=False)
    monkeypatch.setattr(gk, "plan_for", refuse)
    monkeypatch.setattr(ck, "plan_for", refuse)
    monkeypatch.setattr(gk, "build", refuse)
    monkeypatch.setattr(ck, "build", refuse)
    args = _cpu_problem(0)
    before = gk.launches, gk.last_plan
    asg, _, _ = gk.greedy_solve(*args)
    assert (asg.numpy() >= 0).all()
    assert (gk.launches, gk.last_plan) == before
    from kubernetes_tpu_torch.ops.scoring import noop_score_tensors
    from kubernetes_tpu_torch.ops.affinity import noop_affinity_tensors
    from kubernetes_tpu_torch.ops.topology import noop_spread_tensors

    n, b = args[0].shape[0], args[4].shape[0]
    fams = [
        tuple(torch.as_tensor(np.asarray(a)) for a in f(b, n))
        for f in (noop_spread_tensors, noop_affinity_tensors,
                  noop_score_tensors)
    ]
    before = ck.launches, ck.last_plan
    asg2, _, _ = ck.constrained_solve(*args, *fams)
    assert (asg2.numpy() >= 0).all()
    assert (ck.launches, ck.last_plan) == before
    # the kernels' entry points refuse CPU tensors before any plan
    with pytest.raises(gk.KernelError):
        gk.greedy_solve_cuda(*args)
    with pytest.raises(ck.KernelError):
        ck.constrained_solve_cuda(*args, *fams)


# -- the sliced (score, index) combine (solve_common.cuh cluster_best) ------

def _ordered_bits(scores):
    u = np.asarray(scores, np.float32).view(np.uint32).astype(np.uint64)
    u = np.where(u == 0x80000000, 0, u)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _cluster_argmax(scores, feasible, plan, extra_warps=0):
    """The kernel's combine: each thread's first maximum over its own
    rows (strict >), the warp's maximum key, one slot per (CTA, warp),
    and the maximum over the slots; -1 when nothing is feasible."""
    bounds = plan.slice_bounds
    row_threads = plan.threads - 32 * extra_warps
    keys = _ordered_bits(scores) << 32 | (
        ~np.arange(len(scores), dtype=np.uint64) & 0xFFFFFFFF
    )
    slots = []
    for k in range(plan.cluster):
        lo, hi = bounds[k], bounds[k + 1]
        for warp in range(plan.threads // 32):
            warp_key = 0
            for lane in range(32):
                tid = warp * 32 + lane
                best, best_i = -np.inf, NO_INDEX
                if tid < row_threads:
                    for j in range(lo + tid, hi, row_threads):
                        if feasible[j] and scores[j] > best:
                            best, best_i = scores[j], j
                key = 0 if best_i == NO_INDEX else int(keys[best_i])
                warp_key = max(warp_key, key)
            slots.append(warp_key)
    top = max(slots)
    return -1 if top == 0 else int(~np.uint32(top & 0xFFFFFFFF))


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_sliced_combine_equals_the_first_argmax_over_ties(seed, kernel):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 700))
    # few distinct scores, so ties are everywhere; both zeros, negatives
    values = np.array([-3.5, -0.0, 0.0, 1.0, 57.0, 57.0, 200.0], np.float32)
    scores = rng.choice(values[: int(rng.integers(2, 8))], n).astype(np.float32)
    feasible = rng.random(n) < rng.choice([0.0, 0.05, 0.5, 1.0])
    plan = PLANS[kernel](n, 4, int(rng.choice([2, 4, 8, 16])), STATIC[kernel])
    got = _cluster_argmax(scores, feasible, plan,
                          extra_warps=1 if kernel == "k2" else 0)
    masked = np.where(feasible, scores, -np.inf)
    want = int(np.argmax(masked)) if feasible.any() else -1
    assert got == want


# -- the incremental hard-spread minimum (csrc/constrained_solve.cu) --------

class _IncrementalMinimum:
    """Per group: the minimum count over its valid values (INT_MAX when
    none) and how many valid values hold it; a bump at a valid value at
    the minimum lowers the multiplicity, and the group is recounted
    before the next step only when that reaches 0 or a count wraps."""

    def __init__(self, counts, valid):
        self.counts = counts
        self.valid = valid
        self.gmin = np.zeros(len(counts), np.int64)
        self.gmult = np.zeros(len(counts), np.int64)
        self.recounts = 0
        self.stale = set(range(len(counts)))
        self.refresh()

    def refresh(self):
        for g in self.stale:
            vals = self.counts[g][self.valid[g]]
            self.gmin[g] = vals.min() if vals.size else INT_MAX
            self.gmult[g] = int((vals == self.gmin[g]).sum())
            self.recounts += 1
        self.stale = set()

    def bump(self, g, v):
        old = int(self.counts[g, v])
        new = (old + 1 + 2**31) % 2**32 - 2**31  # int32 wrap
        self.counts[g, v] = new
        if self.valid[g, v]:
            if old == self.gmin[g]:
                self.gmult[g] -= 1
                if self.gmult[g] == 0:
                    self.stale.add(g)
            if new < old:
                self.stale.add(g)


@pytest.mark.parametrize("seed", range(6))
def test_incremental_spread_minimum_equals_recounting_every_step(seed):
    rng = np.random.default_rng(seed)
    groups, values = 5, int(rng.integers(1, 40))
    counts = rng.integers(0, 4, (groups, values)).astype(np.int32)
    counts[1, : values // 2] = INT_MAX - 1  # counts that wrap
    valid = rng.random((groups, values)) < 0.7
    valid[2] = False  # a group with no valid value
    model = _IncrementalMinimum(counts, valid)
    for _ in range(400):
        g = int(rng.integers(groups))
        v = int(rng.integers(values))
        model.bump(g, v)
        model.refresh()  # the next step opens with the flagged recounts
        for k in range(groups):
            vals = counts[k][valid[k]]
            want = int(vals.min()) if vals.size else INT_MAX
            assert model.gmin[k] == want
            # the kernel's slot minimum: min(kBig, group minimum)
            assert min(1 << 20, model.gmin[k]) == min(1 << 20, want)
    # a recount is rare, not every step
    assert model.recounts < 400 * groups

