"""The launch plans of the cluster kernels K1-K4, and numpy models of
their exact tricks.

The kernels themselves run only on the card (chip_smoke.py holds them
bit-equal to their plain versions there); on the CPU the plans are pure
Python and the wrappers take the plain versions without ever planning.
The models mirror csrc/solve_common.cuh's cluster step (the sliced
(score, index) combine), csrc/constrained_solve.cu's incremental
hard-spread minimum, csrc/shard_candidate.cu's batch combine (CTA keys,
shard candidates, the device's winner) and csrc/preempt_solve.cu's
packed pick key, its PDB spending and its sliced minimum with only the
chosen node's owner rescanning, and are held against the obvious
computation; so is K3's plain version's reprieve, taken a run at a time,
against the walk one victim at a time.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.ops import cluster_plan
from kubernetes_tpu_torch.ops import constrained_kernel as ck
from kubernetes_tpu_torch.ops import greedy_kernel as gk
from kubernetes_tpu_torch.ops import preempt_kernel as pk
from kubernetes_tpu_torch.ops import shard_kernel as sk
from kubernetes_tpu_torch.ops.cluster_plan import SMEM_PER_CTA, plan_launch
from kubernetes_tpu_torch.ops.mesh import NodeMesh

PLANS = {"k1": gk.plan_for, "k2": ck.plan_for}
# static shared memory of the kernels, as ptxas lays them out (slots,
# per-pod parameters, exchange buffers), rounded up
STATIC = {"k1": 4096, "k2": 16384, "k3": 2048, "k4": 4096}
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



# -- K4's batch plan: CTA slices follow the shards ----------------------------

def _check_shard_plan(plan, n_loc):
    """Every CTA's rows lie inside one shard, the shards' CTAs run in
    order and cover each shard, and a shard's slices are balanced."""
    b = plan.slice_bounds
    offs = np.concatenate([[0], np.cumsum(n_loc)])
    assert len(plan.shards) == plan.cluster == len(b) - 1
    assert b[0] == 0 and b[-1] == offs[-1]
    assert list(plan.shards) == sorted(plan.shards)
    assert set(plan.shards) == set(range(len(n_loc)))
    for c, k in enumerate(plan.shards):
        assert offs[k] <= b[c] <= b[c + 1] <= offs[k + 1]
    for k, m in enumerate(n_loc):
        ctas = [c for c, kk in enumerate(plan.shards) if kk == k]
        assert b[ctas[0]] == offs[k] and b[ctas[-1] + 1] == offs[k + 1]
        sizes = [b[c + 1] - b[c] for c in ctas]
        assert max(sizes) - min(sizes) <= 1
        assert sum(sizes) == m


@pytest.mark.parametrize(
    "case, n_loc, r, cluster, resident, ctas_per_shard",
    [("mesh_burst", [1408] * 4, 4, 16, True, [4] * 4),
     ("scalar_r6", [1408] * 4, 6, 16, True, [4] * 4),
     ("ragged_5000_over_3", [1667, 1667, 1666], 4, 16, True, [6, 5, 5]),
     ("above_resident_gate", [32768] * 4, 4, 16, False, [4] * 4),
     ("mesh_mixed_fill", [16] * 4, 4, 4, True, [1] * 4),
     ("tiny_ragged", [2, 1, 0], 4, 3, True, [1] * 3)],
)
def test_k4_batch_plans_at_the_smoke_shapes(case, n_loc, r, cluster,
                                            resident, ctas_per_shard):
    plan = sk.plan_for_batch(n_loc, r, 16, STATIC["k4"])
    _check_shard_plan(plan, n_loc)
    assert plan.cluster == cluster
    assert plan.resident is resident
    assert [plan.shards.count(k) for k in range(len(n_loc))] == ctas_per_shard
    cap = max(np.diff(plan.slice_bounds))
    assert plan.threads == min(512, max(32, -(-cap // 32) * 32))
    # csrc/solve_common.cuh greedy_smem_bytes: the chunk's pod words,
    # then (resident) alloc, req, nzr and mask bits of the largest slice
    need = 4 * (32 * (r + 4) + (cap * (2 * r + 3) if resident else 0))
    assert need <= plan.smem_bytes < need + 16
    assert plan.smem_bytes + STATIC["k4"] <= SMEM_PER_CTA


@pytest.mark.parametrize("seed", range(10))
def test_k4_shard_slices_never_straddle_a_shard(seed):
    rng = np.random.default_rng(seed)
    p = int(rng.integers(1, 17))
    n_loc = [int(x) for x in rng.integers(0, 3000, p)]
    n_loc[0] += 1  # at least one row
    for cluster in cluster_plan.CLUSTER_SIZES:
        if cluster < p:
            with pytest.raises(sk.KernelError):
                sk.plan_for_batch(n_loc, 4, cluster, STATIC["k4"])
            continue
        _check_shard_plan(sk.plan_for_batch(n_loc, 4, cluster, STATIC["k4"]),
                          n_loc)


# -- K3's plan: the node layout ------------------------------------------------

@pytest.mark.parametrize(
    "case, n, r, v, p, resident",
    [("preemption5000_wave", 5000, 4, 16, 0, True),
     ("pdbs", 5000, 4, 16, 4, True),
     ("v48_scalar_r6", 5000, 6, 48, 0, False),
     ("above_resident_gate", 40000, 4, 16, 2, False),
     ("mesh_mixed", 64, 4, 8, 0, True)],
)
def test_k3_plans_at_the_smoke_shapes(case, n, r, v, p, resident):
    plan = pk.plan_for(n, r, v, p, 16, STATIC["k3"])
    assert plan.cluster == min(16, -(-n // 32))
    assert plan.threads == 512  # the warps build keys, one node each
    assert plan.resident is resident
    b = plan.slice_bounds
    assert b == cluster_plan.slice_bounds(n, plan.cluster)
    words = pk.node_words(r, v, p)
    w = -(-v // 32)
    # alloc, carry, nominations; prio, start; requests; active bits; PDB
    # bits; budgets; three masks; candidate bit; the packed key
    assert words == 3 * r + 2 * v + r * v + w + -(-v * p // 32) + p + 3 * w \
        + 1 + 6
    # csrc/preempt_solve.cu dynamic_smem_bytes: the fixed words, then
    # (resident) the layout at an odd stride
    stride = -(-n // plan.cluster) | 1
    need = 4 * (pk.fixed_words(r) + (stride * words if resident else 0))
    assert need <= plan.smem_bytes
    assert plan.smem_bytes + STATIC["k3"] <= SMEM_PER_CTA


def test_k3_gate_flips_where_the_layout_stops_fitting():
    r, v, p = 4, 16, 0
    words = pk.node_words(r, v, p)
    per_cta = (SMEM_PER_CTA - STATIC["k3"]) // (4 * words) - 2
    assert pk.plan_for(16 * per_cta, r, v, p, 16, STATIC["k3"]).resident
    assert not pk.plan_for(16 * (per_cta + 4), r, v, p, 16,
                           STATIC["k3"]).resident
    # Preemption/5000's victims stay on chip (~313 nodes a CTA); 16 CTAs
    # hold ~7,800 nodes at V = 16, R = 4
    assert 313 < per_cta < 500


@pytest.mark.parametrize(
    "r, v, message",
    [(pk.MAX_DIMS + 1, 16, "resource dims"),
     (4, pk.MAX_VICTIMS + 1, "victim slots")],
)
def test_k3_refuses_shapes_past_its_limits(r, v, message):
    """K3 holds a node's dims in lane registers (R <= 64) and victim
    counts in 16 bits of the packed key (V < 65,536): a wave past either
    limit has no plan, so on the card it raises KernelError."""
    with pytest.raises(pk.KernelError, match=message):
        pk.plan_for(5000, r, v, 0, 16, STATIC["k3"])


@pytest.mark.parametrize("n", [8, 5000])
def test_k3_streams_a_node_larger_than_shared_memory(n):
    """V = 12,000 at R = 4, no PDB: one node's layout alone is larger
    than a CTA's shared memory, so the wave streams every node from the
    device-memory scratch and shared memory holds only the fixed words
    (csrc/preempt_solve.cu dynamic_smem_bytes)."""
    r, v, p = 4, 12_000, 0
    assert 4 * pk.node_words(r, v, p) > SMEM_PER_CTA
    plan = pk.plan_for(n, r, v, p, 16, STATIC["k3"])
    assert not plan.resident
    assert plan.cluster == min(16, -(-n // 32))
    assert plan.threads == 512
    assert plan.smem_bytes == -(-4 * pk.fixed_words(r) // 16) * 16
    assert plan.smem_bytes + STATIC["k3"] <= SMEM_PER_CTA
    # the largest victim count still plans
    assert not pk.plan_for(n, r, pk.MAX_VICTIMS, p, 16, STATIC["k3"]).resident


def test_k3_plans_at_its_limits():
    plan = pk.plan_for(5000, pk.MAX_DIMS, 16, 0, 16, STATIC["k3"])
    assert plan.cluster == 16 and not plan.resident
    assert pk.MAX_DIMS == 64 and pk.MAX_VICTIMS == (1 << 16) - 1


def test_cpu_tensors_never_plan_k3_or_k4(monkeypatch):
    """The batch entry and the victim search on CPU tensors run their
    plain versions: no build, no plan, no launch."""
    def refuse(*_a, **_k):
        raise AssertionError("planned a launch for CPU tensors")

    for mod in (sk, pk):
        monkeypatch.setattr(mod, "choose_plan", refuse)
        monkeypatch.setattr(mod, "build", refuse)
    monkeypatch.setattr(sk, "plan_for_batch", refuse)
    monkeypatch.setattr(pk, "plan_for", refuse)
    args = _cpu_problem(1)
    mesh = NodeMesh(["cpu"] * 2)
    cols = [[a[lo:hi].clone() for lo, hi in mesh.bounds(48)]
            for a in args[:4]]
    rows = [args[6][:, lo:hi] for lo, hi in mesh.bounds(48)]
    before = sk.launches, sk.last_plan
    cands = sk.ShardCandidates(*cols, rows, *args[4:6], args[7])
    asg = cands.batch(args[8])
    assert (asg.numpy() >= 0).all()
    assert (sk.launches, sk.last_plan) == before
    # a wave of two pods on three full nodes, one victim slot each
    i32 = torch.int32
    alloc = torch.tensor([[4000, 8, 0, 10]] * 3, dtype=i32)
    wave = (
        alloc, alloc.clone(), torch.zeros((3, 1), dtype=i32),
        torch.zeros((3, 1)), torch.tensor([[[1000, 4, 0, 1]]] * 3, dtype=i32),
        torch.ones((3, 1), dtype=torch.bool),
        torch.zeros((3, 1, 0), dtype=torch.bool), torch.zeros(0, dtype=i32),
        torch.zeros((0, 4), dtype=i32), torch.zeros(0, dtype=i32),
        torch.zeros(0, dtype=i32), torch.tensor([[500, 2, 0, 1]] * 2, dtype=i32),
        torch.tensor([10, 10], dtype=i32), torch.ones((1, 3), dtype=torch.bool),
        torch.zeros(2, dtype=i32), torch.ones(2, dtype=torch.bool),
    )
    before = pk.launches, pk.last_plan
    chosen = pk.preempt_solve(*wave)[0]
    assert chosen.tolist() == [0, 1]
    assert (pk.launches, pk.last_plan) == before


# -- K4's batch combine (csrc/shard_candidate.cu shard_batch_kernel) --------

def _pack(scores, rows):
    """pack_best: order-preserving score bits, then the complemented row;
    0 is "no candidate"."""
    return (_ordered_bits(scores) << np.uint64(32)) | (
        ~np.asarray(rows, np.uint64) & np.uint64(0xFFFFFFFF)
    )


def _k4_step(scores, feasible, plan, n_loc):
    """One pod step as the batch kernel takes it: each CTA's maximum key
    over its rows (the cluster step inside a CTA is the K1 combine held
    above), each shard's candidate folded from its CTAs' keys, the
    device's winner from all of them. Returns ([(score, local index)] per
    shard, winner row or -1)."""
    b = plan.slice_bounds
    offs = np.concatenate([[0], np.cumsum(n_loc)])
    keys = np.where(feasible, _pack(scores, np.arange(len(scores))),
                    np.uint64(0))
    cta = [int(keys[b[c]:b[c + 1]].max(initial=0)) for c in range(plan.cluster)]
    cands = []
    for k in range(len(n_loc)):
        top = max((cta[c] for c, kk in enumerate(plan.shards) if kk == k),
                  default=0)
        if top == 0:
            cands.append((-np.inf, 0))
        else:
            row = int(~np.uint32(top & 0xFFFFFFFF))
            cands.append((float(scores[row]), row - int(offs[k])))
    top = max(cta)
    return cands, (-1 if top == 0 else int(~np.uint32(top & 0xFFFFFFFF)))


@pytest.mark.parametrize("seed", range(12))
def test_k4_batch_combine_equals_the_step_combine(seed):
    """Seeded scores with ties inside and across shards, ragged splits
    and all-infeasible steps: the kernel's shard candidates are each
    shard's first maximum, and its winner is the step route's combine
    (_mesh_step_loop: max score, then min global index)."""
    rng = np.random.default_rng(seed)
    p = int(rng.integers(1, 6))
    n = int(rng.integers(p, 900))
    mesh = NodeMesh(["cpu"] * p)
    n_loc = [hi - lo for lo, hi in mesh.bounds(n)]
    plan = sk.plan_for_batch(n_loc, 4, int(rng.choice([4, 8, 16]) if p <= 4
                                           else 16), STATIC["k4"])
    values = np.array([-0.0, 0.0, 3.0, 57.0, 57.0, 200.0], np.float32)
    for step in range(8):
        scores = rng.choice(values[: int(rng.integers(1, 7))], n).astype(np.float32)
        feasible = rng.random(n) < [0.0, 0.02, 0.5, 1.0][step % 4]
        cands, win = _k4_step(scores, feasible, plan, n_loc)
        masked = np.where(feasible, scores, -np.inf).astype(np.float32)
        offs = np.concatenate([[0], np.cumsum(n_loc)])
        want = []
        for k in range(p):
            seg = masked[offs[k]:offs[k + 1]]
            if seg.size == 0 or not np.isfinite(seg).any():
                want.append((-np.inf, 0))
            else:
                i = int(np.argmax(seg))  # the first maximum, as argmax keeps
                want.append((float(seg[i]), i))
        assert cands == want
        # _mesh_step_loop's combine on those candidates
        s = torch.tensor([c[0] for c in cands], dtype=torch.float32)
        g = torch.tensor([c[1] for c in cands], dtype=torch.int64) + \
            torch.tensor(offs[:-1], dtype=torch.int64)
        best = s.max()
        pick = torch.where(s == best, g, 1 << 30).min()
        step_win = int(pick) if best > -torch.inf else -1
        assert win == step_win


# -- K3's packed pick key (csrc/preempt_solve.cu pack_key) ------------------

def _key_tuple(tier, nviol, fprio, psum, vcount, earliest, index):
    """KeyLess's order as a tuple: the latest earliest start first."""
    return (tier, nviol, fprio, psum, vcount, -float(earliest), index)


def _packed(tier, nviol, fprio, psum, vcount, earliest, index):
    bits = int(_ordered_bits(np.array([earliest], np.float32))[0])
    return (
        (tier << 30) | nviol,
        (fprio & 0xFFFFFFFF) ^ 0x80000000,
        (psum >> 16) & 0xFFFFFFFF,
        ((psum & 0xFFFF) << 16) | vcount,
        ~bits & 0xFFFFFFFF,
        index,
    )


@pytest.mark.parametrize("seed", range(6))
def test_k3_packed_key_orders_as_the_composite_key(seed):
    """Seeded keys with ties on every field (negative priorities, signed
    zeros, priority sums past 32 bits): the packed words' lexicographic
    order is the composite order the reference narrows by."""
    rng = np.random.default_rng(seed)
    keys = []
    for index in range(300):
        v = int(rng.integers(1, 1 << 16))
        vcount = int(rng.integers(0, min(v, 4) + 1))
        prios = rng.choice([-(1 << 31), -5, 0, 5, (1 << 31) - 2], vcount)
        keys.append((
            int(rng.integers(0, 3)), int(rng.integers(0, 3)),
            int(rng.choice([-(1 << 31), -7, 0, 7, (1 << 31) - 2])),
            int(sum((int(x) + (1 << 31)) for x in prios))
            + int(rng.choice([0, 1 << 40, (1 << 48) - (1 << 34)])),
            vcount,
            float(rng.choice(np.array([-0.0, 0.0, 1.5, 999.0, -3.0],
                                      np.float32))),
            index,
        ))
    by_tuple = sorted(range(len(keys)), key=lambda i: _key_tuple(*keys[i]))
    by_packed = sorted(range(len(keys)), key=lambda i: _packed(*keys[i]))
    assert by_tuple == by_packed


def _warp_min_key(words):
    """warp_min_key: one minimum per word among the lanes still tied."""
    tied = np.ones(len(words), bool)
    out = []
    for e in range(words.shape[1]):
        m = words[tied, e].min()
        out.append(int(m))
        tied &= words[:, e] == m
    return tuple(out)


@pytest.mark.parametrize("seed", range(4))
def test_k3_warp_minimum_is_the_lexicographic_minimum(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        words = rng.integers(0, 3, (32, 6)).astype(np.uint64)
        words[:, 5] = rng.permutation(32)  # the unique index
        words[rng.random(32) < 0.3] = 0xFFFFFFFF  # idle lanes: no_key
        want = min(tuple(int(x) for x in row) for row in words)
        assert _warp_min_key(words) == want


# -- K3's PDB spending (csrc/preempt_solve.cu warp_build_key) ---------------

def _pdb_sequential(eligible, match, allowed):
    budgets = list(allowed)
    violating = []
    for i in range(len(eligible)):
        if not eligible[i]:
            violating.append(False)
            continue
        viol = False
        for k in range(len(budgets)):
            if not match[i, k]:
                continue
            if budgets[k] <= 0:
                viol = True
                break
            budgets[k] -= 1
        violating.append(viol)
    return violating


def _pdb_lanes(eligible, match, allowed):
    """Lanes over PDBs: the first matching PDB with no budget left (a
    ballot), then every matching budget before it spends one."""
    budgets = np.array(allowed)
    violating = []
    for i in range(len(eligible)):
        if not eligible[i]:
            violating.append(False)
            continue
        spent = match[i] & (budgets <= 0)
        first = int(np.argmax(spent)) if spent.any() else len(budgets)
        budgets[:first] -= match[i, :first]
        violating.append(first < len(budgets))
    return violating


@pytest.mark.parametrize("seed", range(6))
def test_k3_pdb_spending_equals_the_sequential_walk(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        v, p = int(rng.integers(1, 40)), int(rng.integers(1, 70))
        eligible = rng.random(v) < 0.8
        match = rng.random((v, p)) < rng.choice([0.05, 0.3, 0.9])
        allowed = rng.integers(-1, 4, p)
        assert _pdb_lanes(eligible, match, allowed) == _pdb_sequential(
            eligible, match, allowed)


# -- K3's reprieve in its plain version (ops/preemption._reprieve) ----------

def _reprieve_walk(alloc, state, req, sel, pod_req):
    """The reprieve one victim at a time, as csrc/preempt_solve.cu walks
    it: re-add each selected victim and keep it while the pod fits."""
    from kubernetes_tpu_torch.ops.assignment import _fits

    taken = []
    for vi in range(req.shape[1]):
        cand = state + req[:, vi, :] * sel[:, vi, None].to(torch.int32)
        keep = _fits(alloc - cand, pod_req) & sel[:, vi]
        state = torch.where(keep[:, None], cand, state)
        taken.append(sel[:, vi] & ~keep)
    return state, torch.stack(taken, dim=1)


@pytest.mark.parametrize("seed", range(4))
def test_k3_plain_reprieve_runs_equal_the_walk(seed):
    """The plain version takes the reprieve a run at a time (kept runs by
    prefix sums, taken runs by single fits): the walk's victims and
    state, on small and wrapping int32 values, negative requests, scalar
    dims and all-zero pods."""
    from kubernetes_tpu_torch.ops.preemption import _reprieve

    rng = np.random.default_rng(seed)
    for trial in range(250):
        n, v, r = (int(rng.integers(1, 7)), int(rng.integers(1, 40)),
                   int(rng.integers(4, 7)))
        hi = INT_MAX if trial % 5 == 0 else 50
        lo = -hi if trial % 5 == 0 or trial % 7 == 0 else 0
        alloc = rng.integers(lo, hi, (n, r)).astype(np.int32)
        state = rng.integers(lo, hi, (n, r)).astype(np.int32)
        req = rng.integers(lo, hi // 4 + 2, (n, v, r)).astype(np.int32)
        sel = rng.random((n, v)) < rng.random()
        pod = rng.integers(0, hi // 3 + 2, r).astype(np.int32)
        if trial % 3 == 0:
            pod[:3] = 0
        if trial % 11 == 0:
            pod[4:] = 0
        args = [torch.from_numpy(a) for a in (alloc, state, req, sel, pod)]
        got, want = _reprieve(*args), _reprieve_walk(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- K3's sliced minimum: only the chosen node's owner rescans --------------

@pytest.mark.parametrize("seed", range(6))
def test_k3_sliced_minimum_with_owner_rescans_equals_a_full_rescan(seed):
    """Nodes' composite keys with ties everywhere but the index, over
    the plan's CTAs and 512 threads each: per step the pick is the
    minimum of the C cached CTA minima; the chosen node's key changes
    (its rebuild), only its owner thread rescans its nodes, its warp and
    CTA minima are refolded, and the owner CTA's new minimum replaces
    its cached copy. Every pick equals the minimum of a full rescan."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 3000))
    plan = pk.plan_for(n, 4, 16, 0, 16, STATIC["k3"])
    b, nt = plan.slice_bounds, plan.threads

    def draw(i):
        return (int(rng.integers(0, 3)), int(rng.integers(0, 2)),
                int(rng.integers(-1, 2)), int(rng.integers(0, 2)), i)

    keys = [draw(i) for i in range(n)]
    none = (9,)

    def thread_min(c, t):
        return min((keys[j] for j in range(b[c] + t, b[c + 1], nt)),
                   default=none)

    mine = {(c, t): thread_min(c, t) for c in range(plan.cluster)
            for t in range(nt)}
    wmin = {(c, w): min(mine[c, t] for t in range(32 * w, 32 * w + 32))
            for c in range(plan.cluster) for w in range(nt // 32)}
    cmin = [min(wmin[c, w] for w in range(nt // 32))
            for c in range(plan.cluster)]
    for _ in range(200):
        pick = min(cmin)
        assert pick == min(keys)
        if pick[0] > 1:  # nothing feasible: nothing changes again
            break
        j = pick[-1]
        keys[j] = draw(j)  # the rebuild
        c = ((j + 1) * plan.cluster + n - 1) // n - 1  # the owner CTA
        assert b[c] <= j < b[c + 1]
        t = (j - b[c]) % nt
        mine[c, t] = thread_min(c, t)  # only the owner thread rescans
        w = t // 32
        wmin[c, w] = min(mine[c, u] for u in range(32 * w, 32 * w + 32))
        cmin[c] = min(wmin[c, u] for u in range(nt // 32))
