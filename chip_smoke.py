#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero, and the final
line is printed only when every phase passed):

1. ``device``: the card's name and power limit (nvidia-smi), torch and
   CUDA versions.
2. ``build``: builds the greedy-solve (K1), constrained-solve (K2),
   victim-search (K3) and shard-candidate (K4) kernels from
   kubernetes_tpu_torch/csrc/, one nvcc each, all started together;
   prints each one's seconds and ptxas's register and spill report.
3. ``kernel_vs_twin``: K1 against its plain PyTorch version on the card,
   on seeded inputs at the burst's full shape (B=4,096 pods, N=5,632 node
   rows, R=4, U=8 mask rows) and at R=6 with scalar dims, with all-zero
   pods, over-committed and invalid rows and inactive padding; on
   SchedulingBasic's own batch (every pod 250m/512Mi on one mask row);
   and at N=131,072 rows x B=512, above K1's shape gate, so both the
   resident and the streaming side run. The tolerance is zero:
   assignments, requested' and nzr' must be bit-equal. Times the kernel
   with CUDA events after a warmup launch, and the plain version with the
   host clock. Each record names the launch plan (cluster size, threads,
   gate side, shared memory per CTA), ptxas's registers and spills for
   that side, and the microseconds per active pod step; a cluster of one
   CTA fails the phase.
3b. ``sinkhorn_kernel_vs_twin``: K1's scored entry (the sinkhorn commit
   scan) against its plain version ``sinkhorn_commit`` on the card, on
   the same card-computed prior: ChurnSinkhorn/50000's batch (B=1,024,
   N=50,048, one pod shape on one mask row, a churned load) at the
   default weights and at most-allocated weight 2, and the burst shape.
   Tolerance zero on assignments, requested' and nzr'. Times the prior
   (the plan, torch ops) and both entries of K1 with CUDA events, the
   plain version with the host clock; the bound adds the prior's bytes
   and one add per scored pair to K1's. On the churn case the plan's
   inputs computed on the card must equal the CPU's, and the plan on
   the card must lie within 1e-6 of the plan on the CPU (the 1e4-scaled
   prior within 1e-2): the reductions run in another order.
4. ``constrained_kernel_vs_twin``: K2 against its plain PyTorch version
   on the card at the constrained burst's shape (B=1,024 with inactive
   padding, N=5,632 node rows, R=4), packed by the port's own packers
   from a seeded 5,000-node cluster (10 zones, hostname labels, some
   nodes without a zone or rack label, small nodes that fill up,
   PreferNoSchedule taints, existing pods with affinity terms, a
   Service): hard spread, required affinity and anti-affinity on zone
   and hostname keys, preferred (anti-)affinity, soft spread, preferred
   node affinity and Service-selected pods. Cases: all three families at
   their live rows, at every row the packers emit, and each family alone
   (the other two as constants); then 64 pods on 36,400 nodes (40,960
   rows, above the reference's 32,768-node constrained cap) and on 72,800
   nodes (81,920 rows, above K2's shape gate: the streaming side).
   Tolerance zero on assignments, requested' and nzr'. K2 is timed with
   CUDA events after a warmup launch, the plain version with the host
   clock; each record names the launch plan as phase 3's do.
4b. ``preempt_kernel_vs_twin``: K3 against its plain PyTorch version on
   the card, tolerance zero on chosen nodes, victim and violating masks,
   violation counts and state'. Cases: (a) Preemption/5000's wave shape
   (N=5,000, V=16 with nodes short of pods, R=4, 1,032 pods of one class
   plus inactive padding); (b) four priorities x three request rows x
   eight candidate rows with 64 pre-existing nominations; (c) four
   PDBs, some at zero budget; (d) V=48 with R=6 (scalar dims), past the
   TPU kernel's 32-victim cap; (e) 40,000 nodes at V=16 with nominations
   and PDBs. (a)-(c) keep the node slices in shared memory, (d) and (e)
   stream them. K3 is timed with CUDA events after a warmup launch, the
   plain version with the host clock; each record names the launch plan
   as phase 3's do, and a cluster of one CTA fails the phase.
4c. ``shard_kernel_vs_twin``: K4 against its plain PyTorch versions on
   the card, tolerance zero. The step entry, 256 pod steps per case on
   (score, shard-local index): (a) the mesh burst's shard shape (5,632
   seeded rows over 4 shards of 1,408, R=4, U=8, invalid rows); (b) R=6
   with scalar dims and all-zero pods; (c) pods with no feasible row,
   which must give (-inf, 0); (d) a ragged split, 5,000 rows over 3
   shards. Timed per launch (all shards of a pod step) with CUDA events,
   queued behind a sleeping kernel (``ms``) and paced by the host
   (``host_paced_ms``). The batch entry against ``mesh_batch_plain`` on
   the assignment, req', nzr' and every active step's candidate columns:
   the same four shapes at B=256, the mesh burst's full batch (B=4,096),
   and 4 shards x 32,768 rows at B=512 (streaming); each record names
   the launch plan (the CTAs' shards too), a cluster of one CTA fails the
   phase, and launches are timed one by one on the same state.
5. ``burst``: the main path end to end through the port's entry points,
   as bench.py builds it: APIServer, Client, InformerFactory,
   new_scheduler(batch=True, max_batch=4096) on the card, 5,000 nodes
   (32 CPU, 64Gi, 110 pods), warmup() and a warm burst, then 10,000 pods
   of 250m/512Mi. Asserts every pod binds, no node exceeds capacity,
   every burst batch solved on the "cuda" tier with K1's launch count
   moving and no fallback of any kind, and that the placements equal a
   replay of the burst's batches, in solve order, through the numpy
   host_greedy_assign from the post-warmup cluster state. Prints pods/s,
   p50/p99 pod-to-bind and the per-stage seconds.
6. ``constrained_bursts``: the five 5,000-node constrained rows of the
   perf matrix (PodTopologySpread, PodAntiAffinity, PodAffinity,
   PreferredPodAffinity, ServiceSpread), each on a fresh stack through
   the entry points: new_scheduler(batch=True, max_batch=1024) on the
   card, warmup(), the init pods, then 1,000 measured pods created in
   chunks. Asserts every pod binds, every measured batch solved on the
   "cuda" tier with K2 launching, no fallback counter moved, each
   recorded solve equals a CPU replay of its pieces and handed carry
   through the plain version, the placements equal that replay, and the
   row's hard constraints hold. Prints pods/s, p50/p99 create-to-bind,
   the batch sizes, K2's launches and the stage seconds. The
   anti-affinity row runs a second time at max_batch 256, so its
   measured pods land in several batches and K2 solves back to back on
   the resident carry (at least four launches, each replayed).
7. ``preemption_burst``: Preemption/5000
   (benchmarks/config/performance-config.yaml:305-312, built as
   benchmarks/runner.py:1040-1066 builds it) on a fresh stack through
   the entry points: new_scheduler(batch=True) on the card, warmup(),
   50,000 fill pods of 3 CPU / 6Gi at priority 0 (10 fill each 32-CPU
   node), 32 warm preemptors, then 1,000 measured pods of 3 CPU / 6Gi at
   priority 100. Asserts every preemptor binds, no node holds more than
   10 pods, each preemptor took exactly one priority-0 victim, every
   wave ran on the "cuda" tier with K3 launching and no host preemption
   or fallback counter moving, and every K3 call equals a CPU replay of
   its recorded pack and pods through the plain version. Prints pods/s,
   p50/p99 create-to-bind, the waves and their sizes and seconds, K3's
   launches, the victims, the pack seconds and the stage seconds.
8. ``mesh_burst``: the ``burst`` phase again on the node-sharded tier,
   ``new_scheduler(batch=True, max_batch=4096,
   mesh=NodeMesh(["cuda:0"] * 4))``: four shards of 1,408 rows on the
   one card. Asserts, beside the ``burst`` checks and the host-greedy
   replay, that K4 launched exactly once per measured batch (one device
   holds every shard: the batch entry) and K1 never, at most one full
   state upload and no carry divergence, and no K4 build during the
   burst. Prints K4's launches and the shard sizes too.
9. ``mesh_mixed``: ``__graft_entry__.dryrun_multichip`` parts 1 and 1b on
   the same mesh: 512 nodes with plain, hard-spread, anti-affinity,
   preferred-affinity and gang pods (68 bound; the constrained batches
   run K2 on the gathered carry; every solve equals a replay on a CPU
   mesh; plain pods that share a batch with constrained ones ride K2),
   then a cluster
   saturated by plain priority-0 pods that all bind through K4, whose
   high-priority burst preempts through K3 on the mesh's first device;
   (1c) 32 pods in sinkhorn mode on the mesh (the prior and K1's scored
   entry on the gathered state), which must all bind where one card
   places them.
10. ``sinkhorn_churn``: ChurnSinkhorn/50000
   (benchmarks/config/performance-config.yaml:480-488, its churn rounds
   as benchmarks/runner.py:1269-1296 runs them) through the entry
   points: new_scheduler(batch=True, max_batch=1024,
   solver_mode="sinkhorn") on the card, 50,000 nodes (32 CPU, 64Gi, 110
   pods, 10 zones), a HollowNodePool acking every bind, 100,000 init
   pods of 100m/128Mi, then 10,000 measured pods in 5 rounds, each round
   first deleting 2,000 bound pods. Asserts every pod binds and every
   live pod is acked Running, no node over capacity, every solve on the
   "cuda" tier with no fallback, one scored K1 launch per sinkhorn batch
   and no greedy launch or plain commit; replays every measured batch
   and every fourth init batch through ``sinkhorn_commit`` on the card
   on the batch's own prior, which must be equal. Prints pods/s, p50/p99
   create-to-bind, the stage seconds, the plan's and the scored entry's
   device seconds (CUDA events) and the per-node CPU utilization mean,
   std and max. Then RebalanceSinkhorn/500 (:268-277: 500 nodes, 6,000
   init and 2,000 measured pods of 2 CPU/2Gi, 4 rounds of 500 deletes),
   where the slot cap binds, every batch replayed.
11. ``lifecycle``: the cluster-lifecycle rows of the perf matrix
   (benchmarks/config/performance-config.yaml), each on a fresh stack
   built as benchmarks/runner.py builds it, through the entry points on
   the card: DrainViaPreemption/500 (4,000 residents of 3 CPU / 6Gi, 500
   measured pods arriving Poisson at 300 pods/s; at half bound 3 waves x
   4 nodes drained by ``NodeDrainer.drain_via_preemption`` under a PDB
   of 40, each plan one K3 launch at the plan priority), LifecycleDrainWave
   /500 (5 waves x 4 whole-node drains), LifecycleReclaimStorm/500
   (``ClusterLifecycleDriver`` reclaims 10% of the fleet, cold
   replacements rejoin 1 s later), LifecycleColdScaleUp/500 (400 nodes,
   pods of 16 CPU, 120 cold nodes join at 60% bound),
   HeartbeatLapseStorm/1000 (a ``HollowNodeFleet`` acking binds; 25
   agents go dark at 60% bound, ``NodeLifecycleController`` taints them
   and evicts, the evictees respawn) and PreemptionCascade/500 (5,000
   residents fill the cluster, 500 priority-100 pods arrive in MMPP
   bursts, K3 waves under a PDB of 600, victims respawn). The streaming
   rows attach the SLO-adaptive controller through
   ``apply_streaming_config`` and feed the measured pods through
   ``ArrivalEngine``. Asserts per row: every solve on the "cuda" tier,
   no fallback; every K1 launch replayed on the CPU from its pieces and
   handed carry (assignment, requested' and nzr' equal) and every K3
   launch, plan or wave, through ``preempt_batch_plain`` (chosen, victim
   words, violation counts and state' equal), the launch counts equal to
   the recorded calls; every live pod bound (HeartbeatLapseStorm: every
   pod Running, none on a dark node, every dark node tainted;
   PreemptionCascade: every priority-100 pod, the respawned victims
   having no room); no incarnation bound twice; no PDB below zero; no
   helper thread failed and no batch failed on the card. Per row:
   DrainViaPreemption's eviction ledger (planned + classic evictions,
   counted apart through the drainer's client, equal the drainer's, no
   more than the residents) and at least one K3 plan launch per drained
   node; ReclaimStorm: one storm, the fleet whole again, membership row
   patches and one full repack; ColdScaleUp: pods on ``cold-*`` nodes;
   PreemptionCascade: K3 waves. Prints pods/s, p50/p99 arrival-to-bind,
   the stage seconds, K1 and K3 launches (plan and wave), the
   controller's trajectory, the lifecycle counters and one plan launch's
   time by CUDA events; then the phase's seconds. ``device="cpu"``
   rehearses it on the CPU.
12. ``kernels``: every ported kernel with its launches on the main path,
   its time per launch, its plain version's time and its bound (K4: the
   batch entry at the mesh burst's full batch; K1's scored entry at
   ChurnSinkhorn/50000's batch, its launches those of that workload; K1
   and K3 add their launches in ``lifecycle``).

Then the card's name and power limit as nvidia-smi prints them, and the
last line: {"ok": true, "device": {...}}. Needs a CUDA device; exits
non-zero without one.
"""

import json
import os
import re
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# the H100 SXM's published peaks (NVIDIA data sheet, dense): fp32 outside
# the tensor cores, and HBM3 bandwidth. The 67 TFLOP/s count a fused
# multiply-add as two operations. The greedy solve's arithmetic cannot
# fuse (bit parity with the reference rounds every product and sum on its
# own), so each of its operations takes one fp32 issue slot, and the
# card's rate for them is half that figure.
PEAK_FP32_FLOPS = 67e12
PEAK_UNFUSED_OPS_PER_S = PEAK_FP32_FLOPS / 2
PEAK_BYTES_PER_S = 3.35e12

N_NODES = 5000
N_PODS = 10000
MAX_BATCH = 4096
BURST_SHAPE = dict(n=5632, b=4096, r=4, u=8)  # N_NODES + headroom, 128-padded
# K1 above its shape gate: more rows than 16 CTAs hold in shared memory
GATE_SHAPE = dict(n=131072, b=512, r=4, u=8)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def counter_total(counter):
    return sum(counter._values.values())


# -- phase 3: kernel vs twin --------------------------------------------------

def random_problem(seed, n, b, r, u):
    """Seeded inputs at the main path's shape with its edge cases."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = rng.choice([0, 4000, 16000, 32000], n)
    alloc[:, 1] = rng.choice([8, 16, 64], n) * 1024 * 1024
    alloc[:, 2] = rng.choice([0, 1 << 20], n)
    alloc[:, 3] = rng.choice([3, 40, 110], n)
    if r > 4:
        alloc[:, 4:] = rng.choice([0, 2, 8], (n, r - 4))
    requested = np.zeros_like(alloc)
    requested[:, 0] = rng.integers(0, 4000, n)
    requested[:, 1] = rng.integers(0, 1 << 22, n)
    requested[:, 3] = rng.integers(0, 3, n)
    over = rng.random(n) < 0.02  # over-committed ephemeral dim
    requested[over, 2] = alloc[over, 2] + 1
    nzr = requested[:, :2].copy()
    nzr[:, 1] += rng.integers(0, 1 << 20, n).astype(np.int32)
    valid = rng.random(n) > 0.05
    valid[n - n // 10:] = False  # padding rows past the live nodes
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = rng.choice([0, 100, 250, 1000], b)
    pod_req[:, 1] = rng.choice([0, 128, 512, 2048], b) * 1024
    pod_req[:, 3] = 1
    if r > 4:
        pod_req[:, 4:] = rng.choice([0, 0, 0, 1], (b, r - 4))
    zero = rng.random(b) < 0.05
    pod_req[zero, :3] = 0
    pod_req[zero, 4:] = 0
    pod_nzr = np.maximum(pod_req[:, :2], [100, 200 * 1024]).astype(np.int32)
    rows = rng.random((u, n)) > 0.1
    rows[u - 1] = False
    midx = rng.integers(0, u, b).astype(np.int32)
    active = rng.random(b) > 0.02
    active[b - b // 16:] = False  # inactive padding tail
    return [alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active]


def fit_ops(r):
    """Operations of the fit test for one (pod, node) pair, counted from
    the kernel body (csrc/greedy_solve.cu): per fixed dim a subtract, a
    compare and an AND; per scalar dim also the zero-request compare and
    its OR; then the all-zero select."""
    return 3 * min(r, 4) + 5 * max(r - 4, 0) + 1


def score_ops(least, balanced, most):
    """Operations that score one feasible (pod, node) pair, counted from
    the kernel body, each division as ONE operation (the kernel's IEEE
    division takes several instructions; the bound counts the function's
    arithmetic, not this kernel's instructions):
      common   2 int adds, 4 int->float casts, 2 max, 4 compares, 2 ORs: 14
      least    per dim sub, mul, div, add, floor, select (12); half-sum
               add, div, add, floor (4); weight mul and add (2): 18
      balanced 2 compares, 2 divs, 2 selects; sub, abs, sub, mul, add,
               trunc; 2 compares, OR, select; weight mul and add: 18
      most     as least: 18
      argmax   compare and keep: 2"""
    return 14 + 2 + 18 * (bool(least) + bool(balanced) + bool(most))


def pair_counts(host, asg):
    """(pairs fit-tested, pairs scored) for this run's data: the kernel
    tests the fit of every active pod against every valid node its mask
    row admits, and scores only the nodes that fit. Replays the state
    with the kernel's own (checked) assignments, in numpy."""
    alloc, requested, _, valid, pod_req, _, rows, midx, active = host
    req = requested.astype(np.int64)
    r = alloc.shape[1]
    scalar = np.arange(r) >= 4
    others = np.arange(r) != 3
    tested = scored = 0
    for t in np.flatnonzero(active):
        checked = valid & rows[min(max(int(midx[t]), 0), rows.shape[0] - 1)]
        s = pod_req[t]
        ok = s[None, :] <= (alloc - req)
        ok[:, scalar & (s == 0)] = True
        fits = ok[:, 3] if not (s[others] > 0).any() else ok.all(axis=1)
        tested += int(checked.sum())
        scored += int((checked & fits).sum())
        if asg[t] >= 0:
            req[asg[t]] += s
    return tested, scored


def kernel_bytes(n, b, r, u):
    """Bytes the solve must move: each input read once, each output
    written once."""
    inputs = 4 * (2 * n * r + 2 * n + b * r + 2 * b + b) + n + u * n + b
    outputs = 4 * (b + n * r + 2 * n)
    return inputs + outputs


def homogeneous_problem(n, b, r, u):
    """SchedulingBasic's batch as K1 sees it: 5,000 live rows of 32 CPU /
    64Gi / 110 pods (the rest capacity padding), every pod 250m / 512Mi on
    one all-true mask row."""
    live = min(n, N_NODES)
    alloc = np.zeros((n, r), np.int32)
    alloc[:live, 0] = 32000
    alloc[:live, 1] = 64 * 1024 * 1024
    alloc[:live, 3] = 110
    requested = np.zeros_like(alloc)
    nzr = np.zeros((n, 2), np.int32)
    valid = np.zeros(n, bool)
    valid[:live] = True
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = 250
    pod_req[:, 1] = 512 * 1024
    pod_req[:, 3] = 1
    pod_nzr = pod_req[:, :2].copy()
    rows = np.zeros((u, n), bool)
    rows[0] = True
    midx = np.zeros(b, np.int32)
    active = np.ones(b, bool)
    return [alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active]


def ptxas_report(mod, resident, want=None):
    """Registers and spill bytes ptxas reported for the kernel's resident
    or streaming instantiation (the build's -Xptxas -v log), or for the
    kernel whose mangled name holds ``want``."""
    want = want or ("ILb1E" if resident else "ILb0E")
    out = {}
    current = None
    for line in mod.last_build.get("log", "").splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?([\w$]+)", line)
        if m:
            current = m.group(1)
            continue
        if current is None or want not in current:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out["spill_stores"], out["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            out["smem"] = int(m.group(1))
    return out


#: K1's kernel instantiations: greedy_cluster_kernel<resident, scored>
K1_GREEDY = "ILb{resident}ELb0E"
K1_SCORED = "ILb{resident}ELb1E"


def plan_record(mod, active_pods, ms, want=None):
    """The last launch's cluster, gate side and shared memory, the
    instantiation's registers and spills (``want``: a format of the
    mangled name's part that picks it, given ``resident``), and the time
    per active pod."""
    plan = mod.last_plan
    pick = want.format(resident=int(plan.resident)) if want else None
    return dict(
        cluster=plan.cluster, threads=plan.threads,
        side="resident" if plan.resident else "streaming",
        smem_bytes_per_cta=plan.smem_bytes + plan.static_bytes,
        ptxas=ptxas_report(mod, plan.resident, pick),
        us_per_pod_step=ms * 1e3 / max(active_pods, 1),
    )


def kernel_vs_twin(gk, asg_mod, cfg_cls):
    cases = [
        ("burst_r4", random_problem(0, **BURST_SHAPE), BURST_SHAPE, cfg_cls()),
        ("burst_r4_most_allocated", random_problem(1, **BURST_SHAPE),
         BURST_SHAPE, cfg_cls(0, 0, 1)),
        ("scalar_r6", random_problem(2, **dict(BURST_SHAPE, r=6)),
         dict(BURST_SHAPE, r=6), cfg_cls()),
        ("burst_homogeneous", homogeneous_problem(**BURST_SHAPE),
         BURST_SHAPE, cfg_cls()),
        # above what 16 CTAs hold in shared memory: the streaming side
        ("above_resident_gate", random_problem(3, **GATE_SHAPE), GATE_SHAPE,
         cfg_cls()),
    ]
    timing = None
    max_err = 0.0
    for name, host, shape, cfg in cases:
        dev = [torch.from_numpy(a).cuda() for a in host]
        torch.cuda.synchronize()
        k_out = gk.greedy_solve_cuda(*dev, config=cfg)  # warm launch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_out = asg_mod.greedy_assign_compact(*dev, config=cfg)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = [bool(torch.equal(k, p)) for k, p in zip(k_out, p_out)]
        err = max(
            float((k.to(torch.int64) - p.to(torch.int64)).abs().max())
            for k, p in zip(k_out, p_out)
        )
        max_err = max(max_err, err)
        reps = 10
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            gk.greedy_solve_cuda(*dev, config=cfg)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        n, b, r, u = shape["n"], shape["b"], shape["r"], shape["u"]
        tested, scored = pair_counts(host, k_out[0].cpu().numpy())
        ops = tested * fit_ops(r) + scored * score_ops(
            cfg.least_allocated_weight, cfg.balanced_allocation_weight,
            cfg.most_allocated_weight,
        )
        bytes_ms = kernel_bytes(n, b, r, u) / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_UNFUSED_OPS_PER_S * 1e3
        rec = dict(
            case=name, shape=shape, equal=equal, max_abs_err=err,
            placed=int((k_out[0] >= 0).sum()), ms=ms, plain_ms=plain_ms,
            pairs_tested=tested, pairs_scored=scored, ops=ops,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms > ops_ms else "operations",
            **plan_record(gk, int(host[8].sum()), ms, K1_GREEDY),
        )
        emit("kernel_vs_twin", **rec)
        if not all(equal):
            raise AssertionError(f"kernel disagrees with its twin on {name}")
        if rec["cluster"] < 2:
            raise AssertionError(f"{name} launched a cluster of one CTA")
        if name == "burst_r4":
            timing = rec
    return timing, max_err


# -- phase 3b: K1's scored entry (the sinkhorn commit scan) vs its twin -------

# ChurnSinkhorn/50000's batch: 50,000 nodes padded to 128 rows, one pod
# shape on one mask row
CHURN_SHAPE = dict(n=50048, b=1024, r=4, u=1)
CHURN_LIVE = 50000
#: the plan on the card against the plan on the CPU from the same inputs.
#: Not zero: each logsumexp reduces 1,024 or 50,048 terms in another
#: order on the card than on the CPU, and the card's exp and log may
#: differ from the CPU's in the last bit; 50 iterations carry that on.
#: The prior is the plan scaled by 1e4.
PLAN_TOL = 1e-6
PRIOR_TOL = 1e-2


def churned_problem(seed, n, b, r, u, live=CHURN_LIVE):
    """ChurnSinkhorn/50000's batch as K1's scored entry sees it: ``live``
    nodes of 32 CPU / 64Gi / 110 pods (the rest capacity padding) after
    churn, each holding a seeded number of 100m/128Mi pods (two on
    average, some nodes full), and a batch of 100m/128Mi pods on one
    all-true mask row."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:live, 0] = 32000
    alloc[:live, 1] = 64 * 1024 * 1024
    alloc[:live, 3] = 110
    pods = np.minimum(rng.poisson(2.0, n), 110)
    pods[rng.random(n) < 0.01] = 110
    pods[live:] = 0
    requested = np.zeros_like(alloc)
    requested[:, 0] = pods * 100
    requested[:, 1] = pods * 128 * 1024
    requested[:, 3] = pods
    nzr = requested[:, :2].copy()
    valid = np.zeros(n, bool)
    valid[:live] = True
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = 100
    pod_req[:, 1] = 128 * 1024
    pod_req[:, 3] = 1
    pod_nzr = pod_req[:, :2].copy()
    rows = np.ones((u, n), bool)
    midx = np.zeros(b, np.int32)
    active = np.ones(b, bool)
    return [alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` calls on the current
    stream, by CUDA events, after one warm call; returns (ms, last
    result)."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def scored_bound(host, asg, cfg, shape):
    """The scored entry's bound: K1's bytes plus the [B, N] f32 prior read
    once; K1's operations plus one add per scored pair."""
    n, b, r, u = shape["n"], shape["b"], shape["r"], shape["u"]
    tested, scored = pair_counts(host, asg)
    ops = tested * fit_ops(r) + scored * (1 + score_ops(
        cfg.least_allocated_weight, cfg.balanced_allocation_weight,
        cfg.most_allocated_weight,
    ))
    bytes_ms = (kernel_bytes(n, b, r, u) + 4 * b * n) / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_UNFUSED_OPS_PER_S * 1e3
    return dict(
        pairs_tested=tested, pairs_scored=scored, ops=ops,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms > ops_ms else "operations",
    )


def sinkhorn_kernel_vs_twin(gk, asg_mod, sk_mod):
    """K1's scored entry against ``sinkhorn_commit`` on the card, on the
    same card-computed prior, tolerance zero; the plan on the card against
    the plan on the CPU from the same inputs (the churn case)."""
    cfg = asg_mod.GreedyConfig
    cases = [
        ("churn_sinkhorn_50000", churned_problem(0, **CHURN_SHAPE),
         CHURN_SHAPE, cfg(), True),
        ("churn_most_allocated_w2", churned_problem(1, **CHURN_SHAPE),
         CHURN_SHAPE, cfg(0, 0, 2), False),
        ("burst_shape", random_problem(4, **BURST_SHAPE), BURST_SHAPE,
         cfg(), False),
    ]
    timing = None
    max_err = 0.0
    for name, host, shape, config, check_plan in cases:
        dev = [torch.from_numpy(a).cuda() for a in host]
        torch.cuda.synchronize()
        plan_ms, prior = cuda_ms(
            lambda: asg_mod.sinkhorn_prior(*dev, config=config), 3
        )
        k_out = gk.greedy_solve_cuda(*dev, config=config, prior=prior)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_out = asg_mod.sinkhorn_commit(*dev, prior, config=config)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = [bool(torch.equal(k, p)) for k, p in zip(k_out, p_out)]
        err = max(
            float((k.to(torch.int64) - p.to(torch.int64)).abs().max())
            for k, p in zip(k_out, p_out)
        )
        max_err = max(max_err, err)
        ms, _ = cuda_ms(
            lambda: gk.greedy_solve_cuda(*dev, config=config, prior=prior), 5
        )
        # the greedy entry on the same inputs: what the prior adds
        greedy_ms, _ = cuda_ms(
            lambda: gk.greedy_solve_cuda(*dev, config=config), 5
        )
        active = int(host[8].sum())
        rec = dict(
            case=name, shape=shape, equal=equal, max_abs_err=err,
            placed=int((k_out[0] >= 0).sum()), ms=ms, plain_ms=plain_ms,
            plan_ms=plan_ms, greedy_entry_ms=greedy_ms,
            **scored_bound(host, k_out[0].cpu().numpy(), config, shape),
            **plan_record(gk, active, ms, K1_SCORED),
        )
        if check_plan:
            inputs = asg_mod.sinkhorn_plan_inputs(*dev, config=config)
            cpu_inputs = asg_mod.sinkhorn_plan_inputs(
                *(torch.from_numpy(a) for a in host), config=config
            )
            same_inputs = all(
                torch.equal(a.cpu(), c) for a, c in zip(inputs, cpu_inputs)
            )
            plan_card = sk_mod.sinkhorn_plan(*inputs, dev[8]).cpu()
            t0 = time.perf_counter()
            plan_cpu = sk_mod.sinkhorn_plan(
                *cpu_inputs, torch.from_numpy(host[8])
            )
            rec.update(
                plan_inputs_equal=same_inputs,
                plan_max_abs_err=float((plan_card - plan_cpu).abs().max()),
                prior_max_abs_err=float(
                    (plan_card * sk_mod.PRIOR_SCALE
                     - plan_cpu * sk_mod.PRIOR_SCALE).abs().max()
                ),
                plan_tol=PLAN_TOL, prior_tol=PRIOR_TOL,
                cpu_plan_seconds=time.perf_counter() - t0,
            )
        emit("sinkhorn_kernel_vs_twin", **rec)
        if not all(equal):
            raise AssertionError(f"the scored entry disagrees with its twin on {name}")
        if rec["cluster"] < 2:
            raise AssertionError(f"{name} launched a cluster of one CTA")
        if check_plan and not (
            rec["plan_inputs_equal"] and rec["plan_max_abs_err"] <= PLAN_TOL
            and rec["prior_max_abs_err"] <= PRIOR_TOL
        ):
            raise AssertionError(f"the card's plan is off the CPU's on {name}")
        if name == "churn_sinkhorn_50000":
            timing = rec
        del dev, prior, k_out, p_out
        torch.cuda.empty_cache()
    return timing, max_err


# -- phase 4c: the shard-candidate kernel vs its twin -------------------------

MESH_SHARDS = 4
SHARD_PODS = 256  # pod steps checked per case


def shard_problem(seed, n, r, p, infeasible=False, b=SHARD_PODS):
    """A seeded node state split over p shards of a p-device mesh on the
    card (ragged when p does not divide n), and a pod batch; with
    ``infeasible`` every pod asks for more than any node holds or points
    at the all-False mask row. Returns (host arrays, bounds, per-shard
    tensors, pod tensors, active [B] bool on the card)."""
    from kubernetes_tpu_torch.ops.mesh import NodeMesh

    host = random_problem(seed, n=n, b=b, r=r, u=BURST_SHAPE["u"])
    alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active = host
    if infeasible:
        pod_req = pod_req.copy()
        midx = midx.copy()
        pod_req[0::2, 0] = 1 << 30  # no node has that much CPU
        midx[1::2] = rows.shape[0] - 1  # the all-False row
        host = [alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx,
                active]
    mesh = NodeMesh(["cuda:0"] * p)
    bounds = mesh.bounds(n)
    dev = torch.device("cuda:0")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    shards = [
        tuple(put(x) for x in (
            alloc[lo:hi], requested[lo:hi], nzr[lo:hi], valid[lo:hi],
            rows[:, lo:hi],
        ))
        for lo, hi in bounds
    ]
    pods = (put(pod_req), put(pod_nzr), put(midx.astype(np.int32)))
    return host, bounds, shards, pods, put(active)


def shard_bound(host, bounds, t):
    """The least time one K4 step launch (pod t over every shard) could
    take: bytes each input read once (alloc, req, nzr, valid and the
    pod's one mask row, the pod's rows) and each output written once,
    against the operations of the rows the pod tests and scores
    (fit_ops, score_ops counted from the kernel body, as for K1)."""
    alloc, requested, _, valid, pod_req, _, rows, midx, _ = host
    n, r = alloc.shape
    p = len(bounds)
    n_bytes = 4 * (2 * n * r + 2 * n) + 2 * n + 4 * (r + 2 + 1) + 8 * p
    m = min(max(int(midx[t]), 0), rows.shape[0] - 1)
    checked = valid & rows[m]
    s = pod_req[t]
    ok = s[None, :] <= (alloc.astype(np.int64) - requested)
    ok[:, (np.arange(r) >= 4) & (s == 0)] = True
    others = np.arange(r) != 3
    fits = ok[:, 3] if not (s[others] > 0).any() else ok.all(axis=1)
    ops = int(checked.sum()) * fit_ops(r) + int((checked & fits).sum()) * (
        score_ops(1, 1, 0)
    )
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_UNFUSED_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


def shard_batch_bound(host, asg, p):
    """The least time one K4 batch launch could take: K1's bytes (each
    input read once, the assignment and req'/nzr' written once) plus the
    per-shard candidates written, against the operations of the pairs
    this run's data tests and scores (pair_counts, replayed with the
    kernel's checked assignments)."""
    alloc, _, _, _, pod_req, _, rows, _, _ = host
    n, r = alloc.shape
    b, u = pod_req.shape[0], rows.shape[0]
    n_bytes = kernel_bytes(n, b, r, u) + 8 * b * p
    tested, scored = pair_counts(host, asg)
    ops = tested * fit_ops(r) + scored * score_ops(1, 1, 0)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_UNFUSED_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms > ops_ms else "operations"


SHARD_CASES = [
    ("burst_shard_r4", 11, BURST_SHAPE["n"], 4, MESH_SHARDS, False),
    ("scalar_r6", 12, BURST_SHAPE["n"], 6, MESH_SHARDS, False),
    ("infeasible", 13, BURST_SHAPE["n"], 4, MESH_SHARDS, True),
    ("ragged_5000_over_3", 14, N_NODES, 4, 3, False),
]


def shard_step_cases(sk):
    """K4's step entry: SHARD_PODS pod steps per case, each one launch
    over every shard, against shard_candidate_plain per shard."""
    timing = None
    max_err = 0.0
    for name, seed, n, r, p, infeasible in SHARD_CASES:
        host, bounds, shards, pods, _ = shard_problem(seed, n, r, p, infeasible)
        cols = [list(x) for x in zip(*shards)]
        cands = sk.ShardCandidates(*cols, *pods)
        torch.cuda.synchronize()
        for t in range(SHARD_PODS):
            cands.step(t)
        torch.cuda.synchronize()
        k_score, k_index = cands.score.clone(), cands.index.clone()
        t0 = time.perf_counter()
        plain = [
            [sk.shard_candidate_plain(*sh, pods[0][t], pods[1][t], pods[2][t])
             for sh in shards]
            for t in range(SHARD_PODS)
        ]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3 / SHARD_PODS
        p_score = torch.stack([torch.stack([b for b, _ in row]) for row in plain])
        p_index = torch.stack([torch.stack([i for _, i in row]) for row in plain])
        equal = [bool(torch.equal(k_score, p_score)),
                 bool(torch.equal(k_index, p_index))]
        finite = torch.isfinite(p_score) & torch.isfinite(k_score)
        err = max(
            float((k_index.long() - p_index.long()).abs().max()),
            float((k_score - p_score)[finite].abs().max()) if finite.any() else 0.0,
        )
        max_err = max(max_err, err)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # paced by the host: each launch is enqueued as the step route
        # enqueues it, and a launch this short may wait on the next one
        start.record()
        for t in range(SHARD_PODS):
            cands.step(t)
        end.record()
        torch.cuda.synchronize()
        host_paced_ms = start.elapsed_time(end) / SHARD_PODS
        # the kernel's own time: the launches queue up behind a sleeping
        # kernel first (~0.1 s, far longer than enqueueing them), so the
        # events bracket them back to back on the card
        torch.cuda._sleep(200_000_000)
        start.record()
        for t in range(SHARD_PODS):
            cands.step(t)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / SHARD_PODS
        none_feasible = int((~torch.isfinite(p_score)).all(dim=1).sum())
        bound_ms, bound_by = shard_bound(host, bounds, 0)
        ptxas = ptxas_report(sk, False, want="shard_candidate_kernel")
        rec = dict(
            entry="step", case=name, n=n, r=r, shards=p,
            n_loc=[hi - lo for lo, hi in bounds], pods=SHARD_PODS,
            # no cluster: one block of 1,024 threads per shard per launch
            blocks=p, threads=1024, side="device memory",
            smem_bytes_per_cta=ptxas.get("smem"), ptxas=ptxas,
            us_per_pod_step=ms * 1e3,
            equal=equal, max_abs_err=err,
            pods_with_no_feasible_row=none_feasible,
            empty_candidates_are_minus_inf_0=bool(
                (k_index[~torch.isfinite(k_score)] == 0).all()
            ),
            ms=ms, host_paced_ms=host_paced_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by,
        )
        emit("shard_kernel_vs_twin", **rec)
        if not all(equal) or not rec["empty_candidates_are_minus_inf_0"]:
            raise AssertionError(f"K4 disagrees with its twin on {name}")
        if infeasible and none_feasible == 0:
            raise AssertionError("the infeasible case has a feasible pod")
        if name == "burst_shard_r4":
            timing = rec
    return timing, max_err


def mesh_step_route(sk, p, shards, pods, active, plain, batch):
    """The route of a mesh over several devices, run on the card over the
    one-device work list of ``p`` shards (assignment._mesh_step_loop:
    per active pod one K4 step launch, then the torch combine and bump).
    Holds its assignment, req', nzr' and every active step's candidate
    columns bit-equal to ``plain`` (mesh_batch_plain's outputs on the
    same inputs) and to ``batch`` (the batch entry's), and its K4
    launches to one per active pod."""
    from kubernetes_tpu_torch.ops import assignment as asg_mod
    from kubernetes_tpu_torch.ops.mesh import NodeMesh

    mesh = NodeMesh(["cuda:0"] * p)
    alloc, req0, nzr0, valid, rows = [list(x) for x in zip(*shards)]
    work, score, index = asg_mod._mesh_work(
        mesh, alloc, req0, nzr0, valid, rows, [pods], asg_mod.GreedyConfig())
    act = active.cpu().numpy()
    before = sk.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asg = asg_mod._mesh_step_loop(mesh, work, score, index, act)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = sk.launches - before
    w = work[0]
    n = w.views[-1][1]  # the working buffers' last row is scratch
    got = (asg, w.req[:n], w.nzr[:n], score[active], index[active])
    names = ("assignment", "req", "nzr", "score", "index")
    rec = dict(
        n_active=int(act.sum()), launches=launches, host_ms=ms,
        host_us_per_pod_step=ms * 1e3 / max(int(act.sum()), 1),
        equal_plain={nm: bool(torch.equal(x, y))
                     for nm, x, y in zip(names, got, plain)},
        equal_batch={nm: bool(torch.equal(x, y))
                     for nm, x, y in zip(names, got, batch)},
    )
    if not (all(rec["equal_plain"].values())
            and all(rec["equal_batch"].values())):
        raise AssertionError("the mesh step route disagrees with K4's batch "
                             "entry or its plain version")
    if launches != rec["n_active"]:
        raise AssertionError(
            f"the step route made {launches} K4 launches for "
            f"{rec['n_active']} active pods")
    return rec


def shard_batch_cases(sk):
    """K4's batch entry: the step cases' shapes as whole-batch launches
    at B=SHARD_PODS, the mesh burst's full batch (B=4,096), and 4 shards
    x 32,768 rows at B=512, above the resident gate. Each holds the
    assignment, req', nzr' and every active step's candidate columns
    bit-equal to mesh_batch_plain on the same inputs."""
    cases = [(nm, seed, n, r, p, inf, SHARD_PODS)
             for nm, seed, n, r, p, inf in SHARD_CASES]
    cases += [
        ("mesh_burst_batch", 15, BURST_SHAPE["n"], 4, MESH_SHARDS, False,
         MAX_BATCH),
        ("above_resident_gate", 16, 4 * 32768, 4, MESH_SHARDS, False, 512),
    ]
    timing = None
    max_err = 0.0
    for name, seed, n, r, p, infeasible, b in cases:
        host, bounds, shards, pods, active = shard_problem(
            seed, n, r, p, infeasible, b=b)
        alloc, req0, nzr0, valid, rows = [list(x) for x in zip(*shards)]

        def fresh():
            return [q.clone() for q in req0], [z.clone() for z in nzr0]

        k_req, k_nzr = fresh()
        cands = sk.ShardCandidates(alloc, k_req, k_nzr, valid, rows, *pods)
        torch.cuda.synchronize()
        k_asg = cands.batch(active)
        torch.cuda.synchronize()
        p_req, p_nzr = fresh()
        t0 = time.perf_counter()
        p_asg, p_score, p_index = sk.mesh_batch_plain(
            alloc, p_req, p_nzr, valid, rows, *pods, active)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        act = active
        pairs = [
            ("assignment", k_asg, p_asg),
            ("req", torch.cat(k_req), torch.cat(p_req)),
            ("nzr", torch.cat(k_nzr), torch.cat(p_nzr)),
            ("score", cands.score[act], p_score[act]),
            ("index", cands.index[act], p_index[act]),
        ]
        equal = {nm: bool(torch.equal(x, y)) for nm, x, y in pairs}
        err = 0.0
        for nm, x, y in pairs:
            if nm == "score":
                finite = torch.isfinite(x) & torch.isfinite(y)
                d = (x - y)[finite].abs()
            else:
                d = (x.long() - y.long()).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
        max_err = max(max_err, err)
        # time launches on the same state: req/nzr are restored between
        # launches, outside the events
        reps = 5
        times = []
        for _ in range(reps):
            for q, q0 in zip(k_req, req0):
                q.copy_(q0)
            for z, z0 in zip(k_nzr, nzr0):
                z.copy_(z0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            cands.batch(active)
            end.record()
            times.append((start, end))
        torch.cuda.synchronize()
        ms = sum(s.elapsed_time(e) for s, e in times) / reps
        k_host = k_asg.cpu().numpy()
        bound_ms, bound_by = shard_batch_bound(host, k_host, p)
        n_active = int(active.sum())
        rec = dict(
            entry="batch", case=name, n=n, r=r, shards=p, b=b,
            active=n_active, n_loc=[hi - lo for lo, hi in bounds],
            equal=equal, max_abs_err=err,
            placed=int((k_host >= 0).sum()),
            pods_with_no_feasible_row=int(
                (~torch.isfinite(p_score[act])).all(dim=1).sum()),
            empty_candidates_are_minus_inf_0=bool(
                (cands.index[act][~torch.isfinite(cands.score[act])] == 0).all()
            ),
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            cta_shards=list(sk.last_plan.shards),
            **plan_record(sk, n_active, ms),
        )
        if name == "mesh_burst_batch":
            rec["step_route"] = mesh_step_route(
                sk, p, shards, pods, active,
                plain=[y for _, _, y in pairs],
                batch=[k_asg, torch.cat(k_req), torch.cat(k_nzr),
                       cands.score[act], cands.index[act]],
            )
        emit("shard_kernel_vs_twin", **rec)
        if not all(equal.values()) or not rec["empty_candidates_are_minus_inf_0"]:
            raise AssertionError(f"K4's batch entry disagrees with its twin on {name}")
        if rec["cluster"] < 2:
            raise AssertionError(f"{name} launched a cluster of one CTA")
        if infeasible and rec["pods_with_no_feasible_row"] == 0:
            raise AssertionError("the infeasible case has a feasible pod")
        if name == "mesh_burst_batch":
            timing = rec
    return timing, max_err


def shard_kernel_vs_twin(sk):
    step, step_err = shard_step_cases(sk)
    batch, batch_err = shard_batch_cases(sk)
    return step, batch, max(step_err, batch_err)


# -- phase 4: the constrained kernel vs its twin ------------------------------

ZONE_KEY = "topology.kubernetes.io/zone"
HOST_KEY = "kubernetes.io/hostname"
CONSTRAINED_SHAPE = dict(nodes=N_NODES, zones=10, existing=2000, pods=1000)
# 36,400 nodes pack into 40,960 rows: above the reference's 32,768-node
# CONSTRAINED_NODE_CAP, where it sends constrained batches to the host
CAPPED_SHAPE = dict(nodes=36400, zones=10, existing=2000, pods=64)
# 72,800 nodes pack into 81,920 rows: above what 16 CTAs of K2 hold in
# shared memory, so K2 runs on the streaming side of its gate
K2_GATE_SHAPE = dict(nodes=72800, zones=10, existing=2000, pods=64)


class _Lister:
    def __init__(self, items=()):
        self._items = list(items)

    def list(self):
        return list(self._items)


class _ServiceInformers:
    """What the score packer reads of the informers: the Services whose
    selectors drive SelectorSpread."""

    def __init__(self, services):
        self._services = _Lister(services)

    def services(self):
        return self._services

    def replication_controllers(self):
        return _Lister()

    def replica_sets(self):
        return _Lister()

    def stateful_sets(self):
        return _Lister()


def constrained_problem(seed, shape=CONSTRAINED_SHAPE, padded=None):
    """A constrained batch at the burst's shape (or ``shape``), packed as
    the batch scheduler packs it, by the port's packers, into ``padded``
    pod slots (default MAX_CONSTRAINED_BATCH): host arrays of the common
    operands and the three padded family tuples (and their no-op
    twins)."""
    import random

    from kubernetes_tpu_torch.api.types import ObjectMeta, Service
    from kubernetes_tpu_torch.cache.snapshot import new_snapshot
    from kubernetes_tpu_torch.ops.affinity import (
        noop_affinity_tensors, pack_affinity_batch, pad_affinity_tensors,
    )
    from kubernetes_tpu_torch.ops.host_masks import static_mask_compact
    from kubernetes_tpu_torch.ops.scoring import (
        noop_score_tensors, pack_score_batch, pad_score_tensors,
    )
    from kubernetes_tpu_torch.ops.topology import (
        noop_spread_tensors, pack_spread_batch, pad_spread_tensors,
    )
    from kubernetes_tpu_torch.tensors import NodeTensorCache, pack_pod_batch
    from kubernetes_tpu_torch.testing import make_node, make_pod

    rng = random.Random(seed)
    nodes = []
    for i in range(shape["nodes"]):
        # some nodes lack the zone or the rack label (ineligible for the
        # families keyed on them), some fill up within the batch
        nd = (
            make_node(f"node-{i}")
            .capacity(cpu="1" if i % 5 == 4 else "32", memory="64Gi",
                      pods=110)
            .label(HOST_KEY, f"node-{i}")
        )
        if i % 8 != 7:
            nd = nd.label(ZONE_KEY, f"zone-{i % shape['zones']}")
        if i % 6 != 5:
            nd = nd.label("rack", f"rack-{i % 7}")
        if i % 13 == 5:
            nd = nd.taint("flaky", "yes", effect="PreferNoSchedule")
        nodes.append(nd.obj())
    apps = ["a", "b", "c"]
    existing = []
    for i in range(shape["existing"]):
        p = (
            make_pod(f"ex-{i}").node(f"node-{rng.randrange(shape['nodes'])}")
            .container(cpu="200m", memory="256Mi")
            .labels(app=rng.choice(apps), svc=rng.choice(["web", "db"]))
        )
        roll = rng.random()
        if roll < 0.05:
            p = p.pod_affinity(HOST_KEY, {"app": rng.choice(apps)}, anti=True)
        elif roll < 0.15:
            p = p.preferred_pod_affinity(
                ZONE_KEY, {"app": rng.choice(apps)},
                weight=rng.randrange(1, 20), anti=rng.random() < 0.5,
            )
        existing.append(p.obj())
    pods = []
    for i in range(shape["pods"]):
        app = rng.choice(apps)
        p = (
            make_pod(f"pod-{i}").container(cpu="250m", memory="512Mi")
            .labels(app=app, svc=rng.choice(["web", "db", "none"]))
        )
        roll = rng.random()
        if roll < 0.10:
            p = p.pod_affinity(HOST_KEY, {"app": rng.choice(apps)}, anti=True)
        elif roll < 0.16:
            p = p.pod_affinity(ZONE_KEY, {"app": rng.choice(apps)}, anti=True)
        elif roll < 0.26:
            p = p.pod_affinity(ZONE_KEY, {"app": rng.choice(apps)})
        elif roll < 0.30:
            p = p.pod_affinity(HOST_KEY, {"app": rng.choice(apps)})
        elif roll < 0.42:
            p = p.spread_constraint(
                max_skew=rng.randrange(1, 4),
                topology_key=rng.choice([ZONE_KEY, HOST_KEY]),
                when_unsatisfiable="DoNotSchedule", match_labels={"app": app},
            )
        elif roll < 0.47:
            p = p.spread_constraint(
                max_skew=1, topology_key=rng.choice([ZONE_KEY, "rack"]),
                when_unsatisfiable="ScheduleAnyway", match_labels={"app": app},
            )
        elif roll < 0.62:
            p = p.preferred_pod_affinity(
                rng.choice([ZONE_KEY, HOST_KEY]), {"app": rng.choice(apps)},
                weight=rng.randrange(1, 30), anti=rng.random() < 0.4,
            )
        elif roll < 0.66:
            p = p.preferred_node_affinity_in("rack", ["rack-1", "rack-2"])
        pods.append(p.obj())
    snap = new_snapshot(existing, nodes)
    nt = NodeTensorCache().update(snap)
    batch = pack_pod_batch(pods, nt.dims)
    mask_rows, mask_index = static_mask_compact(pods, snap, nt)
    b = batch.size
    padded = padded or MAX_CONSTRAINED_BATCH
    order = batch.order
    req = np.zeros((padded, nt.dims.num_dims), np.int32)
    nzr = np.zeros((padded, 2), np.int32)
    midx = np.zeros(padded, np.int32)
    active = np.zeros(padded, bool)
    req[:b] = batch.requests[order]
    nzr[:b] = batch.non_zero_requests[order]
    midx[:b] = mask_index[order]
    active[:b] = True
    u = mask_rows.shape[0]
    rows = np.zeros((8 * -(-u // 8), nt.capacity), bool)
    rows[:u] = mask_rows
    ordered = [pods[int(i)] for i in order]
    services = [Service(metadata=ObjectMeta(name="web", namespace="default"),
                        selector={"svc": "web"})]
    sp = pack_spread_batch(ordered, snap, nt)
    af = pack_affinity_batch(ordered, snap, nt)
    sc = pack_score_batch(
        ordered, snap, nt, _ServiceInformers(services),
        {"NodeAffinity": 1, "TaintToleration": 1,
         "DefaultPodTopologySpread": 1, "PodTopologySpread": 2,
         "InterPodAffinity": 1},
        hard_pod_affinity_weight=1,
    )
    if sp is None or af is None or sc is None:
        raise AssertionError("a family packer refused the seeded batch")
    common = [
        np.asarray(nt.allocatable), np.asarray(nt.requested),
        np.asarray(nt.non_zero_requested), np.asarray(nt.valid),
        req, nzr, rows, midx, active,
    ]
    fams = (
        tuple(pad_spread_tensors(sp, padded)),
        tuple(pad_affinity_tensors(af, padded)),
        tuple(pad_score_tensors(sc, padded)),
    )
    noops = (
        tuple(noop_spread_tensors(padded, nt.capacity)),
        tuple(noop_affinity_tensors(padded, nt.capacity)),
        tuple(noop_score_tensors(padded, nt.capacity)),
    )
    return common, fams, noops


def k2_pair_ops(r, least, balanced, most):
    """Operations of K2 per (pod, node) pair, counted from the kernel body
    (csrc/constrained_solve.cu), each division as ONE operation:
      fit       K1's fit test, per pair fit-tested;
      spread    per live slot: key compare, clamp (2), add self, sub min,
                compare, AND: 7, per pair that fits;
      affinity  per live row (incoming, anti, existing-pod): key compare,
                value compare, clamp (2), count compare, AND: 6, per pair
                that fits;
      scoring   per feasible pair: K1's resource score; direct add 1;
                NodeAffinity mul, div, floor, mul, select, add and its max
                fold 2: 8; TaintToleration the same and a sub: 9;
                SelectorSpread sub, mul, div, select for the node and the
                zone (8), clamp, the blend (mul, FMA as 2), floor, mul,
                add, max fold, zone add: 19; soft per slot key compare,
                clamp, add (3), then sub, mul, div, floor, mul, add and
                its folds (add, min, select): 9; preferred affinity per
                row key compare, clamp, 2 mul, 2 add (6), then sub, mul,
                div, max, add, floor, mul, add and its folds (2): 10."""
    return dict(
        fit=fit_ops(r), spread_slot=7, affinity_row=6,
        score=score_ops(least, balanced, most) + 1 + 8 + 9,
        sel=19, soft_slot=3, soft=9, ipa_row=6, ipa=10,
    )


def k2_operations(host, fams, counts, cfg):
    """The operations this run's data needs: pairs fit-tested (active pod
    x valid node its mask row admits), pairs that fit and pairs feasible
    (per pod, from the plain version's step counts), times each family's
    per-pair operations at the pod's live slots and rows, plus each
    spread slot's minimum over values (2 per value). Preferred affinity
    counts only the rows with a value on some node: padding rows add
    nothing to any score."""
    alloc, _, _, valid, _, _, rows, midx, active = host
    sp, af, sc = fams
    ops = k2_pair_ops(
        alloc.shape[1], cfg.least_allocated_weight,
        cfg.balanced_allocation_weight, cfg.most_allocated_weight,
    )
    ipa_rows = int((sc[13] >= 0).any(axis=1).sum())
    total = 0
    pairs = dict(tested=0, fit=0, feasible=0)
    for k, t in enumerate(np.flatnonzero(active)):
        tested = int((valid & rows[min(int(midx[t]), rows.shape[0] - 1)]).sum())
        fit, feas = (int(x) for x in counts[k])
        n_sp = int((sp[3][t] >= 0).sum())
        n_rows = (
            int((af[3][t] >= 0).sum()) + int((af[8][t] >= 0).sum())
            + int(af[12][t].sum())
        )
        n_soft = int((sc[11][t] >= 0).sum())
        sel = sc[7][t] >= 0
        per_feasible = (
            ops["score"] + (ops["sel"] if sel else 0)
            + (ops["soft"] + ops["soft_slot"] * n_soft if n_soft else 0)
            + (ops["ipa"] + ops["ipa_row"] * ipa_rows if ipa_rows else 0)
        )
        total += (
            tested * ops["fit"]
            + fit * (ops["spread_slot"] * n_sp + ops["affinity_row"] * n_rows)
            + feas * per_feasible
            + 2 * n_sp * sp[0].shape[1]
        )
        pairs["tested"] += tested
        pairs["fit"] += fit
        pairs["feasible"] += feas
    return total, pairs


def constrained_kernel_vs_twin(ck, asg_mod):
    t_pack = time.perf_counter()
    burst = constrained_problem(7)
    pack_s = time.perf_counter() - t_pack
    capped = constrained_problem(11, CAPPED_SHAPE, padded=64)
    streamed = constrained_problem(13, K2_GATE_SHAPE, padded=64)
    cfg = asg_mod.GreedyConfig()
    # K2 at each family's live rows, and at every row the packers emit
    # (padding rows that change nothing); the plain version runs every row
    cases = [("all_live_rows", burst, (0, 1, 2), True),
             ("all_packed_rows", burst, (0, 1, 2), False)]
    for k, name in enumerate(("spread_alone", "affinity_alone",
                              "scoring_alone")):
        cases.append((name, burst, (k,), True))
    cases.append(("above_node_cap", capped, (0, 1, 2), True))
    cases.append(("above_resident_gate", streamed, (0, 1, 2), True))
    timing = None
    max_err = 0.0
    for name, (host, fams, noops), live, at_live_rows in cases:
        dev_common = [
            torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in host
        ]
        case_fams = tuple(fams[k] if k in live else noops[k] for k in range(3))
        rows = ck.live_rows(
            *(fams[k] if k in live else None for k in range(3))
        ) if at_live_rows else None
        dev_fams = [
            tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in f)
            for f in case_fams
        ]
        torch.cuda.synchronize()
        k_out = ck.constrained_solve_cuda(
            *dev_common, *dev_fams, config=cfg, rows=rows
        )  # warm launch
        torch.cuda.synchronize()
        counts = []
        t0 = time.perf_counter()
        p_out = asg_mod.greedy_assign_constrained(
            *dev_common, *dev_fams, config=cfg, pair_counts=counts,
        )
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = [bool(torch.equal(k, p)) for k, p in zip(k_out, p_out)]
        err = max(
            float((k.to(torch.int64) - p.to(torch.int64)).abs().max())
            for k, p in zip(k_out, p_out)
        )
        max_err = max(max_err, err)
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            ck.constrained_solve_cuda(
                *dev_common, *dev_fams, config=cfg, rows=rows
            )
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        counts = torch.stack(counts).cpu().numpy() if counts else []
        ops, pairs = k2_operations(host, case_fams, counts, cfg)
        n_bytes = sum(a.nbytes for a in host) + sum(
            np.asarray(a).nbytes for f in case_fams for a in f
        ) + k_out[0].numel() * 4 + 2 * (k_out[1].numel() + k_out[2].numel())
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = ops / PEAK_UNFUSED_OPS_PER_S * 1e3
        active = int(host[8].sum())
        rec = dict(
            case=name, rows=None if rows is None else dict(rows._asdict()),
            node_rows=int(host[0].shape[0]), equal=equal,
            max_abs_err=err, active=active,
            placed=int((k_out[0] >= 0).sum()), ms=ms, plain_ms=plain_ms,
            pairs=pairs, ops=ops, bytes=n_bytes,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms > ops_ms else "operations",
            **plan_record(ck, active, ms),
        )
        if name == "all_live_rows":
            rec["pack_seconds"] = pack_s
            timing = rec
        emit("constrained_kernel_vs_twin", **rec)
        if not all(equal):
            raise AssertionError(f"K2 disagrees with its twin on {name}")
        if rec["cluster"] < 2:
            raise AssertionError(f"{name} launched a cluster of one CTA")
    return timing, max_err


# -- phase 6: the constrained rows of the perf matrix -------------------------

# The five 5,000-node constrained rows of the repo's perf matrix,
# benchmarks/config/performance-config.yaml:86-145 (written out here: the
# card's machine has no YAML parser, and benchmarks/runner.py imports the
# JAX package). Matrix defaults: 32 CPU, 64Gi and 110 pods per node,
# zone-{i % 10} and hostname labels, max_batch 1,024.
CONSTRAINED_ROWS = [
    dict(name="PodTopologySpread/5000", init_pods=1000,
         init_labels={"app": "spread-init"}, labels={"app": "spread"},
         spread=dict(key=ZONE_KEY, max_skew=120, match={"app": "spread"})),
    dict(name="PodAntiAffinity/5000", init_pods=500, init_labels=None,
         labels={"color": "red"},
         affinity=dict(key=HOST_KEY, match={"color": "red"}, anti=True)),
    dict(name="PodAffinity/5000", init_pods=1000,
         init_labels={"peer": "base"}, labels={"peer": "base"},
         affinity=dict(key=ZONE_KEY, match={"peer": "base"})),
    dict(name="PreferredPodAffinity/5000", init_pods=1000,
         init_labels={"pref": "base"}, labels={"pref": "base"},
         affinity=dict(key=ZONE_KEY, match={"pref": "base"},
                       preferred=True, weight=10)),
    dict(name="ServiceSpread/5000", init_pods=1000,
         init_labels={"svc": "web"}, labels={"svc": "web"},
         services=[("web", {"svc": "web"})]),
    # the anti-affinity row again at max_batch 256: the measured pods land
    # in several batches, so K2 solves back to back on the resident carry
    dict(name="PodAntiAffinity/5000 in batches of 256", init_pods=500,
         init_labels=None, labels={"color": "red"},
         affinity=dict(key=HOST_KEY, match={"color": "red"}, anti=True),
         max_batch=256, min_launches=4),
]
MEASURED_PODS = 1000
MAX_CONSTRAINED_BATCH = 1024


def row_pod(make_pod, row, name, labels, constrained):
    """One pod of a matrix row, as benchmarks/runner.py builds it (100m,
    128Mi); the init pods of a row without an init spec take the row's
    own spec."""
    w = make_pod(name).container(cpu="100m", memory="128Mi").labels(**labels)
    if not constrained:
        return w.obj()
    sp = row.get("spread")
    if sp:
        w = w.spread_constraint(
            max_skew=sp["max_skew"], topology_key=sp["key"],
            when_unsatisfiable="DoNotSchedule", match_labels=sp["match"],
        )
    af = row.get("affinity")
    if af and af.get("preferred"):
        w = w.preferred_pod_affinity(
            af["key"], af["match"], weight=af["weight"],
        )
    elif af:
        w = w.pod_affinity(af["key"], af["match"], anti=af.get("anti", False))
    return w.obj()


def solve_recorders(orig_dispatch, orig_solve, dispatched, seen, calls):
    """Wrappers of a scheduler's ``_dispatch_solve`` and of the batch
    module's ``solve_packed`` that record every dispatch and every solve
    it made (pieces, the device state handed in, the answer)."""
    from kubernetes_tpu_torch.ops.mesh import ShardedRows

    def recording_dispatch(*args, **kwargs):
        p = orig_dispatch(*args, **kwargs)
        if p is not None and id(p) not in seen:
            seen.add(id(p))
            dispatched.append(p)
        return p

    def copy(t):
        if t is None:
            return None
        if isinstance(t, ShardedRows):
            return t.map(lambda s: s.clone())
        return t.clone()

    def recording_solve(pieces, alloc_in, valid_in, req_in, nzr_in, **kw):
        # the host arrays as they are now: a cold upload's node state is
        # the tensor cache's own, which later batches update in place
        pieces = [
            (name, a.copy() if isinstance(a, np.ndarray) else a)
            for name, a in pieces
        ]
        out = orig_solve(pieces, alloc_in, valid_in, req_in, nzr_in, **kw)
        # copies of the state handed in and of the carry handed out,
        # taken in stream order: a later solve's row patches may update
        # the resident carry in place
        handed = tuple(copy(t) for t in (alloc_in, valid_in, req_in, nzr_in))
        calls.append(dict(
            pieces=pieces, state=handed,
            carry=(copy(out[1]), copy(out[2])),
            out=out, mode=kw.get("mode", "greedy"),
            config=kw.get("config"), compress=kw.get("compress", False),
            mesh=kw.get("mesh"),
        ))
        return out

    return recording_dispatch, recording_solve


def replay_solves(calls, dispatched):
    """Replay each recorded solve on the CPU through the plain versions,
    from its pieces and the device state it was handed, in order; check
    each against the card's answer (the assignment and the carry it
    handed out, requested' and nzr') and return the placements the
    replay implies: pod name -> node name."""
    from kubernetes_tpu_torch.ops.assignment import solve_packed
    from kubernetes_tpu_torch.ops.mesh import NodeMesh, ShardedRows
    from kubernetes_tpu_torch.scheduler.batch import _to_host

    by_out = {id(c["out"][0]): c for c in calls}
    want = {}
    for p in dispatched:
        call = by_out.get(id(p["assignments_dev"]))
        if call is None:
            raise AssertionError(
                f"a dispatch on the {p['tier']} tier has no recorded solve "
                f"({type(p['assignments_dev']).__name__} of {p['b']} pods)"
            )
        mesh = call.get("mesh")
        # a mesh solve replays on a CPU mesh of as many shards
        cpu_mesh = None if mesh is None else NodeMesh(["cpu"] * mesh.size)
        handed = [
            None if t is None
            else ShardedRows(cpu_mesh, [s.cpu() for s in t.shards])
            if isinstance(t, ShardedRows) else t.cpu()
            for t in call["state"]
        ]
        asg, req, nzr, _, _ = solve_packed(
            call["pieces"], *handed, config=call["config"],
            mode=call["mode"], compress=call["compress"], device="cpu",
            mesh=cpu_mesh,
        )
        asg = asg.numpy()
        dev_asg = _to_host(p["assignments_dev"])
        if not np.array_equal(dev_asg, asg) or not all(
            np.array_equal(_to_host(got), _to_host(want))
            for got, want in zip(call["carry"], (req, nzr))
        ):
            raise AssertionError(
                f"a {call['mode']} solve differs from its CPU replay"
            )
        b = p["b"]
        for k in range(b):
            pod = p["solver_infos"][int(p["order"][k])].pod
            want[pod.metadata.name] = (
                p["names"][int(asg[k])] if asg[k] >= 0 else ""
            )
    return want


def check_row_constraints(row, pods):
    """The row's hard constraints on the final placements."""
    placed = [(p, p.spec.node_name) for p in pods if p.spec.node_name]

    def zone_of(node):  # node-{i} carries zone-{i % 10}
        return f"zone-{int(node.split('-')[1]) % 10}"

    name = row["name"]
    if name.startswith("PodAntiAffinity"):
        hosts = [n for p, n in placed if p.metadata.labels.get("color") == "red"]
        if len(hosts) != len(set(hosts)):
            raise AssertionError("two anti-affinity pods share a host")
    if name.startswith("PodTopologySpread"):
        per_zone = {f"zone-{z}": 0 for z in range(10)}
        for p, n in placed:
            if p.metadata.labels.get("app") == "spread":
                per_zone[zone_of(n)] += 1
        skew = max(per_zone.values()) - min(per_zone.values())
        if skew > 120:
            raise AssertionError(f"zone skew {skew} > 120")
    if name.startswith("PodAffinity"):
        base_zones = {
            zone_of(n) for p, n in placed
            if p.metadata.labels.get("peer") == "base"
            and not p.metadata.name.startswith("measure-")
        }
        for p, n in placed:
            if p.metadata.name.startswith("measure-") and (
                zone_of(n) not in base_zones
            ):
                raise AssertionError("an affinity pod sits in a zone without a peer")


def constrained_row(row, ck):
    from kubernetes_tpu_torch.api.types import ObjectMeta, Service
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.scheduler import batch as batch_mod
    from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod
    from kubernetes_tpu_torch.utils import metrics

    t_setup = time.perf_counter()
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    max_batch = row.get("max_batch", MAX_CONSTRAINED_BATCH)
    sched = new_scheduler(client, informers, batch=True, max_batch=max_batch)
    if sched.device.type != "cuda":
        raise AssertionError(f"the scheduler solves on {sched.device}")
    for i in range(N_NODES):
        client.create_node(
            make_node(f"node-{i}").capacity(cpu="32", memory="64Gi", pods=110)
            .label(ZONE_KEY, f"zone-{i % 10}").label(HOST_KEY, f"node-{i}")
            .obj()
        )
    for svc, selector in row.get("services", []):
        server.create(Service(
            metadata=ObjectMeta(name=svc, namespace="default"),
            selector=dict(selector),
        ))
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    init_constrained = row["init_labels"] is None
    init = [
        row_pod(make_pod, row, f"init-{i}",
                row["labels"] if init_constrained else row["init_labels"],
                init_constrained)
        for i in range(row["init_pods"])
    ]
    watch = BindWatcher(server, [p.metadata.name for p in init])
    for lo in range(0, len(init), 100):
        client.create_pods_bulk(init[lo:lo + 100])
    sched.start()
    if not watch.wait(300):
        raise AssertionError(f"{row['name']}: the init pods did not all bind")
    watch.stop()
    sched.wait_for_inflight_binds(timeout=60)
    setup_s = time.perf_counter() - t_setup

    # record every measured dispatch and every solve it made (pieces, the
    # device state handed in, the answer)
    dispatched, seen, calls = [], set(), []
    orig_dispatch = sched._dispatch_solve
    orig_solve = batch_mod.solve_packed
    recording_dispatch, recording_solve = solve_recorders(
        orig_dispatch, orig_solve, dispatched, seen, calls
    )
    sched._dispatch_solve = recording_dispatch
    batch_mod.solve_packed = recording_solve
    tiers0 = dict(sched.ladder.solves_by_tier)
    counters0 = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
    )
    stages0 = dict(sched.stage_seconds)
    measured = [
        row_pod(make_pod, row, f"measure-{i}", row["labels"], True)
        for i in range(MEASURED_PODS)
    ]
    names = [p.metadata.name for p in measured]
    watch = BindWatcher(server, names)
    create_times = {}
    ck.launches = 0  # the count of THIS row's measured run
    start = time.perf_counter()
    try:
        for lo in range(0, MEASURED_PODS, 100):
            chunk = measured[lo:lo + 100]
            now = time.perf_counter()
            for p in chunk:
                create_times[p.metadata.name] = now
            client.create_pods_bulk(chunk)
        completed = watch.wait(300)
        elapsed = time.perf_counter() - start
        launches = ck.launches
        sched.wait_for_inflight_binds(timeout=60)
    finally:
        watch.stop()
        sched._dispatch_solve = orig_dispatch
        batch_mod.solve_packed = orig_solve
    stages = {
        k: v - stages0.get(k, 0.0) for k, v in sched.stage_seconds.items()
    }
    tiers = {
        k: v - tiers0.get(k, 0) for k, v in sched.ladder.solves_by_tier.items()
    }
    moved = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
    )
    moved = {k: moved[k] - counters0[k] for k in moved}
    pods, _ = client.list_pods()
    placed = {p.metadata.name: p.spec.node_name for p in pods}
    sched.stop()
    informers.stop()

    bound = sum(1 for n in names if placed.get(n))
    if not completed or bound != MEASURED_PODS:
        raise AssertionError(f"{row['name']}: only {bound} pods bound")
    if set(k for k, v in tiers.items() if v) != {"cuda"}:
        raise AssertionError(f"{row['name']}: batches off the cuda tier: {tiers}")
    if launches < row.get("min_launches", 1):
        raise AssertionError(f"{row['name']}: K2 launched {launches} times")
    if any(moved.values()):
        raise AssertionError(f"{row['name']}: a fallback counter moved: {moved}")
    if any(p["tier"] != "cuda" for p in dispatched):
        raise AssertionError(f"{row['name']}: a dispatch solved off the card")
    check_row_constraints(row, pods)
    t_replay = time.perf_counter()
    want = replay_solves(calls, dispatched)
    replay_s = time.perf_counter() - t_replay
    mismatched = [n for n in names if want.get(n) != placed.get(n)]
    if mismatched:
        raise AssertionError(
            f"{row['name']}: {len(mismatched)} placements differ from the "
            f"replay, e.g. {mismatched[:3]}"
        )
    lat = sorted(watch.bind_times[n] - create_times[n] for n in names)
    rec = dict(
        row=row["name"], max_batch=max_batch, nodes=N_NODES,
        init_pods=row["init_pods"], pods=MEASURED_PODS, bound=bound,
        seconds=elapsed,
        pods_per_sec=MEASURED_PODS / elapsed,
        p50_create_to_bind_s=lat[len(lat) // 2],
        p99_create_to_bind_s=lat[min(len(lat) - 1, len(lat) * 99 // 100)],
        batches=len(dispatched), batch_sizes=[p["b"] for p in dispatched],
        modes=[c["mode"] for c in calls],
        solves_by_tier=tiers, constrained_kernel_launches=launches,
        counters_moved=moved, stage_seconds=stages, replay_equal=True,
        replay_seconds=replay_s, setup_seconds=setup_s,
    )
    emit("constrained_bursts", **rec)
    return rec


def constrained_bursts(ck):
    return [constrained_row(row, ck) for row in CONSTRAINED_ROWS]


# -- phase 7: the victim-search kernel vs its twin ----------------------------

# Preemption/5000's wave: 1,032 preemptors (32 warm + 1,000 measured) of
# 3 CPU / 6Gi at priority 100 (benchmarks/config/performance-config.yaml
# :305-312), here all in one wave over 5,000 nodes
PREEMPT_WAVE = 1032
GIB_KIB = 1 << 20


def preempt_problem(seed, n=N_NODES, v=16, r=4, b=PREEMPT_WAVE, pad=8,
                    classes=False, m=0, p=0):
    """A seeded wave at the main path's width: nodes of 32 CPU / 64Gi /
    110 pods holding v/2..v victims (the rest of the slots inactive, as
    a node short of pods leaves them) sorted priority-desc, full up to
    0-4 free CPUs; ``pad`` inactive pods after the wave. ``classes``:
    4 priorities x 3 request rows x 8 candidate rows in class runs, else
    one class. ``m`` pre-existing nominations, ``p`` PDBs (some at zero
    budget). Returns host arrays in preempt_batch_plain's order."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 32000
    alloc[:, 1] = 64 * GIB_KIB
    alloc[:, 3] = 110
    if r > 4:
        alloc[:, 4:] = rng.choice([0, 4, 8], (n, r - 4))
    count = rng.integers(v // 2, v + 1, n)
    active = np.arange(v)[None, :] < count[:, None]
    prio = np.sort(rng.choice([0, 0, 0, 5, 50], (n, v)), axis=1)[:, ::-1]
    prio = np.where(active, prio, -(1 << 31)).astype(np.int32)
    start = (rng.random((n, v)) * 1000).astype(np.float32)
    req = np.zeros((n, v, r), np.int32)
    req[:, :, 0] = rng.choice([1000, 2000, 3000], (n, v)) * 16 // v
    req[:, :, 1] = rng.choice([1, 2, 4], (n, v)) * GIB_KIB * 16 // v
    req[:, :, 3] = 1
    if r > 4:
        req[:, :, 4:] = rng.choice([0, 0, 1], (n, v, r - 4))
    req *= active[:, :, None]
    base = req.sum(axis=1).astype(np.int32)
    free = rng.choice([0, 1000, 2000, 4000], n, p=[0.3, 0.3, 0.38, 0.02])
    base[:, 0] = np.maximum(base[:, 0], 32000 - free)
    pdb_match = np.zeros((n, v, p), bool)
    pdb_allowed = np.zeros(p, np.int32)
    if p:
        pdb_match[:] = (rng.random((n, v, p)) < 0.4) & active[:, :, None]
        pdb_allowed[:] = rng.choice([0, 1, 3], p)
        # every victim below priority 10 is under a spent budget: a pod
        # of priority 10 can only take those, so some victims violate
        pdb_match[:, :, 0] = active & (prio < 10)
        pdb_allowed[0] = 0
    nom_req = np.zeros((m, r), np.int32)
    nom_req[:, 0] = 2000
    nom_req[:, 1] = 2 * GIB_KIB
    nom_req[:, 3] = 1
    nom_prio = rng.choice([10, 50, 80, 100, 120], m).astype(np.int32)
    nom_node = rng.integers(0, n, m).astype(np.int32)
    total = b + pad
    reqs = np.zeros((3, r), np.int32)
    reqs[:, 0] = [3000, 1000, 6000]
    reqs[:, 1] = np.array([6, 2, 8]) * GIB_KIB
    reqs[:, 3] = 1
    if r > 4:
        reqs[1, 4] = 1
    if classes:
        prio_k = rng.choice([100, 80, 50, 10], total)
        req_k = rng.integers(0, 3, total)
        row_k = rng.integers(0, 8, total)
        order = np.lexsort((row_k, req_k, -prio_k))
        prio_k, req_k, row_k = prio_k[order], req_k[order], row_k[order]
        rows = rng.random((8, n)) > 0.1
    else:
        prio_k = np.full(total, 100)
        req_k = np.zeros(total, np.int64)
        row_k = np.zeros(total, np.int64)
        rows = rng.random((1, n)) > 0.01
    pods_active = np.arange(total) < b
    return [
        alloc, base, prio, start, req, active, pdb_match, pdb_allowed,
        nom_req, nom_prio, nom_node, reqs[req_k], prio_k.astype(np.int32),
        rows, row_k.astype(np.int32), pods_active,
    ]


def k3_operations(host, chosen):
    """The operations this run's data needs, counted from K3's body
    (csrc/preempt_solve.cu): per class of active pods, the nomination
    fold (a node and a priority compare per nomination, R adds for each
    that lands) and every node's key build; per active pod, one compare
    per node for the minimum and the chosen node's key build. A node's
    key build: R adds for its nomination addend, 2 per victim slot to find
    the eligible ones, per eligible victim R subtractions to remove it,
    2P for its budgets and a reprieve fit (R adds, 3R+1 for the fit
    test), 3R+1 for the first fit, and 6 per victim slot for the key.
    Replays the carry with the kernel's own (checked) choices, in numpy."""
    (alloc, base, prio, _, req, active, pdb_match, _, _, nom_prio, _,
     pods_req, pods_prio, _, cand_index, pods_active) = host
    n, v = prio.shape
    r = alloc.shape[1]
    p = pdb_match.shape[2]

    def node_ops(elig):
        return r + 8 * v + elig * (r + 2 * p + 4 * r + 1) + 3 * r + 1

    ops = 0
    prev = None
    for t in np.flatnonzero(pods_active):
        cls = (int(pods_prio[t]), int(cand_index[t]), pods_req[t].tobytes())
        elig = (active & (prio < pods_prio[t])).sum(axis=1)
        if cls != prev:
            landed = int((nom_prio >= pods_prio[t]).sum())
            ops += 2 * len(nom_prio) + r * landed + int(node_ops(elig).sum())
            prev = cls
        ops += 2 * n
        if chosen[t] >= 0:
            ops += int(node_ops(elig[chosen[t]]))
    return ops


def preempt_kernel_vs_twin(pk, pre_mod):
    cases = [
        ("preemption5000_wave", dict(seed=0)),
        ("classes_nominations", dict(seed=1, b=512, classes=True, m=64)),
        ("pdbs", dict(seed=2, b=512, classes=True, p=4)),
        ("v48_scalar_r6", dict(seed=3, b=512, v=48, r=6, classes=True)),
        # 40,000 nodes at V=16: above what 16 CTAs hold in shared memory
        ("above_resident_gate", dict(seed=4, n=40000, b=128, classes=True,
                                     m=64, p=2)),
    ]
    timing = None
    max_err = 0.0
    for name, kw in cases:
        host = preempt_problem(**kw)
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in host]
        torch.cuda.synchronize()
        k_out = pk.preempt_solve_cuda(*dev)  # warm launch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_out = pre_mod.preempt_batch_plain(*dev)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        names = ("chosen", "victims", "violating", "num_violating", "state")
        equal = {nm: bool(torch.equal(k, q))
                 for nm, k, q in zip(names, k_out, p_out)}
        err = max(
            float((k.to(torch.int64) - q.to(torch.int64)).abs().max())
            if k.numel() else 0.0
            for k, q in zip(k_out, p_out)
        )
        max_err = max(max_err, err)
        reps = 5
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            pk.preempt_solve_cuda(*dev)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        chosen = k_out[0].cpu().numpy()
        ops = k3_operations(host, chosen)
        n_bytes = sum(a.nbytes for a in host) + sum(
            t.numel() * t.element_size() for t in k_out
        )
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        # integer operations issue at no more than the unfused fp32 rate
        ops_ms = ops / PEAK_UNFUSED_OPS_PER_S * 1e3
        n, v = host[2].shape
        rec = dict(
            case=name, n=n, v=v, r=host[0].shape[1], p=host[6].shape[2],
            m=host[9].shape[0], b=len(host[12]), u=host[13].shape[0],
            active=int(host[15].sum()), equal=equal, max_abs_err=err,
            placed=int((chosen >= 0).sum()),
            victims=int(pre_mod.unpack_bits(
                k_out[1].cpu().numpy(), v).sum()),
            violating=int(k_out[3].sum()),
            ms=ms, plain_ms=plain_ms, ops=ops, bytes=n_bytes,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms > ops_ms else "operations",
            **plan_record(pk, int(host[15].sum()), ms),
        )
        emit("preempt_kernel_vs_twin", **rec)
        if not all(equal.values()):
            raise AssertionError(f"K3 disagrees with its twin on {name}")
        if rec["cluster"] < 2:
            raise AssertionError(f"{name} launched a cluster of one CTA")
        if rec["placed"] == 0:
            raise AssertionError(f"{name}: the wave placed no preemptor")
        if name == "preemption5000_wave":
            timing = rec
    return timing, max_err


# -- phase 8: the preemption burst --------------------------------------------

PREEMPT_NODES = 5000
PREEMPT_FILL = 50000      # init_pods: 3 CPU / 6Gi at priority 0
PREEMPT_WARM = 32         # init_preempt
PREEMPT_MEASURED = 1000   # measure_pods: 3 CPU / 6Gi at priority 100


def preemption_burst(pk, gk):
    """Preemption/5000 as benchmarks/runner.py:1040-1066 builds it, on a
    fresh stack through the port's entry points."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.ops import preemption as pre_mod
    from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod
    from kubernetes_tpu_torch.utils import metrics

    def pods(prefix, count, priority):
        return [
            make_pod(f"{prefix}-{i}").container(cpu="3000m", memory="6Gi")
            .priority(priority).obj()
            for i in range(count)
        ]

    def create(batch):
        for lo in range(0, len(batch), 1000):
            client.create_pods_bulk(batch[lo:lo + 1000])

    t_setup = time.perf_counter()
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=MAX_CONSTRAINED_BATCH,
    )
    if sched.device.type != "cuda" or sched.preemptor.device.type != "cuda":
        raise AssertionError("the scheduler or its preemptor is off the card")
    for i in range(PREEMPT_NODES):
        client.create_node(
            make_node(f"node-{i}").capacity(cpu="32", memory="64Gi", pods=110)
            .label(ZONE_KEY, f"zone-{i % 10}").label(HOST_KEY, f"node-{i}")
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    fill = pods("init", PREEMPT_FILL, 0)
    watch = BindWatcher(server, [p.metadata.name for p in fill])
    create(fill)
    sched.start()
    if not watch.wait(600):
        raise AssertionError("the fill pods did not all bind")
    watch.stop()
    sched.wait_for_inflight_binds(timeout=60)
    fill_s = time.perf_counter() - t_setup

    # record every K3 call (its operands and answer), every nomination's
    # victims, the pack builds and the waves
    calls, applied, packs, waves = [], [], [], []
    preemptor = sched.preemptor
    orig_solve = pk.preempt_solve
    orig_pack = pre_mod.pack_preemption_state
    orig_apply = preemptor._apply_preemption
    orig_wave = preemptor.preempt_batch

    def recording_solve(*args):
        out = orig_solve(*args)
        calls.append((args, out))
        return out

    def timed_pack(*args, **kw):
        t0 = time.perf_counter()
        out = orig_pack(*args, **kw)
        packs.append(time.perf_counter() - t0)
        return out

    def recording_apply(prof, pod, node_name, victims, **kw):
        applied.append((pod.metadata.name, node_name,
                        [v.spec.priority for v in victims]))
        return orig_apply(prof, pod, node_name, victims, **kw)

    def timed_wave(prof, items):
        t0 = time.perf_counter()
        out = orig_wave(prof, items)
        waves.append((len(items), time.perf_counter() - t0))
        return out

    pk.preempt_solve = recording_solve
    pre_mod.pack_preemption_state = timed_pack
    preemptor._apply_preemption = recording_apply
    preemptor.preempt_batch = timed_wave
    try:
        warm = pods("warmpre", PREEMPT_WARM, 100)
        watch = BindWatcher(server, [p.metadata.name for p in warm])
        create(warm)
        if not watch.wait(300):
            raise AssertionError("the warm preemptors did not all bind")
        watch.stop()
        sched.wait_for_inflight_binds(timeout=60)
        warm_waves = len(waves)
        setup_s = time.perf_counter() - t_setup

        tiers0 = dict(preemptor.ladder.solves_by_tier)
        counters0 = dict(
            fallbacks=counter_total(metrics.solver_fallbacks),
            retries=counter_total(metrics.solve_retries),
            pods_fallback=sched.pods_fallback,
            envelope_fallbacks=sched.envelope_fallbacks,
            host_preemptions=preemptor.host_preemptions,
        )
        stages0 = dict(sched.stage_seconds)
        measured = pods("measure", PREEMPT_MEASURED, 100)
        names = [p.metadata.name for p in measured]
        watch = BindWatcher(server, names)
        create_times = {}
        pk.launches = 0  # the counts of THIS run of the main path
        gk.launches = 0
        start = time.perf_counter()
        for lo in range(0, PREEMPT_MEASURED, 100):
            chunk = measured[lo:lo + 100]
            now = time.perf_counter()
            for p in chunk:
                create_times[p.metadata.name] = now
            client.create_pods_bulk(chunk)
        completed = watch.wait(600)
        elapsed = time.perf_counter() - start
        launches, k1_launches = pk.launches, gk.launches
        sched.wait_for_inflight_binds(timeout=60)
        watch.stop()
    finally:
        pk.preempt_solve = orig_solve
        pre_mod.pack_preemption_state = orig_pack
        preemptor._apply_preemption = orig_apply
        preemptor.preempt_batch = orig_wave
    stages = {
        k: v - stages0.get(k, 0.0) for k, v in sched.stage_seconds.items()
    }
    tiers = {
        k: v - tiers0.get(k, 0)
        for k, v in preemptor.ladder.solves_by_tier.items()
    }
    moved = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
        host_preemptions=preemptor.host_preemptions,
    )
    moved = {k: moved[k] - counters0[k] for k in moved}
    listed, _ = client.list_pods()
    placed = {p.metadata.name: p.spec.node_name for p in listed}
    victims_by_tier = dict(preemptor.victims_by_tier)
    sched.stop()
    informers.stop()

    preemptors = [p.metadata.name for p in warm] + names
    bound = sum(1 for nm in preemptors if placed.get(nm))
    if not completed or bound != len(preemptors):
        raise AssertionError(f"only {bound}/{len(preemptors)} preemptors bound")
    per_node = {}
    for node in placed.values():
        if node:
            per_node[node] = per_node.get(node, 0) + 1
    if max(per_node.values()) > 10:  # 10 pods of 3 CPU fill a 32-CPU node
        raise AssertionError("a node holds more than 10 pods of 3 CPU")
    evicted = [f"init-{i}" for i in range(PREEMPT_FILL)
               if f"init-{i}" not in placed]
    # a preemptor may be nominated again (its retry raced the eviction
    # into the cache): the node it holds then needs no further victim
    victims_of = {nm: [] for nm in preemptors}
    for nm, _, prios in applied:
        victims_of.setdefault(nm, []).extend(prios)
    taken = sorted({len(v) for v in victims_of.values()})
    prios = sorted({p for v in victims_of.values() for p in v})
    renominated = len(applied) - len({nm for nm, _, _ in applied})
    if (set(victims_of) != set(preemptors) or taken != [1] or prios != [0]
            or len(evicted) != len(preemptors)):
        raise AssertionError(
            f"victims per preemptor {taken} of priorities {prios}, "
            f"{len(applied)} nominations ({renominated} again), "
            f"{len(evicted)} pods evicted for {len(preemptors)} preemptors"
        )
    if set(k for k, v in tiers.items() if v) != {"cuda"}:
        raise AssertionError(f"waves off the cuda tier: {tiers}")
    if set(victims_by_tier) != {"cuda"}:
        raise AssertionError(f"victims booked off the cuda tier: {victims_by_tier}")
    if launches <= 0 or k1_launches <= 0:
        raise AssertionError(
            f"the measured run launched K3 {launches} and K1 "
            f"{k1_launches} times"
        )
    if preemptor.host_preemptions:
        raise AssertionError("a preemption took the host oracle")
    if any(moved.values()):
        raise AssertionError(f"a fallback counter moved: {moved}")

    # every recorded wave against a CPU replay of its pack and pods
    t_replay = time.perf_counter()
    for args, out in calls:
        want = pre_mod.preempt_batch_plain(*(a.cpu() for a in args))
        if not all(torch.equal(o.cpu(), w) for o, w in zip(out, want)):
            raise AssertionError("a wave's K3 answer differs from its replay")
    replay_s = time.perf_counter() - t_replay
    lat = sorted(watch.bind_times[nm] - create_times[nm] for nm in names)
    measured_waves = waves[warm_waves:]
    rec = dict(
        workload="Preemption/5000", nodes=PREEMPT_NODES, fill=PREEMPT_FILL,
        warm=PREEMPT_WARM, pods=PREEMPT_MEASURED, bound=bound,
        seconds=elapsed, pods_per_sec=PREEMPT_MEASURED / elapsed,
        p50_create_to_bind_s=lat[len(lat) // 2],
        p99_create_to_bind_s=lat[min(len(lat) - 1, len(lat) * 99 // 100)],
        waves=len(measured_waves),
        wave_sizes=[sz for sz, _ in measured_waves],
        wave_seconds=[s for _, s in measured_waves],
        warm_waves=warm_waves, k3_calls=len(calls),
        k3_call_sizes=[int(a[11].shape[0]) for a, _ in calls],
        preempt_kernel_launches=launches, greedy_kernel_launches=k1_launches,
        victims=len(evicted), victims_by_tier=victims_by_tier,
        nominations=len(applied), renominations=renominated,
        pack_seconds=packs, solves_by_tier=tiers, counters_moved=moved,
        stage_seconds=stages, replay_equal=True, replay_seconds=replay_s,
        fill_seconds=fill_s, setup_seconds=setup_s,
    )
    emit("preemption_burst", **rec)
    return rec


# -- phase 8: the mixed workload on the mesh ----------------------------------

def pump(sched, client, want, prefix="", seconds=60.0):
    """Drive schedule_batch until ``want`` pods whose names start with
    ``prefix`` are bound (preempted pods re-enter through backoff)."""
    deadline = time.time() + seconds
    bound = 0
    while time.time() < deadline:
        sched.schedule_batch(timeout=0.5)
        pods, _ = client.list_pods()
        bound = sum(1 for p in pods
                    if p.spec.node_name and p.metadata.name.startswith(prefix))
        if bound >= want:
            break
    return bound


def mesh_mixed(mesh, gk, ck, pk, sk):
    """__graft_entry__.dryrun_multichip parts 1 and 1b (:87-220) on a mesh
    on the card, through the entry points: (1) 128 nodes per shard with
    zone labels, 48 plain pods, 8 hard-spread, 4 anti-affinity, 4
    preferred-affinity and a 4-pod gang (68 pods, max_batch 64); every
    solve is replayed on a CPU mesh of as many shards; (1b) 16 nodes per
    shard filled with priority-0 pods, which must all bind through K4,
    then a high-priority burst that must preempt through K3 on the
    mesh's first device."""
    from kubernetes_tpu_torch.api.types import (
        ObjectMeta, POD_GROUP_LABEL, PodGroup,
    )
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.scheduler import batch as batch_mod
    from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    p_dev = mesh.size
    t0 = time.perf_counter()
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=64,
                          mesh=mesh, async_binding=False)
    n_nodes = 128 * p_dev
    for i in range(n_nodes):
        client.create_node(
            make_node(f"n{i}").labels(zone=f"z{i % 4}")
            .capacity(cpu="16", memory="32Gi", pods=40).obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    dispatched, seen, calls = [], set(), []
    orig_dispatch, orig_solve = sched._dispatch_solve, batch_mod.solve_packed
    sched._dispatch_solve, batch_mod.solve_packed = solve_recorders(
        orig_dispatch, orig_solve, dispatched, seen, calls
    )
    launches0 = dict(k1=gk.launches, k2=ck.launches, k4=sk.launches)
    try:
        for i in range(48):
            client.create_pod(
                make_pod(f"p{i}").container(cpu="250m", memory="256Mi").obj())
        for i in range(8):
            client.create_pod(
                make_pod(f"sp{i}").labels(app="web")
                .container(cpu="100m", memory="128Mi")
                .spread_constraint(1, "zone", match_labels={"app": "web"}).obj())
        for i in range(4):
            client.create_pod(
                make_pod(f"db{i}").labels(app="db")
                .container(cpu="100m", memory="128Mi")
                .pod_affinity("zone", {"app": "db"}, anti=True).obj())
        for i in range(4):
            client.create_pod(
                make_pod(f"pref{i}").labels(app="web")
                .container(cpu="100m", memory="128Mi")
                .preferred_pod_affinity("zone", {"app": "db"}, weight=5).obj())
        client.create_pod_group(PodGroup(
            metadata=ObjectMeta(name="gang", namespace="default"), min_member=4,
        ))
        for i in range(4):
            gp = make_pod(f"gang{i}").container(cpu="100m", memory="128Mi").obj()
            gp.metadata.labels[POD_GROUP_LABEL] = "gang"
            client.create_pod(gp)
        time.sleep(0.2)
        bound = pump(sched, client, 68, seconds=120)
    finally:
        sched._dispatch_solve, batch_mod.solve_packed = orig_dispatch, orig_solve
    pods, _ = client.list_pods()
    placed = {p.metadata.name: p.spec.node_name for p in pods}
    tiers = dict(sched.ladder.solves_by_tier)
    part1_launches = dict(
        k1=gk.launches - launches0["k1"], k2=ck.launches - launches0["k2"],
        k4=sk.launches - launches0["k4"],
    )
    fallback1 = sched.pods_fallback
    sched.stop()
    informers.stop()
    gang = sum(1 for n, v in placed.items() if v and n.startswith("gang"))
    if bound != 68 or gang != 4 or fallback1:
        raise AssertionError(
            f"mesh_mixed part 1: {bound}/68 bound, gang {gang}/4, "
            f"{fallback1} fallback pods"
        )
    modes = [c["mode"] for c in calls]
    on_card = mesh.first.type == "cuda"  # the CPU is for rehearsal
    tier = "cuda" if on_card else "torch"
    if "constrained" not in modes or (on_card and part1_launches["k2"] <= 0):
        raise AssertionError(f"no constrained solve launched K2: {modes}")
    if set(k for k, v in tiers.items() if v) != {tier}:
        raise AssertionError(f"mesh_mixed solved off the {tier} tier: {tiers}")
    if part1_launches["k1"]:
        raise AssertionError("K1 launched on the mesh")
    t_replay = time.perf_counter()
    want = replay_solves(calls, dispatched)
    replay_s = time.perf_counter() - t_replay
    differ = [n for n, v in want.items() if placed.get(n) != v]
    if differ:
        raise AssertionError(f"mesh placements differ from the replay: {differ[:3]}")
    part1_s = time.perf_counter() - t0

    # 1b: preemption on the mesh
    t1 = time.perf_counter()
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=64,
                          mesh=mesh, async_binding=False)
    if sched.preemptor.device != mesh.first:
        raise AssertionError(f"the preemptor runs on {sched.preemptor.device}")
    n_small = 16 * p_dev
    for i in range(n_small):
        client.create_node(
            make_node(f"pn{i}").capacity(cpu="8", memory="16Gi", pods=10).obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    for i in range(n_small * 2):
        client.create_pod(
            make_pod(f"fill{i}").container(cpu="3500m", memory="2Gi")
            .priority(0).obj())
    time.sleep(0.2)
    k4_before = sk.launches
    fill_bound = pump(sched, client, n_small * 2, prefix="fill", seconds=60)
    k4_fill = sk.launches - k4_before
    if fill_bound != n_small * 2 or (on_card and k4_fill <= 0):
        raise AssertionError(
            f"mesh fill bound {fill_bound}/{n_small * 2} with {k4_fill} K4 "
            f"launches"
        )
    k3_before = pk.launches
    hi = [make_pod(f"hi{i}").container(cpu="4", memory="1Gi").priority(100).obj()
          for i in range(2 * p_dev)]
    for hp in hi:
        client.create_pod(hp)
    time.sleep(0.2)
    hi_bound = pump(sched, client, len(hi), prefix="hi", seconds=60)
    k3 = pk.launches - k3_before
    preemptions = sched.preemptor.device_preemptions
    host_preemptions = sched.preemptor.host_preemptions
    tiers_b = dict(sched.ladder.solves_by_tier)
    sched.stop()
    informers.stop()
    if (hi_bound != len(hi) or preemptions <= 0 or (on_card and k3 <= 0)
            or host_preemptions):
        raise AssertionError(
            f"mesh preemption bound {hi_bound}/{len(hi)} with {preemptions} "
            f"device preemptions, {k3} K3 launches, {host_preemptions} on "
            f"the host"
        )
    # 1c: sinkhorn mode on the mesh (the prior and K1's scored entry on
    # the state gathered onto the first device), against one device
    t2 = time.perf_counter()
    sk_mesh = sinkhorn_part_1c(gk, n_nodes, mesh)
    sk_one = sinkhorn_part_1c(gk, n_nodes, None, device=mesh.first)
    if (sk_mesh["bound"] != 32 or sk_one["bound"] != 32
            or sk_mesh["placed"] != sk_one["placed"]
            or sk_mesh["pods_fallback"] or sk_one["pods_fallback"]
            or sk_mesh["tiers"] != {tier} or sk_one["tiers"] != {tier}
            or (on_card and (sk_mesh["scored"] <= 0 or sk_mesh["greedy"]))):
        raise AssertionError(
            f"mesh_mixed part 1c: {sk_mesh['bound']}/32 bound on the mesh, "
            f"{sk_one['bound']}/32 on one device, placements equal "
            f"{sk_mesh['placed'] == sk_one['placed']}, tiers "
            f"{sk_mesh['tiers']}, {sk_mesh['scored']} scored and "
            f"{sk_mesh['greedy']} greedy launches"
        )
    rec = dict(
        mesh=[str(d) for d in mesh.devices], nodes=n_nodes, bound=bound,
        gang_bound=gang, solves=len(calls), modes=modes,
        batch_sizes=[p["b"] for p in dispatched], launches=part1_launches,
        solves_by_tier=tiers, replay_equal=True, replay_seconds=replay_s,
        part1_seconds=part1_s, preempt_nodes=n_small, fill_bound=fill_bound,
        fill_shard_kernel_launches=k4_fill, hi_bound=hi_bound,
        device_preemptions=preemptions, preempt_kernel_launches=k3,
        preempt_solves_by_tier=tiers_b,
        part1b_seconds=t2 - t1,
        sinkhorn_bound=sk_mesh["bound"], sinkhorn_equal_one_device=True,
        sinkhorn_scored_launches=sk_mesh["scored"],
        part1c_seconds=time.perf_counter() - t2,
    )
    emit("mesh_mixed", **rec)
    return rec


def sinkhorn_part_1c(gk, n_nodes, mesh, device=None):
    """__graft_entry__.dryrun_multichip part 1c (:326-356): 32 pods of
    500m/512Mi in sinkhorn mode, max_batch 64, on ``mesh`` or on one
    ``device``; the pods are all queued before the first pop, so both runs
    solve the same batch."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=64,
                          mesh=mesh, device=device, async_binding=False,
                          solver_mode="sinkhorn")
    for i in range(n_nodes):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="16", memory="32Gi", pods=40).obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    scored0, greedy0 = gk.scored_launches, gk.launches
    for i in range(32):
        client.create_pod(
            make_pod(f"sk{i}").container(cpu="500m", memory="512Mi").obj())
    deadline = time.time() + 30
    while sched.queue.active_count() < 32 and time.time() < deadline:
        time.sleep(0.01)
    bound = pump(sched, client, 32, prefix="sk", seconds=60)
    pods, _ = client.list_pods()
    out = dict(
        bound=bound, placed={p.metadata.name: p.spec.node_name for p in pods},
        scored=gk.scored_launches - scored0, greedy=gk.launches - greedy0,
        tiers={k for k, v in sched.ladder.solves_by_tier.items() if v},
        pods_fallback=sched.pods_fallback,
    )
    sched.stop()
    informers.stop()
    return out


# -- phase 5: the burst -------------------------------------------------------

class BindWatcher:
    """Bind wall time per pod from the apiserver's watch stream."""

    def __init__(self, server, names):
        self._watch = server.watch("Pod", since_rv=server.current_rv())
        self.bind_times = {}
        self._targets = set(names)
        self._outstanding = len(self._targets)
        self._cond = threading.Condition()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            evs = self._watch.next_batch(timeout=0.2)
            if not evs:
                continue
            now = time.perf_counter()
            with self._cond:
                for ev in evs:
                    pod = ev.object
                    if ev.type != "MODIFIED" or not pod.spec.node_name:
                        continue
                    name = pod.metadata.name
                    if name not in self.bind_times:
                        self.bind_times[name] = now
                        if name in self._targets:
                            self._outstanding -= 1
                if self._outstanding <= 0:
                    self._cond.notify_all()

    def wait(self, timeout):
        deadline = time.time() + timeout
        with self._cond:
            while self._outstanding > 0:
                left = deadline - time.time()
                if left <= 0:
                    return False
                self._cond.wait(min(left, 0.5))
            return True

    def stop(self):
        self._stop = True
        self._watch.stop()
        self._thread.join(timeout=2)


def burst(gk, device=None, mesh=None, sk=None):
    """SchedulingBasic through the entry points (the ``burst`` phase); with
    ``mesh`` (a NodeMesh) and ``sk`` (the K4 module) the ``mesh_burst``
    phase: the same burst on the node-sharded tier, where every measured
    batch is one K4 launch and K1 never launches."""
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.robustness.ladder import host_greedy_assign
    from kubernetes_tpu_torch.scheduler.batch import _to_host
    from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod
    from kubernetes_tpu_torch.utils import metrics

    t_setup = time.perf_counter()
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=MAX_BATCH, device=device,
        mesh=mesh,
    )
    want_dev = mesh.first.type if mesh is not None else (
        "cuda" if device is None else device
    )
    tier = "cuda" if want_dev == "cuda" else "torch"  # the CPU is for rehearsal
    if sched.device.type != want_dev:
        raise AssertionError(f"the scheduler solves on {sched.device}")
    for i in range(N_NODES):
        client.create_node(
            make_node(f"node-{i}")
            .capacity(cpu="32", memory="64Gi", pods=110)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    warm = [
        make_pod(f"warm-{i}").container(cpu="100m", memory="128Mi").obj()
        for i in range(MAX_BATCH)
    ]
    watch = BindWatcher(server, [p.metadata.name for p in warm])
    for p in warm:
        client.create_pod(p)
    sched.start()
    if not watch.wait(600):
        raise AssertionError("the warm pods did not all bind")
    watch.stop()
    sched.wait_for_inflight_binds(timeout=60)
    setup_s = time.perf_counter() - t_setup

    # record every burst dispatch (its pending record holds the solve
    # order, the packed pod rows and the device assignments)
    dispatched = []
    seen = set()
    orig_dispatch = sched._dispatch_solve

    def recording_dispatch(*args, **kwargs):
        p = orig_dispatch(*args, **kwargs)
        if p is not None and id(p) not in seen:
            seen.add(id(p))
            dispatched.append(p)
        return p

    sched._dispatch_solve = recording_dispatch

    # the post-warmup cluster state, from the host shadow -- which must
    # equal the resident device carry with nothing in flight
    ds = sched._dev
    with sched._shadow_lock:
        alloc0 = ds.alloc_shadow.copy()
        valid0 = ds.valid_shadow.copy()
        req0 = ds.req_shadow.copy()
        nzr0 = ds.nzr_shadow.copy()
        carry = (ds.req_dev, ds.nzr_dev)
    if carry[0] is not None and not (
        np.array_equal(_to_host(carry[0]).astype(np.int32), req0)
        and np.array_equal(_to_host(carry[1]).astype(np.int32), nzr0)
    ):
        raise AssertionError("the resident carry differs from the shadow")

    tiers0 = dict(sched.ladder.solves_by_tier)
    counters0 = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
        carry_divergences=sched.carry_divergences,
    )
    stages0 = dict(sched.stage_seconds)
    burst_pods = [
        make_pod(f"burst-{i}").container(cpu="250m", memory="512Mi").obj()
        for i in range(N_PODS)
    ]
    names = [p.metadata.name for p in burst_pods]
    watch = BindWatcher(server, names)
    create_times = {}
    gk.launches = 0  # the counts of THIS run of the main path
    if sk is not None:
        sk.launches = 0
        k4_builds = sk.builds
    start = time.perf_counter()
    for lo in range(0, N_PODS, 256):
        chunk = burst_pods[lo:lo + 256]
        now = time.perf_counter()
        for p in chunk:
            create_times[p.metadata.name] = now
        client.create_pods_bulk(chunk)
    completed = watch.wait(600)
    elapsed = time.perf_counter() - start
    launches = gk.launches
    k4_launches = sk.launches if sk is not None else 0
    sched.wait_for_inflight_binds(timeout=60)
    watch.stop()
    sched._dispatch_solve = orig_dispatch
    stages = {
        k: v - stages0.get(k, 0.0) for k, v in sched.stage_seconds.items()
    }
    tiers = {
        k: v - tiers0.get(k, 0) for k, v in sched.ladder.solves_by_tier.items()
    }
    counters = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
        carry_divergences=sched.carry_divergences,
    )
    moved = {k: counters[k] - counters0[k] for k in counters}

    pods, _ = client.list_pods()
    placed = {p.metadata.name: p.spec.node_name for p in pods}
    sched.stop()
    informers.stop()

    bound = sum(1 for n in names if placed.get(n))
    if not completed or bound != N_PODS:
        raise AssertionError(f"only {bound}/{N_PODS} burst pods bound")
    # capacity: warm pods 100m/128Mi, burst pods 250m/512Mi, 110 pods
    per_node = {}
    for name, node in placed.items():
        if not node:
            continue
        w, b = per_node.get(node, (0, 0))
        per_node[node] = (w + 1, b) if name.startswith("warm-") else (w, b + 1)
    for node, (w, b) in per_node.items():
        if 100 * w + 250 * b > 32000 or 128 * w + 512 * b > 65536 or w + b > 110:
            raise AssertionError(f"node {node} over capacity: {w} + {b} pods")
    if set(k for k, v in tiers.items() if v) != {tier}:
        raise AssertionError(f"burst batches off the {tier} tier: {tiers}")
    if mesh is None and tier == "cuda" and launches <= 0:
        raise AssertionError("the burst never launched the greedy kernel")
    if any(v for k, v in moved.items() if k != "carry_divergences"):
        raise AssertionError(f"a fallback counter moved: {moved}")
    if any(p["tier"] != tier for p in dispatched):
        raise AssertionError("a burst dispatch was solved off the card")
    if mesh is not None:
        # one device holds every shard: ONE K4 launch per greedy batch
        if tier == "cuda" and (k4_launches != len(dispatched) or launches != 0):
            raise AssertionError(
                f"the mesh burst launched K4 {k4_launches} times for "
                f"{len(dispatched)} batches and K1 {launches} times"
            )
        if sched.mesh_solver_tier != tier:
            raise AssertionError(f"the mesh solved on {sched.mesh_solver_tier!r}")
        if sched.state_uploads > 1 or moved["carry_divergences"]:
            raise AssertionError(
                f"{sched.state_uploads} full uploads and "
                f"{moved['carry_divergences']} divergences on the mesh"
            )
        if sk.builds != k4_builds:
            raise AssertionError("K4 was built again during the burst")

    # host replay: the burst's batches in solve order through the numpy
    # host greedy, from the post-warmup state
    t_replay = time.perf_counter()
    req_s, nzr_s = req0.astype(np.int32), nzr0.astype(np.int32)
    want = {}
    for p in dispatched:
        b = p["b"]
        padded = p["req"].shape[0]
        active = np.zeros(padded, bool)
        active[:b] = True
        asg, req_s, nzr_s = host_greedy_assign(
            alloc0, req_s, nzr_s, valid0, p["req"], p["nzr"],
            p["mask_rows"], p["mask_index_solved"], active,
            config=sched.solver_config,
        )
        dev_asg = _to_host(p["assignments_dev"])[:b]
        if not np.array_equal(dev_asg, asg[:b]):
            raise AssertionError("device assignments differ from the replay")
        for k in range(b):
            pod = p["solver_infos"][int(p["order"][k])].pod
            want[pod.metadata.name] = (
                p["names"][int(asg[k])] if asg[k] >= 0 else ""
            )
    replay_s = time.perf_counter() - t_replay
    mismatched = [n for n in names if want.get(n) != placed.get(n)]
    if mismatched:
        raise AssertionError(
            f"{len(mismatched)} placements differ from the host replay, "
            f"e.g. {mismatched[:3]}"
        )
    lat = sorted(watch.bind_times[n] - create_times[n] for n in names)
    rec = dict(
        nodes=N_NODES, pods=N_PODS, bound=bound, seconds=elapsed,
        pods_per_sec=N_PODS / elapsed,
        p50_pod_to_bind_s=lat[len(lat) // 2],
        p99_pod_to_bind_s=lat[min(len(lat) - 1, len(lat) * 99 // 100)],
        batches=len(dispatched), batch_sizes=[p["b"] for p in dispatched],
        solves_by_tier=tiers,
        greedy_kernel_launches=launches, counters_moved=moved,
        stage_seconds=stages, replay_equal=True, replay_seconds=replay_s,
        setup_seconds=setup_s,
    )
    if mesh is None:
        emit("burst", **rec)
        return rec
    rec.update(
        mesh=[str(d) for d in mesh.devices],
        n_loc=[hi - lo for lo, hi in mesh.bounds(int(alloc0.shape[0]))],
        shard_kernel_launches=k4_launches, state_uploads=sched.state_uploads,
        shard_kernel_builds=sk.builds,
    )
    emit("mesh_burst", **rec)
    return rec


# -- phases 11-12: churn in sinkhorn mode with hollow kubelets ----------------

# benchmarks/config/performance-config.yaml:480-488 (ChurnSinkhorn/50000)
# and :268-277 (RebalanceSinkhorn/500), with the defaults of :9-15 (32
# CPU, 64Gi, 110 pods, 10 zones, max_batch 1,024), as
# benchmarks/runner.py:1269-1296 runs the churn rounds
CHURN_WORKLOADS = {
    "ChurnSinkhorn/50000": dict(
        nodes=50000, init=100000, measured=10000, rounds=5, delete=2000,
        cpu=100, memory_mi=128, replay_init_every=4,
    ),
    "RebalanceSinkhorn/500": dict(
        nodes=500, init=6000, measured=2000, rounds=4, delete=500,
        cpu=2000, memory_mi=2048, replay_init_every=1,
    ),
}


def churn_sinkhorn(gk, asg_mod, workload, device=None):
    """A churn workload of the perf matrix in sinkhorn mode through the
    port's entry points on the card, with ``HollowNodePool`` acking every
    bind: the nodes, the init pods, then the measured pods in rounds, each
    round first deleting bound pods (listed once, in list order, as the
    runner does) and waiting for its own pods to bind. Every sinkhorn
    batch's prior is timed on the card by CUDA events and its K1 scored
    launch recorded; afterwards the recorded launches (every measured
    one and every ``replay_init_every``-th init one) are replayed through
    ``sinkhorn_commit`` on the card on their own prior and must be equal.
    ``device="cpu"`` rehearses the phase on the CPU (every commit is then
    the plain loop)."""
    from kubernetes_tpu_torch.api.types import POD_RUNNING
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.kubelet import HollowNodePool
    from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod
    from kubernetes_tpu_torch.utils import metrics

    spec = CHURN_WORKLOADS[workload]
    n_nodes = spec["nodes"]
    cpu, mem = spec["cpu"], spec["memory_mi"]

    def pods(prefix, count):
        return [
            make_pod(f"{prefix}-{i}")
            .container(cpu=f"{cpu}m", memory=f"{mem}Mi").obj()
            for i in range(count)
        ]

    t_setup = time.perf_counter()
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True,
                          max_batch=MAX_CONSTRAINED_BATCH,
                          solver_mode="sinkhorn", device=device)
    on_card = device is None
    tier = "cuda" if on_card else "torch"  # the CPU is for rehearsal
    if (sched.device.type == "cuda") != on_card:
        raise AssertionError(f"the scheduler solves on {sched.device}")
    names = [f"node-{i}" for i in range(n_nodes)]
    for i, name in enumerate(names):
        client.create_node(
            make_node(name).capacity(cpu="32", memory="64Gi", pods=110)
            .label(ZONE_KEY, f"zone-{i % 10}").obj()
        )
    hollow = HollowNodePool(client, names)
    hollow.start()
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()

    # time every prior, record every scored solve, count plain commits
    orig_prior, orig_solve = asg_mod.sinkhorn_prior, gk.greedy_solve
    orig_commit = gk.greedy_assign_compact
    plan_events, k_events, records = [], [], []
    state = dict(keep=spec["replay_init_every"], scored=0, plain=0)

    def events():
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def timed_prior(*args, **kw):
        start, end = events()
        start.record()
        out = orig_prior(*args, **kw)
        end.record()
        plan_events.append((start, end))
        return out

    def recording_solve(*args, config, prior=None):
        if prior is None:
            return orig_solve(*args, config=config)
        start, end = events()
        start.record()
        out = orig_solve(*args, config=config, prior=prior)
        end.record()
        k_events.append((start, end))
        state["scored"] += 1
        if (state["scored"] - 1) % state["keep"] == 0:
            records.append((args, prior, config, out))
        return out

    def counting_commit(*args, **kw):
        state["plain"] += 1
        return orig_commit(*args, **kw)

    dispatched = []
    orig_dispatch = sched._dispatch_solve

    def recording_dispatch(*args, **kw):
        p = orig_dispatch(*args, **kw)
        if p is not None and all(p is not q for q in dispatched):
            dispatched.append(p)
        return p

    asg_mod.sinkhorn_prior = timed_prior
    gk.greedy_solve = recording_solve
    gk.greedy_assign_compact = counting_commit
    sched._dispatch_solve = recording_dispatch
    gk.launches = 0  # the counts of THIS run of the main path
    gk.scored_launches = 0
    try:
        init = pods("init", spec["init"])
        watch = BindWatcher(server, [p.metadata.name for p in init])
        sched.start()
        t_init = time.perf_counter()
        for lo in range(0, len(init), 1000):
            client.create_pods_bulk(init[lo:lo + 1000])
        if not watch.wait(900):
            raise AssertionError("the init pods did not all bind")
        watch.stop()
        sched.wait_for_inflight_binds(timeout=60)
        init_s = time.perf_counter() - t_init
        init_batches = len(dispatched)
        init_scored = state["scored"]
        state["keep"] = 1  # every measured launch is replayed

        tiers0 = dict(sched.ladder.solves_by_tier)
        counters0 = dict(
            fallbacks=counter_total(metrics.solver_fallbacks),
            retries=counter_total(metrics.solve_retries),
            pods_fallback=sched.pods_fallback,
            envelope_fallbacks=sched.envelope_fallbacks,
        )
        stages0 = dict(sched.stage_seconds)
        plans0 = len(plan_events)
        measured = pods("measure", spec["measured"])
        names_m = [p.metadata.name for p in measured]
        watch = BindWatcher(server, names_m)
        rounds = spec["rounds"]
        chunks = [measured[r * len(measured) // rounds:
                           (r + 1) * len(measured) // rounds]
                  for r in range(rounds)]
        listed, _ = client.list_pods()
        victims = [p for p in listed if p.spec.node_name]
        create_times, deleted, vi = {}, [], 0
        start = time.perf_counter()
        for chunk in chunks:
            for _ in range(min(spec["delete"], len(victims) - vi)):
                v = victims[vi]
                vi += 1
                client.delete_pod(v.metadata.namespace, v.metadata.name)
                deleted.append(v.metadata.name)
            now = time.perf_counter()
            for p in chunk:
                create_times[p.metadata.name] = now
            client.create_pods_bulk(chunk)
            want = {p.metadata.name for p in chunk}
            deadline = time.time() + 300
            while time.time() < deadline:
                with watch._cond:
                    if want <= watch.bind_times.keys():
                        break
                time.sleep(0.01)
        completed = watch.wait(300)
        elapsed = time.perf_counter() - start
        scored = state["scored"]
        launches, scored_launches = gk.launches, gk.scored_launches
        sched.wait_for_inflight_binds(timeout=60)
        watch.stop()
        total_live = spec["init"] - len(deleted) + spec["measured"]
        deadline = time.time() + 300
        running = 0
        while time.time() < deadline:
            listed, _ = client.list_pods()
            running = sum(1 for p in listed if p.status.phase == POD_RUNNING)
            if running == total_live:
                break
            time.sleep(0.5)
    finally:
        asg_mod.sinkhorn_prior = orig_prior
        gk.greedy_solve = orig_solve
        gk.greedy_assign_compact = orig_commit
        sched._dispatch_solve = orig_dispatch
    stages = {
        k: v - stages0.get(k, 0.0) for k, v in sched.stage_seconds.items()
    }
    tiers = {
        k: v - tiers0.get(k, 0) for k, v in sched.ladder.solves_by_tier.items()
    }
    moved = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
    )
    moved = {k: moved[k] - counters0[k] for k in moved}
    all_tiers = dict(sched.ladder.solves_by_tier)
    listed, _ = client.list_pods()
    nodes_listed, _ = client.list_nodes()
    sched.stop()
    hollow.stop()
    informers.stop()

    # placement: everything bound, nothing over capacity, the spread
    placed = {p.metadata.name: p.spec.node_name for p in listed}
    unbound = [nm for nm, node in placed.items() if not node]
    per_node = {}
    for node in placed.values():
        if node:
            per_node[node] = per_node.get(node, 0) + 1
    cap_pods = min(110, 32000 // cpu, 64 * 1024 // mem)
    over = {nd: c for nd, c in per_node.items() if c > cap_pods}
    utils = [per_node.get(nd.metadata.name, 0) * cpu / 32000.0
             for nd in nodes_listed]
    mean = sum(utils) / len(utils)
    std = (sum((u - mean) ** 2 for u in utils) / len(utils)) ** 0.5
    bound_m = sum(1 for nm in names_m if placed.get(nm))
    if not completed or bound_m != spec["measured"] or unbound:
        raise AssertionError(
            f"{workload}: {bound_m}/{spec['measured']} measured pods bound, "
            f"{len(unbound)} live pods unbound"
        )
    if len(listed) != total_live or running != total_live:
        raise AssertionError(
            f"{workload}: {running}/{len(listed)} live pods acked Running, "
            f"{total_live} expected"
        )
    if over:
        raise AssertionError(f"{workload}: nodes over capacity: {list(over)[:3]}")
    if set(k for k, v in all_tiers.items() if v) != {tier}:
        raise AssertionError(f"{workload}: solves off the {tier} tier: {all_tiers}")
    if any(p["tier"] != tier for p in dispatched):
        raise AssertionError(f"{workload}: a dispatch was solved off the {tier} tier")
    if any(moved.values()):
        raise AssertionError(f"{workload}: a fallback counter moved: {moved}")
    # on the card every sinkhorn batch is one scored launch and no plain
    # commit; on the CPU every batch is a plain commit
    plain_want = 0 if on_card else len(dispatched)
    if (scored != len(dispatched) or launches or state["plain"] != plain_want
            or (on_card and scored_launches != len(dispatched))):
        raise AssertionError(
            f"{workload}: {scored_launches} scored launches, {launches} "
            f"greedy launches and {state['plain']} plain commits for "
            f"{len(dispatched)} sinkhorn batches"
        )

    # the recorded launches' replays through the plain loop on the card
    t_replay = time.perf_counter()
    for args, prior, config, out in records:
        want = asg_mod.sinkhorn_commit(*args, prior, config=config)
        if not all(torch.equal(o, w) for o, w in zip(out, want)):
            raise AssertionError(f"{workload}: a batch differs from its replay")
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t_replay
    plan_ms = [s.elapsed_time(e) for s, e in plan_events]
    k_ms = [s.elapsed_time(e) for s, e in k_events]
    measured_plans = plan_ms[plans0:]
    lat = sorted(watch.bind_times[nm] - create_times[nm] for nm in names_m)
    rec = dict(
        workload=workload, nodes=n_nodes, init=spec["init"],
        pods=spec["measured"], rounds=rounds, deleted=len(deleted),
        bound=bound_m, seconds=elapsed,
        pods_per_sec=spec["measured"] / elapsed,
        p50_create_to_bind_s=lat[len(lat) // 2],
        p99_create_to_bind_s=lat[min(len(lat) - 1, len(lat) * 99 // 100)],
        batches=len(dispatched), init_batches=init_batches,
        measured_batch_sizes=[p["b"] for p in dispatched[init_batches:]],
        scored_kernel_launches=scored_launches, greedy_kernel_launches=launches,
        plain_commits=state["plain"],
        plan_seconds_total=sum(plan_ms) / 1e3,
        plan_ms_mean=sum(plan_ms) / len(plan_ms),
        measured_plan_seconds=sum(measured_plans) / 1e3,
        scored_ms_mean=sum(k_ms) / len(k_ms),
        scored_seconds_total=sum(k_ms) / 1e3,
        solves_by_tier=tiers, counters_moved=moved, stage_seconds=stages,
        live_pods=len(listed), running=running,
        max_pods_per_node=max(per_node.values()),
        utilization_cpu=dict(mean=mean, std=std, max=max(utils)),
        replayed=len(records),
        replayed_init=-(-init_scored // spec["replay_init_every"]),
        replay_equal=True, replay_seconds=replay_s,
        init_seconds=init_s, setup_seconds=t_init - t_setup,
    )
    emit("sinkhorn_churn", **rec)
    records.clear()
    torch.cuda.empty_cache()
    return rec


# -- phase 11: the cluster-lifecycle plane ------------------------------------

# The lifecycle rows of the perf matrix (benchmarks/config/
# performance-config.yaml; the defaults of :9-15: 32 CPU / 64Gi / 110-pod
# nodes in 10 zones, max_batch 1024), built as benchmarks/runner.py builds
# them. Nothing is cut.
LIFECYCLE_ROWS = [
    dict(
        name="DrainViaPreemption/500", source=":366-381", nodes=500,
        init=4000, init_pod=dict(cpu="3000m", memory="6Gi", priority=0,
                                 labels={"app": "drainable"}),
        measured=500, pod=dict(cpu="3000m", memory="6Gi",
                               labels={"app": "drainable"}),
        streaming=dict(trace="poisson", rate=300, seed=31, sloP99="5s"),
        lifecycle=dict(mode="drain_via_preemption", at_fraction=0.5,
                       waves=3, nodes_per_wave=4, wave_timeout_s=60,
                       pdb=dict(match_labels={"app": "drainable"},
                                max_unavailable=40)),
    ),
    dict(
        name="LifecycleDrainWave/500", source=":558-570", nodes=500,
        measured=1000, pod=dict(cpu="250m", memory="512Mi",
                                labels={"app": "drainable"}),
        streaming=dict(trace="poisson", rate=300, seed=7, sloP99="2s"),
        lifecycle=dict(mode="drain_wave", at_fraction=0.5, waves=5,
                       nodes_per_wave=4, wave_timeout_s=30,
                       pdb=dict(match_labels={"app": "drainable"},
                                max_unavailable=100)),
    ),
    dict(
        name="LifecycleReclaimStorm/500", source=":571-582", nodes=500,
        measured=1000, pod=dict(cpu="250m", memory="512Mi"),
        streaming=dict(trace="poisson", rate=300, seed=11, sloP99="2s"),
        lifecycle=dict(mode="reclaim_storm", at_fraction=0.5, storms=1,
                       storm_fraction=0.1, storm_down_seconds=1.0),
    ),
    dict(
        name="LifecycleColdScaleUp/500", source=":583-595", nodes=400,
        measured=1000, pod=dict(cpu="16", memory="512Mi"),
        streaming=dict(trace="poisson", rate=200, seed=13, sloP99="5s"),
        lifecycle=dict(mode="scale_up", at_fraction=0.6, add_nodes=120),
    ),
    dict(
        name="HeartbeatLapseStorm/1000", source=":762-775", nodes=500,
        measured=1000, pod=dict(cpu="250m", memory="512Mi"),
        fleet=dict(ack_latency_seconds=0.02, heartbeat_interval_seconds=0.5,
                   lease_duration_seconds=4.0,
                   dark=dict(count=25, at_fraction=0.6),
                   lifecycle=dict(grace_period=3.0, monitor_interval=0.5),
                   bind_ack=dict(ack_timeout_seconds=2.0,
                                 sweep_interval_seconds=0.25)),
    ),
    dict(
        name="PreemptionCascade/500", source=":348-360", nodes=500,
        init=5000, init_pod=dict(cpu="3000m", memory="6Gi", priority=0,
                                 labels={"app": "fill"}),
        measured=500, pod=dict(cpu="3000m", memory="6Gi", priority=100),
        init_preempt=32,
        streaming=dict(trace="bursty", rate=250, seed=29, sloP99="10s"),
        preemption=dict(pdb=dict(match_labels={"app": "fill"},
                                 max_unavailable=600),
                        respawn_prefix="init-", high_priority_threshold=100),
    ),
]
LIFECYCLE_WAIT_S = 180  # each wait of a row: measured binds, settle


def lifecycle_pod(make_pod, name, spec):
    """A pod as benchmarks/runner.py:139 _build_pod builds these rows'."""
    w = make_pod(name).container(cpu=spec["cpu"], memory=spec["memory"])
    if spec.get("labels"):
        w.labels(**spec["labels"])
    if spec.get("priority") is not None:
        w.priority(int(spec["priority"]))
    return w.obj()


def double_binds(server, rebinds_allowed):
    """Pod incarnations (uids) bound twice, replayed from the whole watch
    history: moved from one node straight to another, or bound again
    after more unbinds than ``rebinds_allowed`` (the bind-ack tracker
    unbinds an unacked pod once per incarnation, and it binds again)."""
    w = server.watch("Pod", since_rv=0)
    node, binds, unbinds, bad = {}, {}, {}, set()
    for ev in w.pending():
        uid = ev.object.metadata.uid
        if ev.type == "DELETED":
            node.pop(uid, None)
            continue
        prev, cur = node.get(uid, ""), ev.object.spec.node_name or ""
        if prev and cur and prev != cur:
            bad.add(uid)
        if not prev and cur:
            binds[uid] = binds.get(uid, 0) + 1
        if prev and not cur:
            unbinds[uid] = unbinds.get(uid, 0) + 1
        node[uid] = cur
    w.stop()
    for uid, n in binds.items():
        u = unbinds.get(uid, 0)
        if u > rebinds_allowed or n > u + 1:
            bad.add(uid)
    return bad


def pdb_floor(server):
    """The least disruptionsAllowed any PDB status write ever left."""
    w = server.watch("PodDisruptionBudget", since_rv=0)
    floor = 0
    for ev in w.pending():
        if ev.type != "DELETED":
            floor = min(floor, ev.object.status.disruptions_allowed)
    w.stop()
    return floor


def residents_faced(server, windows):
    """Per drain window (node, rv at its start, rv at its end): the pod
    incarnations (uids) on the node at the start, plus those bound to it
    during the drain (a dispatch in flight can land a pod before the
    scheduler sees the cordon) -- every pod a whole-node drain of that
    window would evict. Replayed from the whole watch history."""
    w = server.watch("Pod", since_rv=0)
    evs = w.pending()
    w.stop()
    total = 0
    for v, rv0, rv1 in windows:
        node, faced, started = {}, set(), False
        for ev in evs:
            if ev.resource_version > rv0 and not started:
                faced |= {u for u, n in node.items() if n == v}
                started = True
            if ev.resource_version > rv1:
                break
            uid = ev.object.metadata.uid
            if ev.type == "DELETED":
                node.pop(uid, None)
                continue
            node[uid] = ev.object.spec.node_name
            if started and node[uid] == v:
                faced.add(uid)
        if not started:
            faced |= {u for u, n in node.items() if n == v}
        total += len(faced)
    return total


class EvictionLedger:
    """The drainer's client, counting each of the drainer's evictions by
    whether the victim search planned a destination for the pod (an
    account of the drain kept apart from the drainer's own counters)."""

    def __init__(self, client):
        self._client = client
        self.planned_uids = set()
        self.planned = 0
        self.classic = 0

    def __getattr__(self, name):
        return getattr(self._client, name)

    def delete_pod(self, namespace, name):
        uid = self._client.get_pod(namespace, name).metadata.uid
        out = self._client.delete_pod(namespace, name)
        if uid in self.planned_uids:
            self.planned += 1
        else:
            self.classic += 1
        return out


def lifecycle_row(row, gk, pk, device=None):
    """One lifecycle row through the port's entry points: its stack, the
    init fill, then the measured pods arriving on the row's trace while
    its scenario (drains, a storm, cold nodes, dark agents, preemption
    waves) runs on its own thread. Every K1 launch is replayed on the CPU
    from its recorded pieces and handed state, every K3 launch (plans
    and waves) through ``preempt_batch_plain``. ``device="cpu"``
    rehearses the row on the CPU."""
    from kubernetes_tpu_torch.api.types import (
        POD_RUNNING, LabelSelector, PodDisruptionBudget,
    )
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.client.client import Client
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.config.loader import load_config_from_dict
    from kubernetes_tpu_torch.config.types import BindAckConfiguration
    from kubernetes_tpu_torch.controllers import (
        DisruptionController, NodeDrainer, NodeLifecycleController,
    )
    from kubernetes_tpu_torch.controllers.nodelifecycle import (
        TAINT_UNREACHABLE,
    )
    from kubernetes_tpu_torch.kubelet import FleetConfig, HollowNodeFleet
    from kubernetes_tpu_torch.ops import preemption as pre_mod
    from kubernetes_tpu_torch.robustness.faults import (
        FaultInjector, FaultPoint, FaultProfile, PointConfig,
    )
    from kubernetes_tpu_torch.robustness.lifecycle import (
        ClusterLifecycleDriver, PodRespawner,
    )
    from kubernetes_tpu_torch.scheduler import batch as batch_mod
    from kubernetes_tpu_torch.scheduler.preemption import _PLAN_PRIO
    from kubernetes_tpu_torch.scheduler.scheduler import (
        apply_streaming_config, new_scheduler,
    )
    from kubernetes_tpu_torch.streaming.arrivals import (
        ArrivalEngine, trace_from_config,
    )
    from kubernetes_tpu_torch.testing import make_node, make_pod
    from kubernetes_tpu_torch.utils import metrics

    name = row["name"]
    on_card = device is None
    tier = "cuda" if on_card else "torch"  # the CPU is for rehearsal
    n_nodes = row["nodes"]
    lc = row.get("lifecycle") or {}
    fleet_cfg = row.get("fleet")
    pre_cfg = row.get("preemption")
    t_setup = time.perf_counter()
    errors = []  # (thread, exception) of every helper thread
    stoppers = []
    stop_evt = threading.Event()
    counters = {}

    def spawn(thread_name, fn):
        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append((thread_name, e))
                raise

        t = threading.Thread(target=run, name=thread_name, daemon=True)
        t.start()
        return t

    def pdb(spec, pdb_name):
        out = PodDisruptionBudget(
            selector=LabelSelector(match_labels=dict(spec["match_labels"])),
            max_unavailable=spec.get("max_unavailable"),
        )
        out.metadata.name = pdb_name
        out.metadata.namespace = "default"
        return out

    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=MAX_CONSTRAINED_BATCH,
        device=device,
        bind_ack_config=(
            BindAckConfiguration(enabled=True, **fleet_cfg["bind_ack"])
            if fleet_cfg else None
        ),
    )
    if (sched.device.type == "cuda") != on_card or (
        sched.preemptor.device.type != sched.device.type
    ):
        raise AssertionError(f"{name}: the scheduler solves on {sched.device}")
    streaming = None
    if row.get("streaming"):
        # the workload's streaming block through the config entry point:
        # the controller replaces the static batch window
        cfg = load_config_from_dict(
            {"streaming": {"enabled": True, **row["streaming"]}}
        )
        apply_streaming_config(
            sched, cfg, informers, batch=True,
            max_batch=MAX_CONSTRAINED_BATCH,
        )
        streaming = cfg.streaming
        if sched.autobatch is None:
            raise AssertionError(f"{name}: no controller attached")
    preemptor = sched.preemptor
    respawner = None
    if pre_cfg:
        dc = DisruptionController(client, informers)
        dc.start()
        stoppers.append(dc)
        preemptor.disruption = dc
        client.create_pdb(pdb(pre_cfg["pdb"], "preemption-budget"))
        prefix = pre_cfg["respawn_prefix"]
        respawner = PodRespawner(
            client, should_respawn=lambda p: p.metadata.name.startswith(prefix)
        )
        respawner.start()
        stoppers.append(respawner)
    node_names = [f"node-{i}" for i in range(n_nodes)]
    for i, nm in enumerate(node_names):
        client.create_node(
            make_node(nm).capacity(cpu="32", memory="64Gi", pods=110)
            .label(ZONE_KEY, f"zone-{i % 10}").label(HOST_KEY, nm).obj()
        )

    # the scenario, as benchmarks/runner.py:262-454 builds it
    mode = lc.get("mode")
    drainer = ledger = driver = None
    plan_nodes = {}  # drained node -> K3 plan launches for it
    windows = []  # (drained node, rv at the drain's start, rv at its end)
    if mode in ("drain_via_preemption", "drain_wave"):
        dc = DisruptionController(client, informers)
        dc.start()
        stoppers.append(dc)
        client.create_pdb(pdb(lc["pdb"], "drain-budget"))
        respawner = PodRespawner(client)
        respawner.start()
        stoppers.append(respawner)
        if mode == "drain_via_preemption":
            preemptor.disruption = dc
            ledger = EvictionLedger(client)
            drainer = NodeDrainer(ledger, disruption=dc,
                                  should_abort=stop_evt.is_set,
                                  preemptor=preemptor)
        else:
            drainer = NodeDrainer(client, disruption=dc,
                                  should_abort=stop_evt.is_set)
        counters["baseline_pods"] = 0
    elif mode == "reclaim_storm":
        # a private injector (never installed): the storm count is fixed
        # and no solver fault rides along
        driver = ClusterLifecycleDriver(
            client,
            injector=FaultInjector(FaultProfile(
                name="bench-reclaim", seed=0,
                points={FaultPoint.RECLAIM_STORM: PointConfig(
                    rate=1.0, max_fires=int(lc["storms"]))},
            )),
            tick_interval=0.2, flap_down_seconds=0.5,
            storm_fraction=float(lc["storm_fraction"]),
            storm_down_seconds=float(lc["storm_down_seconds"]),
        )
        stoppers.append(driver)
    fleet = lifecycle_ctrl = None
    dark = []
    if fleet_cfg:
        fleet = HollowNodeFleet(client, node_names, FleetConfig(**{
            k: fleet_cfg[k] for k in (
                "ack_latency_seconds", "heartbeat_interval_seconds",
                "lease_duration_seconds",
            )
        }))
        fleet.start()
        stoppers.append(fleet)
        dc = DisruptionController(client, informers)
        dc.start()
        stoppers.append(dc)
        lifecycle_ctrl = NodeLifecycleController(
            client, informers,
            grace_period=fleet_cfg["lifecycle"]["grace_period"],
            monitor_interval=fleet_cfg["lifecycle"]["monitor_interval"],
            disruption=dc,
        )
        lifecycle_ctrl.start()
        stoppers.append(lifecycle_ctrl)
        respawner = PodRespawner(
            client,
            should_respawn=lambda p: p.metadata.name.startswith("measure-"),
        )
        respawner.start()
        stoppers.append(respawner)

    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()

    # record every K1 solve (pieces, handed state, answer) and every K3
    # launch (operands, answer, the node a plan drains)
    dispatched, seen, calls, k3_calls = [], set(), [], []
    orig_dispatch, orig_solve = sched._dispatch_solve, batch_mod.solve_packed
    orig_k3 = pk.preempt_solve
    orig_plan = preemptor.plan_replacements
    # the node a plan drains: plans come from the scenario thread alone,
    # and the launch itself may run on the ladder's watchdog thread
    draining = {"node": None}
    recording_dispatch, recording_solve = solve_recorders(
        orig_dispatch, orig_solve, dispatched, seen, calls
    )

    def recording_k3(*args):
        out = orig_k3(*args)
        k3_calls.append((args, out, draining["node"]))
        return out

    def recording_plan(pods, exclude_nodes=()):
        draining["node"] = exclude_nodes[0] if exclude_nodes else None
        try:
            dests = orig_plan(pods, exclude_nodes=exclude_nodes)
        finally:
            draining["node"] = None
        if ledger is not None:
            ledger.planned_uids.update(
                p.metadata.uid for p, d in zip(pods, dests) if d
            )
        return dests

    sched._dispatch_solve = recording_dispatch
    batch_mod.solve_packed = recording_solve
    pk.preempt_solve = recording_k3
    preemptor.plan_replacements = recording_plan
    tiers0 = dict(sched.ladder.solves_by_tier)
    wave_tiers0 = dict(preemptor.ladder.solves_by_tier)
    counters0 = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
        host_preemptions=preemptor.host_preemptions,
    )
    stages0 = dict(sched.stage_seconds)
    patches0 = sched.membership_row_patches
    uploads0 = sched.state_uploads
    gk.launches = 0  # the counts of THIS row's run of the path
    pk.launches = 0
    sched_thread = None
    engine = None
    scenario_thread = None
    watch = None

    def check_alive(running=True):
        if errors:
            thread_name, err = errors[0]
            raise AssertionError(f"{name}: {thread_name} failed: {err!r}") from err
        if sched.card_fault is not None:
            raise AssertionError(
                f"{name}: a batch failed on the card: {sched.card_fault!r}"
            ) from sched.card_fault
        if running and sched_thread is not None and (
            not sched_thread.is_alive()
        ):
            raise AssertionError(f"{name}: the scheduler thread died")

    def wait_for(cond, what, timeout=LIFECYCLE_WAIT_S):
        deadline = time.time() + timeout
        while True:
            check_alive()
            if cond():
                return
            if time.time() > deadline:
                raise AssertionError(f"{name}: timed out waiting for {what}")
            time.sleep(0.05)

    def live_pods():
        return [p for p in client.list_pods()[0]
                if p.metadata.deletion_timestamp is None]

    try:
        init_n = row.get("init", 0)
        fill_s = 0.0
        if init_n:
            init = [lifecycle_pod(make_pod, f"init-{i}", row["init_pod"])
                    for i in range(init_n)]
            watch = BindWatcher(server, [p.metadata.name for p in init])
            sched_thread = sched.start()
            t0 = time.perf_counter()
            for lo in range(0, init_n, 1000):
                client.create_pods_bulk(init[lo:lo + 1000])
            wait_for(lambda: watch._outstanding <= 0, "the init pods")
            watch.stop()
            sched.wait_for_inflight_binds(timeout=60)
            fill_s = time.perf_counter() - t0
        else:
            sched_thread = sched.start()
        n_warm = row.get("init_preempt", 0)
        if n_warm:
            warm = [lifecycle_pod(make_pod, f"warmpre-{i}", row["pod"])
                    for i in range(n_warm)]
            watch = BindWatcher(server, [p.metadata.name for p in warm])
            client.create_pods_bulk(warm)
            wait_for(lambda: watch._outstanding <= 0, "the warm preemptors")
            watch.stop()
            sched.wait_for_inflight_binds(timeout=60)
        setup_s = time.perf_counter() - t_setup

        measured_n = row["measured"]
        pods = [lifecycle_pod(make_pod, f"measure-{i}", row["pod"])
                for i in range(measured_n)]
        names = [p.metadata.name for p in pods]
        watch = BindWatcher(server, names)

        def wait_fraction(frac):
            need = int(frac * measured_n)
            wait_for(lambda: measured_n - watch._outstanding >= need,
                     f"{frac:.0%} of the measured pods to bind")

        def drains():
            wait_fraction(lc["at_fraction"])
            idx = 0
            for _ in range(lc["waves"]):
                victims = [f"node-{(idx + j) % n_nodes}"
                           for j in range(lc["nodes_per_wave"])]
                idx += lc["nodes_per_wave"]
                for v in victims:
                    if stop_evt.is_set():
                        return
                    rv0 = server.current_rv()
                    counters["baseline_pods"] += sum(
                        1 for p in client.list_pods()[0]
                        if p.spec.node_name == v
                    )
                    if mode == "drain_via_preemption":
                        plan_nodes[v] = 0
                        drainer.drain_via_preemption(
                            v, timeout=lc["wave_timeout_s"])
                    else:
                        drainer.drain(v, timeout=lc["wave_timeout_s"])
                    windows.append((v, rv0, server.current_rv()))
                for v in victims:  # the wave is back in service
                    drainer.uncordon(v)

        def storm():
            wait_fraction(lc["at_fraction"])
            driver.start()
            # hold until the storm landed and its nodes came back
            deadline = time.time() + 30
            while time.time() < deadline and not stop_evt.is_set():
                if driver.storms >= 1 and driver.down_count() == 0:
                    return
                time.sleep(0.1)
            raise AssertionError("the storm did not land and heal in 30 s")

        def scale_up():
            wait_fraction(lc["at_fraction"])
            for i in range(lc["add_nodes"]):
                client.create_node(
                    make_node(f"cold-{i}").capacity(
                        cpu="32", memory="64Gi", pods=110)
                    .label(ZONE_KEY, f"zone-{i % 10}")
                    .label(HOST_KEY, f"cold-{i}").obj()
                )
            counters["nodes_added"] = lc["add_nodes"]

        def go_dark():
            wait_fraction(fleet_cfg["dark"]["at_fraction"])
            dark.extend(node_names[:fleet_cfg["dark"]["count"]])
            fleet.go_dark(list(dark))

        scenario = {
            "drain_via_preemption": drains, "drain_wave": drains,
            "reclaim_storm": storm, "scale_up": scale_up,
        }.get(mode, go_dark if fleet_cfg else None)
        create_times = {}
        start = time.perf_counter()
        if scenario is not None:
            scenario_thread = spawn(f"{name} scenario", scenario)
        if streaming is not None:
            # the runner's sizing (:1221-1262): grow the trace until it
            # covers every measured pod, then trim
            dur = measured_n / streaming.rate_pods_per_sec
            offsets = trace_from_config(streaming, duration=dur)
            while offsets.size < measured_n:
                dur *= 1.3
                offsets = trace_from_config(streaming, duration=dur)
            engine = ArrivalEngine(
                client, offsets[:measured_n], lambda i: pods[i],
                depth_fn=sched.queue.active_count,
                max_queue_depth=streaming.max_queue_depth,
            )
            engine.start()
        else:
            for lo in range(0, measured_n, 100):
                now = time.perf_counter()
                for p in pods[lo:lo + 100]:
                    create_times[p.metadata.name] = now
                client.create_pods_bulk(pods[lo:lo + 100])
        wait_for(lambda: watch._outstanding <= 0, "the measured pods")
        last_bind = max(watch.bind_times[nm] for nm in names)
        elapsed = last_bind - start
        if engine is not None:
            engine.stop()
            if engine.created != measured_n:
                raise AssertionError(
                    f"{name}: the arrival engine created {engine.created} "
                    f"of {measured_n} pods"
                )
            create_times.update(engine.created_ts)
        if scenario_thread is not None:
            wait_for(lambda: not scenario_thread.is_alive(), "the scenario")
        # settle: every live incarnation bound (the respawned clones the
        # name-keyed watch cannot see), the fleet back to Running
        high = (pre_cfg or {}).get("high_priority_threshold")

        def settled():
            live = live_pods()
            unbound = [p for p in live if not p.spec.node_name]
            if high is not None:
                # the cluster is full by construction: respawned victims
                # (priority 0) have no room; the high band must all bind
                return not [p for p in unbound
                            if p.spec.priority >= high
                            or not p.metadata.name.startswith("init-")]
            if unbound:
                return False
            if fleet_cfg:
                # the storm fired, the monitor tainted every dark node
                # unreachable, and every live pod runs off them
                dark_set = set(dark)
                tainted = {
                    n.metadata.name for n in client.list_nodes()[0]
                    if any(t.key == TAINT_UNREACHABLE for t in n.spec.taints)
                }
                return bool(dark_set) and dark_set <= tainted and all(
                    p.status.phase == POD_RUNNING
                    and p.spec.node_name not in dark_set for p in live
                )
            return True

        wait_for(settled, "every live pod to bind")
        sched.wait_for_inflight_binds(timeout=60)
        check_alive()
        nodes_now = [n.metadata.name for n in client.list_nodes()[0]]
        live = live_pods()
        # the dispatcher stops first: it lands what is in flight and stops
        # its committer, so no launch follows the counts read below
        sched._stop.set()
        sched_thread.join(timeout=60)
        if sched_thread.is_alive():
            raise AssertionError(f"{name}: the scheduler did not stop")
        check_alive(running=False)
        k1_launches, k3_launches = gk.launches, pk.launches
    finally:
        stop_evt.set()
        if engine is not None:
            engine.stop()
        if watch is not None:
            watch.stop()
        sched._dispatch_solve = orig_dispatch
        batch_mod.solve_packed = orig_solve
        pk.preempt_solve = orig_k3
        preemptor.plan_replacements = orig_plan
        if scenario_thread is not None:
            scenario_thread.join(timeout=30)
        for comp in reversed(stoppers):
            comp.stop()
        sched.stop()

    doubles = double_binds(server, 1 if fleet_cfg else 0)
    floor = pdb_floor(server)
    stages = {k: v - stages0.get(k, 0.0) for k, v in sched.stage_seconds.items()}
    tiers = {k: v - tiers0.get(k, 0)
             for k, v in sched.ladder.solves_by_tier.items()}
    wave_tiers = {k: v - wave_tiers0.get(k, 0)
                  for k, v in preemptor.ladder.solves_by_tier.items()}
    moved = dict(
        fallbacks=counter_total(metrics.solver_fallbacks),
        retries=counter_total(metrics.solve_retries),
        pods_fallback=sched.pods_fallback,
        envelope_fallbacks=sched.envelope_fallbacks,
        host_preemptions=preemptor.host_preemptions,
    )
    moved = {k: moved[k] - counters0[k] for k in moved}
    controller = sched.autobatch
    full_repacks = sched.tensor_cache.full_repacks
    informers.stop()

    if set(k for k, v in tiers.items() if v) != {tier}:
        raise AssertionError(f"{name}: batches off the {tier} tier: {tiers}")
    if any(p["tier"] != tier for p in dispatched):
        raise AssertionError(f"{name}: a dispatch solved off the {tier} tier")
    if set(k for k, v in wave_tiers.items() if v) - {tier}:
        raise AssertionError(f"{name}: K3 off the {tier} tier: {wave_tiers}")
    if any(moved.values()):
        raise AssertionError(f"{name}: a fallback counter moved: {moved}")
    if doubles:
        raise AssertionError(
            f"{name}: {len(doubles)} incarnations bound more than once"
        )
    if floor < 0:
        raise AssertionError(f"{name}: a PDB went to {floor}")
    # every K1 launch replayed on the CPU, every K3 launch through the
    # plain version
    greedy = [c for c in calls if c["mode"] == "greedy"]
    if on_card and k1_launches != len(greedy):
        raise AssertionError(
            f"{name}: {k1_launches} K1 launches, {len(greedy)} recorded"
        )
    if on_card and k3_launches != len(k3_calls):
        raise AssertionError(
            f"{name}: {k3_launches} K3 launches, {len(k3_calls)} recorded"
        )
    t_replay = time.perf_counter()
    replay_solves(calls, dispatched)
    k3_plan = k3_wave = 0
    plan_shape = None
    for args, out, node in k3_calls:
        cpu_args = [a.cpu() for a in args]
        want = pre_mod.preempt_batch_plain(*cpu_args)
        if not all(torch.equal(o.cpu(), w) for o, w in zip(out, want)):
            raise AssertionError(f"{name}: a K3 launch differs from its replay")
        if bool((cpu_args[12] == _PLAN_PRIO).all()):
            k3_plan += 1
            if node in plan_nodes:
                plan_nodes[node] += 1
            shape = (int(cpu_args[0].shape[0]), int(cpu_args[2].shape[1]),
                     int(cpu_args[11].shape[0]))
            if plan_shape is None or shape[2] > plan_shape[2]:
                plan_shape, plan_args = shape, args
        else:
            k3_wave += 1
    replay_s = time.perf_counter() - t_replay

    if drainer is not None:
        counters.update(
            residents_faced=residents_faced(server, windows),
            evictions=drainer.evictions,
            evictions_blocked=drainer.evictions_blocked,
            drains_completed=drainer.drains,
            preempt_planned=drainer.preempt_planned,
            preempt_left_running=drainer.preempt_left_running,
        )
    if ledger is not None:
        counters.update(planned_evictions=ledger.planned,
                        classic_evictions=ledger.classic)
        if (ledger.planned != drainer.preempt_planned
                or ledger.planned + ledger.classic != drainer.evictions):
            raise AssertionError(
                f"{name}: eviction ledger: {ledger.planned} planned + "
                f"{ledger.classic} classic != {drainer.evictions} evictions "
                f"({drainer.preempt_planned} planned by the drainer)"
            )
        if drainer.evictions > counters["residents_faced"]:
            raise AssertionError(
                f"{name}: more evictions than residents: {counters}"
            )
        short = {v: k for v, k in plan_nodes.items() if k < 1}
        if on_card and short:
            raise AssertionError(f"{name}: no K3 plan launch for {short}")
    if lifecycle_ctrl is not None:
        counters.update(evictions=lifecycle_ctrl.evictions,
                        evictions_blocked=lifecycle_ctrl.evictions_blocked,
                        dark_nodes=len(dark),
                        ack_rebinds=sched.bind_ack_tracker.rebinds)
    if respawner is not None:
        counters["respawned"] = respawner.respawned
    if driver is not None:
        counters.update(
            storms=driver.storms, flaps=driver.flaps,
            nodes_reclaimed=driver.nodes_reclaimed,
            pods_killed=driver.pods_killed, respawned=driver.pods_respawned,
        )
    counters.update(
        membership_row_patches=sched.membership_row_patches - patches0,
        full_repacks=full_repacks,
        state_uploads=sched.state_uploads - uploads0,
    )
    if mode == "reclaim_storm" and (
        driver.storms != 1 or len(nodes_now) != n_nodes
        or counters["membership_row_patches"] <= 0 or full_repacks != 1
    ):
        raise AssertionError(f"{name}: the storm's ledger: {counters}")
    on_cold = sum(1 for p in live if p.spec.node_name.startswith("cold-"))
    if mode == "scale_up" and on_cold <= 0:
        raise AssertionError(f"{name}: no pod on a cold node")
    high_unbound = None
    if pre_cfg:
        high_unbound = sum(
            1 for p in live
            if p.spec.priority >= pre_cfg["high_priority_threshold"]
            and not p.spec.node_name
        )
        if high_unbound or k3_wave <= 0:
            raise AssertionError(
                f"{name}: {high_unbound} high-priority pods unbound, "
                f"{k3_wave} waves"
            )
    if on_card and k1_launches <= 0:
        raise AssertionError(f"{name}: K1 never launched")

    plan_ms = None
    if on_card and plan_shape is not None:
        # one plan launch at this row's largest plan, by CUDA events
        plan_ms, _ = cuda_ms(lambda: orig_k3(*plan_args), 20)
    lat = sorted(watch.bind_times[nm] - create_times[nm] for nm in names)
    rec = dict(
        row=name, source=f"benchmarks/config/performance-config.yaml"
        f"{row['source']}", nodes=n_nodes, init_pods=row.get("init", 0),
        pods=measured_n, seconds=elapsed, pods_per_sec=measured_n / elapsed,
        p50_arrival_to_bind_s=lat[len(lat) // 2],
        p99_arrival_to_bind_s=lat[min(len(lat) - 1, len(lat) * 99 // 100)],
        live_pods=len(live), bound=sum(1 for p in live if p.spec.node_name),
        on_cold_nodes=on_cold, high_priority_unbound=high_unbound,
        nodes_at_end=len(nodes_now), stage_seconds=stages,
        greedy_kernel_launches=k1_launches, preempt_kernel_launches=k3_launches,
        k3_plan_launches=k3_plan, k3_wave_launches=k3_wave,
        k3_plan_launches_by_node=plan_nodes or None,
        k3_plan_ms=plan_ms, k3_plan_shape=plan_shape,
        batches=len(dispatched), solves_by_tier=tiers,
        wave_solves_by_tier=wave_tiers, counters_moved=moved,
        lifecycle=counters, replay_equal=True, replay_seconds=replay_s,
        fill_seconds=fill_s, setup_seconds=setup_s,
    )
    if controller is not None:
        rec["controller"] = dict(
            steps=controller.steps, window_changes=controller.window_changes,
            cap_changes=controller.cap_changes, grows=controller.grows,
            shrinks=controller.shrinks, latches=controller.latches,
            window=controller.window, batch_cap=controller.batch_cap,
        )
    if engine is not None:
        rec["arrivals"] = dict(
            trace=streaming.trace, rate=streaming.rate_pods_per_sec,
            seed=streaming.seed, created=engine.created,
            backpressure_stalls=engine.backpressure_stalls,
        )
    emit("lifecycle", **rec)
    return rec


def lifecycle(gk, pk, device=None, rows=LIFECYCLE_ROWS):
    """The ``lifecycle`` phase: every row on a fresh stack, in order."""
    t0 = time.perf_counter()
    recs = [lifecycle_row(row, gk, pk, device) for row in rows]
    totals = dict(
        greedy_kernel_launches=sum(r["greedy_kernel_launches"] for r in recs),
        preempt_kernel_launches=sum(
            r["preempt_kernel_launches"] for r in recs),
        k3_plan_launches=sum(r["k3_plan_launches"] for r in recs),
        k3_wave_launches=sum(r["k3_wave_launches"] for r in recs),
    )
    emit("lifecycle_phase", rows=len(recs),
         seconds=time.perf_counter() - t0, **totals)
    return totals


def build_kernels(modules):
    """Build every kernel library, one nvcc each, all started together so
    the builds' time stays that of the slowest as kernels are added (a
    failed build re-raises here)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        list(pool.map(lambda mod: mod.build(), modules))
    for mod in modules:
        ptxas = [
            line.strip() for line in mod.last_build.get("log", "").splitlines()
            if "registers" in line or "spill" in line
        ]
        emit("build", kernel=mod.__name__.rsplit(".", 1)[-1],
             seconds=mod.last_build["seconds"], ptxas=ptxas,
             library=os.path.relpath(mod.last_build["library"]))
    return time.perf_counter() - t0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import assignment as asg_mod
    from kubernetes_tpu_torch.ops import constrained_kernel as ck
    from kubernetes_tpu_torch.ops import greedy_kernel as gk
    from kubernetes_tpu_torch.ops import preempt_kernel as pk
    from kubernetes_tpu_torch.ops import preemption as pre_mod
    from kubernetes_tpu_torch.ops import shard_kernel as sk
    from kubernetes_tpu_torch.ops import sinkhorn as sk_mod
    from kubernetes_tpu_torch.ops.mesh import NodeMesh

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit(
        "device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
    )
    build_s = build_kernels([gk, ck, pk, sk])

    timing, max_err = kernel_vs_twin(gk, asg_mod, asg_mod.GreedyConfig)
    sk_timing, sk_max_err = sinkhorn_kernel_vs_twin(gk, asg_mod, sk_mod)
    c_timing, c_max_err = constrained_kernel_vs_twin(ck, asg_mod)
    p_timing, p_max_err = preempt_kernel_vs_twin(pk, pre_mod)
    _, s_timing, s_max_err = shard_kernel_vs_twin(sk)
    rec = burst(gk)
    rows = constrained_bursts(ck)
    pre = preemption_burst(pk, gk)
    mesh = NodeMesh(["cuda:0"] * MESH_SHARDS)
    m_rec = burst(gk, mesh=mesh, sk=sk)
    mesh_mixed(mesh, gk, ck, pk, sk)
    churn = churn_sinkhorn(gk, asg_mod, "ChurnSinkhorn/50000")
    churn_sinkhorn(gk, asg_mod, "RebalanceSinkhorn/500")
    life = lifecycle(gk, pk)
    kernels = [dict(
        name="greedy_solve",
        route="cuda",
        source="kubernetes_tpu_torch/csrc/greedy_solve.cu",
        replaces="kubernetes_tpu/ops/pallas_solver.py:123",
        launches=rec["greedy_kernel_launches"]
        + life["greedy_kernel_launches"],
        max_abs_err=max_err,
        ms=timing["ms"],
        plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"],
        library_ms=None,  # no single PyTorch call computes this solve
    ), dict(
        name="greedy_solve_scored",
        route="cuda",
        source="kubernetes_tpu_torch/csrc/greedy_solve.cu",
        replaces="kubernetes_tpu/ops/assignment.py:1576",
        launches=churn["scored_kernel_launches"],
        max_abs_err=sk_max_err,
        ms=sk_timing["ms"],
        plain_ms=sk_timing["plain_ms"],
        bound_ms=sk_timing["bound_ms"],
        bound_by=sk_timing["bound_by"],
        library_ms=None,  # no single PyTorch call computes this scan
    ), dict(
        name="constrained_solve",
        route="cuda",
        source="kubernetes_tpu_torch/csrc/constrained_solve.cu",
        replaces="kubernetes_tpu/ops/pallas_constrained.py:182",
        launches=sum(r["constrained_kernel_launches"] for r in rows),
        max_abs_err=c_max_err,
        ms=c_timing["ms"],
        plain_ms=c_timing["plain_ms"],
        bound_ms=c_timing["bound_ms"],
        bound_by=c_timing["bound_by"],
        library_ms=None,  # no single PyTorch call computes this solve
    ), dict(
        name="preempt_solve",
        route="cuda",
        source="kubernetes_tpu_torch/csrc/preempt_solve.cu",
        replaces="kubernetes_tpu/ops/pallas_preempt.py:69",
        launches=pre["preempt_kernel_launches"]
        + life["preempt_kernel_launches"],
        max_abs_err=p_max_err,
        ms=p_timing["ms"],
        plain_ms=p_timing["plain_ms"],
        bound_ms=p_timing["bound_ms"],
        bound_by=p_timing["bound_by"],
        library_ms=None,  # no single PyTorch call computes this search
    ), dict(
        name="shard_candidate",
        route="cuda",
        source="kubernetes_tpu_torch/csrc/shard_candidate.cu",
        replaces="kubernetes_tpu/ops/pallas_solver.py:193",
        launches=m_rec["shard_kernel_launches"],
        max_abs_err=s_max_err,
        ms=s_timing["ms"],
        plain_ms=s_timing["plain_ms"],
        bound_ms=s_timing["bound_ms"],
        bound_by=s_timing["bound_by"],
        library_ms=None,  # no single PyTorch call computes this candidate
    )]
    emit("timing", build_seconds=build_s,
         total_seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
