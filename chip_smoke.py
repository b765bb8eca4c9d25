#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure exits non-zero, and the final
line is printed only when every phase passed):

1. ``device``: the card's name and power limit (nvidia-smi), torch and
   CUDA versions.
2. ``build``: builds the greedy-solve kernel (K1) from
   kubernetes_tpu_torch/csrc/ with nvcc; prints the seconds and ptxas's
   register report.
3. ``kernel_vs_twin``: K1 against its plain PyTorch version on the card,
   on seeded inputs at the burst's full shape (B=4,096 pods, N=5,632 node
   rows, R=4, U=8 mask rows) and at R=6 with scalar dims, with all-zero
   pods, over-committed and invalid rows and inactive padding. The
   tolerance is zero: assignments, requested' and nzr' must be
   bit-equal. Times the kernel with CUDA events after a warmup launch,
   and the plain version with the host clock.
4. ``burst``: the main path end to end through the port's entry points,
   as bench.py builds it: APIServer, Client, InformerFactory,
   new_scheduler(batch=True, max_batch=4096) on the card, 5,000 nodes
   (32 CPU, 64Gi, 110 pods), warmup() and a warm burst, then 10,000 pods
   of 250m/512Mi. Asserts every pod binds, no node exceeds capacity,
   every burst batch solved on the "cuda" tier with K1's launch count
   moving and no fallback of any kind, and that the placements equal a
   replay of the burst's batches, in solve order, through the numpy
   host_greedy_assign from the post-warmup cluster state. Prints pods/s,
   p50/p99 pod-to-bind and the per-stage seconds.
5. ``kernels``: every ported kernel with its launches in the burst, its
   time per launch, its plain version's time and its bound.

Then the card's name and power limit as nvidia-smi prints them, and the
last line: {"ok": true, "device": {...}}. Needs a CUDA device; exits
non-zero without one.
"""

import json
import os
import subprocess
import sys
import threading
import time

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


def kernel_vs_twin(gk, asg_mod, cfg_cls):
    cases = [
        ("burst_r4", 0, BURST_SHAPE, cfg_cls()),
        ("burst_r4_most_allocated", 1, BURST_SHAPE, cfg_cls(0, 0, 1)),
        ("scalar_r6", 2, dict(BURST_SHAPE, r=6), cfg_cls()),
    ]
    timing = None
    max_err = 0.0
    for name, seed, shape, cfg in cases:
        host = random_problem(seed, **shape)
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
        )
        emit("kernel_vs_twin", **rec)
        if not all(equal):
            raise AssertionError(f"kernel disagrees with its twin on {name}")
        if name == "burst_r4":
            timing = rec
    return timing, max_err


# -- phase 4: the burst -------------------------------------------------------

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


def burst(gk, device=None):
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
        client, informers, batch=True, max_batch=MAX_BATCH, device=device
    )
    tier = "cuda" if device is None else "torch"  # the CPU is for rehearsal
    if sched.device.type != ("cuda" if device is None else device):
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
        constrained_not_ported=sched.constrained_not_ported,
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
    gk.launches = 0  # the count of THIS run of the main path
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
        constrained_not_ported=sched.constrained_not_ported,
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
    if tier == "cuda" and launches <= 0:
        raise AssertionError("the burst never launched the greedy kernel")
    if any(v for k, v in moved.items() if k != "carry_divergences"):
        raise AssertionError(f"a fallback counter moved: {moved}")
    if any(p["tier"] != tier for p in dispatched):
        raise AssertionError("a burst dispatch was solved off the card")

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
    emit("burst", **rec)
    return rec


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    from kubernetes_tpu_torch.ops import assignment as asg_mod
    from kubernetes_tpu_torch.ops import greedy_kernel as gk

    smi = nvidia_smi_line()
    emit(
        "device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
    )
    t0 = time.perf_counter()
    gk.build()
    ptxas = [
        line.strip() for line in gk.last_build.get("log", "").splitlines()
        if "registers" in line or "spill" in line
    ]
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas,
         library=os.path.relpath(gk.last_build["library"]))

    timing, max_err = kernel_vs_twin(gk, asg_mod, asg_mod.GreedyConfig)
    rec = burst(gk)
    kernels = [dict(
        name="greedy_solve",
        route="cuda",
        source="kubernetes_tpu_torch/csrc/greedy_solve.cu",
        replaces="kubernetes_tpu/ops/pallas_solver.py:123",
        launches=rec["greedy_kernel_launches"],
        max_abs_err=max_err,
        ms=timing["ms"],
        plain_ms=timing["plain_ms"],
        bound_ms=timing["bound_ms"],
        bound_by=timing["bound_by"],
        library_ms=None,  # no single PyTorch call computes this solve
    )]
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
