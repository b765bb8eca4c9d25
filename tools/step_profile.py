#!/usr/bin/env python3
"""Where a pod step of the cluster kernels K1, K2 and K3 spends its cycles.

    python3 tools/step_profile.py

Needs one CUDA card. Builds K1 (csrc/greedy_solve.cu), K2
(csrc/constrained_solve.cu) and K3 (csrc/preempt_solve.cu) a second time
with -DSOLVE_STEP_PROFILE, which turns on the STEP_MARK counters of
csrc/solve_common.cuh: thread 0 of CTA 0 adds the clock64 cycles between
consecutive marks to one counter per phase (K3's "owner rebuild" is
added by the chosen node's owner warp instead). Runs each kernel once at
chip_smoke.py's shapes (K1: the burst's random batch and its homogeneous
batch, B=4,096, N=5,632, and ChurnSinkhorn/50000's batch, B=1,024,
N=50,048, through the greedy entry and through the scored entry on its
sinkhorn prior; K2: the constrained batch, B=1,024 with 1,000
active, N=5,632, with all three families and with each alone; K3: the
Preemption/5000 wave, 1,032 active pods on 5,000 nodes, and its
four-PDB case), after one warm launch, and prints
one JSON line per case: the card, the kernel's ms with the counters on
and off (their cost), the clock rate the counters imply, and the cycles
per active pod step of each phase. A phase that ends in a barrier also
holds thread 0's wait there for the slowest thread of the cluster.
"""

import ctypes
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from kubernetes_tpu_torch.ops import assignment as asg  # noqa: E402
from kubernetes_tpu_torch.ops import constrained_kernel as ck  # noqa: E402
from kubernetes_tpu_torch.ops import greedy_kernel as gk  # noqa: E402
from kubernetes_tpu_torch.ops import kernel_build  # noqa: E402
from kubernetes_tpu_torch.ops import preempt_kernel as pk  # noqa: E402

K1_PHASES = ["chunk staging", "bump and parameters", "scoring own rows",
             "cluster step"]
K2_PHASES = ["loop", "CTA barrier 1", "recounts and slot minima", "pass 1",
             "warp fold", "CTA barrier 2", "CTA fold and publish",
             "cluster barrier 1", "normaliser fold and pass 2",
             "cluster barrier 2 and pick", "replay"]
K3_PHASES = ["parameters, class build and exchange", "pick",
             "thread 0's rebuilds", "owner rebuild"]


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile(mod, symbol, fn, steps, phases):
    """ms with the counters on, and the cycles per step of each phase."""
    lib = mod.build()
    read = getattr(lib, symbol)
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    counters = (ctypes.c_ulonglong * 16)()
    fn()
    torch.cuda.synchronize()
    read(counters)  # zero them after the warm launch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if read(counters) != 0:
        raise RuntimeError(f"reading {symbol} failed")
    cycles = np.array(list(counters)[:len(phases)], dtype=np.float64)
    return ms, dict(
        ghz_implied=float(cycles.sum() / (ms * 1e6)),
        cycles_per_step={
            name: float(c / steps) for name, c in zip(phases, cycles)
        },
    )


def cases():
    host = chip_smoke.random_problem(0, **chip_smoke.BURST_SHAPE)
    homog = chip_smoke.homogeneous_problem(**chip_smoke.BURST_SHAPE)
    k1 = []
    for name, h in (("burst_r4", host), ("burst_homogeneous", homog)):
        dev = [torch.from_numpy(a).cuda() for a in h]
        k1.append((name, int(h[8].sum()),
                   lambda dev=dev: gk.greedy_solve_cuda(*dev)))
    churn = chip_smoke.churned_problem(0, **chip_smoke.CHURN_SHAPE)
    dev = [torch.from_numpy(a).cuda() for a in churn]
    prior = asg.sinkhorn_prior(*dev)
    k1.append(("churn_sinkhorn_50000_greedy", int(churn[8].sum()),
               lambda dev=dev: gk.greedy_solve_cuda(*dev)))
    k1.append(("churn_sinkhorn_50000_scored", int(churn[8].sum()),
               lambda dev=dev: gk.greedy_solve_cuda(*dev, prior=prior)))
    common, fams, noops = chip_smoke.constrained_problem(7)
    dev_common = [
        torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in common
    ]
    k2 = []
    for name, live in (("all_live_rows", (0, 1, 2)), ("spread_alone", (0,)),
                       ("affinity_alone", (1,)), ("scoring_alone", (2,))):
        case = tuple(fams[k] if k in live else noops[k] for k in range(3))
        rows = ck.live_rows(*(fams[k] if k in live else None for k in range(3)))
        dev = [
            tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in f)
            for f in case
        ]
        k2.append((name, int(common[8].sum()),
                   lambda dev=dev, rows=rows: ck.constrained_solve_cuda(
                       *dev_common, *dev, rows=rows)))
    k3 = []
    for name, kw in (("preemption5000_wave", dict(seed=0)),
                     ("pdbs", dict(seed=2, b=512, classes=True, p=4))):
        h = chip_smoke.preempt_problem(**kw)
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in h]
        k3.append((name, int(h[15].sum()),
                   lambda dev=dev: pk.preempt_solve_cuda(*dev)))
    return k1, k2, k3


def main():
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device is visible", file=sys.stderr)
        return 2
    smi = chip_smoke.nvidia_smi_line()
    k1, k2, k3 = cases()
    plain = {}
    for mod, runs in ((gk, k1), (ck, k2), (pk, k3)):
        mod.build()
        for name, _steps, fn in runs:
            plain[name] = time_ms(fn)
    kernel_build.NVCC_FLAGS = kernel_build.NVCC_FLAGS + ("-DSOLVE_STEP_PROFILE",)
    for mod, symbol, runs, phases in (
        (gk, "greedy_solve_step_cycles", k1, K1_PHASES),
        (ck, "constrained_solve_step_cycles", k2, K2_PHASES),
        (pk, "preempt_solve_step_cycles", k3, K3_PHASES),
    ):
        mod._lib = None  # rebuild with the counters on
        mod._admitted.clear()
        for name, steps, fn in runs:
            ms, rec = profile(mod, symbol, fn, steps, phases)
            print(json.dumps(dict(
                kernel=mod.__name__.rsplit(".", 1)[-1], case=name,
                nvidia_smi=smi, active_pods=steps, ms_counters_off=plain[name],
                ms_counters_on=ms,
                us_per_step_counters_off=plain[name] * 1e3 / steps, **rec,
            )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
