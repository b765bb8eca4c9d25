"""K1: the greedy batch solve as ONE hand-written CUDA kernel for Hopper.

Replaces ``kubernetes_tpu/ops/pallas_solver.py::_solver_kernel`` (entry
``pallas_greedy_solve``). The source is ``csrc/greedy_solve.cu``; its
header says what bounds the kernel on the card and how its thread-block
cluster works. The kernel's plain PyTorch version is
``ops/assignment.greedy_assign_compact`` (the loop over pods in
``_greedy_assign_impl``): ``greedy_solve`` takes it only for tensors that
lie on the CPU. A tensor on the card launches the kernel or raises.

The scored entry (``greedy_solve(..., prior=)``) is the same kernel with
a ``[B, N]`` float32 prior added to every feasible row's score: the
sinkhorn mode's commit scan (the JAX package's ``sinkhorn_assign`` runs it
as an XLA scan, not a Pallas kernel). Its plain version is
``ops/assignment.sinkhorn_commit``; its launches are counted apart, in
``scored_launches``.

Each launch is one cluster planned by ``plan_for`` (``ops/cluster_plan``):
the largest cluster the card admits, and the node slices resident in
shared memory when they fit, streamed from device memory otherwise.

Build: ``ops/kernel_build.build_library`` (nvcc for ``sm_90a`` into a
library with a plain C interface, loaded with ctypes, at first use).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from kubernetes_tpu_torch.ops.assignment import (
    GreedyConfig,
    greedy_assign_compact,
)
from kubernetes_tpu_torch.ops.cluster_plan import (
    LaunchPlan,
    card_admits,
    choose_plan,
    plan_launch,
)
from kubernetes_tpu_torch.ops.kernel_build import (
    KernelError,
    build_library,
    check_tensor as _check,
)

__all__ = [
    "KernelError", "build", "greedy_solve", "greedy_solve_cuda", "plan_for",
]

_CHUNK = 32  # pods staged at once (csrc/greedy_solve.cu kChunk)


def plan_for(n: int, r: int, cluster: int, static_bytes: int = 0) -> LaunchPlan:
    """K1's launch plan for N rows of R dims on at most ``cluster`` CTAs.
    A resident row holds alloc, req and nzr and one word of mask bits;
    every CTA stages a chunk's pod requests, nzr, mask rows and flags
    (csrc/solve_common.cuh greedy_smem_bytes)."""
    return plan_launch(
        n, cluster, node_bytes=4 * (2 * r + 3),
        fixed_bytes=4 * _CHUNK * (r + 4), static_bytes=static_bytes,
    )

#: times the kernel library was built (or loaded) in this process --
#: the cache watchdog's "compile" count
builds = 0
#: kernel launches: incremented where the kernel is launched, nowhere else
launches = 0
#: launches of the scored entry (a prior operand), counted apart
scored_launches = 0
#: what the last build did: {"seconds", "command", "log", "library"}
last_build: dict = {}
#: the plan of the last launch
last_plan: Optional[LaunchPlan] = None

_lib = None
_lib_lock = threading.Lock()
#: the counts are bumped from every partitioned stack's dispatcher
_count_lock = threading.Lock()
_static_bytes = 0
#: clusters the card holds at once, per planned shape
_admitted: dict = {}


def build() -> ctypes.CDLL:
    """Compile (once per process and source hash) and load the kernel
    library. Raises KernelError when nvcc fails."""
    global _lib, builds, _static_bytes
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = build_library("greedy_solve")
        fn = lib.greedy_solve_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p
        ]
        lib.greedy_solve_max_clusters.restype = ctypes.c_int
        lib.greedy_solve_max_clusters.argtypes = [ctypes.c_int] * 5
        lib.greedy_solve_static_smem.restype = ctypes.c_int
        lib.greedy_solve_static_smem.argtypes = [ctypes.c_int]
        static = [lib.greedy_solve_static_smem(k) for k in (0, 1)]
        if min(static) < 0:
            raise KernelError("cannot read greedy_solve's attributes")
        _static_bytes = max(static)
        last_build.update(info)
        builds += 1
        _lib = lib
        return lib


def _check_prior(prior, b: int, n: int, device):
    """The scored entry's prior: [B, N] float32 on the solve's device."""
    return _check(prior, "prior", torch.float32, (b, n), device)


def greedy_solve_cuda(
    allocatable, requested, nzr, valid, pod_requests, pod_nzr,
    mask_rows, mask_index, active, config: GreedyConfig = GreedyConfig(),
    prior=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream (no synchronize). Every
    operand must already be on the card with the kernel's dtypes: int32
    state and indices, bool masks, a float32 ``prior`` [B, N] for the
    scored entry. Returns fresh (assignment [B] int32, requested' [N, R],
    nzr' [N, 2]); the inputs are never written."""
    global launches, scored_launches, last_plan
    device = allocatable.device
    if device.type != "cuda":
        raise KernelError(f"greedy_solve_cuda needs CUDA tensors, got {device}")
    n, r = allocatable.shape
    b = pod_requests.shape[0]
    u = mask_rows.shape[0]
    i32, bl = torch.int32, torch.bool
    ops = [
        _check(allocatable, "allocatable", i32, (n, r), device),
        _check(requested, "requested", i32, (n, r), device),
        _check(nzr, "nzr", i32, (n, 2), device),
        _check(valid, "valid", bl, (n,), device),
        _check(pod_requests, "pod_requests", i32, (b, r), device),
        _check(pod_nzr, "pod_nzr", i32, (b, 2), device),
        _check(mask_rows, "mask_rows", bl, (u, n), device),
        _check(mask_index, "mask_index", i32, (b,), device),
        _check(active, "active", bl, (b,), device),
    ]
    scored = prior is not None
    if scored:
        prior = _check_prior(prior, b, n, device)
    asg = torch.empty(b, dtype=i32, device=device)
    req_out = torch.empty((n, r), dtype=i32, device=device)
    nzr_out = torch.empty((n, 2), dtype=i32, device=device)
    if b == 0 or n == 0 or u == 0:
        asg.fill_(-1)
        req_out.copy_(requested)
        nzr_out.copy_(nzr)
        return asg, req_out, nzr_out
    lib = build()
    with torch.cuda.device(device):
        plan = _plan(lib, n, r, scored)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.greedy_solve_launch(
            *(t.data_ptr() for t in ops),
            asg.data_ptr(), req_out.data_ptr(), nzr_out.data_ptr(),
            prior.data_ptr() if scored else None,
            n, r, b, u,
            int(config.least_allocated_weight),
            int(config.balanced_allocation_weight),
            int(config.most_allocated_weight),
            plan.cluster, plan.threads, int(plan.resident), plan.smem_bytes,
            stream,
        )
    if err != 0:
        entry = "scored entry" if scored else "kernel"
        raise KernelError(f"greedy_solve {entry} launch failed: cudaError {err}")
    with _count_lock:
        if scored:
            scored_launches += 1
        else:
            launches += 1
    last_plan = plan
    return asg, req_out, nzr_out


def _plan(lib, n: int, r: int, scored: bool = False) -> LaunchPlan:
    """The plan at the largest cluster the current card admits."""

    def max_clusters(cluster, threads, smem, resident):
        return lib.greedy_solve_max_clusters(
            cluster, threads, smem, resident, int(scored)
        )

    return choose_plan(
        lambda c: plan_for(n, r, c, _static_bytes),
        card_admits(max_clusters, _admitted.setdefault(scored, {}),
                    torch.cuda.current_device()),
    )


def greedy_solve(
    allocatable, requested, nzr, valid, pod_requests, pod_nzr,
    mask_rows, mask_index, active, config: GreedyConfig = GreedyConfig(),
    prior=None,
):
    """Drop-in for greedy_assign_compact: the kernel for tensors on the
    card, the plain version for tensors on the CPU, an error otherwise.
    With ``prior`` ([B, N] float32 on the same device) the scored entry:
    the kernel's scored launch on the card, the plain loop with the prior
    (``sinkhorn_commit``) on the CPU."""
    kind = allocatable.device.type
    if kind == "cuda":
        return greedy_solve_cuda(
            allocatable, requested, nzr, valid, pod_requests, pod_nzr,
            mask_rows, mask_index, active, config=config, prior=prior,
        )
    if kind == "cpu":
        if prior is not None:
            prior = _check_prior(
                prior, pod_requests.shape[0], allocatable.shape[0],
                allocatable.device,
            )
        return greedy_assign_compact(
            allocatable, requested, nzr, valid, pod_requests, pod_nzr,
            mask_rows, mask_index, active, config=config, prior=prior,
        )
    raise KernelError(f"no greedy solver for device type {kind!r}")

