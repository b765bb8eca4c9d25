"""K3: the preemption victim search as ONE hand-written CUDA kernel for
Hopper, launched as one thread-block cluster.

Replaces ``kubernetes_tpu/ops/pallas_preempt.py::_preempt_kernel`` (entry
``pallas_preempt_solve``) and computes the function of the JAX package's
XLA wave kernel (``ops/preemption.py::_preempt_batch_kernel`` with
``_device_pick``), PDB budgets and pre-existing nominations included.
The source is ``csrc/preempt_solve.cu``; its header says what bounds the
kernel on the card and how its cluster works. The plain PyTorch version
is ``ops/preemption.preempt_batch_plain``: ``preempt_solve`` takes it
only for tensors that lie on the CPU. A tensor on the card launches the
kernel or raises.

Each launch is one cluster planned by ``plan_for`` (``ops/cluster_plan``):
the largest cluster the card admits, each CTA's node slice (its state,
victims, PDB bits and pick keys) resident in shared memory when it fits,
in a device-memory scratch layout otherwise.

The TPU kernel serves only waves without PDBs and with at most 32
victims per node, in 512-pod chunks over power-of-two padded shapes.
K3 takes N, V, R, P (PDBs), M (nominations), U and B at run time: one
build serves every wave, and no wave is routed anywhere else.

Build: ``ops/kernel_build.build_library`` (nvcc for ``sm_90a`` into a
library with a plain C interface, loaded with ctypes, at first use).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from kubernetes_tpu_torch.ops.cluster_plan import (
    MAX_THREADS,
    LaunchPlan,
    card_admits,
    choose_plan,
    plan_launch,
)
from kubernetes_tpu_torch.ops.kernel_build import (
    KernelError,
    build_library,
    check_tensor,
)
from kubernetes_tpu_torch.ops.preemption import preempt_batch_plain

__all__ = [
    "KernelError", "MAX_DIMS", "MAX_VICTIMS", "build", "fixed_words", "node_words",
    "plan_for", "preempt_solve", "preempt_solve_cuda",
]


#: most resource dims K3 takes (csrc/preempt_solve.cu kMaxDims: a node's
#: dims live two to a lane of one warp)
MAX_DIMS = 64
#: victim slots per node K3 takes: below 2^16, the packed pick key holds
#: the victim counts in 16 bits
MAX_VICTIMS = (1 << 16) - 1
_CHUNK = 32  # pods staged at once (solve_common.cuh kChunk)


def node_words(r: int, v: int, p: int) -> int:
    """int32 words of one node in a CTA's layout (csrc/preempt_solve.cu
    node_words): alloc, carry and nomination addend (R each), victim
    priorities and starts (V each), victim requests (R x V), active bits
    (W), PDB match bits (ceil(V * P / 32)), budgets (P), the three victim
    masks (3W), the candidate bit and the 6-word packed pick key."""
    w = -(-v // 32)
    return 3 * r + 2 * v + r * v + w + -(-(v * p) // 32) + p + 3 * w + 1 + 6


def fixed_words(r: int) -> int:
    """int32 words every CTA stages: the class's request and a chunk's
    pod flags, priorities and candidate rows (csrc/preempt_solve.cu
    fixed_words)."""
    return r + 3 * _CHUNK


def plan_for(n: int, r: int, v: int, p: int, cluster: int,
             static_bytes: int = 0) -> LaunchPlan:
    """K3's launch plan for N nodes of R dims with V victim slots and P
    PDBs on at most ``cluster`` CTAs. Every CTA stages the fixed words;
    a resident slice adds its whole layout at an odd stride, and the
    streaming side keeps the layout in the device-memory scratch, whose
    nodes the warps walk there, so a node of any size plans
    (csrc/preempt_solve.cu dynamic_smem_bytes). Every CTA runs
    ``MAX_THREADS`` threads: its warps build the keys, one node each,
    whatever the slice's length. Raises KernelError above ``MAX_DIMS``
    dims or ``MAX_VICTIMS`` victim slots, the kernel's widths."""
    if r > MAX_DIMS or v > MAX_VICTIMS:
        raise KernelError(
            f"K3 takes at most {MAX_DIMS} resource dims and {MAX_VICTIMS} "
            f"victim slots, got {r} and {v}"
        )
    return plan_launch(
        n, cluster, node_bytes=4 * node_words(r, v, p),
        fixed_bytes=4 * fixed_words(r), static_bytes=static_bytes,
        min_threads=MAX_THREADS, odd_stride=True,
    )


#: times the kernel library was built (or loaded) in this process --
#: the cache watchdog's "compile" count
builds = 0
#: kernel launches: incremented where the kernel is launched, nowhere else
launches = 0
#: what the last build did: {"seconds", "command", "log", "library"}
last_build: dict = {}
#: the plan of the last launch
last_plan: Optional[LaunchPlan] = None

_lib = None
_lib_lock = threading.Lock()
#: the count is bumped from every partitioned stack's committer
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
        lib, info = build_library("preempt_solve")
        fn = lib.preempt_solve_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 11 + [
            ctypes.c_void_p
        ]
        lib.preempt_solve_max_clusters.restype = ctypes.c_int
        lib.preempt_solve_max_clusters.argtypes = [ctypes.c_int] * 4
        lib.preempt_solve_static_smem.restype = ctypes.c_int
        lib.preempt_solve_static_smem.argtypes = [ctypes.c_int]
        lib.preempt_solve_node_words.restype = ctypes.c_int
        lib.preempt_solve_node_words.argtypes = [ctypes.c_int] * 3
        lib.preempt_solve_fixed_words.restype = ctypes.c_int
        lib.preempt_solve_fixed_words.argtypes = [ctypes.c_int]
        static = [lib.preempt_solve_static_smem(k) for k in (0, 1)]
        if min(static) < 0:
            raise KernelError("cannot read preempt_solve's attributes")
        for shape in ((4, 16, 0), (6, 48, 4), (1, 0, 0)):
            if (lib.preempt_solve_node_words(*shape) != node_words(*shape)
                    or lib.preempt_solve_fixed_words(shape[0])
                    != fixed_words(shape[0])):
                raise KernelError("preempt_solve's node layout disagrees")
        _static_bytes = max(static)
        last_build.update(info)
        builds += 1
        _lib = lib
        return lib


def preempt_solve_cuda(
    alloc, base_requested, prio, start_rel, req, active, pdb_match,
    pdb_allowed, nom_req, nom_prio, nom_node, pods_req, pods_prio,
    cand_rows, cand_index, pods_active,
) -> Tuple[torch.Tensor, ...]:
    """Launch K3 on the current stream (no synchronize). Every operand
    must already be on the card with the dtypes of
    ``preempt_batch_plain``: int32 state, priorities and indices, float32
    start times, bool masks. Returns fresh (chosen [B] int32, victims
    [B, W] int32 words, victims_violating [B, W], num_violating [B],
    state' [N, R]), W = ceil(V/32); the inputs are never written."""
    global launches, last_plan
    device = alloc.device
    if device.type != "cuda":
        raise KernelError(f"preempt_solve_cuda needs CUDA tensors, got {device}")
    n, r = alloc.shape
    v = prio.shape[1]
    p = pdb_allowed.shape[0]
    m = nom_prio.shape[0]
    b = pods_req.shape[0]
    u = cand_rows.shape[0]
    w = -(-v // 32)
    i32, f32, bl = torch.int32, torch.float32, torch.bool

    def chk(t, name, dtype, shape):
        return check_tensor(t, name, dtype, shape, device)

    operands = [
        chk(alloc, "alloc", i32, (n, r)),
        chk(base_requested, "base_requested", i32, (n, r)),
        chk(prio, "prio", i32, (n, v)),
        chk(start_rel, "start_rel", f32, (n, v)),
        chk(req, "req", i32, (n, v, r)),
        chk(active, "active", bl, (n, v)),
        chk(pdb_match, "pdb_match", bl, (n, v, p)),
        chk(pdb_allowed, "pdb_allowed", i32, (p,)),
        chk(nom_req, "nom_req", i32, (m, r)),
        chk(nom_prio, "nom_prio", i32, (m,)),
        chk(nom_node, "nom_node", i32, (m,)),
        chk(pods_req, "pods_req", i32, (b, r)),
        chk(pods_prio, "pods_prio", i32, (b,)),
        chk(cand_rows, "cand_rows", bl, (u, n)),
        chk(cand_index, "cand_index", i32, (b,)),
        chk(pods_active, "pods_active", bl, (b,)),
    ]
    chosen = torch.empty(b, dtype=i32, device=device)
    vwords = torch.empty((b, w), dtype=i32, device=device)
    violwords = torch.empty((b, w), dtype=i32, device=device)
    nviol = torch.empty(b, dtype=i32, device=device)
    state_out = torch.empty((n, r), dtype=i32, device=device)
    if b == 0 or n == 0 or u == 0:
        # nothing can be placed: no candidate row, node or pod
        chosen.fill_(-1)
        vwords.zero_()
        violwords.zero_()
        nviol.zero_()
        state_out.copy_(base_requested)
        return chosen, vwords, violwords, nviol, state_out
    lib = build()
    with torch.cuda.device(device):
        plan = choose_plan(
            lambda c: plan_for(n, r, v, p, c, _static_bytes),
            card_admits(lib.preempt_solve_max_clusters, _admitted,
                        torch.cuda.current_device()),
        )
        # the streaming side's layouts: one region per CTA
        stride = -(-n // plan.cluster) | 1
        scratch = torch.empty(
            0 if plan.resident else plan.cluster * stride * node_words(r, v, p),
            dtype=i32, device=device,
        )
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.preempt_solve_launch(
            *(t.data_ptr() for t in operands),
            chosen.data_ptr(), vwords.data_ptr(), violwords.data_ptr(),
            nviol.data_ptr(), state_out.data_ptr(),
            scratch.data_ptr() if scratch.numel() else None,
            n, v, r, p, m, b, u,
            plan.cluster, plan.threads, int(plan.resident), plan.smem_bytes,
            stream,
        )
    if err != 0:
        raise KernelError(f"preempt_solve_kernel launch failed: cudaError {err}")
    with _count_lock:
        launches += 1
    last_plan = plan
    return chosen, vwords, violwords, nviol, state_out


def preempt_solve(
    alloc, base_requested, prio, start_rel, req, active, pdb_match,
    pdb_allowed, nom_req, nom_prio, nom_node, pods_req, pods_prio,
    cand_rows, cand_index, pods_active,
):
    """The wave's victim search: K3 for tensors on the card, the plain
    version for tensors on the CPU, an error otherwise."""
    args = (
        alloc, base_requested, prio, start_rel, req, active, pdb_match,
        pdb_allowed, nom_req, nom_prio, nom_node, pods_req, pods_prio,
        cand_rows, cand_index, pods_active,
    )
    kind = alloc.device.type
    if kind == "cuda":
        return preempt_solve_cuda(*args)
    if kind == "cpu":
        return preempt_batch_plain(*args)
    raise KernelError(f"no victim search for device type {kind!r}")
