"""K3: the preemption victim search as ONE hand-written CUDA kernel for
Hopper.

Replaces ``kubernetes_tpu/ops/pallas_preempt.py::_preempt_kernel`` (entry
``pallas_preempt_solve``) and computes the function of the JAX package's
XLA wave kernel (``ops/preemption.py::_preempt_batch_kernel`` with
``_device_pick``), PDB budgets and pre-existing nominations included.
The source is ``csrc/preempt_solve.cu``; its header says what bounds the
kernel on the card and what the one-block design leaves on the table.
The plain PyTorch version is ``ops/preemption.preempt_batch_plain``:
``preempt_solve`` takes it only for tensors that lie on the CPU. A
tensor on the card launches the kernel or raises.

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
from typing import Tuple

import torch

from kubernetes_tpu_torch.ops.kernel_build import (
    KernelError,
    build_library,
    check_tensor,
)
from kubernetes_tpu_torch.ops.preemption import preempt_batch_plain

__all__ = ["KernelError", "build", "preempt_solve", "preempt_solve_cuda"]

#: times the kernel library was built (or loaded) in this process --
#: the cache watchdog's "compile" count
builds = 0
#: kernel launches: incremented where the kernel is launched, nowhere else
launches = 0
#: what the last build did: {"seconds", "command", "log", "library"}
last_build: dict = {}

#: int32 words of one node's pick key (csrc/preempt_solve.cu PickKey)
_KEY_WORDS = 8

_lib = None
_lib_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (once per process and source hash) and load the kernel
    library. Raises KernelError when nvcc fails."""
    global _lib, builds
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib, info = build_library("preempt_solve")
        fn = lib.preempt_solve_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 25 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
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
    global launches
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
    # scratch: each node's working state, PDB budgets, masks
    # (victims, violating victims, PDB-violating) and pick key
    work = torch.empty((n, r), dtype=i32, device=device)
    budgets = torch.empty((n, max(p, 1)), dtype=i32, device=device)
    masks = torch.empty((n, 3 * w), dtype=i32, device=device)
    keys = torch.empty((n, _KEY_WORDS), dtype=i32, device=device)
    lib = build()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.preempt_solve_launch(
            *(t.data_ptr() for t in operands),
            chosen.data_ptr(), vwords.data_ptr(), violwords.data_ptr(),
            nviol.data_ptr(), state_out.data_ptr(),
            work.data_ptr(), budgets.data_ptr(), masks.data_ptr(),
            keys.data_ptr(),
            n, v, r, p, m, b, u,
            stream,
        )
    if err != 0:
        raise KernelError(f"preempt_solve_kernel launch failed: cudaError {err}")
    launches += 1
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
