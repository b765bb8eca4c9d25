"""K1: the greedy batch solve as ONE hand-written CUDA kernel for Hopper.

Replaces ``kubernetes_tpu/ops/pallas_solver.py::_solver_kernel`` (entry
``pallas_greedy_solve``). The source is ``csrc/greedy_solve.cu``; its
header says what bounds the kernel on the card and what the simple
one-block design leaves on the table. The kernel's plain PyTorch version
is ``ops/assignment.greedy_assign_compact`` (the loop over pods in
``_greedy_assign_impl``): ``greedy_solve`` takes it only for tensors that
lie on the CPU. A tensor on the card launches the kernel or raises.

Build: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a
library with a plain C interface, loaded with ctypes, at first use, into
``build/kernels/`` at the root of the checkout (listed in .gitignore).
The library's file name carries a hash of the source, so an edited
source never loads a stale build. Nothing here runs nvcc at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Tuple

import torch

from kubernetes_tpu_torch.ops.assignment import (
    GreedyConfig,
    greedy_assign_compact,
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "greedy_solve.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

#: times the kernel library was built (or loaded) in this process --
#: the cache watchdog's "compile" count
builds = 0
#: kernel launches: incremented where the kernel is launched, nowhere else
launches = 0
#: what the last build did: {"seconds", "command", "log"}
last_build: dict = {}

_lib = None
_lib_lock = threading.Lock()


class KernelError(RuntimeError):
    """The kernel did not build, load or launch. Never caught on the
    solve path: a card whose kernel cannot run must fail loudly, not
    degrade to another solver."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA toolkit is required")
    return path


def build() -> ctypes.CDLL:
    """Compile (once per process and source hash) and load the kernel
    library. Raises KernelError when nvcc fails."""
    global _lib, builds
    with _lib_lock:
        if _lib is not None:
            return _lib
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
        os.makedirs(BUILD_DIR, exist_ok=True)
        so = os.path.join(BUILD_DIR, f"libgreedy_solve_{digest}.so")
        t0 = time.perf_counter()
        log = ""
        cmd = []
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise KernelError(
                    f"nvcc failed ({proc.returncode}) building "
                    f"{SOURCE}:\n{log}"
                )
            os.replace(tmp, so)  # atomic publish
        lib = ctypes.CDLL(so)
        fn = lib.greedy_solve_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p
        ]
        last_build.update(
            seconds=time.perf_counter() - t0, command=cmd, log=log,
            library=so,
        )
        builds += 1
        _lib = lib
        return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    if t.device != device:
        raise KernelError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    return t.contiguous()


def greedy_solve_cuda(
    allocatable, requested, nzr, valid, pod_requests, pod_nzr,
    mask_rows, mask_index, active, config: GreedyConfig = GreedyConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream (no synchronize). Every
    operand must already be on the card with the kernel's dtypes: int32
    state and indices, bool masks. Returns fresh (assignment [B] int32,
    requested' [N, R], nzr' [N, 2]); the inputs are never written."""
    global launches
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
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.greedy_solve_launch(
            *(t.data_ptr() for t in ops),
            asg.data_ptr(), req_out.data_ptr(), nzr_out.data_ptr(),
            n, r, b, u,
            int(config.least_allocated_weight),
            int(config.balanced_allocation_weight),
            int(config.most_allocated_weight),
            stream,
        )
    if err != 0:
        raise KernelError(f"greedy_solve_kernel launch failed: cudaError {err}")
    launches += 1
    return asg, req_out, nzr_out


def greedy_solve(
    allocatable, requested, nzr, valid, pod_requests, pod_nzr,
    mask_rows, mask_index, active, config: GreedyConfig = GreedyConfig(),
):
    """Drop-in for greedy_assign_compact: the kernel for tensors on the
    card, the plain version for tensors on the CPU, an error otherwise."""
    kind = allocatable.device.type
    if kind == "cuda":
        return greedy_solve_cuda(
            allocatable, requested, nzr, valid, pod_requests, pod_nzr,
            mask_rows, mask_index, active, config=config,
        )
    if kind == "cpu":
        return greedy_assign_compact(
            allocatable, requested, nzr, valid, pod_requests, pod_nzr,
            mask_rows, mask_index, active, config=config,
        )
    raise KernelError(f"no greedy solver for device type {kind!r}")

