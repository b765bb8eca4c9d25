"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface. It is
compiled by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-fmad=false -shared`` at first use into ``build/kernels/`` at the root
of the checkout (listed in .gitignore) and loaded with ctypes. The
library's file name carries a hash of the source, every header beside
it and the flags, so an edited source never loads a stale build.
Nothing here runs nvcc at import.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)


class KernelError(RuntimeError):
    """A kernel did not build, load or launch. Never caught on the
    solve path: a card whose kernel cannot run must fail loudly, not
    degrade to another solver."""


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise KernelError("nvcc not found: the CUDA toolkit is required")
    return path


def build_library(name: str) -> Tuple[ctypes.CDLL, dict]:
    """Compile ``csrc/<name>.cu`` (unless this source hash is already
    built) and load it. Returns (library, {"seconds", "command", "log",
    "library"}); raises KernelError when nvcc fails."""
    source = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    log = ""
    cmd = []
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelError(
                f"nvcc failed ({proc.returncode}) building {source}:\n{log}"
            )
        os.replace(tmp, so)  # atomic publish
    lib = ctypes.CDLL(so)
    info = dict(
        seconds=time.perf_counter() - t0, command=cmd, log=log, library=so
    )
    return lib, info


def check_tensor(t, name: str, dtype, shape, device):
    """The kernel's operand contract: on ``device``, of ``dtype`` and
    ``shape``; returns a contiguous view (or copy)."""
    if t.device != device:
        raise KernelError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    return t.contiguous()
