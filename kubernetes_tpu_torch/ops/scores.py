"""Vectorized Score matrices (the Score extension point, tensorized).

Reference semantics: noderesources/resource_allocation.go:135 score base,
least_allocated.go ((cap-req)*100/cap averaged over cpu+mem, integer
floor), most_allocated.go (inverse), balanced_allocation.go:83
(100*(1-|cpuFrac-memFrac|)).

Inputs are the non-zero request aggregates (util/non_zero.go defaults:
pods with no requests still count 100m/200Mi toward these heuristics) --
``nzr`` is the node's running total, ``pod_nzr`` the incoming pod's.

Integer floor divisions are evaluated in float32 with a +1e-4 epsilon
before flooring: exact for every realistic quantity (relative f32 error
~1e-7 over scores bounded by 100) without needing int64 on device. The
node total and the pod's request are summed in int32 BEFORE the cast to
float32 (the sum is exact; casting each addend first rounds twice once
memKiB passes 2^24). Every op below is a separate elementwise kernel, so
no multiply-add is ever contracted into an FMA: the arithmetic is
bit-identical on the CPU, on the card, and in the hand-written solver
kernel (csrc/greedy_solve.cu), which spells out the same rounding.
"""

from __future__ import annotations

import torch

MAX_NODE_SCORE = 100.0
_EPS = 1e-4


def _fractions(
    caps: torch.Tensor,  # [N, 2] int32 (milliCPU, memKiB)
    nzr: torch.Tensor,  # [N, 2] int32
    pod_nzr: torch.Tensor,  # [B, 2] int32
):
    """Returns (req [B, N, 2], cap [1, N, 2]) float32: the summed
    requested magnitudes (node total + incoming pod) and broadcastable
    capacities. Division happens in each scorer."""
    req = nzr[None, :, :] + pod_nzr[:, None, :]
    cap = caps[None, :, :].to(torch.float32)
    return req.to(torch.float32), cap


def _half_sum_floor(per_dim: torch.Tensor) -> torch.Tensor:
    """floor((dim0 + dim1) / 2 + eps), summed in the order dim0 + dim1."""
    return torch.floor((per_dim[..., 0] + per_dim[..., 1]) / 2.0 + _EPS)


def least_allocated_score(caps, nzr, pod_nzr) -> torch.Tensor:
    """[B, N] float32 in [0, 100]."""
    req, cap = _fractions(caps, nzr, pod_nzr)
    raw = torch.floor(
        (cap - req) * MAX_NODE_SCORE / torch.clamp(cap, min=1.0) + _EPS
    )
    per_dim = torch.where((cap == 0) | (req > cap), 0.0, raw)
    return _half_sum_floor(per_dim)


def most_allocated_score(caps, nzr, pod_nzr) -> torch.Tensor:
    """[B, N] float32 in [0, 100]."""
    req, cap = _fractions(caps, nzr, pod_nzr)
    raw = torch.floor(
        req * MAX_NODE_SCORE / torch.clamp(cap, min=1.0) + _EPS
    )
    per_dim = torch.where((cap == 0) | (req > cap), 0.0, raw)
    return _half_sum_floor(per_dim)


def balanced_allocation_score(caps, nzr, pod_nzr) -> torch.Tensor:
    """[B, N] float32 in [0, 100]."""
    req, cap = _fractions(caps, nzr, pod_nzr)
    frac = torch.where(cap == 0, 1.0, req / torch.clamp(cap, min=1.0))
    cpu_frac = frac[..., 0]
    mem_frac = frac[..., 1]
    diff = torch.abs(cpu_frac - mem_frac)
    # epsilon guards the equal-fractions case against f32 rounding; the
    # oracle's float64 truncation artifacts can still differ by at most 1
    score = torch.trunc((1.0 - diff) * MAX_NODE_SCORE + _EPS)
    return torch.where((cpu_frac >= 1.0) | (mem_frac >= 1.0), 0.0, score)
