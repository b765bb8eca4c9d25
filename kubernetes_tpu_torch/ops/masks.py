"""Vectorized feasibility masks (the Filter extension point, tensorized).

Reference semantics: noderesources/fit.go:181 fitsRequest. This is the
batched [B, N] form of the solver's per-step ``_fits``
(ops/assignment.py) and shares it, so the exact zero-request semantics
(only scalar/extended dimensions skip when unrequested; fixed dimensions
check strictly; an all-zero request still checks the pod-count slot)
stay in ONE place.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops.assignment import _fits


def fit_mask(
    allocatable: torch.Tensor,  # [N, R] int32
    requested: torch.Tensor,  # [N, R] int32
    pod_requests: torch.Tensor,  # [B, R] int32 (col PODS == 1)
    valid: torch.Tensor,  # [N] bool
) -> torch.Tensor:
    """[B, N] bool: True where the pod fits the node's free resources."""
    free = allocatable - requested  # [N, R]
    if pod_requests.shape[0] == 0:
        return torch.zeros(
            (0, allocatable.shape[0]), dtype=torch.bool,
            device=allocatable.device,
        )
    per_pod = torch.stack([_fits(free, req) for req in pod_requests])
    return per_pod & valid[None, :]
