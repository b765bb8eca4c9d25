"""PyTorch/CUDA solver ops: vectorized Filter masks, Score matrices, and
batched assignment (the greedy solve is one hand-written CUDA kernel on
the card, ops/greedy_kernel.py).

This package replaces the reference's per-pod hot loops
(/root/reference/pkg/scheduler/core/generic_scheduler.go:429
findNodesThatPassFilters and :626 prioritizeNodes, both 16-goroutine
ParallelizeUntil loops) with whole-batch tensor ops: a ``[B, N]``
feasibility mask, ``[B, N]`` score matrices, and a priority-ordered
assignment scan that replays capacity updates on device so a batch never
double-books a node (SURVEY.md section 7, "hardest parts (a)").
"""

from kubernetes_tpu_torch.ops.masks import fit_mask
from kubernetes_tpu_torch.ops.scores import (
    balanced_allocation_score,
    least_allocated_score,
    most_allocated_score,
)
from kubernetes_tpu_torch.ops.assignment import GreedyConfig, greedy_assign

__all__ = [
    "fit_mask",
    "least_allocated_score",
    "most_allocated_score",
    "balanced_allocation_score",
    "GreedyConfig",
    "greedy_assign",
]
