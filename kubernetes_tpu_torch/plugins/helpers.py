"""Shared scoring helpers."""

from __future__ import annotations

from typing import List

from kubernetes_tpu_torch.framework.interface import MAX_NODE_SCORE, NodeScore


def default_normalize_score(
    max_priority: int, reverse: bool, scores: List[NodeScore]
) -> None:
    """Reference pkg/scheduler/framework/plugins/helper/normalize_score.go:
    scale to [0, max_priority] by the max raw score; optionally reverse."""
    max_count = max((ns.score for ns in scores), default=0)
    if max_count == 0:
        if reverse:
            for ns in scores:
                ns.score = max_priority
        return
    for ns in scores:
        s = max_priority * ns.score // max_count
        ns.score = (max_priority - s) if reverse else s
