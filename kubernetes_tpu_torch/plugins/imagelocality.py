"""ImageLocality score
(reference framework/plugins/imagelocality/image_locality.go)."""

from __future__ import annotations

from typing import Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.framework.interface import CycleState, MAX_NODE_SCORE, Plugin, Status

MB = 1024 * 1024
MIN_THRESHOLD = 23 * MB  # image_locality.go:33
MAX_THRESHOLD = 1000 * MB  # image_locality.go:35


class ImageLocality(Plugin):
    NAME = "ImageLocality"

    def __init__(self, handle=None) -> None:
        self.handle = handle

    def score(
        self, state: CycleState, pod: Pod, node_name: str
    ) -> Tuple[int, Optional[Status]]:
        snapshot = state.read("__snapshot__")
        ni = snapshot.get_node_info(node_name)
        if ni is None or ni.node is None:
            return 0, Status.error(f"node {node_name} not in snapshot")
        total_nodes = snapshot.num_nodes()
        image_counts = snapshot.image_num_nodes()
        # image spread factor: images on many nodes contribute more
        # (image_locality.go:76 scaledImageScore).
        score_sum = 0.0
        for container in pod.spec.containers:
            size = ni.image_states.get(container.image)
            if size is None:
                continue
            spread = image_counts.get(container.image, 0) / total_nodes if total_nodes else 0.0
            score_sum += size * spread
        return self._calculate_priority(score_sum), None

    @staticmethod
    def _calculate_priority(sum_scores: float) -> int:
        """image_locality.go:60 calculatePriority."""
        if sum_scores < MIN_THRESHOLD:
            sum_scores = MIN_THRESHOLD
        elif sum_scores > MAX_THRESHOLD:
            sum_scores = MAX_THRESHOLD
        return int(
            MAX_NODE_SCORE * (sum_scores - MIN_THRESHOLD) / (MAX_THRESHOLD - MIN_THRESHOLD)
        )
