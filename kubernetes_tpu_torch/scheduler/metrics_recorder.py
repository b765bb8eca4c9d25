"""MetricsRecorder: plugs the framework runtime into the metric set.

Reference: pkg/scheduler/framework/v1alpha1/metrics_recorder.go (the
reference buffers and flushes asynchronously; host-side observation here
is cheap enough to record inline) and the 10% sampling of
plugin_execution_duration (scheduler.go:57 pluginMetricsSamplePercent).
"""

from __future__ import annotations

import random
from kubernetes_tpu_torch.utils import metrics

PLUGIN_METRICS_SAMPLE_PERCENT = 10  # scheduler.go:57


class MetricsRecorder:
    def __init__(self, rng: random.Random = None) -> None:
        self.rng = rng or random.Random()

    def observe_plugin_duration(
        self, plugin: str, extension_point: str, seconds: float
    ) -> None:
        if self.rng.randrange(100) >= PLUGIN_METRICS_SAMPLE_PERCENT:
            return
        metrics.plugin_execution_duration.observe(
            seconds,
            plugin=plugin,
            extension_point=extension_point,
            status="Success",
        )

    def observe_extension_point(
        self, extension_point: str, seconds: float, status: str = "Success"
    ) -> None:
        metrics.framework_extension_point_duration.observe(
            seconds, extension_point=extension_point, status=status
        )
