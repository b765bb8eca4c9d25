from kubernetes_tpu_torch.config.types import (
    KubeSchedulerConfiguration,
    KubeSchedulerProfile,
    Plugin as PluginRef,
    PluginSet,
    Plugins,
)

__all__ = [
    "KubeSchedulerConfiguration",
    "KubeSchedulerProfile",
    "PluginRef",
    "PluginSet",
    "Plugins",
]
