"""DefaultBinder bind plugin
(reference framework/plugins/defaultbinder/default_binder.go:50-61)."""

from __future__ import annotations

from typing import Optional

from kubernetes_tpu_torch.api.types import Binding, Pod
from kubernetes_tpu_torch.framework.interface import CycleState, Plugin, Status


class DefaultBinder(Plugin):
    NAME = "DefaultBinder"

    def __init__(self, handle) -> None:
        self.handle = handle

    def bind(self, state: CycleState, pod: Pod, node_name: str) -> Optional[Status]:
        client = self.handle.client_set()
        if client is None:
            return Status.error("no client available for binding")
        try:
            client.bind(
                Binding(
                    pod_namespace=pod.metadata.namespace,
                    pod_name=pod.metadata.name,
                    pod_uid=pod.metadata.uid,
                    target_node=node_name,
                )
            )
        except Exception as e:  # Conflict / NotFound -> bind failure
            return Status.error(str(e))
        return None
