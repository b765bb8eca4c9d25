"""Plugin registry (reference framework/v1alpha1/registry.go:50).

``Registry`` maps plugin name -> factory(args, handle) -> Plugin. ``merge``
is the out-of-tree injection point (registry.go:73) through which the TPU
profile's plugins are added without touching the in-tree set.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from kubernetes_tpu_torch.framework.interface import Plugin

# factory(args: Optional[dict], handle: FrameworkHandle) -> Plugin
PluginFactory = Callable[[Optional[dict], Any], Plugin]


class Registry(Dict[str, PluginFactory]):
    def register(self, name: str, factory: PluginFactory) -> None:
        if name in self:
            raise ValueError(f"a plugin named {name} already exists")
        self[name] = factory

    def unregister(self, name: str) -> None:
        if name not in self:
            raise ValueError(f"no plugin named {name} exists")
        del self[name]

    def merge(self, other: Optional["Registry"]) -> None:
        """Reference registry.go:73 Merge: duplicate names are an error."""
        if not other:
            return
        for name, factory in other.items():
            self.register(name, factory)
