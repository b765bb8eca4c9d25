"""Typed client over the in-process API server (clientset equivalent)."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import (
    Binding,
    Node,
    Pod,
    PodDisruptionBudget,
    PodGroup,
)
from kubernetes_tpu_torch.apiserver.server import APIServer


class Client:
    def __init__(self, server: APIServer):
        self._server = server

    # pods
    def create_pod(self, pod: Pod) -> Pod:
        return self._server.create(pod)

    def create_pods_bulk(self, pods: List[Pod]) -> List[Pod]:
        """One store transaction + one watch fan-out for a pod burst."""
        return self._server.create_bulk(pods)

    def get_pod(self, namespace: str, name: str) -> Pod:
        return self._server.get("Pod", namespace, name)

    def list_pods(self) -> Tuple[List[Pod], int]:
        return self._server.list("Pod")

    def update_pod(self, pod: Pod, expect_rv: Optional[int] = None) -> Pod:
        return self._server.update(pod, expect_rv)

    def delete_pod(self, namespace: str, name: str) -> Pod:
        return self._server.delete("Pod", namespace, name)

    def delete_pods_bulk(
        self, keys: List[Tuple[str, str]], missing_out=None
    ) -> int:
        """One transaction deleting many pods (preemption evicts whole
        victim sets); missing pods are skipped (reported via
        ``missing_out`` when given)."""
        if missing_out is not None:
            return self._server.delete_bulk(
                "Pod", keys, missing_out=missing_out
            )
        return self._server.delete_bulk("Pod", keys)

    def bind(self, binding: Binding, binder: str = None) -> Pod:
        """POST pods/<name>/binding (reference default_binder.go:50).
        ``binder`` identifies the committing stack for the partitioned
        control plane's server-side fence."""
        return self._server.bind(binding, binder=binder)

    def bind_bulk(self, bindings: List[Binding], binder: str = None):
        """One transaction committing a whole solver batch; returns a
        (pod, error) pair per binding."""
        return self._server.bind_bulk(bindings, binder=binder)

    def bind_assumed_bulk(self, assumed_pods: List[Pod], binder: str = None):
        """Allocation-free bulk bind from assumed clones; returns only
        the failed slots as (index, error)."""
        return self._server.bind_assumed_bulk(assumed_pods, binder=binder)

    def update_pod_status(
        self, namespace: str, name: str, mutate: Callable[[Pod], None]
    ) -> Pod:
        return self._server.update_pod_status(namespace, name, mutate)

    def unbind_pod(
        self, namespace: str, name: str,
        expect_uid: Optional[str] = None,
        expect_node: Optional[str] = None,
    ) -> Pod:
        """Release a binding (DELETE pods/<name>/binding analogue):
        uid/node/not-yet-Running preconditions checked atomically under
        the store lock -- the rebind-after-timeout primitive."""
        return self._server.unbind(
            namespace, name, expect_uid=expect_uid, expect_node=expect_node
        )

    # nodes
    def create_node(self, node: Node) -> Node:
        return self._server.create(node)

    def get_node(self, name: str) -> Node:
        return self._server.get("Node", "", name)

    def list_nodes(self) -> Tuple[List[Node], int]:
        return self._server.list("Node")

    def update_node(self, node: Node, expect_rv: Optional[int] = None) -> Node:
        return self._server.update(node, expect_rv)

    def delete_node(self, name: str) -> Node:
        return self._server.delete("Node", "", name)

    # policy / scheduling CRDs
    def create_pdb(self, pdb: PodDisruptionBudget) -> PodDisruptionBudget:
        return self._server.create(pdb)

    def list_pdbs(self) -> Tuple[List[PodDisruptionBudget], int]:
        return self._server.list("PodDisruptionBudget")

    def update_pdb_status(
        self, namespace: str, name: str, mutate
    ) -> PodDisruptionBudget:
        """pdb/status subresource (the disruption controller's write)."""
        return self._server.guaranteed_update(
            "PodDisruptionBudget", namespace, name, mutate
        )

    def create_resource_quota(self, quota) -> object:
        return self._server.create(quota)

    def list_resource_quotas(self) -> Tuple[List[object], int]:
        return self._server.list("ResourceQuota")

    def update_resource_quota_status(
        self, namespace: str, name: str, mutate
    ) -> object:
        """resourcequotas/status subresource: the QuotaController's
        check-and-increment ledger write (atomic under guaranteed_update,
        so N admission gates contend on the same counter instead of
        double-spending a stale informer read -- the PDB
        checkAndDecrement discipline)."""
        return self._server.guaranteed_update(
            "ResourceQuota", namespace, name, mutate
        )

    def create_pod_group(self, pg: PodGroup) -> PodGroup:
        return self._server.create(pg)

    def list_pod_groups(self) -> Tuple[List[PodGroup], int]:
        return self._server.list("PodGroup")

    # storage + services (generic create/list over the object store)
    def create(self, obj) -> object:
        return self._server.create(obj)

    def list(self, kind: str) -> Tuple[List[object], int]:
        return self._server.list(kind)

    def list_events(self) -> Tuple[List[object], int]:
        return self._server.list("Event")

    @property
    def server(self):
        """The backing store (the event broadcaster writes through it)."""
        return self._server

    def get(self, kind: str, namespace: str, name: str):
        return self._server.get(kind, namespace, name)

    def update(self, obj, expect_rv: Optional[int] = None):
        return self._server.update(obj, expect_rv)

    # raw access (leases for leader election, etc.)
    @property
    def server(self) -> APIServer:
        return self._server
