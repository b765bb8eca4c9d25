"""Controllers: the reconcile loops the scheduler depends on.

Reference: the reference Kubernetes tree, cmd/kube-controller-manager/app/
controllermanager.go:372 (controller list). The disruption controller
maintains PDB.Status.DisruptionsAllowed, the budget preemption spends
(generic_scheduler.go:885-887); the node-lifecycle loop taints nodes
whose heartbeat lapsed and evicts their pods; the drainer cordons and
drains nodes, paced by the same budget, or drains by a plan of the
victim search. The quota loop arrives with the tenancy slice.
"""

from kubernetes_tpu_torch.controllers.disruption import DisruptionController
from kubernetes_tpu_torch.controllers.nodelifecycle import (
    NodeDrainer,
    NodeLifecycleController,
)

__all__ = ["DisruptionController", "NodeDrainer", "NodeLifecycleController"]
