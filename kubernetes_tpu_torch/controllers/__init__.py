"""Controllers: the reconcile loops the scheduler depends on.

Reference: the reference Kubernetes tree, cmd/kube-controller-manager/app/
controllermanager.go:372 (controller list). The disruption controller
maintains PDB.Status.DisruptionsAllowed, the budget preemption spends
(generic_scheduler.go:885-887); the node-lifecycle loop taints nodes
whose heartbeat lapsed and evicts their pods; the drainer cordons and
drains nodes, paced by the same budget, or drains by a plan of the
victim search; the quota controller charges, refunds and reconciles
each namespace's ResourceQuota at the scheduling gate and wakes the
pods it parked (armed by ``scheduler.tenancy.arm_tenancy`` or a
``tenancy:`` config block).

Tests on the CPU: ``python -m pytest tests/test_torch_tenancy.py -q``
holds the quota ledger against the JAX package's.
"""

from kubernetes_tpu_torch.controllers.disruption import DisruptionController
from kubernetes_tpu_torch.controllers.nodelifecycle import (
    NodeDrainer,
    NodeLifecycleController,
)
from kubernetes_tpu_torch.controllers.quota import QuotaController

__all__ = [
    "DisruptionController",
    "NodeDrainer",
    "NodeLifecycleController",
    "QuotaController",
]
