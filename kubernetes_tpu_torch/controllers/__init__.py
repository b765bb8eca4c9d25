"""Controllers: the reconcile loops the scheduler depends on.

Reference: the reference Kubernetes tree, cmd/kube-controller-manager/app/
controllermanager.go:372 (controller list). Only the disruption
controller is here so far: it maintains PDB.Status.DisruptionsAllowed,
the budget preemption spends (generic_scheduler.go:885-887). The
node-lifecycle and quota loops arrive with the control-plane slice.
"""

from kubernetes_tpu_torch.controllers.disruption import DisruptionController

__all__ = ["DisruptionController"]
