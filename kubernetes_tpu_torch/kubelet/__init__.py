"""Node agents.

Reference: pkg/kubelet/ is the real agent; pkg/kubemark/hollow_kubelet.go
is the fake one the reference uses to scale-test a 5k-node control plane
on small hardware (SURVEY.md layer 7 / layer 10). This build ships the
hollow variant: it acknowledges bindings and reports status without
running containers, completing the control loop
(bind -> kubelet observes -> pod Running) and providing the churn
substrate for the perf harness.
"""

from kubernetes_tpu_torch.kubelet.fleet import FleetConfig, HollowNodeFleet
from kubernetes_tpu_torch.kubelet.hollow import HollowKubelet, HollowNodePool

__all__ = ["FleetConfig", "HollowKubelet", "HollowNodeFleet", "HollowNodePool"]
