"""tpu-sched on PyTorch and CUDA: the cluster scheduler's port to an
NVIDIA GPU.

The same capabilities of Kubernetes' kube-scheduler (reference:
longhao54/kubernetes ~v1.18) as ``kubernetes_tpu``, with pending pods and
the node snapshot lifted into pod x node tensors and placement solved as
a batched assignment problem -- here on torch tensors resident on the
card, with every solve kernel written by hand in CUDA C++ for Hopper
(csrc/): the greedy solve and its scored entry for the sinkhorn mode's
commit scan (K1), the constrained solve (K2), the preemption victim
search (K3) and the mesh tier's shard candidate (K4):

- Filter plugins  -> vectorized feasibility masks          (ops/masks.py)
- Score plugins   -> score matrices                        (ops/scores.py)
- scheduleOne     -> the batched greedy solve              (ops/assignment.py)
- NodeInfo cache  -> incrementally-updated NodeTensor      (tensors/)

Entry points solve on the card unless the caller names the CPU
(``device="cpu"``, where each kernel's plain PyTorch version runs). The
layout mirrors ``kubernetes_tpu`` module for module, the hollow-node
plane (kubelet/, scheduler/bindack.py) included; not here yet: drain
planning and the node-lifecycle controller, streaming, partitions,
tenancy and the quota controller, and the lifecycle chaos plane
(robustness/lifecycle.py).
"""

__version__ = "0.1.0"
