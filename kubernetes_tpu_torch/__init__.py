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
plane (kubelet/, scheduler/bindack.py), the lifecycle plane
(controllers/nodelifecycle.py with drain planning through K3,
robustness/lifecycle.py), streaming arrivals with the SLO-adaptive
batcher (streaming/), multi-active partitioned scheduling
(scheduler/partition.py: several ``SchedulerApp`` stacks over one
apiserver, each owning a lease-backed slice of the nodes with its own
carry on the card) and the multi-tenant fairness plane
(scheduler/tenancy.py, controllers/quota.py: the quota gate and the
DRF solve order) included.

Tests run on the CPU against the JAX package (``python -m pytest
tests/test_torch_*.py -q``, e.g. ``tests/test_torch_partition.py`` and
``tests/test_torch_tenancy.py`` for the two planes); ``python3
chip_smoke.py`` drives the port on one NVIDIA GPU, its ``partitions``
and ``tenancy`` phases included.
"""

__version__ = "0.1.0"
