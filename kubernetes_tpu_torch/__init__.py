"""tpu-sched on PyTorch and CUDA: the cluster scheduler's port to an
NVIDIA GPU.

The same capabilities of Kubernetes' kube-scheduler (reference:
longhao54/kubernetes ~v1.18) as ``kubernetes_tpu``, with pending pods and
the node snapshot lifted into pod x node tensors and placement solved as
a batched assignment problem -- here on torch tensors resident on the
card, with the greedy solve written by hand in CUDA C++ for Hopper
(ops/greedy_kernel.py, csrc/greedy_solve.cu):

- Filter plugins  -> vectorized feasibility masks          (ops/masks.py)
- Score plugins   -> score matrices                        (ops/scores.py)
- scheduleOne     -> the batched greedy solve              (ops/assignment.py)
- NodeInfo cache  -> incrementally-updated NodeTensor      (tensors/)

Entry points solve on the card unless the caller names the CPU
(``device="cpu"``, where each kernel's plain PyTorch version runs). The
layout mirrors ``kubernetes_tpu`` module for module; the modules of the
later slices of the port (constrained and sinkhorn solves, device
preemption, the mesh tier, streaming, partitions, tenancy, bind acks,
kubelets, controllers) are not here yet.
"""

__version__ = "0.1.0"
