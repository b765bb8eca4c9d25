"""Tensorized cluster state: the bridge from API objects to device arrays.

This is the TPU-native replacement for the reference's NodeInfo snapshot
(/root/reference/pkg/scheduler/internal/cache/snapshot.go): instead of a
list of per-node Go structs walked by 16 goroutines, cluster state is packed
into dense ``[N, R]`` integer tensors that the JAX solver
(kubernetes_tpu_torch.ops) consumes, with generation-based incremental repacking
mirroring cache.UpdateSnapshot (cache.go:203).
"""

from kubernetes_tpu_torch.tensors.node_tensor import (
    NodeTensor,
    NodeTensorCache,
    PodBatch,
    ResourceDims,
    pack_pod_batch,
)
from kubernetes_tpu_torch.tensors.encoding import StringInterner, TopologyEncoder

__all__ = [
    "NodeTensor",
    "NodeTensorCache",
    "PodBatch",
    "ResourceDims",
    "pack_pod_batch",
    "StringInterner",
    "TopologyEncoder",
]
