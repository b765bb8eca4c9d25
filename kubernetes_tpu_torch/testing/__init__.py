from kubernetes_tpu_torch.testing.wrappers import PodWrapper, NodeWrapper, make_node, make_pod

__all__ = ["PodWrapper", "NodeWrapper", "make_node", "make_pod"]
