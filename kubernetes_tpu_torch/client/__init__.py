"""Client layer: typed client + informer machinery.

Reference: /root/reference/staging/src/k8s.io/client-go/ (clientsets,
Reflector tools/cache/reflector.go:49, SharedInformerFactory). The
scheduler's entire input plane.
"""

from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import Informer, InformerFactory, ResourceEventHandler

__all__ = ["Client", "Informer", "InformerFactory", "ResourceEventHandler"]
