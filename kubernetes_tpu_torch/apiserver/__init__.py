"""In-process API server: storage, list/watch fan-out, binding subresource.

Reference: the apiserver+etcd pair the integration tests spin up
(/root/reference/test/integration/framework/master_utils.go:332, etcd3
store at staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go, watch
fan-out at storage/cacher/cacher.go:238). The control plane's only durable
state lives here; the scheduler holds soft state only and resumes by
re-list+watch, exactly like the reference.
"""

from kubernetes_tpu_torch.apiserver.server import APIServer, Conflict, NotFound, WatchEvent

__all__ = ["APIServer", "Conflict", "NotFound", "WatchEvent"]
