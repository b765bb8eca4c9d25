"""Cache debugger: on-demand state dump + cache-vs-apiserver comparison.

Reference: /root/reference/pkg/scheduler/internal/cache/debugger/
(debugger.go:29 CacheDebugger, signal.go:25 SIGUSR2 listener, dumper.go:39
DumpAll, comparer.go CompareNodes/ComparePods) -- the reference's runtime
consistency checker for scheduler state.

The TPU build adds a tensor checksum comparison: the packed NodeTensor is
re-derived from a fresh snapshot and diffed against the cached one,
catching drift in the incremental row-repack path (the device-side
analogue of the cache comparer).
"""

from __future__ import annotations

import logging
import signal
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


class CacheDumper:
    """dumper.go:39 DumpAll."""

    def __init__(self, cache, queue) -> None:
        self.cache = cache
        self.queue = queue

    def dump_all(self) -> str:
        lines = ["Dump of cached NodeInfo:"]
        for name, pods in sorted(self.cache.dump().items()):
            lines.append(f"  node {name}: pods={sorted(pods)}")
        lines.append("Dump of scheduling queue:")
        for pod in self.queue.pending_pods():
            lines.append(f"  {pod.key()} priority={pod.spec.priority}")
        text = "\n".join(lines)
        logger.info("%s", text)
        return text


class CacheComparer:
    """comparer.go: diff cache/queue against the apiserver view."""

    def __init__(self, client, cache, queue) -> None:
        self.client = client
        self.cache = cache
        self.queue = queue

    def compare(self) -> Dict[str, List[str]]:
        """Returns {missed_nodes, redundant_nodes, missed_pods,
        redundant_pods} -- empty lists mean consistent."""
        nodes, _ = self.client.list_nodes()
        pods, _ = self.client.list_pods()
        cached = self.cache.dump()  # node -> [pod keys]

        api_nodes = {n.metadata.name for n in nodes}
        cache_nodes = set(cached)
        # scheduled pods only; pending ones live in the queue
        api_pods = {p.key() for p in pods if p.spec.node_name}
        queued = {p.key() for p in self.queue.pending_pods()}
        cache_pods = {key for pod_keys in cached.values() for key in pod_keys}

        result = {
            "missed_nodes": sorted(api_nodes - cache_nodes),
            "redundant_nodes": sorted(cache_nodes - api_nodes),
            "missed_pods": sorted(api_pods - cache_pods - queued),
            "redundant_pods": sorted(cache_pods - api_pods),
        }
        for k, v in result.items():
            if v:
                logger.warning("cache comparer: %s = %s", k, v)
        return result


class TensorComparer:
    """TPU addition: verify the incremental NodeTensor equals a from-
    scratch repack of the same snapshot."""

    def __init__(self, tensor_cache, snapshot) -> None:
        self.tensor_cache = tensor_cache
        self.snapshot = snapshot

    def compare(self) -> List[str]:
        from kubernetes_tpu_torch.tensors import NodeTensorCache

        incremental = self.tensor_cache.update(self.snapshot)
        fresh = NodeTensorCache(
            dims=self.tensor_cache.dims,
            topology_encoder=self.tensor_cache.topology,
        ).update(self.snapshot)
        problems = []
        # compare per NAME: the incremental tensor's slot layout (free
        # rows, claimed headroom) legitimately orders rows differently
        # from a from-scratch pack of the same snapshot
        live = sorted(n for n in incremental.names if n)
        if live != sorted(fresh.names):
            problems.append("node membership mismatch")
        else:
            inc_rows = np.asarray(
                [incremental.row(n) for n in live], dtype=np.int64
            )
            fr_rows = np.asarray(
                [fresh.row(n) for n in live], dtype=np.int64
            )
            for field in ("allocatable", "requested", "non_zero_requested"):
                a = getattr(incremental, field)[inc_rows]
                b = getattr(fresh, field)[fr_rows]
                if not np.array_equal(a, b):
                    rows = np.where((a != b).any(axis=1))[0]
                    problems.append(
                        f"{field} mismatch on rows "
                        f"{[live[r] for r in rows[:5]]}"
                    )
        for p in problems:
            logger.warning("tensor comparer: %s", p)
        return problems


class CacheDebugger:
    """debugger.go:29 + signal.go:25: SIGUSR2 triggers compare + dump."""

    def __init__(
        self, client, cache, queue, tensor_cache=None, snapshot=None
    ) -> None:
        self.dumper = CacheDumper(cache, queue)
        self.comparer = CacheComparer(client, cache, queue)
        self.tensor_comparer = (
            TensorComparer(tensor_cache, snapshot)
            if tensor_cache is not None and snapshot is not None
            else None
        )

    def on_signal(self, signum=None, frame=None) -> None:
        self.comparer.compare()
        if self.tensor_comparer is not None:
            self.tensor_comparer.compare()
        self.dumper.dump_all()

    def listen_for_signal(self) -> None:
        signal.signal(signal.SIGUSR2, self.on_signal)
