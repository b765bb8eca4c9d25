"""The cluster and the pods of a configuration, twice: as the program's
API objects, and as the plain reference sees them.

A configuration file states the nodes (count, capacity, zones), the
pods bound during set-up, the measured pod and the scheduler's
settings. ``--seed`` permutes the order in which the nodes are created,
which sets the rows of the scheduler's resident state and so which node
wins a tie; it changes no shape.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from portbench.reference.scheduler import (
    FLOAT32, Arithmetic, Cluster, PodSpec, Spread, zone_domains,
)

_BINARY = {"Ki": 2 ** 10, "Mi": 2 ** 20, "Gi": 2 ** 30, "Ti": 2 ** 40}
_DECIMAL = {"k": 10 ** 3, "M": 10 ** 6, "G": 10 ** 9, "T": 10 ** 12}


def parse_bytes(q: str) -> int:
    m = re.fullmatch(r"(\d+)([KMGT]i|[kMGT])?", str(q))
    if m is None:
        raise ValueError(f"not a byte quantity: {q!r}")
    mult = _BINARY.get(m.group(2)) or _DECIMAL.get(m.group(2)) or 1
    return int(m.group(1)) * mult


def parse_milli_cpu(q: str) -> int:
    s = str(q)
    if s.endswith("m"):
        return int(s[:-1])
    return int(round(float(s) * 1000))


def node_order(config: Dict[str, Any], seed: int) -> List[int]:
    """Node indices in creation order: a permutation drawn from the seed."""
    n = int(config["nodes"]["count"])
    return [int(i) for i in np.random.default_rng(seed).permutation(n)]


def node_name(i: int) -> str:
    return f"node-{i}"


def node_zone(config: Dict[str, Any], i: int) -> Optional[str]:
    """Node ``i``'s zone, or None where the configuration labels no zones."""
    zones = int(config["nodes"].get("zones", 0))
    return f"zone-{i % zones}" if zones else None


def pod_spec(template: Dict[str, Any]) -> PodSpec:
    """A pod template of a configuration, as the reference reads it."""
    spread = tuple(
        Spread(int(s["max_skew"]), s["topology_key"],
               tuple(sorted(s["match_labels"].items())))
        for s in template.get("spread", [])
    )
    return PodSpec(
        req=(parse_milli_cpu(template["cpu"]),
             math.ceil(parse_bytes(template["memory"]) / 1024), 0, 1),
        labels=tuple(sorted(template.get("labels", {}).items())),
        spread=spread,
    )


def reference_cluster(config: Dict[str, Any], order: Sequence[int],
                      arithmetic: Arithmetic = FLOAT32) -> Cluster:
    """The empty cluster in row (creation) order."""
    nodes = config["nodes"]
    row = [parse_milli_cpu(nodes["cpu"]),
           parse_bytes(nodes["memory"]) // 1024, 0, int(nodes["pods"])]
    alloc = np.array([row] * len(order), dtype=np.int64)
    domains = {}
    if nodes.get("zones"):
        domains[nodes["zone_label"]] = zone_domains(
            [node_zone(config, i) for i in order])
    return Cluster(alloc, domains, arithmetic)


def reference_setup(config: Dict[str, Any], order: Sequence[int],
                    arithmetic: Arithmetic = FLOAT32) -> Cluster:
    """The cluster once set-up's pods are bound, worked out by placing
    them in creation order."""
    cluster = reference_cluster(config, order, arithmetic)
    setup = config["setup_pods"]
    spec = pod_spec(setup)
    for _ in range(int(setup["count"])):
        cluster.place(spec)
    return cluster


# -- the program's objects (imported only where a run builds them) ------

def make_node(config: Dict[str, Any], i: int):
    from kubernetes_tpu_torch.testing import make_node as wrap

    nodes = config["nodes"]
    w = wrap(node_name(i)).capacity(
        cpu=nodes["cpu"], memory=nodes["memory"], pods=int(nodes["pods"]))
    zone = node_zone(config, i)
    if zone is not None:
        w.label(nodes["zone_label"], zone)
    return w.obj()


def make_pod(template: Dict[str, Any], name: str):
    from kubernetes_tpu_torch.testing import make_pod as wrap

    w = wrap(name).container(cpu=template["cpu"], memory=template["memory"])
    if template.get("labels"):
        w.labels(**template["labels"])
    for s in template.get("spread", []):
        w.spread_constraint(
            max_skew=int(s["max_skew"]), topology_key=s["topology_key"],
            when_unsatisfiable="DoNotSchedule",
            match_labels=dict(s["match_labels"]),
        )
    return w.obj()


class PodMaker:
    """Pods of one template, as ``make_pod`` builds them, with the
    template's quantities parsed once: the wrapper parses them for every
    pod, which costs the client five times the time the rest of the
    object does, and the client shares the scheduler's interpreter."""

    def __init__(self, template: Dict[str, Any]):
        from kubernetes_tpu_torch.api.types import (
            Container, ResourceRequirements,
        )
        from kubernetes_tpu_torch.testing import make_pod as wrap

        self._wrap = wrap
        self._container_type = Container
        self._requirements = ResourceRequirements
        proto = make_pod(template, "prototype")
        self._container = proto.spec.containers[0]
        self._labels = dict(template.get("labels", {}))
        self._spread = list(template.get("spread", []))

    def __call__(self, name: str):
        c = self._container
        w = self._wrap(name)
        w.pod.spec.containers.append(self._container_type(
            name=c.name, image=c.image,
            resources=self._requirements(
                requests=dict(c.resources.requests),
                limits=dict(c.resources.limits)),
            ports=[],
        ))
        if self._labels:
            w.labels(**self._labels)
        for sp in self._spread:
            w.spread_constraint(
                max_skew=int(sp["max_skew"]), topology_key=sp["topology_key"],
                when_unsatisfiable="DoNotSchedule",
                match_labels=dict(sp["match_labels"]),
            )
        return w.obj()
