"""Hard topology spread on the device path, on the CPU, in both packages.

Twins of the 8 cases of ``tests/test_topology.py``: the spread pack
(``ops/topology.pack_spread_batch``), the spread scan
(``ops/assignment.greedy_assign_spread``, a plain torch loop in the
port, an XLA scan in the JAX package) with its within-batch count
replay, the batch scheduler spreading on the device path end to end, and
the multi-key eligibility rule. Each case builds the same cluster with
each package's own objects and requires the packs to be equal array for
array, the scans equal in assignment, requested', nzr' and the final
group counts, and the end-to-end placements equal pod for pod; then it
holds the port to the reference test's own checks. Tolerance: exact
(every value is an integer).
"""

import importlib
import random
import time
from types import SimpleNamespace

import numpy as np
import torch

import jax.numpy as jnp

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}
SPREAD_FIELDS = ("group_counts", "value_valid", "node_value", "pod_groups",
                 "pod_max_skew", "pod_self", "pod_match")


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        APIServer=m("apiserver.server").APIServer,
        Client=m("client.client").Client,
        InformerFactory=m("client.informer").InformerFactory,
        new_snapshot=m("cache.snapshot").new_snapshot,
        greedy_assign_spread=m("ops.assignment").greedy_assign_spread,
        pack_spread_batch=m("ops.topology").pack_spread_batch,
        new_scheduler=m("scheduler.scheduler").new_scheduler,
        NodeTensorCache=m("tensors").NodeTensorCache,
        pack_pod_batch=m("tensors").pack_pod_batch,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


SIDES = [_side("torch"), _side("jax")]


def _zone_cluster(s):
    return [
        s.make_node(name).labels(zone=zone)
        .capacity(cpu="16", memory="32Gi").obj()
        for name, zone in (("n1a", "z1"), ("n1b", "z1"), ("n2a", "z2"),
                           ("n2b", "z2"))
    ]


def _spread_pod(s, name, ts):
    return (
        s.make_pod(name).labels(app="web").creation_timestamp(ts)
        .container(cpu="500m", memory="512Mi")
        .spread_constraint(1, "zone", match_labels={"app": "web"})
        .obj()
    )


def _same_spread(packs):
    """Both packages' spread packs: equal field for field (or both None)."""
    port, ref = packs
    assert (port is None) == (ref is None)
    if port is not None:
        for f in SPREAD_FIELDS:
            assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    return port


def _scan(s, nt, batch, order, sp, static):
    conv = jnp.asarray if s.pkg == "jax" else torch.from_numpy
    b = batch.size
    args = (
        nt.allocatable, nt.requested, nt.non_zero_requested, nt.valid,
        batch.requests[order], batch.non_zero_requests[order], static,
        np.ones(b, dtype=bool),
    ) + tuple(getattr(sp, f) for f in SPREAD_FIELDS)
    out = s.greedy_assign_spread(
        *(conv(np.ascontiguousarray(a)) for a in args))
    return tuple(np.asarray(o) for o in out)


def _same_scan(build):
    """``build(s)`` -> (nt, batch, order, spread pack) in each package;
    the two scans must agree in all four outputs. Returns the port's
    outputs, tensor and pack."""
    outs = []
    for s in SIDES:
        nt, batch, order, sp = build(s)
        static = np.ones((batch.size, nt.capacity), dtype=bool)
        outs.append((_scan(s, nt, batch, order, sp, static), nt, sp))
    for g, w in zip(outs[0][0], outs[1][0]):
        assert np.array_equal(g, w)
    _same_spread([outs[0][2], outs[1][2]])
    return outs[0]


# -- TestPackSpreadBatch ------------------------------------------------------


def test_initial_counts_and_groups():
    packs = []
    for s in SIDES:
        existing = [
            s.make_pod("e1").node("n1a").labels(app="web").obj(),
            s.make_pod("e2").node("n1b").labels(app="web").obj(),
            s.make_pod("e3").node("n2a").labels(app="other").obj(),
        ]
        snap = s.new_snapshot(existing, _zone_cluster(s))
        nt = s.NodeTensorCache().update(snap)
        pods = [_spread_pod(s, "p0", 0.0), _spread_pod(s, "p1", 1.0)]
        packs.append(s.pack_spread_batch(pods, snap, nt))
    sp = _same_spread(packs)
    assert sp is not None
    # one group (default, zone, app=web): z1 holds 2 matches, z2 none
    assert sorted(sp.group_counts[0][sp.value_valid[0]].tolist()) == [0, 2]
    assert sp.pod_groups[0, 0] == sp.pod_groups[1, 0] == 0
    assert sp.pod_self[:, 0].all()
    assert sp.pod_match[:, 0].all()


def test_node_selector_combo_scopes_the_group():
    packs, nts, nodes = [], [], None
    for s in SIDES:
        nodes = _zone_cluster(s)
        for i, nd in enumerate(nodes):
            nd.metadata.labels["pool"] = "x" if i % 2 == 0 else "y"
        snap = s.new_snapshot([], nodes)
        nt = s.NodeTensorCache().update(snap)
        pod = (
            s.make_pod("p").labels(app="web")
            .spread_constraint(1, "zone", match_labels={"app": "web"})
            .node_selector(pool="x").obj()
        )
        packs.append(s.pack_spread_batch([pod], snap, nt))
        nts.append(nt)
    sp = _same_spread(packs)
    assert sp is not None
    g = int(sp.pod_groups[0, 0])
    # out-of-scope (pool=y) nodes carry -1 in the group's value row
    for nd in nodes:
        v = int(sp.node_value[g, nts[0].row(nd.metadata.name)])
        if nd.metadata.labels["pool"] == "x":
            assert v >= 0
        else:
            assert v == -1


# -- TestSpreadScan -----------------------------------------------------------


def test_within_batch_spread_maxskew_1():
    """8 pods in one batch land 4/4 across the zones: the scan replays
    the counts between steps."""
    def build(s):
        snap = s.new_snapshot([], _zone_cluster(s))
        nt = s.NodeTensorCache().update(snap)
        pods = [_spread_pod(s, f"p{i}", float(i)) for i in range(8)]
        batch = s.pack_pod_batch(pods, nt.dims)
        order = batch.order
        sp = s.pack_spread_batch([pods[int(i)] for i in order], snap, nt)
        return nt, batch, order, sp

    (assignments, _, _, counts), nt, sp = _same_scan(build)
    assert (assignments >= 0).all()
    zone_of = {0: "z1", 1: "z1", 2: "z2", 3: "z2"}
    by_zone = {"z1": 0, "z2": 0}
    for a in assignments:
        by_zone[zone_of[int(a)]] += 1
    assert by_zone == {"z1": 4, "z2": 4}
    assert sorted(counts[0][sp.value_valid[0]].tolist()) == [4, 4]


def test_skew_blocks_overloaded_zone():
    """z1 holds 3 matching pods, z2 none: a maxSkew=1 pod lands in z2."""
    def build(s):
        existing = [s.make_pod(f"e{i}").node("n1a").labels(app="web").obj()
                    for i in range(3)]
        snap = s.new_snapshot(existing, _zone_cluster(s))
        nt = s.NodeTensorCache().update(snap)
        pods = [_spread_pod(s, "p", 0.0)]
        batch = s.pack_pod_batch(pods, nt.dims)
        return nt, batch, np.arange(1), s.pack_spread_batch(pods, snap, nt)

    (assignments, _, _, _), nt, _ = _same_scan(build)
    assert nt.names[int(assignments[0])] in ("n2a", "n2b")


# -- TestEndToEndDeviceSpread -------------------------------------------------


def _e2e(s):
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    sched = s.new_scheduler(client, informers, batch=True, max_batch=64,
                            rng=random.Random(0), **s.kw)
    try:
        for n in _zone_cluster(s):
            client.create_node(n)
        informers.start()
        informers.wait_for_cache_sync()
        for i in range(12):
            client.create_pod(_spread_pod(s, f"w{i}", float(i)))
        sched.start()
        deadline = time.time() + 20
        while time.time() < deadline:
            if all(p.spec.node_name for p in client.list_pods()[0]):
                break
            time.sleep(0.05)
        sched.wait_for_inflight_binds()
        placed = {p.metadata.name: p.spec.node_name
                  for p in client.list_pods()[0]}
        return placed, sched.pods_fallback, sched.pods_solved_on_device
    finally:
        sched.stop()
        informers.stop()


def test_batch_scheduler_spreads_on_device():
    port, ref = (_e2e(s) for s in SIDES)
    assert port == ref
    placed, fallback, on_device = port
    zone_of = {"n1a": "z1", "n1b": "z1", "n2a": "z2", "n2b": "z2"}
    by_zone = {"z1": 0, "z2": 0}
    for name, node in placed.items():
        assert node, name
        by_zone[zone_of[node]] += 1
    assert by_zone == {"z1": 6, "z2": 6}
    assert fallback == 0  # every pod solved on the device path
    assert on_device >= 12


# -- TestMultiKeyEligibility --------------------------------------------------


def _multi_key_pack(nodes_of, pod_of):
    return _same_spread([
        s.pack_spread_batch([pod_of(s)], snap, s.NodeTensorCache()
                            .update(snap))
        for s in SIDES
        for snap in [s.new_snapshot([], nodes_of(s))]
    ])


def _mk_pod(s):
    return (
        s.make_pod("mk").labels(app="web")
        .container(cpu="100m", memory="128Mi")
        .spread_constraint(1, "zone", match_labels={"app": "web"})
        .spread_constraint(1, "rack", match_labels={"app": "web"})
        .obj()
    )


def test_incomplete_key_coverage_falls_back():
    # a node lacking one of the pod's keys: the batch takes the host path
    assert _multi_key_pack(lambda s: [
        s.make_node("a").labels(zone="z1", rack="r1").obj(),
        s.make_node("b").labels(zone="z2").obj(),
    ], _mk_pod) is None


def test_complete_key_coverage_packs():
    assert _multi_key_pack(lambda s: [
        s.make_node("a").labels(zone="z1", rack="r1").obj(),
        s.make_node("b").labels(zone="z2", rack="r2").obj(),
    ], _mk_pod) is not None


def test_single_key_incomplete_coverage_still_packs():
    # one distinct key: a node without it is simply ineligible
    sp = _multi_key_pack(lambda s: [
        s.make_node("a").labels(zone="z1").obj(),
        s.make_node("b").obj(),
    ], lambda s: (
        s.make_pod("sk").labels(app="web")
        .container(cpu="100m", memory="128Mi")
        .spread_constraint(1, "zone", match_labels={"app": "web"})
        .obj()
    ))
    assert sp is not None
    assert sp.node_value[0, 1] == -1
