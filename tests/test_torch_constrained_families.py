"""The constrained filter families, on the CPU, in both packages: host
ports, attachable-volume counts and required inter-pod (anti-)affinity.

Twins of ``tests/test_nodeports_device.py``, ``tests/
test_volume_device_differential.py`` and ``tests/
test_affinity_device.py``, under the reference's own seeds and sizes.
Every end-to-end scenario runs through the JAX package's batch
scheduler, the port's (``device="cpu"``) and the port's sequential
oracle (``batch=False``, the first of tied nodes kept): the port's batch
path places pod for pod as the JAX package's and as the oracle, and is
held to the reference test's own checks. Beside the placements, each
pod's admission record (device or host-only, and the reason) from the
port's batch scheduler equals the JAX package's. The pack-level cases
hold the port's static mask and affinity feasibility to the plugins'
Filter verdicts and to the JAX package's.

Host ports ride the static mask plus synthetic anti rows (``ops/
affinity.add_host_port_rows``); volume counts ride extra ``[N, R]``
columns; required (anti-)affinity rides the constrained solve.
"""

import copy
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as jax_types
import kubernetes_tpu_torch.api.types as port_types
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.cache.snapshot import new_snapshot as jax_snapshot
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.ops.affinity import pack_affinity_batch as jax_pack_aff
from kubernetes_tpu.ops.assignment import affinity_node_ok as jax_aff_ok
from kubernetes_tpu.ops.assignment import row_node_values as jax_row_values
from kubernetes_tpu.ops.host_masks import static_mask as jax_static_mask
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.tensors import NodeTensorCache as JaxTensorCache
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.cache.node_info import HostPortInfo, pod_host_ports
from kubernetes_tpu_torch.cache.snapshot import new_snapshot
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.framework.interface import CycleState
from kubernetes_tpu_torch.ops.affinity import pack_affinity_batch
from kubernetes_tpu_torch.ops.assignment import affinity_node_ok, row_node_values
from kubernetes_tpu_torch.ops.host_masks import static_mask
from kubernetes_tpu_torch.plugins.interpodaffinity import InterPodAffinity
from kubernetes_tpu_torch.plugins.nodeports import NodePorts
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.tensors import NodeTensorCache
from kubernetes_tpu_torch.testing import make_node, make_pod

PKG = {
    "jax": dict(server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
                new=jax_new, node=jax_node, pod=jax_pod, types=jax_types,
                kw={}),
    "torch": dict(server=APIServer, client=Client, informers=InformerFactory,
                  new=new_scheduler, node=make_node, pod=make_pod,
                  types=port_types, kw={"device": "cpu"}),
}


class _KeepFirstRng:
    """The sequential oracle keeps the first of tied nodes: the device
    argmax's lowest index."""

    def randrange(self, n):
        return 1 if n > 1 else 0

    def randint(self, a, b):
        return b


def _admission(adm):
    return adm.device_ok, adm.reason, adm.klass


def _run(pkg, build, *, batch=True, max_batch=64, pct=0, timeout=60.0):
    """One scenario through package ``pkg``'s scheduler. ``build(P,
    server, client)`` makes the cluster and returns (pods to create once
    the scheduler runs, pods already created). Waits until every pod is
    bound or carries a condition. Returns (placements of the created
    pods, the scheduler, each created pod's admission record -- batch
    only -- and every pod at the end)."""
    P = PKG[pkg]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](client, informers, batch=batch, max_batch=max_batch,
                     percentage_of_nodes_to_score=pct, rng=_KeepFirstRng(),
                     **P["kw"])
    pods, existing = build(P, server, client)
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    admissions = {
        p.metadata.name: _admission(sched.classify_pod(copy.deepcopy(p)))
        for p in pods
    } if batch else {}
    for p in pods:
        client.create_pod(p)
    sched.start()
    try:
        deadline = time.time() + timeout
        total = len(pods) + existing
        while True:
            cur, _ = client.list_pods()
            if len(cur) >= total and all(
                p.spec.node_name or p.status.conditions for p in cur
            ):
                break
            if time.time() > deadline:
                raise AssertionError(f"{pkg}: pods not decided in time")
            time.sleep(0.05)
        sched.wait_for_inflight_binds()
        every = client.list_pods()[0]
        names = {p.metadata.name for p in pods}
        placements = {
            p.metadata.name: p.spec.node_name for p in every
            if p.metadata.name in names
        }
        return placements, sched, admissions, every
    finally:
        sched.stop()
        informers.stop()


def _three_ways(build, **kw):
    """The port's batch run, held to the JAX package's batch run and to
    the port's sequential oracle. Returns the port's batch run."""
    got = _run("torch", build, **kw)
    jax = _run("jax", build, **kw)
    oracle = _run("torch", build, batch=False, **kw)
    assert got[0] == jax[0], "the port's batch placed unlike the JAX package"
    assert got[0] == oracle[0], "the port's batch placed unlike its oracle"
    assert got[2] == jax[2], "admission differs from the JAX package's"
    return got


# -- host ports (tests/test_nodeports_device.py) -------------------------------


def _port_pod(mk, name, port, ip="", proto="TCP", ts=0.0):
    w = mk(name).creation_timestamp(ts).container(
        cpu="100m", memory="128Mi", host_port=port, protocol=proto)
    if ip:
        w.pod.spec.containers[0].ports[0].host_ip = ip
    return w.obj()


def test_static_mask_matches_the_nodeports_plugin_and_the_jax_package():
    masks = {}
    for pkg, snap_fn, cache, mask_fn in (
        ("torch", new_snapshot, NodeTensorCache, static_mask),
        ("jax", jax_snapshot, JaxTensorCache, jax_static_mask),
    ):
        mk_node, mk_pod = PKG[pkg]["node"], PKG[pkg]["pod"]
        nodes = [mk_node(f"n{i}").capacity(cpu="8", memory="16Gi", pods=20)
                 .obj() for i in range(6)]
        existing = [
            _port_pod(mk_pod, "e0", 8080),
            _port_pod(mk_pod, "e1", 8080, ip="10.0.0.1"),
            _port_pod(mk_pod, "e2", 8080, proto="UDP"),
        ]
        for i, p in enumerate(existing):
            p.spec.node_name = f"n{i}"
        snap = snap_fn(existing, nodes)
        nt = cache().update(snap)
        cases = [
            _port_pod(mk_pod, "w0", 8080),
            _port_pod(mk_pod, "w1", 8080, ip="10.0.0.1"),
            _port_pod(mk_pod, "w2", 8080, ip="10.0.0.2"),
            _port_pod(mk_pod, "w3", 8080, proto="UDP"),
            _port_pod(mk_pod, "w4", 9090),
        ]
        mask = np.asarray(mask_fn(cases, snap, nt))
        masks[pkg] = np.stack([
            [bool(mask[b][nt.row(f"n{i}")]) for i in range(6)]
            for b in range(len(cases))
        ])
        if pkg == "torch":
            plugin = NodePorts()
            for b, pod in enumerate(cases):
                for ni in snap.list_node_infos():
                    want = plugin.filter(CycleState(), pod, ni) is None
                    assert masks[pkg][b][int(ni.node_name[1:])] == want
    assert np.array_equal(masks["torch"], masks["jax"])


def _port_cluster(n_nodes, ports, cpu="8", memory="16Gi", pods_cap=20):
    def build(P, server, client):
        for i in range(n_nodes):
            client.create_node(
                P["node"](f"n{i}").capacity(cpu=cpu, memory=memory,
                                            pods=pods_cap).obj()
            )
        return [_port_pod(P["pod"], f"hp{i}", *spec, ts=float(i))
                for i, spec in enumerate(ports)], 0
    return build


def _no_double_booked_port(every):
    by_node = {}
    for p in every:
        if p.spec.node_name:
            by_node.setdefault(p.spec.node_name, []).append(p)
    for node, plist in by_node.items():
        hp = HostPortInfo()
        for p in plist:
            for ip, proto, port in pod_host_ports(p):
                assert not hp.conflicts(ip, proto, port), (
                    f"{proto}:{port}@{ip} booked twice on {node}"
                )
                hp.add(ip, proto, port)


def test_host_port_pods_solve_on_the_batch_path_one_per_node():
    got, sched, adm, every = _three_ways(
        _port_cluster(8, [(8080,)] * 8)
    )
    hosts = [h for h in got.values() if h]
    assert len(hosts) == 8 and len(set(hosts)) == 8
    assert sched.pods_fallback == 0
    assert sched.pods_solved_on_device >= 8
    assert all(device_ok for device_ok, _, _ in adm.values())


def test_a_fourth_pod_is_unschedulable_when_the_ports_run_out():
    got, _, _, _ = _three_ways(_port_cluster(3, [(9000,)] * 4))
    bound = [h for h in got.values() if h]
    assert len(bound) == 3 and len(set(bound)) == 3


@pytest.mark.parametrize("seed", [0, 7, 21])
def test_a_random_port_mix_never_double_books(seed):
    # the reference's draws: port, protocol, then ip, per pod
    rng = random.Random(seed)
    ports = []
    for _ in range(24):
        port = rng.choice([8080, 8080, 9090])
        proto = rng.choice(["TCP", "TCP", "UDP"])
        ip = rng.choice(["", "", "10.0.0.1", "10.0.0.2"])
        ports.append((port, ip, proto))
    got, sched, _, every = _three_ways(
        _port_cluster(10, ports, cpu="16", memory="32Gi", pods_cap=30)
    )
    _no_double_booked_port(every)
    assert sched.pods_fallback == 0


# -- attachable-volume counts (tests/test_volume_device_differential.py) -------

VOL_NODES = 8
VOL_PODS = 20


def _volume_cluster(seed, csi_limit, with_csi_nodes):
    def build(P, server, client):
        T = P["types"]
        rng = random.Random(seed)
        for i in range(VOL_NODES):
            client.create_node(
                P["node"](f"n{i}")
                .capacity(cpu=str(8 + 2 * i), memory=f"{16 + 5 * i}Gi").obj()
            )
            if with_csi_nodes:
                server.create(T.CSINode(
                    metadata=T.ObjectMeta(name=f"n{i}", namespace=""),
                    drivers=[T.CSINodeDriver(
                        name="ebs.csi.aws.com", node_id=f"n{i}",
                        allocatable_count=csi_limit,
                    )],
                ))
        pods = []
        for i in range(VOL_PODS):
            w = (
                P["pod"](f"m{i}").creation_timestamp(float(i))
                .container(cpu=f"{rng.choice([100, 200, 400])}m",
                           memory=f"{rng.choice([128, 256])}Mi")
            )
            for k in range(rng.choice([1, 1, 2])):
                cn, vn = f"pvc-m{i}-{k}", f"pv-m{i}-{k}"
                server.create(T.PersistentVolumeClaim(
                    metadata=T.ObjectMeta(name=cn, namespace="default"),
                    volume_name=vn, requested_bytes=1 << 30,
                ))
                pv = T.PersistentVolume(
                    metadata=T.ObjectMeta(name=vn, namespace=""),
                    capacity_bytes=1 << 30,
                    claim_ref_namespace="default", claim_ref_name=cn,
                )
                if rng.random() < 0.75:
                    pv.csi_driver = "ebs.csi.aws.com"
                    pv.csi_volume_handle = vn
                else:
                    pv.aws_ebs_volume_id = vn
                server.create(pv)
                w.pvc(cn)
            pods.append(w.obj())
        return pods, 0
    return build


@pytest.mark.parametrize(
    "seed, csi_limit, with_csi_nodes, case",
    [(7, 6, True, "fits"), (23, 6, True, "fits"),
     (11, 1, True, "over_capacity"), (5, 0, False, "no_csinode")],
)
def test_volume_columns_place_as_the_oracle(seed, csi_limit, with_csi_nodes,
                                           case):
    got, sched, adm, _ = _three_ways(
        _volume_cluster(seed, csi_limit, with_csi_nodes), max_batch=32,
        timeout=120.0,
    )
    if case == "over_capacity":
        # the same pods stay unschedulable; the device's rejects were
        # re-checked on the host path
        assert any(not v for v in got.values())
        assert sched.volume_reject_retries >= 1
    else:
        assert all(got.values())
        assert sched.pods_fallback == 0
        assert all(device_ok for device_ok, _, _ in adm.values())


# -- required inter-pod (anti-)affinity (tests/test_affinity_device.py) --------

APPS = ["web", "db", "cache", "batch"]


def _random_cluster(mk_node, mk_pod, rng, num_nodes=10, num_existing=25):
    nodes = [
        mk_node(f"n{i}").labels(zone=f"z{i % 3}", rack=f"r{i % 2}")
        .capacity(cpu="16", memory="32Gi").obj()
        for i in range(num_nodes)
    ]
    existing = []
    for i in range(num_existing):
        p = (
            mk_pod(f"e{i}").node(f"n{rng.randrange(num_nodes)}")
            .labels(app=rng.choice(APPS)).container(cpu="100m", memory="128Mi")
        )
        roll = rng.random()
        if roll < 0.2:
            p = p.pod_affinity(rng.choice(["zone", "rack"]),
                               {"app": rng.choice(APPS)}, anti=True)
        elif roll < 0.3:
            p = p.pod_affinity("zone", {"app": rng.choice(APPS)})
        existing.append(p.obj())
    return existing, nodes


def _random_batch(mk_pod, rng, count=12):
    out = []
    for i in range(count):
        p = mk_pod(f"p{i}").labels(app=rng.choice(APPS)).container(
            cpu="100m", memory="128Mi")
        roll = rng.random()
        if roll < 0.35:
            p = p.pod_affinity(rng.choice(["zone", "rack"]),
                               {"app": rng.choice(APPS)})
        elif roll < 0.7:
            p = p.pod_affinity(rng.choice(["zone", "rack"]),
                               {"app": rng.choice(APPS)}, anti=True)
        if 0.3 < roll < 0.45:
            p = p.pod_affinity("rack", {"app": rng.choice(APPS)}, anti=True)
        out.append(p.obj())
    return out


def _port_feasible(af, b):
    """The port's feasibility for pod ``b`` on the initial counts."""
    t = {k: torch.as_tensor(np.asarray(getattr(af, k))) for k in (
        "node_value", "row_key_aff", "row_key_anti", "row_key_exist",
        "counts_aff", "counts_anti", "counts_exist", "pod_aff_rows",
        "pod_self_match", "pod_anti_rows", "pod_exist_match")}
    return affinity_node_ok(
        t["counts_aff"], t["counts_anti"], t["counts_exist"],
        row_node_values(t["node_value"], t["row_key_aff"]),
        row_node_values(t["node_value"], t["row_key_anti"]),
        row_node_values(t["node_value"], t["row_key_exist"]),
        t["pod_aff_rows"][b], t["pod_self_match"][b],
        t["pod_anti_rows"][b], t["pod_exist_match"][b],
    ).numpy()


def _jax_feasible(af, b):
    j = {k: jnp.asarray(np.asarray(getattr(af, k))) for k in (
        "node_value", "row_key_aff", "row_key_anti", "row_key_exist",
        "counts_aff", "counts_anti", "counts_exist", "pod_aff_rows",
        "pod_self_match", "pod_anti_rows", "pod_exist_match")}
    return np.asarray(jax_aff_ok(
        j["counts_aff"], j["counts_anti"], j["counts_exist"],
        jax_row_values(j["node_value"], j["row_key_aff"]),
        jax_row_values(j["node_value"], j["row_key_anti"]),
        jax_row_values(j["node_value"], j["row_key_exist"]),
        j["pod_aff_rows"][b], j["pod_self_match"][b],
        j["pod_anti_rows"][b], j["pod_exist_match"][b],
    ))


def _oracle_feasible(pod, snapshot):
    plugin = InterPodAffinity()
    state = CycleState()
    state.write("__snapshot__", snapshot)
    plugin.pre_filter(state, pod)
    return {
        ni.node_name: plugin.filter(state, pod, ni) is None
        for ni in snapshot.list_node_infos()
    }


def _packs(make):
    """The same scenario packed by both packages: ``make(mk_node, mk_pod)``
    returns (existing, nodes, batch). Yields (batch, snap, nt, port pack,
    JAX pack, JAX tensor cache)."""
    ex, nodes, batch = make(make_node, make_pod)
    snap = new_snapshot(ex, nodes)
    nt = NodeTensorCache().update(snap)
    jex, jnodes, jbatch = make(jax_node, jax_pod)
    jsnap = jax_snapshot(jex, jnodes)
    jnt = JaxTensorCache().update(jsnap)
    af = pack_affinity_batch(batch, snap, nt)
    jaf = jax_pack_aff(jbatch, jsnap, jnt)
    assert af is not None and jaf is not None
    return batch, snap, nt, af, jaf, jnt


@pytest.mark.parametrize("seed", [1, 7, 42, 99])
def test_initial_feasibility_matches_the_plugin_and_the_jax_package(seed):
    def make(mk_node, mk_pod):
        rng = random.Random(seed)
        existing, nodes = _random_cluster(mk_node, mk_pod, rng)
        return existing, nodes, _random_batch(mk_pod, rng)

    batch, snap, nt, af, jaf, jnt = _packs(make)
    for b, pod in enumerate(batch):
        want = _oracle_feasible(pod, snap)
        got = _port_feasible(af, b)[:nt.capacity]
        jgot = _jax_feasible(jaf, b)[:jnt.capacity]
        for ni in snap.list_node_infos():
            j = nt.row(ni.node_name)
            assert bool(got[j]) == want[ni.node_name], (seed, b, ni.node_name)
            assert bool(jgot[jnt.row(ni.node_name)]) == bool(got[j])


@pytest.mark.parametrize("own_label, escapes", [("web", True), ("db", False)],
                         ids=["self_match", "no_self_match"])
def test_the_first_pod_escape(own_label, escapes):
    """Affinity to a label no pod carries yet: schedulable only when the
    pod matches its own term (filtering.go:494)."""
    def make(mk_node, mk_pod):
        nodes = [mk_node("a").labels(zone="z1").obj()]
        pod = (mk_pod("p").labels(app="web")
               .pod_affinity("zone", {"app": own_label}).obj())
        return [], nodes, [pod]

    _, _, nt, af, jaf, jnt = _packs(make)
    assert bool(_port_feasible(af, 0)[:nt.capacity][0]) is escapes
    assert bool(_jax_feasible(jaf, 0)[:jnt.capacity][0]) is escapes


def _zoned(zones, pods, existing=()):
    def build(P, server, client):
        for name, zone in zones:
            client.create_node(
                P["node"](name).labels(zone=zone)
                .capacity(cpu="8", memory="16Gi").obj()
            )
        for make in existing:
            client.create_pod(make(P["pod"]))
        return [make(P["pod"]) for make in pods], len(existing)
    return build


def test_anti_affinity_spreads_within_a_batch():
    pods = [
        (lambda mk, i=i: mk(f"p{i}").labels(app="db")
         .creation_timestamp(float(i)).container(cpu="100m", memory="128Mi")
         .pod_affinity("zone", {"app": "db"}, anti=True).obj())
        for i in range(4)
    ]
    got, sched, _, _ = _three_ways(
        _zoned([("a", "z1"), ("b", "z2"), ("c", "z3")], pods), max_batch=32
    )
    assert sorted(h for h in got.values() if h) == ["a", "b", "c"]
    assert sum(1 for h in got.values() if not h) == 1
    assert sched.pods_fallback == 0
    assert sched.pods_solved_on_device >= 4


def test_affinity_follows_its_peer_within_a_batch():
    pods = [
        lambda mk: mk("leader").labels(app="db").priority(10)
        .creation_timestamp(0.0).container(cpu="100m", memory="128Mi").obj(),
        lambda mk: mk("follower").labels(app="web").creation_timestamp(1.0)
        .container(cpu="100m", memory="128Mi")
        .pod_affinity("zone", {"app": "db"}).obj(),
    ]
    got, sched, _, _ = _three_ways(
        _zoned([("a", "z1"), ("b", "z2")], pods), max_batch=32
    )
    assert got["leader"] and got["follower"] == got["leader"]
    assert sched.pods_fallback == 0


def test_an_existing_anti_affinity_pod_keeps_its_zone_clear():
    guard = (lambda mk: mk("guard").node("a").labels(app="db")
             .container(cpu="100m", memory="128Mi")
             .pod_affinity("zone", {"app": "db"}, anti=True).obj())
    pods = [
        (lambda mk, i=i: mk(f"w{i}").labels(app="web")
         .creation_timestamp(float(i))
         .container(cpu="100m", memory="128Mi").obj())
        for i in range(6)
    ] + [
        lambda mk: mk("rival").labels(app="db").creation_timestamp(6.0)
        .container(cpu="100m", memory="128Mi").obj()
    ]
    got, sched, _, _ = _three_ways(
        _zoned([("a", "z1"), ("b", "z2")], pods, existing=[guard]),
        max_batch=32,
    )
    assert got["rival"] == "b"
    assert all(got[f"w{i}"] for i in range(6))
    assert sched.pods_fallback == 0
    assert sched.pods_solved_on_device >= 7
