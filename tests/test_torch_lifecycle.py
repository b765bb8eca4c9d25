"""The port's cluster-lifecycle plane against the JAX package's.

``kubernetes_tpu_torch/controllers/nodelifecycle.py`` (the heartbeat
monitor and the drainer) and ``robustness/lifecycle.py`` (respawned
clones, cold replacements, the respawner and the chaos driver) are the
JAX package's lifecycle plane carried over. Held here on the CPU: a
stale lease taints the node and evicts its intolerant pods, a recovered
heartbeat untaints it, the shared PDB budget blocks an eviction and then
reopens; cordon and drain; clones and cold replacements are fresh
incarnations; the driver's flaps, storms and node filter -- with the
same victims as the JAX package's driver for the same seed; and a
reclamation storm end to end through the port's batch scheduler on
``device="cpu"``: every live pod bound, no incarnation bound twice, the
membership churn absorbed as slot scatters with the one initial repack.
"""

import time

import pytest

from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.robustness import faults as jax_faults
from kubernetes_tpu.robustness.lifecycle import (
    ClusterLifecycleDriver as JaxDriver,
)
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.api.types import (
    TAINT_EFFECT_NO_EXECUTE,
    LabelSelector,
    PodDisruptionBudget,
)
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers import (
    DisruptionController,
    NodeDrainer,
    NodeLifecycleController,
)
from kubernetes_tpu_torch.controllers.nodelifecycle import TAINT_UNREACHABLE
from kubernetes_tpu_torch.kubelet import HollowKubelet
from kubernetes_tpu_torch.robustness import faults
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjector,
    FaultPoint,
    FaultProfile,
    PointConfig,
    builtin_profiles,
    install_injector,
    load_profile,
)
from kubernetes_tpu_torch.robustness.lifecycle import (
    ClusterLifecycleDriver,
    PodRespawner,
    cold_replacement,
    respawn_clone,
)
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

from test_torch_slice import _bind_transitions_by_uid, _pdb_never_negative


@pytest.fixture(autouse=True)
def _clean_injector():
    yield
    install_injector(None)


# -- the heartbeat monitor ---------------------------------------------------


def _monitor_env(disruption=False):
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    clock = {"now": 1000.0}
    dc = DisruptionController(client, informers) if disruption else None
    ctrl = NodeLifecycleController(
        client, informers, grace_period=40.0, now=lambda: clock["now"],
        disruption=dc,
    )
    return client, informers, ctrl, dc, clock


def _tainted(client, name):
    return any(
        t.key == TAINT_UNREACHABLE for t in client.get_node(name).spec.taints
    )


def test_stale_lease_taints_and_evicts():
    client, informers, ctrl, _, clock = _monitor_env()
    client.create_node(make_node("n").capacity(cpu="4", memory="8Gi").obj())
    client.create_pod(make_pod("victim").node("n").container(cpu="1").obj())
    client.create_pod(
        make_pod("survivor").node("n").container(cpu="1")
        .toleration(TAINT_UNREACHABLE, operator="Exists",
                    effect=TAINT_EFFECT_NO_EXECUTE)
        .obj()
    )
    kubelet = HollowKubelet(client, "n", now=lambda: clock["now"])
    kubelet.heartbeat_once()
    informers.pods().pump()
    informers.nodes().pump()
    ctrl.monitor_once()  # fresh: nothing happens
    assert not _tainted(client, "n")
    clock["now"] += 120.0  # the lease goes stale
    ctrl.monitor_once()
    node = client.get_node("n")
    assert any(
        t.key == TAINT_UNREACHABLE and t.effect == TAINT_EFFECT_NO_EXECUTE
        for t in node.spec.taints
    )
    assert any(
        c.type == "Ready" and c.status == "Unknown"
        for c in node.status.conditions
    )
    names = {p.metadata.name for p in client.list_pods()[0]}
    assert names == {"survivor"}  # the intolerant pod was evicted
    assert ctrl.evictions == 1


def test_recovered_heartbeat_untaints():
    client, informers, ctrl, _, clock = _monitor_env()
    client.create_node(make_node("n").capacity(cpu="4", memory="8Gi").obj())
    kubelet = HollowKubelet(client, "n", now=lambda: clock["now"])
    kubelet.heartbeat_once()
    informers.nodes().pump()
    clock["now"] += 120.0
    ctrl.monitor_once()
    informers.nodes().pump()
    assert _tainted(client, "n")
    kubelet.heartbeat_once()  # the heartbeat resumes
    informers.nodes().pump()
    ctrl.monitor_once()
    assert not _tainted(client, "n")


def _guard_pdb(client, match, min_available):
    pdb = PodDisruptionBudget(
        selector=LabelSelector(match_labels=match),
        min_available=min_available,
    )
    pdb.metadata.name = "guard"
    pdb.metadata.namespace = "default"
    client.create_pdb(pdb)


def test_pdb_blocks_the_taint_eviction_then_reopens():
    """Taint evictions spend the same budget as drains: blocked while
    the PDB allows nothing, evicted on the next pass once it reopens."""
    client, informers, ctrl, dc, clock = _monitor_env(disruption=True)
    client.create_node(make_node("n").capacity(cpu="8", memory="16Gi").obj())
    _guard_pdb(client, {"app": "web"}, min_available=2)
    for i in range(2):
        client.create_pod(
            make_pod(f"w{i}").labels(app="web").node("n")
            .container(cpu="1").obj()
        )
    kubelet = HollowKubelet(client, "n", now=lambda: clock["now"])
    kubelet.heartbeat_once()
    informers.pods().pump()
    informers.nodes().pump()
    informers.pdbs().pump()
    dc.sync_all()  # 2 healthy - 2 minAvailable = 0 allowed
    clock["now"] += 120.0
    ctrl.monitor_once()
    assert _tainted(client, "n")
    assert {p.metadata.name for p in client.list_pods()[0]} == {"w0", "w1"}
    assert ctrl.evictions == 0 and ctrl.evictions_blocked == 2
    for i in range(2):  # replacements land on a healthy node
        client.create_pod(
            make_pod(f"r{i}").labels(app="web").node("m")
            .container(cpu="1").obj()
        )
    informers.pods().pump()
    dc.sync_all()  # 4 healthy - 2 = 2 allowed
    ctrl.monitor_once()
    names = {p.metadata.name for p in client.list_pods()[0]}
    assert "w0" not in names and "w1" not in names
    assert ctrl.evictions == 2


# -- cordon and drain --------------------------------------------------------


def _drainer_env():
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    dc = DisruptionController(client, informers)
    drainer = NodeDrainer(client, disruption=dc, poll=0.01)
    return server, client, informers, dc, drainer


def test_cordon_flips_unschedulable():
    _, client, _, _, drainer = _drainer_env()
    client.create_node(make_node("n").capacity(cpu="4").obj())
    assert drainer.cordon("n")
    assert client.get_node("n").spec.unschedulable
    assert drainer.uncordon("n")
    assert not client.get_node("n").spec.unschedulable
    assert not drainer.cordon("missing")


def test_drain_empties_the_node_within_budget():
    _, client, informers, _, drainer = _drainer_env()
    client.create_node(make_node("n").capacity(cpu="8").obj())
    for i in range(3):
        client.create_pod(make_pod(f"p{i}").node("n").container(cpu="1").obj())
    informers.pods().pump()
    assert drainer.drain("n", timeout=5.0)
    assert drainer.evictions == 3 and drainer.drains == 1
    assert client.get_node("n").spec.unschedulable
    assert not [
        p for p in client.list_pods()[0] if p.spec.node_name == "n"
    ]


def test_drain_blocked_by_pdb_reports_failure():
    server, client, informers, dc, drainer = _drainer_env()
    client.create_node(make_node("n").capacity(cpu="8").obj())
    _guard_pdb(client, {"app": "web"}, min_available=2)
    for i in range(3):
        client.create_pod(
            make_pod(f"p{i}").labels(app="web").node("n")
            .container(cpu="1").obj()
        )
    informers.pods().pump()
    informers.pdbs().pump()
    dc.sync_all()  # 3 healthy - 2 = 1 allowed
    assert not drainer.drain("n", timeout=0.5)
    assert drainer.evictions == 1
    assert drainer.evictions_blocked >= 1 and drainer.drains == 0
    assert client.get_node("n").spec.unschedulable
    assert len([
        p for p in client.list_pods()[0] if p.spec.node_name == "n"
    ]) == 2
    assert _pdb_never_negative(server)


def test_drain_via_preemption_without_a_preemptor_is_a_drain():
    _, client, informers, _, drainer = _drainer_env()
    client.create_node(make_node("n").capacity(cpu="8").obj())
    for i in range(2):
        client.create_pod(make_pod(f"p{i}").node("n").container(cpu="1").obj())
    informers.pods().pump()
    assert drainer.drain_via_preemption("n", timeout=5.0)
    assert drainer.evictions == 2 and drainer.preempt_planned == 0


# -- clones and the respawner ------------------------------------------------


def test_respawn_clone_is_a_fresh_incarnation():
    pod = make_pod("w").labels(app="x").node("n5").container(cpu="1").obj()
    pod.__dict__["_admission"] = object()  # a scheduler memo stamp
    clone = respawn_clone(pod)
    assert clone.metadata.name == "w"
    assert clone.metadata.uid != pod.metadata.uid
    assert clone.spec.node_name == ""
    assert clone.status.phase != "Running"
    assert "_admission" not in clone.__dict__
    assert pod.spec.node_name == "n5"  # the original is untouched


def test_cold_replacement_is_a_new_instance():
    node = make_node("n").capacity(cpu="8").obj()
    node.spec.unschedulable = True
    cold = cold_replacement(node)
    assert cold.metadata.name == "n"
    assert cold.metadata.uid != node.metadata.uid
    assert not cold.spec.unschedulable
    assert cold.status.conditions == []


def test_deleted_pod_respawns_pending():
    client = Client(APIServer())
    client.create_pod(make_pod("w0").node("n0").container(cpu="1").obj())
    rs = PodRespawner(client)
    rs.start()
    try:
        client.delete_pod("default", "w0")
        deadline = time.time() + 5
        while True:
            try:
                p = client.get_pod("default", "w0")
                break
            except KeyError:
                assert time.time() < deadline, "the pod never respawned"
                time.sleep(0.01)
        assert p.spec.node_name == "" and rs.respawned == 1
    finally:
        rs.stop()


def test_respawner_filter_excludes_pods():
    client = Client(APIServer())
    client.create_pod(make_pod("keep").container(cpu="1").obj())
    rs = PodRespawner(
        client, should_respawn=lambda pod: pod.metadata.name != "keep"
    )
    rs.start()
    try:
        client.delete_pod("default", "keep")
        time.sleep(0.3)
        with pytest.raises(KeyError):
            client.get_pod("default", "keep")
        assert rs.respawned == 0
    finally:
        rs.stop()


# -- the chaos driver --------------------------------------------------------


def test_lifecycle_chaos_profile_registered():
    p = builtin_profiles()["lifecycle-chaos"]
    assert FaultPoint.NODE_FLAP in p.points
    assert FaultPoint.RECLAIM_STORM in p.points
    assert all(c.max_fires is not None for c in p.points.values())
    assert load_profile("lifecycle-chaos", seed=7).seed == 7


def _cluster(n):
    client = Client(APIServer())
    for i in range(n):
        client.create_node(
            make_node(f"cn-{i}").capacity(cpu="8", memory="16Gi").obj()
        )
    return client


def test_flap_kills_node_and_pods_then_restores():
    client = _cluster(4)
    for i in range(4):
        client.create_pod(
            make_pod(f"on{i}").node(f"cn-{i}").container(cpu="1").obj()
        )
    drv = ClusterLifecycleDriver(
        client,
        injector=FaultInjector(FaultProfile(
            "flap-once", seed=3,
            points={FaultPoint.NODE_FLAP: PointConfig(rate=1.0, max_fires=1)},
        )),
        flap_down_seconds=30.0,
    )
    drv.tick()
    assert drv.flaps == 1 and drv.down_count() == 1
    live = {x.metadata.name for x in client.list_nodes()[0]}
    (dead,) = {f"cn-{i}" for i in range(4)} - live
    # the pod went with its node, and respawned pending
    assert drv.pods_killed == 1 and drv.pods_respawned == 1
    assert client.get_pod("default", f"on{dead[3:]}").spec.node_name == ""
    drv.stop()  # force-restores everything still down
    assert drv.down_count() == 0
    assert {x.metadata.name for x in client.list_nodes()[0]} == {
        f"cn-{i}" for i in range(4)
    }
    restored = client.get_node(dead)  # cold: a new instance
    assert not restored.spec.taints and restored.status.conditions == []


def test_storm_reclaims_a_fraction_and_never_double_kills():
    client = _cluster(10)
    drv = ClusterLifecycleDriver(
        client,
        injector=FaultInjector(FaultProfile(
            "storm-once", seed=5,
            points={
                FaultPoint.RECLAIM_STORM: PointConfig(rate=1.0, max_fires=1),
            },
        )),
        storm_fraction=0.3, storm_down_seconds=30.0,
    )
    drv.tick()
    assert drv.storms == 1 and drv.nodes_reclaimed == 3
    assert drv.down_count() == 3 and len(client.list_nodes()[0]) == 7
    drv.tick()  # max_fires=1: no second storm
    assert drv.storms == 1
    drv.stop()
    assert len(client.list_nodes()[0]) == 10


def test_node_filter_protects_nodes():
    client = _cluster(3)
    drv = ClusterLifecycleDriver(
        client,
        injector=FaultInjector(FaultProfile(
            "flap", seed=1,
            points={FaultPoint.NODE_FLAP: PointConfig(rate=1.0, max_fires=3)},
        )),
        flap_down_seconds=30.0,
        node_filter=lambda n: n.metadata.name != "cn-0",
    )
    for _ in range(3):
        drv.tick()
    assert "cn-0" in {x.metadata.name for x in client.list_nodes()[0]}
    assert drv.flaps == 2  # the third flap finds no unprotected node up
    drv.stop()


def _driver_run(pkg, seed):
    """Flaps and a storm over 12 nodes, each holding two pods, with every
    node staying down: the nodes and pods each tick took."""
    (server_cls, client_cls, node_fn, pod_fn, fmod, driver_cls) = pkg
    client = client_cls(server_cls())
    for i in range(12):
        client.create_node(
            node_fn(f"cn-{i:02d}").capacity(cpu="8", memory="16Gi").obj()
        )
        for j in range(2):
            client.create_pod(
                pod_fn(f"p{i}-{j}").node(f"cn-{i:02d}").container(cpu="1")
                .obj()
            )
    inj = fmod.FaultInjector(fmod.FaultProfile(
        "churn", seed=seed,
        points={
            fmod.FaultPoint.NODE_FLAP: fmod.PointConfig(
                rate=0.6, max_fires=4),
            fmod.FaultPoint.RECLAIM_STORM: fmod.PointConfig(
                rate=0.3, max_fires=1),
        },
    ))
    drv = driver_cls(
        client, injector=inj, flap_down_seconds=60.0,
        storm_fraction=0.25, storm_down_seconds=60.0,
    )
    out = []
    for _ in range(8):
        drv.tick()
        with drv._lock:
            down = sorted(drv._down)
        out.append((down, drv.flaps, drv.storms, drv.pods_killed))
    drv.stop()
    return out


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_driver_takes_the_jax_packages_victims(seed):
    ours = _driver_run(
        (APIServer, Client, make_node, make_pod, faults,
         ClusterLifecycleDriver), seed,
    )
    theirs = _driver_run(
        (JaxAPIServer, JaxClient, jax_node, jax_pod, jax_faults, JaxDriver),
        seed,
    )
    assert ours == theirs
    assert ours[-1][1] + ours[-1][2] > 0, "the seed fired no chaos"


# -- a reclamation storm through the port's scheduler -----------------------


def _wait_all_bound(client, names, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if {p.metadata.name for p in pods if p.spec.node_name} >= names:
            return True
        time.sleep(0.05)
    return False


def test_storm_e2e_rides_slot_scatters():
    """24 nodes; 200 pods bind; a storm reclaims 10% of the fleet (their
    pods die and respawn), 100 more pods arrive, the cold replacements
    rejoin after 1 s, and a last 20 pods land after the rejoin. Every
    live pod ends bound, the fleet is whole, no incarnation bound twice,
    and the churn rode slot scatters: the one initial full repack."""
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=128, device="cpu"
    )
    for i in range(24):
        client.create_node(
            make_node(f"node-{i}").capacity(cpu="32", memory="64Gi", pods=110)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    sched.start()
    drv = ClusterLifecycleDriver(
        client,
        injector=FaultInjector(FaultProfile(
            "storm", seed=11,
            points={
                FaultPoint.RECLAIM_STORM: PointConfig(rate=1.0, max_fires=1),
            },
        )),
        tick_interval=0.1, storm_fraction=0.1, storm_down_seconds=1.0,
    )

    def pods(prefix, n):
        return [
            make_pod(f"{prefix}-{i}").container(cpu="250m", memory="256Mi")
            .obj()
            for i in range(n)
        ]

    try:
        first = pods("a", 200)
        client.create_pods_bulk(first)
        names = {p.metadata.name for p in first}
        assert _wait_all_bound(client, names, 60)
        drv.start()
        deadline = time.time() + 10
        while drv.storms == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert drv.storms == 1 and drv.nodes_reclaimed == 2
        second = pods("b", 100)
        client.create_pods_bulk(second)
        names |= {p.metadata.name for p in second}
        while drv.down_count() and time.time() < deadline + 10:
            time.sleep(0.05)
        assert drv.down_count() == 0, "the cold replacements never rejoined"
        last = pods("c", 20)
        client.create_pods_bulk(last)
        names |= {p.metadata.name for p in last}
        assert _wait_all_bound(client, names, 60)
        sched.wait_for_inflight_binds()
    finally:
        drv.stop()
    pods_now, _ = client.list_pods()
    assert {p.metadata.name for p in pods_now} == names
    assert all(p.spec.node_name for p in pods_now)
    assert len(client.list_nodes()[0]) == 24
    assert drv.pods_killed > 0 and drv.pods_respawned == drv.pods_killed
    doubles = {
        u: c for u, c in _bind_transitions_by_uid(server).items() if c > 1
    }
    assert not doubles, f"double-bound incarnations: {doubles}"
    assert sched.membership_row_patches > 0
    assert sched.tensor_cache.full_repacks == 1
    sched.stop()
    informers.stop()
