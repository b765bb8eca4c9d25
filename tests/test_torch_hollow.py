"""The hollow-node plane on the port: the scenarios of
test_hollow_kubelet.py, test_hollow_fleet.py and test_bindack.py against
``kubernetes_tpu_torch``'s copies of the kubelet package and the bind-ack
ledger, with every scheduler on ``device="cpu"``, and a small churn
differential of the sinkhorn mode against the JAX package with hollow
pools acking the binds.

The contracts are the JAX package's:

- a hollow kubelet acks a bound pod into Running, heartbeats a Lease
  and a Ready condition, and closes the loop with the scheduler;
- routed watches deliver only to their route, ``unbind`` is fenced by
  uid, node and the Running phase, and the fleet acks, renews, drifts
  allocatable within bounds, stays silent as a zombie or dark node and
  refuses a stale ack;
- the BindAckTracker books acks, unbinds an overdue pod exactly once per
  incarnation, books an ack that wins the race as late, untaints a
  suspect node that acks again, and drops deleted pods; bound-but-never
  acked pods on a zombie node rebind elsewhere exactly once, also in a
  1,000-pod burst under the kubelet-chaos profile (whose heartbeat
  lapses act on nothing here: the node-lifecycle controller is not
  ported yet);
- ChurnSinkhorn in miniature (48 nodes, init pods, 2 rounds of deletes
  and replacements, ``solver_mode="sinkhorn"``) places every pod where
  the JAX package places it, round by round, and every pod is acked
  Running.
"""

import time

import pytest

from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.kubelet import HollowNodePool as JaxHollowNodePool
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.api.types import POD_RUNNING, RESOURCE_PODS
from kubernetes_tpu_torch.apiserver.server import (
    APIServer,
    BindConflict,
    Gone,
)
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.config.types import BindAckConfiguration
from kubernetes_tpu_torch.kubelet import (
    FleetConfig,
    HollowKubelet,
    HollowNodeFleet,
    HollowNodePool,
)
from kubernetes_tpu_torch.kubelet.hollow import LEASE_NAMESPACE
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjector,
    install_injector,
    load_profile,
)
from kubernetes_tpu_torch.scheduler.bindack import (
    BindAckTracker,
    TAINT_BIND_ACK_TIMEOUT,
)
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.utils import flightrecorder


@pytest.fixture(autouse=True)
def _clean_injector():
    yield
    install_injector(None)


def _wait(pred, timeout, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _running(client):
    return sum(1 for p in client.list_pods()[0] if p.status.phase == POD_RUNNING)


def _pod_timelines(server):
    """uid -> [(event_type, node_name, phase)] in watch-history order."""
    out = {}
    for ev in server._history["Pod"]:
        out.setdefault(ev.object.metadata.uid, []).append(
            (ev.type, ev.object.spec.node_name, ev.object.status.phase)
        )
    return out


def _unbinds_and_doublebinds(timelines):
    """Per uid: bound->unbound transitions, and direct node->other-node
    rewrites (a double-bind -- must never happen)."""
    unbinds, double_binds = {}, []
    for uid, frames in timelines.items():
        prev_node = None
        for _type, node, _phase in frames:
            if prev_node and not node:
                unbinds[uid] = unbinds.get(uid, 0) + 1
            if prev_node and node and node != prev_node:
                double_binds.append((uid, prev_node, node))
            prev_node = node
    return unbinds, double_binds


# -- the hollow kubelet -------------------------------------------------------

def test_bound_pod_acked_running():
    server = APIServer()
    client = Client(server)
    client.create_node(make_node("n").capacity(cpu="4", memory="8Gi").obj())
    client.create_pod(make_pod("p").node("n").container(cpu="1").obj())
    kubelet = HollowKubelet(client, "n")
    assert kubelet.sync_once() == 1
    pod = client.get_pod("default", "p")
    assert pod.status.phase == POD_RUNNING
    assert pod.status.start_time is not None
    assert kubelet.sync_once() == 0  # idempotent


def test_heartbeat_lease_and_ready_condition():
    server = APIServer()
    client = Client(server)
    client.create_node(make_node("n").capacity(cpu="4", memory="8Gi").obj())
    kubelet = HollowKubelet(client, "n")
    kubelet.heartbeat_once()
    lease = server.get("Lease", LEASE_NAMESPACE, "n")
    first_renew = lease.renew_time
    assert lease.holder_identity == "n"
    assert any(
        c.type == "Ready" and c.status == "True"
        for c in client.get_node("n").status.conditions
    )
    time.sleep(0.01)
    kubelet.heartbeat_once()
    assert server.get("Lease", LEASE_NAMESPACE, "n").renew_time > first_renew


def test_pool_end_to_end_with_scheduler():
    """create -> schedule -> bind -> hollow kubelet observes -> Running."""
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=16,
                          device="cpu")
    names = [f"n{i}" for i in range(4)]
    for n in names:
        client.create_node(make_node(n).capacity(cpu="4", memory="8Gi").obj())
    pool = HollowNodePool(client, names, heartbeat_interval=0.2)
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    pool.start()
    for i in range(12):
        client.create_pod(
            make_pod(f"p{i}").container(cpu="500m", memory="256Mi").obj()
        )
    sched.start()
    try:
        assert _wait(lambda: _running(client) == 12, 30)
    finally:
        sched.stop()
        pool.stop()
        informers.stop()
    assert pool.pods_started >= 12
    leases, _ = server.list("Lease")
    assert {le.metadata.name for le in leases} >= set(names)


# -- routed watches and unbind --------------------------------------------------

class TestRoutedWatch:
    def test_delivers_only_to_interested_routes(self):
        server = APIServer()
        client = Client(server)
        _, rv = server.list("Pod")
        w0 = server.watch_routes("Pod", {"n0"}, since_rv=rv)
        w1 = server.watch_routes("Pod", {"n1"}, since_rv=rv)
        client.create_pod(make_pod("a").node("n0").container(cpu="1").obj())
        client.create_pod(make_pod("b").node("n1").container(cpu="1").obj())
        assert [e.object.metadata.name for e in w0.pending()] == ["a"]
        assert [e.object.metadata.name for e in w1.pending()] == ["b"]
        assert w0.pending() == [] and w1.pending() == []

    def test_unrouted_events_are_invisible(self):
        server = APIServer()
        client = Client(server)
        _, rv = server.list("Pod")
        w = server.watch_routes("Pod", {"n0"}, since_rv=rv)
        client.create_pod(make_pod("floating").container(cpu="1").obj())
        assert w.pending() == []
        server.guaranteed_update(
            "Pod", "default", "floating",
            lambda p: setattr(p.spec, "node_name", "n0"),
        )
        assert [e.object.metadata.name for e in w.pending()] == ["floating"]

    def test_replay_since_rv(self):
        server = APIServer()
        client = Client(server)
        client.create_pod(make_pod("old").node("n0").container(cpu="1").obj())
        _, rv = server.list("Pod")
        client.create_pod(make_pod("new").node("n0").container(cpu="1").obj())
        client.create_pod(make_pod("other").node("n9").container(cpu="1").obj())
        w = server.watch_routes("Pod", {"n0"}, since_rv=rv)
        assert [e.object.metadata.name for e in w.pending()] == ["new"]

    def test_stalled_consumer_overflows_to_gone(self):
        server = APIServer(watch_history_limit=8)
        client = Client(server)
        _, rv = server.list("Pod")
        w = server.watch_routes("Pod", {"n0"}, since_rv=rv)
        for i in range(10):
            client.create_pod(
                make_pod(f"p{i}").node("n0").container(cpu="1").obj()
            )
        with pytest.raises(Gone):
            w.pending()
        client.create_pod(make_pod("fresh").node("n0").container(cpu="1").obj())
        assert [e.object.metadata.name for e in w.pending()] == ["fresh"]


def _bound(client, name="p", node="n0"):
    client.create_pod(make_pod(name).node(node).container(cpu="1").obj())
    return client.get_pod("default", name)


class TestUnbind:
    def test_unbind_releases_binding(self):
        server = APIServer()
        client = Client(server)
        pod = _bound(client)
        out = server.unbind(
            "default", "p", expect_uid=pod.metadata.uid, expect_node="n0",
        )
        assert out.spec.node_name == ""
        assert out.status.phase != POD_RUNNING
        assert out.status.start_time is None
        assert server.unbind("default", "p").spec.node_name == ""

    def test_acked_pod_refuses_unbind(self):
        server = APIServer()
        client = Client(server)
        pod = _bound(client)
        client.update_pod_status(
            "default", "p", lambda p: setattr(p.status, "phase", POD_RUNNING),
        )
        with pytest.raises(BindConflict) as err:
            server.unbind(
                "default", "p", expect_uid=pod.metadata.uid, expect_node="n0",
            )
        assert err.value.kind == "acked"
        assert client.get_pod("default", "p").spec.node_name == "n0"

    def test_uid_and_node_fences(self):
        server = APIServer()
        client = Client(server)
        pod = _bound(client)
        with pytest.raises(BindConflict) as err:
            server.unbind("default", "p", expect_uid="other-incarnation")
        assert err.value.kind == "uid-mismatch"
        with pytest.raises(BindConflict) as err:
            server.unbind(
                "default", "p", expect_uid=pod.metadata.uid, expect_node="n7",
            )
        assert err.value.kind == "already-bound"
        assert client.get_pod("default", "p").spec.node_name == "n0"


# -- the fleet ------------------------------------------------------------------

class TestHollowNodeFleet:
    def _env(self, num_nodes=4, **cfg):
        server = APIServer()
        client = Client(server)
        names = [f"n{i}" for i in range(num_nodes)]
        for n in names:
            client.create_node(
                make_node(n).capacity(cpu="8", memory="16Gi", pods=110).obj()
            )
        fleet = HollowNodeFleet(client, names, FleetConfig(**cfg))
        return server, client, fleet, names

    def test_pump_acks_bound_pods(self):
        server, client, fleet, names = self._env()
        for i in range(6):
            client.create_pod(
                make_pod(f"p{i}").node(names[i % 4]).container(cpu="500m").obj()
            )
        fleet.pump()
        assert all(p.status.phase == POD_RUNNING for p in client.list_pods()[0])
        assert fleet.pods_acked == 6
        fleet.pump()
        assert fleet.pods_acked == 6

    def test_stale_ack_fenced_after_rebind(self):
        server, client, fleet, names = self._env()
        pod = _bound(client)
        old_uid = pod.metadata.uid
        server.unbind("default", "p", expect_uid=old_uid, expect_node="n0")
        server.guaranteed_update(
            "Pod", "default", "p", lambda p: setattr(p.spec, "node_name", "n1"),
        )
        fleet.shards[0]._fire_ack(("default", "p", old_uid, "n0"))
        assert fleet.stale_acks == 1
        assert client.get_pod("default", "p").status.phase != POD_RUNNING

    def test_zombie_heartbeats_but_never_acks(self):
        server, client, fleet, names = self._env()
        fleet.mark_zombie(["n0"])
        _bound(client, name="stuck")
        fleet.pump()
        fleet.heartbeat_once()
        assert client.get_pod("default", "stuck").status.phase != POD_RUNNING
        assert fleet.pods_acked == 0
        assert fleet.acks_suppressed >= 1
        assert server.get("Lease", LEASE_NAMESPACE, "n0").renew_time > 0

    def test_dark_node_goes_fully_silent(self):
        server, client, fleet, names = self._env()
        fleet.heartbeat_once()
        first = server.get("Lease", LEASE_NAMESPACE, "n0").renew_time
        fleet.go_dark(["n0"])
        _bound(client)
        time.sleep(0.01)
        fleet.pump()
        fleet.heartbeat_once()
        assert client.get_pod("default", "p").status.phase != POD_RUNNING
        assert server.get("Lease", LEASE_NAMESPACE, "n0").renew_time == first
        assert server.get("Lease", LEASE_NAMESPACE, "n1").renew_time > 0

    def test_allocatable_drift_stays_bounded(self):
        server, client, fleet, names = self._env(
            num_nodes=2, allocatable_drift=1.0, seed=7,
        )
        base = client.get_node("n0").status.allocatable[RESOURCE_PODS]
        for _ in range(40):
            fleet.heartbeat_once()
        assert fleet.allocatable_drifts > 0
        for n in names:
            cur = client.get_node(n).status.allocatable[RESOURCE_PODS]
            assert base - 2 <= cur <= base + 2

    def test_sharding_splits_nodes(self):
        server, client, fleet, names = self._env(num_nodes=7, shard_size=3)
        assert [len(s.nodes) for s in fleet.shards] == [3, 3, 1]
        assert fleet.node_names == set(names)

    def test_threaded_fleet_closes_the_loop_with_scheduler(self):
        server = APIServer()
        client = Client(server)
        informers = InformerFactory(server)
        sched = new_scheduler(client, informers, batch=True, max_batch=32,
                              device="cpu")
        names = [f"n{i}" for i in range(6)]
        for n in names:
            client.create_node(
                make_node(n).capacity(cpu="8", memory="16Gi", pods=110).obj()
            )
        fleet = HollowNodeFleet(
            client, names,
            FleetConfig(shard_size=2, heartbeat_interval_seconds=0.2),
        )
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        fleet.start()
        for i in range(24):
            client.create_pod(
                make_pod(f"p{i}").container(cpu="500m", memory="256Mi").obj()
            )
        sched.start()
        try:
            assert _wait(lambda: _running(client) == 24, 30)
        finally:
            sched.stop()
            fleet.stop()
            informers.stop()
        assert fleet.pods_acked >= 24
        leases, _ = server.list("Lease")
        assert {le.metadata.name for le in leases} >= set(names)


# -- the bind-ack ledger --------------------------------------------------------

class TestBindAckTracker:
    def _env(self, **kw):
        server = APIServer()
        client = Client(server)
        for n in ("n0", "n1"):
            client.create_node(make_node(n).capacity(cpu="8", memory="16Gi").obj())
        return server, client, BindAckTracker(client, **kw)

    def test_running_transition_is_the_ack(self):
        server, client, tracker = self._env(ack_timeout_seconds=60.0)
        pod = _bound(client)
        tracker.track_bound([("default", "p", pod.metadata.uid, "n0")])
        assert tracker.pending_count() == 1
        client.update_pod_status(
            "default", "p", lambda p: setattr(p.status, "phase", POD_RUNNING),
        )
        tracker.observe_pod(pod, client.get_pod("default", "p"))
        assert tracker.pending_count() == 0
        assert tracker.acks == 1
        assert tracker.sweep() == 0

    def test_timeout_unbinds_exactly_once_per_incarnation(self):
        server, client, tracker = self._env(
            ack_timeout_seconds=0.05, node_suspect_threshold=1,
        )
        pod = _bound(client)
        uid = pod.metadata.uid
        tracker.track_bound([("default", "p", uid, "n0")])
        time.sleep(0.1)
        assert tracker.sweep() == 1
        assert client.get_pod("default", "p").spec.node_name == ""
        assert tracker.rebinds == 1 and tracker.timeouts == 1
        assert any(
            t.key == TAINT_BIND_ACK_TIMEOUT
            for t in client.get_node("n0").spec.taints
        )
        server.guaranteed_update(
            "Pod", "default", "p", lambda p: setattr(p.spec, "node_name", "n1"),
        )
        tracker.track_bound([("default", "p", uid, "n1")])
        time.sleep(0.1)
        assert tracker.sweep() == 0
        assert tracker.timeouts == 2
        assert client.get_pod("default", "p").spec.node_name == "n1"
        assert tracker.pending_count() == 0

    def test_ack_wins_the_unbind_race_booked_late(self):
        server, client, tracker = self._env(ack_timeout_seconds=0.05)
        pod = _bound(client)
        tracker.track_bound([("default", "p", pod.metadata.uid, "n0")])
        client.update_pod_status(
            "default", "p", lambda p: setattr(p.status, "phase", POD_RUNNING),
        )
        time.sleep(0.1)
        assert tracker.sweep() == 0
        assert tracker.acks_late == 1
        assert tracker.rebinds == 0
        assert client.get_pod("default", "p").spec.node_name == "n0"

    def test_ack_from_suspect_node_untaints(self):
        server, client, tracker = self._env(
            ack_timeout_seconds=0.05, node_suspect_threshold=1,
        )
        pod = _bound(client, name="slow")
        tracker.track_bound([("default", "slow", pod.metadata.uid, "n0")])
        time.sleep(0.1)
        tracker.sweep()
        assert any(
            t.key == TAINT_BIND_ACK_TIMEOUT
            for t in client.get_node("n0").spec.taints
        )
        other = _bound(client, name="ok")
        tracker.track_bound([("default", "ok", other.metadata.uid, "n0")])
        client.update_pod_status(
            "default", "ok", lambda p: setattr(p.status, "phase", POD_RUNNING),
        )
        tracker.observe_pod(other, client.get_pod("default", "ok"))
        assert not any(
            t.key == TAINT_BIND_ACK_TIMEOUT
            for t in client.get_node("n0").spec.taints
        )

    def test_deleted_pod_leaves_the_ledger(self):
        server, client, tracker = self._env(ack_timeout_seconds=0.05)
        pod = _bound(client)
        tracker.track_bound([("default", "p", pod.metadata.uid, "n0")])
        client.delete_pod("default", "p")
        tracker.observe_gone(pod.metadata.uid)
        time.sleep(0.1)
        assert tracker.sweep() == 0
        assert tracker.pending_count() == 0


def _zombie_stack(names, max_batch, ack_timeout, sweep, cpu, pods):
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=max_batch, device="cpu",
        bind_ack_config=BindAckConfiguration(
            enabled=True, ack_timeout_seconds=ack_timeout,
            sweep_interval_seconds=sweep,
        ),
    )
    for n in names:
        client.create_node(
            make_node(n).capacity(cpu=cpu, memory="64Gi", pods=pods).obj()
        )
    return server, client, informers, sched


def test_zombie_kubelet_pods_rebind_elsewhere_exactly_once():
    names = ["n0", "n1", "n2"]
    server, client, informers, sched = _zombie_stack(
        names, 16, 0.6, 0.1, "16", 110,
    )
    fleet = HollowNodeFleet(
        client, names, FleetConfig(heartbeat_interval_seconds=0.2)
    )
    fleet.mark_zombie(["n0"])
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    fleet.start()
    for i in range(9):
        client.create_pod(
            make_pod(f"p{i}").container(cpu="500m", memory="256Mi").obj()
        )
    sched.start()
    try:
        assert _wait(lambda: _running(client) == 9, 60), (
            "zombie-held pods never converged to Running"
        )
    finally:
        sched.stop()
        fleet.stop()
        informers.stop()
    assert all(p.spec.node_name != "n0" for p in client.list_pods()[0])
    tracker = sched.bind_ack_tracker
    assert tracker.rebinds >= 1
    assert any(
        t.key == TAINT_BIND_ACK_TIMEOUT for t in client.get_node("n0").spec.taints
    )
    timelines = _pod_timelines(server)
    unbinds, double_binds = _unbinds_and_doublebinds(timelines)
    assert not double_binds, double_binds
    assert all(n == 1 for n in unbinds.values()), unbinds
    zombie_uids = {
        uid for uid, frames in timelines.items()
        if any(node == "n0" for _t, node, _p in frames)
    }
    assert zombie_uids and zombie_uids == set(unbinds)
    assert tracker.rebinds == len(zombie_uids)


def test_kubelet_chaos_burst_converges_with_exactly_once_rebinds():
    """1,000 pods over 100 hollow nodes under the kubelet-chaos profile
    (slow acks, one zombie node): every pod reaches Running off the
    zombie, each zombie-held uid rebinds exactly once, no double binds,
    and the flight recorder's rebind marks equal the history replay."""
    flightrecorder.RECORDER.reset()
    names = [f"node-{i}" for i in range(100)]
    server, client, informers, sched = _zombie_stack(
        names, 256, 2.5, 0.25, "32", 110,
    )
    fleet = HollowNodeFleet(
        client, names,
        FleetConfig(shard_size=25, heartbeat_interval_seconds=0.25),
    )
    install_injector(FaultInjector(load_profile("kubelet-chaos")))
    fleet.mark_zombie(["node-0"])
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    fleet.start()
    client.create_pods_bulk([
        make_pod(f"p{i}").container(cpu="250m", memory="128Mi").obj()
        for i in range(1000)
    ])
    sched.start()
    try:
        assert _wait(lambda: _running(client) == 1000, 120, interval=0.25)
    finally:
        sched.stop()
        fleet.stop()
        informers.stop()
    pods, _ = client.list_pods()
    assert len(pods) == 1000
    assert all(p.spec.node_name != "node-0" for p in pods)
    timelines = _pod_timelines(server)
    unbinds, double_binds = _unbinds_and_doublebinds(timelines)
    assert not double_binds, double_binds
    assert all(n == 1 for n in unbinds.values())
    zombie_uids = {
        uid for uid, frames in timelines.items()
        if any(node == "node-0" for _t, node, _p in frames)
    }
    assert zombie_uids and zombie_uids == set(unbinds)
    dump = flightrecorder.RECORDER.dump()
    assert {m["pod"] for m in dump["marks"] if m["kind"] == "rebind"} == set(
        unbinds
    )


# -- ChurnSinkhorn in miniature: the port against the JAX package ----------------

CHURN_NODES = 48
CHURN_INIT = 320
CHURN_ROUNDS = 2
CHURN_DELETE = 64
CHURN_ROUND_PODS = 80

STACKS = {
    "jax": (JaxAPIServer, JaxClient, JaxInformers, jax_new, jax_node,
            jax_pod, JaxHollowNodePool),
    "torch": (APIServer, Client, InformerFactory, new_scheduler, make_node,
              make_pod, HollowNodePool),
}


def _churn(stack):
    """Init pods, then rounds that delete bound pods (the first by name)
    and create replacements, each wave fully queued before the scheduler
    pops it, so both stacks solve the same batches. Returns the
    placements after each wave and the count of pods acked Running."""
    Server, Cl, Informers, new, mk_node, mk_pod, Pool = STACKS[stack]
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    kw = {"device": "cpu"} if stack == "torch" else {}
    sched = new(client, informers, batch=True, max_batch=64,
                solver_mode="sinkhorn", **kw)
    names = [f"node-{i}" for i in range(CHURN_NODES)]
    for i, n in enumerate(names):
        client.create_node(
            mk_node(n).capacity(cpu="8" if i % 3 else "4", memory="16Gi",
                                pods=16)
            .label("topology.kubernetes.io/zone", f"zone-{i % 4}").obj()
        )
    pool = Pool(client, names, heartbeat_interval=0.5)
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    pool.start()
    waves = []

    def wave(prefix, count, stamp):
        pods = [
            mk_pod(f"{prefix}-{i}").creation_timestamp(stamp + i)
            .container(cpu="100m", memory="128Mi").obj()
            for i in range(count)
        ]
        client.create_pods_bulk(pods)
        assert _wait(lambda: sched.queue.active_count() == count, 60)
        want = {p.metadata.name for p in pods}
        deadline = time.time() + 120
        while time.time() < deadline:
            sched.schedule_batch(timeout=0.2)
            listed, _ = client.list_pods()
            if all(p.spec.node_name for p in listed
                   if p.metadata.name in want):
                break
        sched.wait_for_inflight_binds()
        waves.append({p.metadata.name: p.spec.node_name
                      for p in client.list_pods()[0]})

    try:
        wave("init", CHURN_INIT, 0.0)
        for r in range(CHURN_ROUNDS):
            bound = sorted(n for n, v in waves[-1].items() if v)
            for name in bound[:CHURN_DELETE]:
                client.delete_pod("default", name)
            wave(f"round{r}", CHURN_ROUND_PODS, 1000.0 * (r + 1))
        total = CHURN_INIT + CHURN_ROUNDS * (CHURN_ROUND_PODS - CHURN_DELETE)
        acked = _wait(lambda: _running(client) == total, 30)
        return waves, acked, sched
    finally:
        sched.stop()
        pool.stop()
        informers.stop()


def test_churn_sinkhorn_miniature_places_as_the_jax_package():
    want, want_acked, _ = _churn("jax")
    got, acked, sched = _churn("torch")
    assert len(got) == 1 + CHURN_ROUNDS
    for w, g in zip(want, got):
        assert all(g.values())
        assert g == w
    assert acked and want_acked
    assert sched.pods_fallback == 0
    assert set(k for k, v in sched.ladder.solves_by_tier.items() if v) == {
        "torch"
    }
    # no node over its 16-pod cap
    per_node = {}
    for node in got[-1].values():
        per_node[node] = per_node.get(node, 0) + 1
    assert max(per_node.values()) <= 16
