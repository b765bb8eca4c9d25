"""Gang scheduling (BASELINE config #3), on the CPU, in both packages.

Twins of ``tests/test_gang_device.py`` (the all-or-nothing group masks
of the batch solver: the quorum re-solve, the capacity a failed gang
gives back, a gang split across batches assembling at Permit) and of
``tests/test_coscheduling.py`` (the Coscheduling plugin's PreFilter
fail-fast, its Permit barrier and timeout, on the sequential and the
batch path). Every scenario runs through the JAX package's scheduler and
the port's (``device="cpu"``) on identical inputs, with the sequential
path's tie-break ``rng`` seeded alike, and is held to the reference
test's own checks. The two runs must give equal placements, an equal
``gang_resolves``, an equal set of pods left unplaced, and no capacity
held by a pod that is not bound: every node's requested CPU and memory
in the scheduler's cache equal the sums of the pods bound to it.

A seeded contention differential adds gangs of several sizes on a
cluster with room for about half of them, at a ``max_batch`` that
splits gangs across batches. Tolerance: exact.
"""

import random
import time

import pytest

import kubernetes_tpu.api.types as jax_types
import kubernetes_tpu_torch.api.types as port_types
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

PKG = {
    "jax": dict(server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
                new=jax_new, node=jax_node, pod=jax_pod, types=jax_types,
                kw={}),
    "torch": dict(server=APIServer, client=Client, informers=InformerFactory,
                  new=new_scheduler, node=make_node, pod=make_pod,
                  types=port_types, kw={"device": "cpu"}),
}


class Stack:
    """One package's apiserver, client, informers and scheduler."""

    def __init__(self, pkg, *, batch=True, max_batch=32, seed=0):
        self.P = P = PKG[pkg]
        self.server = P["server"]()
        self.client = P["client"](self.server)
        self.informers = P["informers"](self.server)
        self.sched = P["new"](self.client, self.informers, batch=batch,
                              max_batch=max_batch, rng=random.Random(seed),
                              **P["kw"])

    def node(self, name, cpu, memory="8Gi", pods=110):
        self.client.create_node(
            self.P["node"](name).capacity(cpu=cpu, memory=memory, pods=pods)
            .obj())

    def group(self, name, min_member, timeout=60):
        T = self.P["types"]
        self.client.create_pod_group(T.PodGroup(
            metadata=T.ObjectMeta(name=name, namespace="default"),
            min_member=min_member, schedule_timeout_seconds=timeout,
        ))

    def pod(self, name, group=None, cpu="1", memory="128Mi", ts=None):
        w = self.P["pod"](name)
        if ts is not None:
            w = w.creation_timestamp(ts)
        p = w.container(cpu=cpu, memory=memory).obj()
        if group:
            p.metadata.labels[self.P["types"].POD_GROUP_LABEL] = group
        self.client.create_pod(p)

    def sync(self, queued=0):
        """Start the informers and the queue; wait until ``queued`` pods
        sit in the active queue, so the first batch is the same in both
        packages."""
        self.informers.start()
        self.informers.wait_for_cache_sync()
        self.sched.queue.run()
        deadline = time.time() + 10
        while (self.sched.queue.num_pending()["active"] < queued
               and time.time() < deadline):
            time.sleep(0.01)

    def pods(self):
        return self.client.list_pods()[0]

    def bound(self):
        return sum(1 for p in self.pods() if p.spec.node_name)

    def wait(self, fn, timeout=30.0):
        deadline = time.time() + timeout
        while time.time() < deadline:
            if fn():
                return True
            time.sleep(0.05)
        return False

    def outcome(self):
        """Placements, the quorum re-solves, the pods left unplaced, and
        every node whose cached requests differ from its bound pods'."""
        self.sched.wait_for_inflight_binds()
        pods = self.pods()
        placed = {p.metadata.name: p.spec.node_name for p in pods}
        sums = {}
        for p in pods:
            if p.spec.node_name:
                c, m = sums.get(p.spec.node_name, (0, 0))
                r = p.spec.containers[0].resources.requests
                sums[p.spec.node_name] = (c + r.get("cpu", 0),
                                          m + r.get("memory", 0))
        held = {
            name: (ni.requested.milli_cpu, ni.requested.memory)
            for name, ni in self.sched.cache._nodes.items()
            if (ni.requested.milli_cpu, ni.requested.memory)
            != sums.get(name, (0, 0))
        }
        return dict(
            placed=placed,
            unplaced=sorted(n for n, node in placed.items() if not node),
            gang_resolves=getattr(self.sched, "gang_resolves", 0),
            held_by_unbound=held,
        )

    def stop(self):
        self.sched.stop()
        self.informers.stop()


def both(scenario, **kw):
    """The scenario through each package; returns (port, JAX) outcomes,
    which must be equal."""
    got = {}
    for pkg in ("torch", "jax"):
        st = Stack(pkg, **kw)
        try:
            got[pkg] = scenario(st)
        finally:
            st.stop()
    assert got["torch"] == got["jax"]
    return got["torch"], got["jax"]


def unschedulable(st, n):
    """A check that ``n`` pods wait in the unschedulable queue: a gang
    member that cannot reach its quorum ends there, on either path, so
    a later member arrives after that decision in both packages."""
    return lambda: st.sched.queue.num_pending()["unschedulable"] == n


def drive(st, until, timeout=10.0):
    """Call ``schedule_batch`` by hand until ``until()`` holds."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        st.sched.schedule_batch(timeout=0.2)
        if until():
            return True
    return False


# -- tests/test_gang_device.py ------------------------------------------------


def test_half_fitting_gang_places_nothing():
    def scenario(st):
        for i in range(2):  # room for 4 gang pods; the gang needs 6
            st.node(f"n{i}", cpu="2")
        st.group("g6", 6)
        for i in range(6):
            st.pod(f"g{i}", "g6", ts=float(i))
        st.sync(queued=6)
        assert drive(st, lambda: st.sched.queue.num_pending()
                     ["unschedulable"] == 6)
        out = st.outcome()
        # all-or-nothing: nothing placed, nothing parked at Permit
        assert out["unplaced"] == [f"g{i}" for i in range(6)]
        assert not any(len(fw.waiting_pods) for fw in
                       st.sched.profiles.values())
        return out

    got, _ = both(scenario)
    assert got["gang_resolves"] >= 1 and not got["held_by_unbound"]


def test_fitting_gang_places_fully_on_device():
    def scenario(st):
        for i in range(3):
            st.node(f"n{i}", cpu="4")
        st.group("g6", 6)
        for i in range(6):
            st.pod(f"g{i}", "g6", ts=float(i))
        st.sync(queued=6)
        st.sched.start()
        assert st.wait(lambda: st.bound() == 6)
        return st.outcome()

    got, _ = both(scenario)
    assert not got["unplaced"] and got["gang_resolves"] == 0


def test_gang_failure_releases_capacity_to_other_pods():
    """The re-solve gives the failed gang's capacity to the plain pods
    of the same batch."""
    def scenario(st):
        st.node("n0", cpu="4")
        st.group("g8", 8)
        # 8 gang pods (only 4 fit) created ahead of 4 plain pods
        for i in range(8):
            st.pod(f"g{i}", "g8", ts=float(i))
        for i in range(4):
            st.pod(f"plain{i}", ts=float(8 + i))
        st.sync(queued=12)
        st.sched.start()
        assert st.wait(lambda: sum(
            1 for p in st.pods()
            if p.spec.node_name and p.metadata.name.startswith("plain")
        ) == 4)
        return st.outcome()

    got, _ = both(scenario)
    assert got["unplaced"] == sorted(f"g{i}" for i in range(8))
    assert got["gang_resolves"] >= 1 and not got["held_by_unbound"]


def test_split_arrival_gang_assembles_via_permit():
    """A gang whose members arrive in two waves assembles: the first
    four fail PreFilter's fail-fast (four known members of six), the
    last two wake them, and the six bind together."""
    def scenario(st):
        for i in range(4):
            st.node(f"n{i}", cpu="2")
        st.group("g6", 6)
        for i in range(4):
            st.pod(f"g{i}", "g6", ts=float(i))
        st.sync(queued=4)
        st.sched.start()
        assert st.wait(unschedulable(st, 4))
        assert st.bound() == 0
        for i in range(4, 6):
            st.pod(f"g{i}", "g6", ts=float(i))
        assert st.wait(lambda: st.bound() == 6)
        return st.outcome()

    got, _ = both(scenario)
    assert not got["unplaced"]


# -- tests/test_coscheduling.py -----------------------------------------------


@pytest.mark.parametrize("batch", [False, True], ids=["sequential", "batch"])
def test_full_gang_binds_together(batch):
    def scenario(st):
        st.node("n", cpu="8", memory="16Gi")
        st.group("job", 3, timeout=30)
        st.sync()
        for i in range(3):
            st.pod(f"g{i}", "job", cpu="500m", memory="256Mi", ts=float(i))
        st.sched.start()
        assert st.wait(lambda: st.bound() == 3), "gang never fully bound"
        return st.outcome()

    both(scenario, batch=batch)


@pytest.mark.parametrize("batch", [False, True], ids=["sequential", "batch"])
def test_partial_gang_times_out_and_releases(batch):
    def scenario(st):
        st.node("n", cpu="8", memory="16Gi")
        st.group("job", 3, timeout=1)
        st.sync()
        # only 2 of 3 members exist: PreFilter fails fast, nothing binds
        for i in range(2):
            st.pod(f"g{i}", "job", cpu="500m", memory="256Mi", ts=float(i))
        st.sched.start()
        time.sleep(2.5)
        out = st.outcome()
        assert out["unplaced"] == ["g0", "g1"]
        # the capacity was released: a plain 7-CPU pod places
        st.pod("plain", cpu="7", memory="0")
        assert st.wait(lambda: st.client.get_pod(
            "default", "plain").spec.node_name != ""), "capacity not released"
        return st.outcome()

    got, _ = both(scenario, batch=batch)
    assert not got["held_by_unbound"]


@pytest.mark.parametrize("batch", [False, True], ids=["sequential", "batch"])
def test_gang_members_arriving_late_complete(batch):
    def scenario(st):
        st.node("n", cpu="8", memory="16Gi")
        st.group("job", 2, timeout=30)
        st.sync()
        st.sched.start()
        st.pod("early", "job", cpu="500m", memory="256Mi", ts=0.0)
        # the first member alone cannot reach the quorum: it is not
        # bound, and waits in the unschedulable queue for its peer
        assert st.wait(unschedulable(st, 1))
        assert not st.client.get_pod("default", "early").spec.node_name
        st.pod("late", "job", cpu="500m", memory="256Mi", ts=1.0)
        assert st.wait(lambda: st.bound() == 2), "the gang did not complete"
        return st.outcome()

    both(scenario, batch=batch)


@pytest.mark.parametrize("batch", [False, True], ids=["sequential", "batch"])
def test_non_gang_pods_unaffected(batch):
    def scenario(st):
        st.node("n", cpu="4")
        st.sync()
        st.pod("p", cpu="1", memory="0")
        st.sched.start()
        assert st.wait(lambda: st.bound() == 1)
        return st.outcome()

    both(scenario, batch=batch)


# -- contention: room for about half the gangs, gangs split across batches ---


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gang_contention_matches_the_jax_package(seed):
    """Eight gangs of 4-7 one-CPU pods on 6 nodes of 2-4 CPUs, three
    plain pods among them, ``max_batch`` 9: gangs split across batches
    and wait at Permit, gangs short of room fail their quorum and are
    re-solved away. Every gang binds whole or not at all, a gang that
    did not bind holds nothing, and the JAX package decides alike."""
    rng = random.Random(seed)
    caps = [rng.choice([2, 3, 4]) for _ in range(6)]
    sizes = [rng.choice([4, 5, 6, 7]) for _ in range(8)]
    order = [(f"gang{g}", k) for g, size in enumerate(sizes)
             for k in range(size)]
    for j in range(3):
        order.insert(rng.randrange(len(order) + 1), ("", j))

    def scenario(st):
        for i, c in enumerate(caps):
            st.node(f"n{i}", cpu=str(c))
        for g, size in enumerate(sizes):
            st.group(f"gang{g}", size, timeout=1)
        for t, (g, k) in enumerate(order):
            st.pod(f"{g}-{k}" if g else f"plain-{k}", g or None, ts=float(t))
        st.sync(queued=len(order))

        def quiet():
            q = st.sched.queue.num_pending()
            return not q["active"] and not any(
                len(fw.waiting_pods) for fw in st.sched.profiles.values())

        # the batches, then the Permit timeouts of gangs that cannot
        # assemble, then their members' retries
        assert drive(st, quiet, timeout=20)
        st.sched.wait_for_inflight_binds()
        return st.outcome()

    got, _ = both(scenario, max_batch=9)
    whole = {}
    for name, node in got["placed"].items():
        if name.startswith("gang"):
            g = name.split("-")[0]
            whole.setdefault(g, set()).add(bool(node))
    assert all(len(v) == 1 for v in whole.values()), whole
    assert not got["held_by_unbound"]
    assert sum(sizes) > sum(caps)  # not every gang fits
