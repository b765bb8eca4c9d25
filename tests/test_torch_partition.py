"""The port's partition plane (kubernetes_tpu_torch/scheduler/partition.py)
on the CPU, against the JAX package.

Exact everywhere: this is integer and host logic. The pure functions
(the partition hash, the rendezvous ranking, the balanced assignment,
a pod's home partition with gang homing and the spill annotation) give
the same answers as the JAX package's on seeded names and members; two
partitioned port stacks and two JAX stacks, the partition map held
fixed and every batch driven once the informers settled, place every
pod alike, one of them spilled to its sibling; the port's twins of the
coordinator and chaos cases (lease split and fence, renew-failure
adoption, spill exhaustion, the authority's index remap, the mid-burst
stack kill); ``SchedulerApp`` wiring the plane on ``device="cpu"``;
control-plane faults never escaping a batch completion (so the card's
halt is reached only by faults of the card); and the plane's modules
import neither JAX nor the JAX package.
"""

import ast
import os
import random
import time

import numpy as np
import pytest

import kubernetes_tpu.scheduler.partition as jax_part
import kubernetes_tpu_torch.scheduler.partition as port_part
from kubernetes_tpu.api.types import POD_GROUP_LABEL as JAX_GROUP
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.config.types import (
    PartitionConfiguration as JaxPartitionConfiguration,
)
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.api.types import POD_GROUP_LABEL, Lease, ObjectMeta
from kubernetes_tpu_torch.apiserver.server import APIServer, BindConflict
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.config.types import (
    KubeSchedulerConfiguration,
    PartitionConfiguration,
)
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjector,
    FaultPoint,
    FaultProfile,
    PointConfig,
    install_injector,
    load_profile,
)
from kubernetes_tpu_torch.scheduler.app import SchedulerApp
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STACKS = {
    "jax": (JaxAPIServer, JaxClient, JaxInformers, jax_new, jax_node,
            jax_pod, JaxPartitionConfiguration, jax_part),
    "torch": (APIServer, Client, InformerFactory, new_scheduler, make_node,
              make_pod, PartitionConfiguration, port_part),
}


@pytest.fixture(autouse=True)
def _clean_injector():
    yield
    install_injector(None)


def _wait(pred, timeout, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


class _FakeSched:
    """The scheduler surface the coordinator touches outside adoption."""

    def __init__(self):
        self.pods_spilled = 0
        self.crashed = False
        self.profiles = {}


def _config(cls=PartitionConfiguration, **kw):
    return cls(**{**dict(enabled=True, num_partitions=2,
                         lease_duration_seconds=0.5,
                         retry_period_seconds=0.05), **kw})


# -- the pure functions -------------------------------------------------------

@pytest.mark.parametrize("parts", [1, 2, 3, 4, 7, 16])
def test_partition_of_name_matches_jax(parts):
    rng = np.random.default_rng(parts)
    names = [f"node-{int(i)}" for i in rng.integers(0, 10**6, 300)]
    names += [f"zone-{i}" for i in range(10)] + ["", "a/b"]
    assert [port_part.partition_of_name(n, parts) for n in names] == [
        jax_part.partition_of_name(n, parts) for n in names
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rendezvous_and_assignment_match_jax(seed):
    rng = np.random.default_rng(seed)
    members = [f"scheduler-{int(x):08x}" for x in rng.integers(0, 2**32, 5)]
    for parts in (1, 2, 4, 8, 13):
        for m in range(1, len(members) + 1):
            sub = list(rng.permutation(members[:m]))
            assert port_part.compute_assignment(parts, sub) == (
                jax_part.compute_assignment(parts, sub)
            )
            for k in range(parts):
                assert port_part.rendezvous_ranking(k, sub) == (
                    jax_part.rendezvous_ranking(k, sub)
                )


def test_pod_partition_gang_homing_and_spill_match_jax():
    """Home partitions of seeded pods: plain pods by uid, gang pods by
    namespace/group, a spill annotation overriding both (an out-of-range
    or malformed one ignored)."""
    rng = np.random.default_rng(7)
    coords = {
        stack: STACKS[stack][7].PartitionCoordinator(
            STACKS[stack][1](STACKS[stack][0]()), _FakeSched(),
            _config(STACKS[stack][6], num_partitions=5), "s1",
        )
        for stack in STACKS
    }
    group_label = {"jax": JAX_GROUP, "torch": POD_GROUP_LABEL}
    homes = {stack: [] for stack in STACKS}
    for i in range(200):
        uid = f"uid-{int(rng.integers(0, 2**40)):x}"
        ns = f"team-{int(rng.integers(0, 3))}"
        gang = f"g{int(rng.integers(0, 6))}" if i % 3 == 0 else None
        spill = [None, "3", "9", "x"][int(rng.integers(0, 4))]
        for stack, coord in coords.items():
            pod = STACKS[stack][5](f"p{i}", ns).container(cpu="100m").obj()
            pod.metadata.uid = uid
            if gang:
                pod.metadata.labels[group_label[stack]] = gang
            if spill is not None:
                pod.metadata.annotations[
                    STACKS[stack][7].SPILL_TARGET_ANNOTATION] = spill
            homes[stack].append(coord.pod_partition(pod))
    assert homes["torch"] == homes["jax"]
    assert set(homes["torch"]) == set(range(5))


# -- two partitioned stacks per package, the map held fixed ------------------

def _partitioned_run(stack, seed=3):
    """Two partitioned batch schedulers ("stack-a", "stack-b") over one
    apiserver: their coordinators split two partitions by stepping by
    hand (no loop: the map stays fixed), then every batch is driven by
    hand once each stack's queue holds its home pods. One pod selects a
    label only the sibling partition's nodes carry: it spills there."""
    (Server, Cl, Informers, new, mk_node, mk_pod, PCfg, part) = STACKS[stack]
    server = Server()
    cfg = PCfg(enabled=True, num_partitions=2, lease_duration_seconds=60.0,
               retry_period_seconds=1.0)
    stacks = []
    for ident in ("stack-a", "stack-b"):
        client = Cl(server)
        informers = Informers(server)
        kw = {"device": "cpu"} if stack == "torch" else {}
        sched = new(client, informers, batch=True, max_batch=64, **kw)
        coord = part.attach_partitioning(sched, client, cfg, ident)
        stacks.append((client, informers, sched, coord))
    client = stacks[0][0]
    rng = random.Random(seed)
    for i in range(32):
        node = mk_node(f"n{i}").capacity(
            cpu=str(rng.choice((2, 4, 8))), memory=f"{rng.choice((4, 8))}Gi",
            pods=20)
        if part.partition_of_name(f"n{i}", 2) == 1:
            node = node.label("disk", "ssd")
        client.create_node(node.obj())
    for _ in range(4):
        for _c, _i, _s, coord in stacks:
            coord.step()
    held = [sorted(coord.held) for *_, coord in stacks]
    assert sorted(held[0] + held[1]) == [0, 1] and all(held)
    for _c, informers, sched, _co in stacks:
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
    pods = []
    for i in range(120):
        p = mk_pod(f"p{i}").creation_timestamp(float(i)).container(
            cpu=f"{rng.choice((100, 250, 500))}m",
            memory=f"{rng.choice((128, 256, 512))}Mi")
        pods.append(p.obj())
    # the spiller: homed to partition 0, feasible only on partition 1
    spiller = mk_pod("spiller").creation_timestamp(200.0).container(
        cpu="100m", memory="128Mi").node_selector(disk="ssd").obj()
    pods.append(spiller)
    for i, p in enumerate(pods):
        p.metadata.uid = f"uid-{seed}-{i:04d}"
    # the spiller's uid homes it to partition 0
    spiller.metadata.uid = next(
        u for u in (f"uid-spill-{j}" for j in range(64))
        if part.partition_of_name(u, 2) == 0)
    homes = [part.partition_of_name(p.metadata.uid, 2) for p in pods]
    try:
        client.create_pods_bulk(pods)
        owner = {k: s for s, (*_, coord) in enumerate(stacks)
                 for k in coord.held}
        want = [sum(1 for h in homes if owner[h] == s) for s in range(2)]
        # the informers settled: each queue holds exactly its home pods
        assert _wait(lambda: all(
            st[2].queue.active_count() == want[s]
            for s, st in enumerate(stacks)), 20)
        deadline = time.time() + 60
        while time.time() < deadline:
            for _c, _i, sched, _co in stacks:
                sched.schedule_batch(timeout=0.05)
                sched.wait_for_inflight_binds(timeout=10)
            if all(p.spec.node_name for p in client.list_pods()[0]):
                break
        placed = {p.metadata.name: p.spec.node_name
                  for p in client.list_pods()[0]}
        spilled = [st[2].pods_spilled for st in stacks]
        return placed, spilled, held
    finally:
        for _c, informers, sched, coord in stacks:
            sched.stop()
            informers.stop()


def test_two_partitioned_stacks_place_like_the_jax_package():
    want, want_spilled, want_held = _partitioned_run("jax")
    got, spilled, held = _partitioned_run("torch")
    assert all(got.values()), [k for k, v in got.items() if not v][:5]
    assert held == want_held
    assert got == want
    assert sum(spilled) == sum(want_spilled) == 1
    assert port_part.partition_of_name(got["spiller"], 2) == 1


# -- twins of the coordinator cases -------------------------------------------

def _coords(stack, parts, idents=("s1", "s2"), **kw):
    (Server, Cl, *_rest) = STACKS[stack]
    PCfg, part = STACKS[stack][6], STACKS[stack][7]
    server = Server()
    out = []
    for ident in idents:
        c = part.PartitionCoordinator(
            Cl(server), _FakeSched(), _config(PCfg, num_partitions=parts, **kw),
            ident)
        c._adopt_partition = lambda k: None
        c._drop_partition = lambda k: None
        out.append(c)
    return server, out


@pytest.mark.parametrize("parts", [2, 4, 6])
def test_two_coordinators_split_and_fence_like_jax(parts):
    split = {}
    for stack in STACKS:
        server, cs = _coords(stack, parts, lease_duration_seconds=30.0)
        for _ in range(6):
            for c in cs:
                c.step()
        held = [sorted(c.held) for c in cs]
        assert sorted(held[0] + held[1]) == list(range(parts))
        assert abs(len(held[0]) - len(held[1])) <= 1
        for c, other in (cs, reversed(cs)):
            for k in c.held:
                assert c.holds_partition(k) and not other.holds_partition(k)
        hosts = [f"n{i}" for i in range(40)]
        fenced = [sorted(c.fence_hosts(hosts)) for c in cs]
        assert set(fenced[0]) | set(fenced[1]) == set(range(40))
        assert not set(fenced[0]) & set(fenced[1])
        split[stack] = (held, fenced)
    assert split["torch"] == split["jax"]


def test_fence_after_seizure_matches_jax():
    out = {}
    for stack in STACKS:
        server, (c,) = _coords(stack, 2, idents=("s1",))
        c.step()
        hosts = [f"n{i}" for i in range(8)]
        assert c.fence_hosts(hosts) == set()
        k = c.node_partition(hosts[0])

        def seize(obj):
            obj.holder_identity = "intruder"
            obj.renew_time = time.monotonic()
            obj.lease_duration_seconds = 30.0

        server.guaranteed_update(
            "Lease", "kube-system", f"ksp-partition-{k}", seize)
        out[stack] = c.fence_hosts(hosts)
        assert out[stack] == {
            i for i, h in enumerate(hosts) if c.node_partition(h) == k}
    assert out["torch"] == out["jax"]


def test_renew_failure_drops_locally_and_sibling_adopts():
    server, (victim, survivor) = _coords("torch", 2)
    for _ in range(4):
        victim.step()
        survivor.step()
    assert len(victim.held) == 1 and len(survivor.held) == 1
    victim.fault_injector = FaultInjector(FaultProfile(
        "kill", seed=0,
        points={FaultPoint.LEASE_RENEW_FAIL: PointConfig(rate=1.0)},
    ))
    deadline = time.time() + 10
    while time.time() < deadline and (len(survivor.held) < 2 or victim.held):
        victim.step()
        survivor.step()
        time.sleep(0.05)
    assert sorted(survivor.held) == [0, 1]
    assert not victim.held
    assert survivor.takeovers >= 1


@pytest.mark.parametrize("parts", [2, 3, 5])
def test_spill_walk_and_exhaustion_match_jax(parts):
    """A pod spilled from every partition in turn: the same targets,
    counts and visited sets as the JAX package, and exhaustion after
    P - 1 hops."""
    trail = {}
    for stack in STACKS:
        (Server, Cl, *_r) = STACKS[stack]
        mk_pod, PCfg, part = STACKS[stack][5], STACKS[stack][6], STACKS[stack][7]
        server = Server()
        client = Cl(server)
        pod = mk_pod("sp").container(cpu="100m", memory="128Mi").obj()
        pod.metadata.uid = "uid-spill-0"
        client.create_pod(pod)
        sched = _FakeSched()
        steps = []
        live = pod
        for hop in range(parts):
            c = part.PartitionCoordinator(
                client, sched, _config(PCfg, num_partitions=parts),
                f"s{hop}")
            c.held = {c.pod_partition(live): 1}
            ok = c.try_spill(live)
            live = client.get_pod("default", "sp")
            ann = live.metadata.annotations
            steps.append((ok, ann.get(part.SPILL_TARGET_ANNOTATION),
                          ann.get(part.SPILL_COUNT_ANNOTATION),
                          ann.get(part.SPILL_VISITED_ANNOTATION)))
        trail[stack] = (steps, sched.pods_spilled)
        assert [s[0] for s in steps] == [True] * (parts - 1) + [False]
        assert sched.pods_spilled == parts - 1
    assert trail["torch"] == trail["jax"]


def test_authority_remaps_bulk_bind_indexes():
    server = APIServer()
    client = Client(server)
    cfg = _config(num_partitions=2)
    server.install_partition_authority(
        port_part.PartitionAuthority(server, cfg, clock=time.monotonic))
    now = time.monotonic()
    for k, holder in ((0, "s1"), (1, "s2")):
        server.create(Lease(
            metadata=ObjectMeta(name=f"ksp-partition-{k}",
                                namespace="kube-system"),
            holder_identity=holder, lease_duration_seconds=30.0,
            renew_time=now))
    part_of = {f"n{i}": port_part.partition_of_name(f"n{i}", 2)
               for i in range(20)}
    nodes = ([n for n, k in part_of.items() if k == 0][:3]
             + [n for n, k in part_of.items() if k == 1][:3])
    random.Random(5).shuffle(nodes)
    assumed, want_conflict = [], []
    for i, node in enumerate(nodes):
        pod = make_pod(f"b{i}").container(cpu="100m", memory="128Mi").obj()
        client.create_pod(pod)
        clone = pod.assumed_clone()
        clone.spec.node_name = node
        assumed.append(clone)
        if part_of[node] == 1:
            want_conflict.append(i)
    errors = server.bind_assumed_bulk(assumed, binder="s1")
    assert sorted(i for i, _ in errors) == want_conflict
    assert all(isinstance(e, BindConflict) and e.kind == "foreign-partition"
               for _, e in errors)
    for i, a in enumerate(assumed):
        live = client.get_pod("default", a.metadata.name)
        assert (live.spec.node_name == "") == (i in want_conflict)


# -- stacks through SchedulerApp on the CPU -----------------------------------

def _cfg(num_partitions=2, lease=0.6, retry=0.06):
    return KubeSchedulerConfiguration(partition=PartitionConfiguration(
        enabled=True, num_partitions=num_partitions,
        lease_duration_seconds=lease, retry_period_seconds=retry))


def _incarnation_binds(server):
    """uid -> unbound-to-bound transitions over the full watch history."""
    w = server.watch("Pod", since_rv=0)
    node, binds = {}, {}
    for ev in w.pending():
        uid = ev.object.metadata.uid
        if ev.type == "DELETED":
            node.pop(uid, None)
            continue
        cur = ev.object.spec.node_name or ""
        if not node.get(uid) and cur:
            binds[uid] = binds.get(uid, 0) + 1
        node[uid] = cur
    w.stop()
    return binds


def test_mid_burst_stack_kill_survivor_adopts_and_binds_all():
    """The port's twin of the headline chaos case: two SchedulerApp
    stacks on the CPU split four partitions over 24 nodes; the first
    stack's renews die as 800 pods land. The survivor adopts every
    partition, every pod binds exactly once per incarnation, and both
    conflict ledgers balance."""
    server = APIServer()
    app1 = SchedulerApp(config=_cfg(4), server=server, device="cpu")
    client = app1.client
    for i in range(24):
        client.create_node(make_node(f"n{i}").capacity(
            cpu="32", memory="64Gi", pods=110).obj())
    app1.start()
    app2 = SchedulerApp(config=_cfg(4), server=server, device="cpu")
    app2.start()
    try:
        assert _wait(lambda: len(app1.coordinator.held) == 2
                     and len(app2.coordinator.held) == 2, 10)
        app1.coordinator.fault_injector = FaultInjector(FaultProfile(
            "stack-kill", seed=0,
            points={FaultPoint.LEASE_RENEW_FAIL: PointConfig(rate=1.0)},
        ))
        n = 800
        for lo in range(0, n, 200):
            client.create_pods_bulk([
                make_pod(f"p{j}").container(cpu="100m", memory="128Mi").obj()
                for j in range(lo, lo + 200)])
        assert _wait(lambda: sum(1 for p in client.list_pods()[0]
                                 if p.spec.node_name) == n, 60)
        assert _wait(lambda: len(app2.coordinator.held) == 4, 30)
        assert app2.coordinator.takeovers >= 1
        assert not app1.coordinator.held
        assert app2.sched.cache.node_count() == 24
        app1.sched.wait_for_inflight_binds()
        app2.sched.wait_for_inflight_binds()
        binds = _incarnation_binds(server)
        assert len(binds) == n and set(binds.values()) == {1}
        for s in (app1.sched, app2.sched):
            assert s.bind_conflicts_absorbed == (
                s.conflict_requeues + s.conflict_stale_binds)
            assert s.card_fault is None
            assert s.ladder.solves_by_tier["host_greedy"] == 0
    finally:
        app2.stop()
        app1.stop()


def test_control_plane_faults_never_escape_a_batch_completion(monkeypatch):
    """The card's halt (a failed batch completion stops the stack) is
    reached only by what escapes ``_complete_solve``. Under the
    partition-chaos profile with every apiserver write and list failing
    often (lease renews, spills, fences, conflict reads, binds, the
    preemption wave's evictions), nothing escapes it: every control-plane
    call on the completion path absorbs its own fault, so on the card
    only a fault of the card can stop a partitioned stack."""
    from kubernetes_tpu_torch.scheduler import batch as batch_mod

    escaped = []
    orig = batch_mod.BatchScheduler._complete_solve

    def complete(self, p):
        try:
            return orig(self, p)
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            escaped.append(repr(e))
            raise

    monkeypatch.setattr(batch_mod.BatchScheduler, "_complete_solve", complete)
    server = APIServer()
    apps = [SchedulerApp(config=_cfg(4), server=server, device="cpu")
            for _ in range(2)]
    client = apps[0].client
    for i in range(24):
        client.create_node(make_node(f"n{i}").capacity(
            cpu="4", memory="8Gi", pods=110).label("zone", f"z{i % 3}").obj())
    for app in apps:
        app.start()
    try:
        assert _wait(lambda: sorted(
            k for a in apps for k in a.coordinator.held) == [0, 1, 2, 3], 10)
        profile = load_profile("partition-chaos", seed=1)
        profile.points[FaultPoint.API_UNAVAILABLE] = PointConfig(
            rate=0.1, max_fires=150)
        install_injector(FaultInjector(profile))
        # zone-pinned pods spill across stacks; the cluster overflows
        # (192 slots by CPU), so preemption waves run too
        for lo in range(0, 300, 100):
            client.create_pods_bulk([
                make_pod(f"c{j}").container(cpu="500m", memory="512Mi")
                .priority(j % 3 * 50).node_selector(zone=f"z{j % 3}").obj()
                for j in range(lo, lo + 100)])
        time.sleep(6.0)
        install_injector(None)
        assert _wait(lambda: sum(1 for p in client.list_pods()[0]
                                 if p.spec.node_name) >= 96, 30)
    finally:
        install_injector(None)
        for app in apps:
            app.stop()
    assert not escaped, escaped[:3]
    for app in apps:
        assert app.sched.card_fault is None


def test_partition_plane_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "kubernetes_tpu_torch", "scheduler", f)
             for f in ("partition.py", "tenancy.py", "app.py")]
    files += [os.path.join(REPO, "kubernetes_tpu_torch", "controllers", f)
              for f in ("quota.py", "__init__.py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                root = mod.split(".")[0]
                assert root not in ("jax", "jaxlib", "kubernetes_tpu"), (
                    f"{path} imports {mod}")
