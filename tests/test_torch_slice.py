"""The port's main path as a whole, on the CPU, against the JAX package.

The same seeded cluster and burst go through the JAX package's batch
scheduler and through the port's (``new_scheduler(batch=True,
device="cpu")``): every pod binds, and the placements are equal pod for
pod -- for plain pods (the greedy solve) and for one constrained burst
per family on a zoned cluster: hard zone spread, hostname
anti-affinity, zone affinity, preferred affinity on a cluster whose
existing pods score every batch, and a Service's selector spread (the
constrained solve). And no module of the port imports JAX or the JAX
package.
"""

import ast
import os
import random
import time

import pytest

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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubernetes_tpu_torch")
ZONE = "topology.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"

STACKS = {
    "jax": (JaxAPIServer, JaxClient, JaxInformers, jax_new, jax_node, jax_pod),
    "torch": (APIServer, Client, InformerFactory, new_scheduler, make_node,
              make_pod),
}


def _pod_specs(num, seed):
    rng = random.Random(seed)
    return [
        (f"p{i}", f"{rng.choice((100, 250, 500, 1000))}m",
         f"{rng.choice((128, 256, 512, 1024))}Mi")
        for i in range(num)
    ]


def _wait_bound(client, want, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if sum(1 for p in pods if p.spec.node_name) >= want:
            return
        time.sleep(0.05)


def _service(stack, name, selector):
    if stack == "jax":
        from kubernetes_tpu.api.types import ObjectMeta, Service
    else:
        from kubernetes_tpu_torch.api.types import ObjectMeta, Service
    return Service(
        metadata=ObjectMeta(name=name, namespace="default"),
        selector=dict(selector),
    )


def _run(stack, specs, nodes=64, max_batch=128, extra=None, caps=None,
         zones=0, labels=None, services=(), **kw):
    Server, Cl, Informers, new, mk_node, mk_pod = STACKS[stack]
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    sched = new(client, informers, batch=True, max_batch=max_batch, **kw)
    rng = random.Random(1)
    for i in range(nodes):
        cpu, mem = caps or (
            str(rng.choice((4, 8, 16))), f"{rng.choice((8, 16, 32))}Gi"
        )
        node = (
            mk_node(f"n{i}")
            .capacity(cpu=cpu, memory=mem, pods=110)
            .label(HOST, f"n{i}")
        )
        if zones:
            node = node.label(ZONE, f"zone-{i % zones}")
        client.create_node(node.obj())
    for name, selector in services:
        server.create(_service(stack, name, selector))
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.start()
    try:
        pods = [
            mk_pod(name).creation_timestamp(float(i))
            .container(cpu=cpu, memory=mem).labels(**(labels or {})).obj()
            for i, (name, cpu, mem) in enumerate(specs)
        ]
        for lo in range(0, len(pods), 100):
            client.create_pods_bulk(pods[lo:lo + 100])
        _wait_bound(client, len(pods))
        sched.wait_for_inflight_binds()
        if extra is not None:
            extra(client, mk_pod)
        placements = {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }
        return placements, sched
    finally:
        sched.stop()
        informers.stop()


def test_plain_burst_places_like_the_jax_package():
    specs = _pod_specs(300, seed=5)
    want, _ = _run("jax", specs)
    got, sched = _run("torch", specs, device="cpu")
    assert all(got.values()), [k for k, v in got.items() if not v][:5]
    assert got == want
    assert sched.pods_fallback == 0
    tiers = sched.ladder.solves_by_tier
    assert tiers["torch"] > 0
    assert tiers["cuda"] == tiers["host_greedy"] == tiers["sequential"] == 0


def test_int16_carry_burst_places_like_the_jax_package():
    """A cluster whose per-node KiB/milliCPU totals sit inside the int16
    range gate: the resident carry runs compressed (packed 'h' uploads,
    int16 on the device, mode flips as it fills) and still places pod
    for pod like the JAX package."""
    from kubernetes_tpu_torch.utils import metrics

    rng = random.Random(11)
    specs = [
        (f"c{i}", f"{rng.choice((50, 100, 150))}m",
         f"{rng.choice((512, 1024))}Ki")
        for i in range(300)
    ]
    kw = dict(nodes=40, max_batch=16, caps=("4", "24Mi"))
    want, _ = _run("jax", specs, **kw)
    saved = metrics.carry_compress_bytes_saved.value()
    got, sched = _run("torch", specs, device="cpu", **kw)
    assert all(got.values())
    assert got == want
    assert metrics.carry_compress_bytes_saved.value() > saved
    assert sched.pods_fallback == 0


def test_required_anti_affinity_takes_the_sequential_route():
    """Pods with required anti-affinity need the constrained solve. The
    port no longer routes their batch to the sequential path: it solves
    on the ``torch`` tier (the constrained kernel's plain version on the
    CPU), the pods land on distinct nodes, and every pod places as in the
    JAX package."""
    n_anti = 4

    def anti_batch(client, mk_pod):
        client.create_pods_bulk([
            mk_pod(f"anti{i}").labels(app="db")
            .creation_timestamp(100.0 + i)
            .container(cpu="100m", memory="64Mi")
            .pod_affinity(
                "kubernetes.io/hostname", {"app": "db"}, anti=True
            ).obj()
            for i in range(n_anti)
        ])
        _wait_bound(client, 40 + n_anti)

    run = dict(nodes=8, extra=anti_batch)
    want, _ = _run("jax", _pod_specs(40, seed=6), **run)
    placements, sched = _run(
        "torch", _pod_specs(40, seed=6), device="cpu", **run
    )
    assert all(placements.values())
    hosts = [placements[f"anti{i}"] for i in range(n_anti)]
    assert len(set(hosts)) == n_anti
    assert placements == want
    assert sched.pods_fallback == 0
    tiers = sched.ladder.solves_by_tier
    assert tiers["torch"] > 0
    assert tiers["cuda"] == tiers["host_greedy"] == tiers["sequential"] == 0


def _family_burst(family):
    """One constrained burst on a 48-node, 6-zone cluster: init pods,
    then 40-60 pods of the family's spec (after the perf matrix's rows,
    benchmarks/config/performance-config.yaml:86-145, scaled down)."""

    def pod(mk_pod, name, ts, labels):
        return (
            mk_pod(name).creation_timestamp(ts).labels(**labels)
            .container(cpu="100m", memory="128Mi")
        )

    def measured(mk_pod, i):
        if family == "spread":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"app": "spread"}) \
                .spread_constraint(
                    max_skew=1, topology_key=ZONE,
                    when_unsatisfiable="DoNotSchedule",
                    match_labels={"app": "spread"},
                )
        if family == "anti":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"color": "red"}) \
                .pod_affinity(HOST, {"color": "red"}, anti=True)
        if family == "affinity":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"peer": "base"}) \
                .pod_affinity(ZONE, {"peer": "base"})
        if family == "preferred":
            return pod(mk_pod, f"m{i}", 1000.0 + i, {"pref": "base"}) \
                .preferred_pod_affinity(ZONE, {"pref": "base"}, weight=10)
        return pod(mk_pod, f"m{i}", 1000.0 + i, {"svc": "web"})

    init_labels = {
        "spread": {"app": "spread"}, "anti": {"color": "blue"},
        "affinity": {"peer": "base"}, "preferred": {"pref": "base"},
        "service": {"svc": "web"},
    }[family]
    # anti-affinity pods each need a node of their own
    n_init, n_measured = 8, 40 if family == "anti" else 60

    def second_wave(client, mk_pod):
        if family == "preferred":
            # existing pods whose preferred terms score every later batch
            client.create_pods_bulk([
                pod(mk_pod, f"e{i}", 500.0 + i, {"pref": "base"})
                .preferred_pod_affinity(ZONE, {"pref": "base"}, weight=5)
                .obj()
                for i in range(4)
            ])
            _wait_bound(client, n_init + 4)
        done = n_init + (4 if family == "preferred" else 0)
        pods = [measured(mk_pod, i).obj() for i in range(n_measured)]
        for lo in range(0, n_measured, 20):
            client.create_pods_bulk(pods[lo:lo + 20])
        _wait_bound(client, done + n_measured)

    services = [("web", {"svc": "web"})] if family == "service" else []
    return dict(
        nodes=48, zones=6, max_batch=32, extra=second_wave,
        labels=init_labels, services=services,
        caps=("8", "16Gi"),
    ), _pod_specs(n_init, seed=9)


@pytest.mark.parametrize(
    "family", ["spread", "anti", "affinity", "preferred", "service"]
)
def test_constrained_burst_places_like_the_jax_package(family):
    run, specs = _family_burst(family)
    want, _ = _run("jax", specs, **run)
    got, sched = _run("torch", specs, device="cpu", **run)
    assert all(got.values()), [k for k, v in got.items() if not v][:5]
    assert got == want
    assert sched.pods_fallback == 0
    assert sched.envelope_fallbacks == 0
    tiers = sched.ladder.solves_by_tier
    assert tiers["torch"] > 0
    assert tiers["cuda"] == tiers["host_greedy"] == tiers["sequential"] == 0
    if family == "anti":
        hosts = [v for k, v in got.items() if k.startswith("m")]
        assert len(hosts) == 40 and len(set(hosts)) == 40


def _drain_then_constrained(stack, **kw):
    """Drive the batch loop by hand with no committer thread, so a
    dispatched batch stays in flight: a plain batch is dispatched, then a
    hard-spread batch whose counts must include the in-flight placements.
    Returns (placements, scheduler)."""
    Server, Cl, Informers, new, mk_node, mk_pod = STACKS[stack]
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    sched = new(client, informers, batch=True, max_batch=32, **kw)
    sched._ensure_committer = lambda: None  # in flight until drained
    for i in range(12):
        client.create_node(
            mk_node(f"n{i}").capacity(cpu="8", memory="16Gi", pods=110)
            .label(HOST, f"n{i}").label(ZONE, f"zone-{i % 3}").obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()

    def dispatch(want):
        done = 0
        for _ in range(100):
            done += sched.schedule_batch(timeout=0.2, pipeline=True)
            if done >= want:
                return
        raise AssertionError(f"only {done}/{want} pods dispatched")

    try:
        client.create_pods_bulk([
            mk_pod(f"plain{i}").creation_timestamp(float(i))
            .labels(app="web").container(cpu="500m", memory="256Mi").obj()
            for i in range(8)
        ])
        dispatch(8)
        assert sched._pending_exists()
        client.create_pods_bulk([
            mk_pod(f"spread{i}").creation_timestamp(100.0 + i)
            .labels(app="web").container(cpu="100m", memory="64Mi")
            .spread_constraint(
                max_skew=1, topology_key=ZONE,
                when_unsatisfiable="DoNotSchedule",
                match_labels={"app": "web"},
            ).obj()
            for i in range(10)
        ])
        dispatch(10)
        sched._drain_pending()
        sched.wait_for_inflight_binds()
        return {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }, sched
    finally:
        sched.stop()
        informers.stop()


def test_a_constrained_pack_lands_the_batches_in_flight_first():
    """The hard-spread batch's counts come from the host cache, so the
    plain batch still in flight must commit before the pack (the
    pipeline drain): the port drains it, as the JAX package does, and
    places every pod as the JAX package does."""
    want, jsched = _drain_then_constrained("jax")
    got, sched = _drain_then_constrained("torch", device="cpu")
    assert all(got.values())
    assert got == want
    assert sched.pipeline_drains >= 1
    assert sched.pipeline_drains == jsched.pipeline_drains
    assert sched.ladder.solves_by_tier["torch"] >= 2
    assert sched.pods_fallback == 0


def test_a_fault_on_the_card_raises_instead_of_solving_on_the_cpu(
    monkeypatch,
):
    """With the solver's tensors on the card, a failed device solve (here
    a stand-in for an illegal-address fault) propagates out of the batch
    loop: no host-greedy or sequential tier solves the batch on the CPU,
    and no pod binds."""
    import torch

    from kubernetes_tpu_torch.scheduler import batch as batch_mod

    def faulting_solve(*_args, **_kwargs):
        raise RuntimeError("CUDA error: an illegal memory access")

    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=32,
                          device="cpu")
    for i in range(4):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="4", memory="8Gi", pods=110).obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        client.create_pods_bulk([
            make_pod(f"p{i}").container(cpu="100m", memory="64Mi").obj()
            for i in range(8)
        ])
        monkeypatch.setattr(batch_mod, "solve_packed", faulting_solve)
        sched.device = torch.device("cuda")  # as if the tensors were there
        with pytest.raises(RuntimeError, match="illegal memory access"):
            for _ in range(50):
                if sched.schedule_batch(timeout=0.2):
                    break
        tiers = sched.ladder.solves_by_tier
        assert tiers["host_greedy"] == tiers["sequential"] == 0
        assert sched.pods_fallback == 0
        assert not any(p.spec.node_name for p in client.list_pods()[0])
    finally:
        sched.stop()
        informers.stop()


def _preemption_tail(stack, **kw):
    """Drive the batch loop by hand (no scheduler thread, so the tail is
    ONE batch and ONE wave): 6 nodes of 4 CPUs filled by 12 low pods of
    priorities 0 and 10, then a tail of 4 high pods (priorities 100 and
    50) that must each evict one victim. Returns (final placements, the
    wave's nominations, the evicted pods, scheduler)."""
    Server, Cl, Informers, new, mk_node, mk_pod = STACKS[stack]
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    sched = new(client, informers, batch=True, max_batch=64, **kw)
    for i in range(6):
        client.create_node(
            mk_node(f"n{i}").capacity(cpu="4", memory="8Gi", pods=10).obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    nominations = {}
    orig = sched.preemptor.preempt_batch

    def recording(prof, items):
        nominated, uids = orig(prof, items)
        for (pod, _), node in zip(items, nominated):
            nominations[pod.metadata.name] = node
        # let the evictions reach the cache before the retries run (the
        # wave itself waits at most 0.5 s), so a loaded machine cannot
        # turn a retry into a second wave in one package and not the other
        deadline = time.time() + 30
        while any(sched.cache.has_pod_uid(u) for u in uids or ()):
            assert time.time() < deadline, "the evictions never landed"
            time.sleep(0.01)
        return nominated, uids

    sched.preemptor.preempt_batch = recording

    def settled(names):
        """The informer holds every listed pod's latest write: a status
        write the scheduler made (the failure condition and nomination)
        has reached the queue, so its echo cannot re-add a pod that a
        later batch is already scheduling."""
        for name in names:
            try:
                cur = client.get_pod("default", name)
            except KeyError:
                continue
            seen = informers.pods().get("default", name)
            if seen is None or (
                seen.metadata.resource_version
                != cur.metadata.resource_version
            ):
                return False
        return True

    def drive(names):
        # the whole set in the queue first, so it is ONE batch
        deadline = time.time() + 30
        while sched.queue.active_count() < len(names):
            assert time.time() < deadline, "the pods never reached the queue"
            time.sleep(0.01)
        deadline = time.time() + 60
        while time.time() < deadline:
            while not settled(names):
                assert time.time() < deadline, "the informer fell behind"
                time.sleep(0.01)
            time.sleep(0.01)  # the handler runs just after the store
            sched.schedule_batch(timeout=0.1)
            sched.wait_for_inflight_binds()
            placed = {
                p.metadata.name: p.spec.node_name
                for p in client.list_pods()[0]
            }
            if all(placed.get(n) for n in names):
                return
        raise AssertionError(f"{stack}: not every pod of {names} bound")

    try:
        low = [f"low{i}" for i in range(12)]
        client.create_pods_bulk([
            mk_pod(name).creation_timestamp(float(i)).priority(10 * (i % 2))
            .container(cpu="2", memory="1Gi").obj()
            for i, name in enumerate(low)
        ])
        drive(low)
        high = [f"high{i}" for i in range(4)]
        client.create_pods_bulk([
            mk_pod(name).creation_timestamp(100.0 + i)
            .priority(100 if i < 2 else 50)
            .container(cpu="2", memory="1Gi").obj()
            for i, name in enumerate(high)
        ])
        drive(high)
        placed = {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }
        evicted = sorted(set(low) - set(placed))
        return placed, nominations, evicted, sched
    finally:
        sched.stop()
        informers.stop()


def test_a_high_priority_tail_preempts_like_the_jax_package():
    """A saturated cluster takes a high-priority tail: the port's wave
    (the ``torch`` tier, K3's plain version) nominates the same nodes,
    evicts the same victims and ends in the same placements as the JAX
    package's device wave, and no pod takes the host oracle."""
    want_placed, want_nom, want_evicted, _ = _preemption_tail("jax")
    placed, nom, evicted, sched = _preemption_tail("torch", device="cpu")
    assert want_nom and all(want_nom.values())
    assert nom == want_nom
    assert evicted == want_evicted and len(evicted) == 4
    assert placed == want_placed
    # a retry that races its victim's eviction into the cache fails once
    # more and takes a second (victim-free) wave: counts are lower bounds
    p = sched.preemptor
    assert p.waves >= 1 and p.wave_solver_tier == "torch"
    assert p.device_preemptions >= 4 and p.host_preemptions == 0
    assert p.ladder.solves_by_tier["torch"] == p.waves


def _pdb_never_negative(server):
    """Replay the full PodDisruptionBudget watch history: every status
    write must leave disruptionsAllowed >= 0."""
    w = server.watch("PodDisruptionBudget", since_rv=0)
    floor = 0
    for ev in w.pending():
        if ev.type == "DELETED":
            continue
        floor = min(floor, ev.object.status.disruptions_allowed)
    w.stop()
    return floor >= 0


def _bind_transitions_by_uid(server):
    """unbound->bound transitions per pod incarnation (uid), replayed
    from the full watch history."""
    w = server.watch("Pod", since_rv=0)
    node = {}
    transitions = {}
    for ev in w.pending():
        pod = ev.object
        uid = pod.metadata.uid
        if ev.type == "DELETED":
            node.pop(uid, None)
            continue
        prev = node.get(uid, "")
        cur = pod.spec.node_name or ""
        if not prev and cur:
            transitions[uid] = transitions.get(uid, 0) + 1
        node[uid] = cur
    w.stop()
    return transitions


def _wait_named_bound(client, names, deadline_s):
    deadline = time.time() + deadline_s
    names = set(names)
    while time.time() < deadline:
        pods, _ = client.list_pods()
        bound = {
            p.metadata.name for p in pods
            if p.metadata.name in names and p.spec.node_name
        }
        if bound == names:
            return True
        time.sleep(0.05)
    return False


def test_high_priority_tail_guard():
    """tests/test_preemption_wave.py's tier-1 guard on the port: 1k
    low-priority pods saturate the cluster; a 40-pod high-priority tail
    must ALL bind via the batched wave (the ``torch`` tier), with zero
    PDB overspend through the port's DisruptionController, no budget
    denials (ample budget), and the device carry warm across the wave
    (state_uploads <= 1 after the victims commit)."""
    from kubernetes_tpu_torch.api.types import (
        LabelSelector,
        PodDisruptionBudget,
    )
    from kubernetes_tpu_torch.controllers import DisruptionController
    from kubernetes_tpu_torch.utils import metrics

    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=256,
                          device="cpu")
    for i in range(50):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="20", memory="64Gi", pods=40)
            .obj()
        )
    dc = DisruptionController(client, informers)
    sched.preemptor.disruption = dc
    pdb = PodDisruptionBudget(
        selector=LabelSelector(match_labels={"app": "low"}),
        max_unavailable=80,
    )
    pdb.metadata.name = "tail-budget"
    pdb.metadata.namespace = "default"
    client.create_pdb(pdb)
    informers.start()
    informers.wait_for_cache_sync()
    dc.start()
    sched.queue.run()
    try:
        low_names = [f"low-{i}" for i in range(1000)]
        client.create_pods_bulk([
            make_pod(nm).container(cpu="1", memory="128Mi")
            .labels(app="low").priority(0).obj()
            for nm in low_names
        ])
        sched.start()
        assert _wait_named_bound(client, low_names, 120), (
            "saturating burst never fully bound"
        )
        sched.wait_for_inflight_binds(timeout=60)

        uploads0 = sched.state_uploads
        denials0 = sched.preemptor.budget_denials
        blocked0 = metrics.evictions_blocked_by_pdb.value()

        high_names = [f"high-{i}" for i in range(40)]
        client.create_pods_bulk([
            make_pod(nm).container(cpu="1", memory="128Mi")
            .priority(100).obj()
            for nm in high_names
        ])
        assert _wait_named_bound(client, high_names, 120), (
            "high-priority tail did not fully bind"
        )
        sched.wait_for_inflight_binds(timeout=60)

        p = sched.preemptor
        assert p.waves >= 1 and p.host_preemptions == 0
        assert p.victims_by_tier.get("torch", 0) >= 40
        assert sum(p.victims_by_tier.values()) == p.victims_by_tier["torch"]
        assert p.budget_denials == denials0
        assert metrics.evictions_blocked_by_pdb.value() == blocked0
        assert _pdb_never_negative(server)
        assert sched.state_uploads - uploads0 <= 1, (
            f"preemption wave forced {sched.state_uploads - uploads0} "
            "state uploads"
        )
        transitions = _bind_transitions_by_uid(server)
        doubles = {u: c for u, c in transitions.items() if c > 1}
        assert not doubles, f"double-bound incarnations: {doubles}"
    finally:
        sched.stop()
        dc.stop()
        informers.stop()


def test_a_fault_of_the_card_victim_search_raises(monkeypatch):
    """With the victim search on the card, a KernelError from K3 (here
    raised by a stand-in for the wave's device call whose launch is
    refused) propagates out of the
    deferred wave, as the cause of the CardFault that halts the
    scheduler: no host oracle answers the wave, no victim is evicted,
    no nomination is made."""
    import torch

    from kubernetes_tpu_torch.ops import preemption as preemption_ops
    from kubernetes_tpu_torch.ops.kernel_build import KernelError
    from kubernetes_tpu_torch.robustness.ladder import CardFault

    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=32,
                          device="cpu")
    for i in range(2):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="4", memory="8Gi", pods=10).obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    flush = sched._flush_deferred_preemptions
    try:
        low = [f"low{i}" for i in range(4)]
        client.create_pods_bulk([
            make_pod(name).container(cpu="2", memory="1Gi").obj()
            for name in low
        ])
        assert sched.schedule_batch(timeout=1.0) == 4
        sched.wait_for_inflight_binds()
        # park the high pod's failure without running the wave
        sched._flush_deferred_preemptions = lambda: None
        client.create_pod(
            make_pod("high").priority(100).container(cpu="2", memory="1Gi")
            .obj()
        )
        for _ in range(50):
            if sched.schedule_batch(timeout=0.2):
                break
        assert len(sched._deferred_preempt) == 1
        sched._flush_deferred_preemptions = flush

        def refused(*_args, **_kwargs):
            raise KernelError("preempt_solve_kernel launch failed: cudaError 1")

        # the device call of the wave, whose K3 launch is refused
        monkeypatch.setattr(preemption_ops, "preempt_batch_device", refused)
        # as if the solver's tensors were on the card
        sched.device = torch.device("cuda")
        sched.preemptor.device = torch.device("cuda")
        with pytest.raises(CardFault, match="launch failed") as raised:
            sched._flush_deferred_preemptions()
        assert isinstance(raised.value.__cause__, KernelError)
        assert sched.card_fault is raised.value and sched._stop.is_set()
        p = sched.preemptor
        assert p.host_preemptions == 0 and p.device_preemptions == 0
        assert p.waves == 0 and not p.victims_by_tier
        assert p.ladder.solves_by_tier["cuda"] == 0
        pods = {pd.metadata.name: pd for pd in client.list_pods()[0]}
        assert all(name in pods for name in low)  # nothing evicted
        assert not pods["high"].spec.node_name
        assert sched.queue.nominated_pods_for_node("n0") == []
        assert sched.queue.nominated_pods_for_node("n1") == []
    finally:
        sched.stop()
        informers.stop()


def test_entry_points_default_to_the_card():
    """No device named and no card visible: the entry point raises
    instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is valid")
    server = APIServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        new_scheduler(Client(server), InformerFactory(server), batch=True)


def _imports(path):
    with open(path, "rb") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_sources():
    for dirpath, dirnames, filenames in os.walk(PORT):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = list(_port_sources())
    assert len(sources) > 50
    bad = []
    for path in sources:
        for mod in _imports(path):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "kubernetes_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad
