"""Two guards of the JAX package, on the CPU, in both packages.

- The preemption guards of ``tests/test_preemption_wave.py``: the
  preemption-chaos storm (wave-solve faults, a bind-conflict burst and
  slow-dying victims at profile seed 10: the high band binds 100%, no
  PodDisruptionBudget is ever spent below zero over the whole watch
  history, and every pod incarnation binds once), a zero-budget PDB
  denying a wave's victims (no nomination, no eviction, the denial
  counted), and a nominated node's deletion clearing the nomination in
  the queue and in the pod's status. The port's wave runs its plain
  victim search (``device="cpu"``), the JAX package's its own tiers; each
  package is held to the reference test's checks, and the outcomes that
  do not hang on thread timing (which pods bound, the denial, the
  nominations) must be equal.
- The zero-mid-run-build probe of ``tests/test_mesh_state_guard.py``: a
  warmed steady burst on a 2-shard mesh builds no kernel family after
  warmup (``kernel_build_counts`` before and after; the JAX package's
  ``mesh_packed_cache_size`` alike) and places as the JAX mesh run, and
  a build that does happen after warmup is booked by the scheduler's
  watchdog as a mid-run build of its family.
"""

import random
import time

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu.apiserver import server as jax_server
from kubernetes_tpu.cache import cache as jax_cache
from kubernetes_tpu.cache import snapshot as jax_snapshot
from kubernetes_tpu.client import client as jax_client
from kubernetes_tpu.client import informer as jax_informer
from kubernetes_tpu import controllers as jax_controllers
from kubernetes_tpu.framework import interface as jax_interface
from kubernetes_tpu.framework import runtime as jax_runtime
from kubernetes_tpu import plugins as jax_plugins
from kubernetes_tpu.queue import scheduling_queue as jax_queue
from kubernetes_tpu.robustness import faults as jax_faults
from kubernetes_tpu.scheduler import generic as jax_generic
from kubernetes_tpu.scheduler import preemption as jax_preemption
from kubernetes_tpu.scheduler import provider as jax_provider
from kubernetes_tpu.scheduler import scheduler as jax_scheduler
from kubernetes_tpu import testing as jax_testing
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu.ops.assignment import mesh_packed_cache_size
from kubernetes_tpu_torch.api import types as torch_types
from kubernetes_tpu_torch.apiserver import server as torch_server
from kubernetes_tpu_torch.cache import cache as torch_cache
from kubernetes_tpu_torch.cache import snapshot as torch_snapshot
from kubernetes_tpu_torch.client import client as torch_client
from kubernetes_tpu_torch.client import informer as torch_informer
from kubernetes_tpu_torch import controllers as torch_controllers
from kubernetes_tpu_torch.framework import interface as torch_interface
from kubernetes_tpu_torch.framework import runtime as torch_runtime
from kubernetes_tpu_torch import plugins as torch_plugins
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.ops import shard_kernel
from kubernetes_tpu_torch.ops.mesh import NodeMesh
from kubernetes_tpu_torch.queue import scheduling_queue as torch_queue
from kubernetes_tpu_torch.robustness import faults as torch_faults
from kubernetes_tpu_torch.scheduler import generic as torch_generic
from kubernetes_tpu_torch.scheduler import preemption as torch_preemption
from kubernetes_tpu_torch.scheduler import provider as torch_provider
from kubernetes_tpu_torch.scheduler import scheduler as torch_scheduler
from kubernetes_tpu_torch import testing as torch_testing
from kubernetes_tpu_torch.utils import metrics as torch_metrics


class Pkg:
    """One package's modules, under the same names."""

    def __init__(self, name, **mods):
        self.name = name
        self.__dict__.update(mods)
        self.kw = {"device": "cpu"} if name == "torch" else {}


NAMES = ("types", "server", "cache", "snapshot", "client", "informer",
         "controllers", "interface", "runtime", "plugins", "queue", "faults",
         "generic", "preemption", "provider", "scheduler", "testing",
         "metrics")
PKGS = {
    "jax": Pkg("jax", **dict(zip(NAMES, (
        jax_types, jax_server, jax_cache, jax_snapshot, jax_client,
        jax_informer, jax_controllers, jax_interface, jax_runtime,
        jax_plugins, jax_queue, jax_faults, jax_generic, jax_preemption,
        jax_provider, jax_scheduler, jax_testing, jax_metrics)))),
    "torch": Pkg("torch", **dict(zip(NAMES, (
        torch_types, torch_server, torch_cache, torch_snapshot, torch_client,
        torch_informer, torch_controllers, torch_interface, torch_runtime,
        torch_plugins, torch_queue, torch_faults, torch_generic,
        torch_preemption, torch_provider, torch_scheduler, torch_testing,
        torch_metrics)))),
}


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for P in PKGS.values():
        P.faults.install_injector(None)


def _bind_transitions_by_uid(server):
    """unbound -> bound transitions per pod incarnation (uid), from the
    whole watch history."""
    w = server.watch("Pod", since_rv=0)
    node, transitions = {}, {}
    for ev in w.pending():
        uid = ev.object.metadata.uid
        if ev.type == "DELETED":
            node.pop(uid, None)
            continue
        cur = ev.object.spec.node_name or ""
        if not node.get(uid, "") and cur:
            transitions[uid] = transitions.get(uid, 0) + 1
        node[uid] = cur
    w.stop()
    return transitions


def _pdb_never_negative(server):
    """No PodDisruptionBudget status in the whole watch history below 0."""
    w = server.watch("PodDisruptionBudget", since_rv=0)
    floor = min((ev.object.status.disruptions_allowed
                 for ev in w.pending() if ev.type != "DELETED"), default=0)
    w.stop()
    return floor >= 0


def _wait_named_bound(client, names, deadline_s):
    deadline = time.time() + deadline_s
    names = set(names)
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if {p.metadata.name for p in pods
                if p.metadata.name in names and p.spec.node_name} == names:
            return True
        time.sleep(0.05)
    return False


def _pdb(P, name, app, **budget):
    T = P.types
    pdb = T.PodDisruptionBudget(
        selector=T.LabelSelector(match_labels={"app": app}), **budget)
    pdb.metadata.name = name
    pdb.metadata.namespace = "default"
    return pdb


# -- tests/test_preemption_wave.py:652, the preemption-chaos storm ------------


def _chaos_storm(P):
    """Sixteen 4-CPU nodes filled by 64 low pods under a PDB of 60; then
    24 high-priority pods arrive interleaved with 24 low ones that can
    never place, under the preemption-chaos profile at seed 10."""
    injector = P.faults.FaultInjector(
        P.faults.load_profile("preemption-chaos", seed=10))
    P.faults.install_injector(injector)
    server = P.server.APIServer()
    client = P.client.Client(server)
    informers = P.informer.InformerFactory(server)
    sched = P.scheduler.new_scheduler(client, informers, batch=True,
                                      max_batch=256, **P.kw)
    for i in range(16):
        client.create_node(P.testing.make_node(f"n{i}").capacity(
            cpu="4", memory="64Gi", pods=12).obj())
    dc = P.controllers.DisruptionController(client, informers)
    sched.preemptor.disruption = dc
    client.create_pdb(_pdb(P, "storm-budget", "low", max_unavailable=60))
    informers.start()
    informers.wait_for_cache_sync()
    dc.start()
    sched.queue.run()
    mk = P.testing.make_pod
    try:
        low = [f"low-{i}" for i in range(64)]
        for nm in low:
            client.create_pod(mk(nm).container(cpu="1", memory="128Mi")
                              .labels(app="low").priority(0).obj())
        sched.start()
        assert _wait_named_bound(client, low, 60)
        sched.wait_for_inflight_binds(timeout=60)
        high = [f"high-{i}" for i in range(24)]
        for i in range(24):
            client.create_pod(mk(f"noise-{i}").container(
                cpu="1", memory="128Mi").labels(app="low").priority(0).obj())
            client.create_pod(mk(high[i]).container(
                cpu="1", memory="128Mi").priority(100).obj())
        assert _wait_named_bound(client, high, 120), (
            f"{P.name}: the high band did not fully bind under "
            "preemption-chaos")
        sched.wait_for_inflight_binds(timeout=60)
        FP = P.faults.FaultPoint
        assert injector.fired_count(FP.PREEMPT_SOLVE) >= 1
        assert injector.fired_count(FP.VICTIM_SLOW_DEATH) >= 1
        assert sched.preemptor.waves >= 1
        assert sched.preemptor.victims_slow_death >= 1
        assert _pdb_never_negative(server)
        doubles = {u: c for u, c in _bind_transitions_by_uid(server).items()
                   if c > 1}
        assert not doubles, f"{P.name}: double-bound incarnations {doubles}"
        # which noise pods bind depends on when slow-dying victims free
        # their room: thread timing, not a decision of either package
        return sorted(p.metadata.name for p in client.list_pods()[0]
                      if p.metadata.name.startswith("high-")
                      and p.spec.node_name)
    finally:
        sched.stop()
        dc.stop()
        informers.stop()


def test_preemption_chaos_storm_matches_the_jax_package():
    got = _chaos_storm(PKGS["torch"])
    want = _chaos_storm(PKGS["jax"])
    assert got == want == sorted(f"high-{i}" for i in range(24))


# -- nominated-pod churn: tests/test_preemption_wave.py:423 and :487 ----------


class _StubProf:
    def run_post_filter_plugins(self, *a, **kw):
        return None


def _budget_deny(P):
    """Three 2-CPU nodes, each full with one pod of a PDB that allows no
    disruption; a priority-100 pod's wave picks a victim, the shared gate
    denies the spend."""
    server = P.server.APIServer()
    client = P.client.Client(server)
    nodes = [P.testing.make_node(f"n{i}").capacity(
        cpu="2", memory="8Gi", pods=10).obj() for i in range(3)]
    pods = []
    for i, n in enumerate(nodes):
        p = (P.testing.make_pod(f"fill{i}").node(n.metadata.name)
             .container(cpu="2", memory="1Gi").labels(app="guarded")
             .priority(0).obj())
        p.status.start_time = time.time() - 100
        pods.append(p)
    for n in nodes:
        client.create_node(n)
    for p in pods:
        client.create_pod(p)
    informers = P.informer.InformerFactory(server)
    cache = P.cache.SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    for p in pods:
        cache.add_pod(p)
    snapshot = P.snapshot.Snapshot()
    cache.update_snapshot(snapshot)
    algorithm = P.generic.GenericScheduler(cache, snapshot)
    fw = P.runtime.Framework(P.plugins.new_in_tree_registry(),
                             P.provider.default_plugins(),
                             snapshot_provider=lambda: snapshot)
    queue = P.queue.PriorityQueue(fw.queue_sort_less_func(),
                                  sort_key_func=fw.queue_sort_key_func())
    dc = P.controllers.DisruptionController(client, informers)
    client.create_pdb(_pdb(P, "frozen", "guarded", min_available=3))
    informers.start()
    informers.wait_for_cache_sync()
    dc.sync_all()
    try:
        assert client.list_pdbs()[0][0].status.disruptions_allowed == 0
        pre = P.preemption.Preemptor(algorithm, queue, client, disruption=dc,
                                     **P.kw)
        high = P.testing.make_pod("high").container(cpu="1").priority(100).obj()
        client.create_pod(high)
        with pytest.raises(P.interface.FitError) as exc:
            algorithm.schedule(fw, P.interface.CycleState(), high)
        denials0 = pre.budget_denials
        results, uids = pre.preempt_batch(_StubProf(), [(high, exc.value)])
        out = dict(
            results=results, uids=uids,
            denials=pre.budget_denials - denials0,
            nominated=[p.metadata.name
                       for p in queue.nominated_pods_for_node("n0")],
            pods=len(client.list_pods()[0]),
            allowed=client.list_pdbs()[0][0].status.disruptions_allowed,
        )
        assert _pdb_never_negative(server)
        return out
    finally:
        informers.stop()


def test_budget_deny_refunds_and_skips_nomination():
    got = _budget_deny(PKGS["torch"])
    assert got == _budget_deny(PKGS["jax"])
    # no nomination survived the deny, nothing was evicted, the budget
    # stayed whole
    assert got == dict(results=[""], uids=[], denials=1, nominated=[],
                       pods=4, allowed=0)


def _wait(fn, seconds=10.0):
    deadline = time.time() + seconds
    while not fn() and time.time() < deadline:
        time.sleep(0.01)
    return fn()


def _nomination_cleared(P):
    """A pod nominated to n1 (as a wave nominates) loses the nomination
    when n1 is deleted, in the queue and in its status, and an update
    echo does not bring it back."""
    server = P.server.APIServer()
    client = P.client.Client(server)
    informers = P.informer.InformerFactory(server)
    sched = P.scheduler.new_scheduler(client, informers, batch=True,
                                      max_batch=16, **P.kw)
    for i in range(2):
        client.create_node(P.testing.make_node(f"n{i}").capacity(
            cpu="2", memory="8Gi").obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        pend = P.testing.make_pod("pend").container(cpu="1").priority(50).obj()
        client.create_pod(pend)
        assert _wait(lambda: sched.queue.active_count() > 0)
        cleared0 = P.metrics.nominations_cleared.value()
        sched.queue.update_nominated_pod_for_node(pend, "n1")

        def set_nom(p):
            p.status.nominated_node_name = "n1"

        client.update_pod_status("default", "pend", set_nom)
        steps = [[p.metadata.name
                  for p in sched.queue.nominated_pods_for_node("n1")]]
        client.delete_node("n1")
        assert _wait(lambda: not sched.queue.nominated_pods_for_node("n1"))
        assert _wait(lambda: not client.get_pod(
            "default", "pend").status.nominated_node_name)
        # an update echo through the informer must not resurrect it
        client.update_pod_status("default", "pend", lambda p: None)
        time.sleep(0.5)
        steps.append([p.metadata.name
                      for p in sched.queue.nominated_pods_for_node("n1")])
        steps.append(client.get_pod("default", "pend")
                     .status.nominated_node_name)
        steps.append(P.metrics.nominations_cleared.value() - cleared0 >= 1)
        return steps
    finally:
        sched.stop()
        informers.stop()


def test_nominations_cleared_on_node_delete():
    got = _nomination_cleared(PKGS["torch"])
    assert got == _nomination_cleared(PKGS["jax"])
    assert got == [["pend"], [], "", True]


# -- tests/test_mesh_state_guard.py:151-190, the zero-mid-run-build probe -----

NUM_NODES = 16
NUM_PODS = 1000


class _KeepFirstRng:
    def randrange(self, n):
        return 1 if n > 1 else 0

    def randint(self, a, b):
        return b


def _mesh_burst(P, mesh, probe, during=None):
    """The reference guard's seeded 1k-pod burst on ``mesh`` after
    warmup; ``probe()`` is read after warmup and after the burst, and
    ``during`` runs once the burst has started. Returns (placements,
    scheduler, the probe's two readings)."""
    rng = random.Random(42)
    server = P.server.APIServer()
    client = P.client.Client(server)
    informers = P.informer.InformerFactory(server)
    sched = P.scheduler.new_scheduler(client, informers, batch=True,
                                      max_batch=256, mesh=mesh,
                                      rng=_KeepFirstRng())
    for i in range(NUM_NODES):
        client.create_node(P.testing.make_node(f"m{i}").capacity(
            cpu="64", memory="256Gi", pods=120).obj())
    pods = [P.testing.make_pod(f"b{i}").creation_timestamp(float(i)).container(
        cpu=f"{rng.choice([100, 200, 250])}m",
        memory=f"{rng.choice([128, 256])}Mi").obj() for i in range(NUM_PODS)]
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        sched.warmup()
        before = probe()
        for p in pods:
            client.create_pod(p)
        sched.start()
        if during is not None:
            during()
        deadline = time.time() + 180
        while sum(1 for p in client.list_pods()[0]
                  if p.spec.node_name) < NUM_PODS:
            assert time.time() < deadline, f"{P.name}: the burst did not bind"
            time.sleep(0.05)
        sched.wait_for_inflight_binds()
        return ({p.metadata.name: p.spec.node_name
                 for p in client.list_pods()[0]}, sched, (before, probe()))
    finally:
        sched.stop()
        informers.stop()


def test_mesh_steady_burst_builds_no_kernel_after_warmup():
    jmesh = Mesh(np.array(jax.devices()[:2]), axis_names=("nodes",))
    want, jsched, jprobe = _mesh_burst(
        PKGS["jax"], jmesh, lambda: mesh_packed_cache_size(jmesh))
    got, sched, probe = _mesh_burst(
        PKGS["torch"], NodeMesh(["cpu"] * 2), torch_asg.kernel_build_counts)
    assert got == want
    assert jprobe[0] == jprobe[1], jprobe  # no mid-run recompile in JAX
    assert probe[0] == probe[1], probe  # no mid-run build in the port
    assert sched.mesh_solver_tier == "torch"
    assert sched.pods_fallback == 0 and sched.batches_solved >= 2
    assert sched.state_uploads <= 1 and sched.carry_divergences == 0


def test_a_build_after_warmup_is_booked_as_mid_run(monkeypatch):
    """The probe's other half: the watchdog sealed at warmup books a build
    of K4 during the burst as one mid-run build of its family."""
    def one_build():
        monkeypatch.setattr(shard_kernel, "builds", shard_kernel.builds + 1)

    before = torch_metrics.jit_compiles.value(signature="shard_kernel")
    _, sched, probe = _mesh_burst(
        PKGS["torch"], NodeMesh(["cpu"] * 2), torch_asg.kernel_build_counts,
        during=one_build)
    assert probe[1]["shard_kernel"] == probe[0]["shard_kernel"] + 1
    assert torch_metrics.jit_compiles.value(
        signature="shard_kernel") == before + 1
    assert sched.batches_solved >= 2
