"""A K3 victim search whose injected fault spent the ladder's attempts, on
the card's branch, and the preemption-chaos storm through both packages,
on the CPU.

- The card's branch, reached on the CPU: the scheduler and its Preemptor
  are named ``cuda`` (no tensor is touched: the injected fault raises
  before the search uploads anything). A deferred wave whose
  ``PREEMPT_SOLVE`` fires on every attempt ends with its pods requeued
  without a nomination (``Preemptor.injected_exhaustions`` moves by
  one, no host preemption, no ``card_fault``); the same wave with a
  KernelError from K3 halts the scheduler through its committer, with a
  CardFault caused by it. On the per-pod path the same two cases: no
  nomination and a requeue, or the halt (``Scheduler.handle_fit_error``)
  instead of a log line. A failure that is not K3's -- a non-ignorable
  extender's preempt verb that cannot be reached -- is still logged and
  the pod requeued on a scheduler named ``cuda``.
- The storm of ``tests/test_preemption_wave.py:652`` at profile seed 42,
  where the third and fourth K3 calls each draw two fires: sixteen 4-CPU
  nodes filled by 64 low pods under a PDB of 60, then 24 high pods
  interleaved with 24 low ones, in three bursts of eight each so that at
  least three victim searches run however the host's load batches them. Both packages bind the whole high band, bind no incarnation
  twice and spend no PDB below zero; the port's ``PREEMPT_SOLVE`` fired
  twice within one call at least once.
"""

import logging
import socket
import threading
import time

import pytest
import torch

from kubernetes_tpu import controllers as jax_controllers
from kubernetes_tpu.apiserver import server as jax_server
from kubernetes_tpu.client import client as jax_client
from kubernetes_tpu.client import informer as jax_informer
from kubernetes_tpu.robustness import faults as jax_faults
from kubernetes_tpu.scheduler import scheduler as jax_scheduler
from kubernetes_tpu import testing as jax_testing
from kubernetes_tpu.api import types as jax_types
from kubernetes_tpu_torch import controllers as torch_controllers
from kubernetes_tpu_torch.api import types as torch_types
from kubernetes_tpu_torch.apiserver import server as torch_server
from kubernetes_tpu_torch.client import client as torch_client
from kubernetes_tpu_torch.client import informer as torch_informer
from kubernetes_tpu_torch.ops import preemption as port_ops_preemption
from kubernetes_tpu_torch.ops.kernel_build import KernelError
from kubernetes_tpu_torch.robustness import faults as torch_faults
from kubernetes_tpu_torch.robustness.ladder import CardFault
from kubernetes_tpu_torch.scheduler import extender as torch_extender
from kubernetes_tpu_torch.scheduler import scheduler as torch_scheduler
from kubernetes_tpu_torch import testing as torch_testing


class Pkg:
    """One package's modules, under the same names."""

    def __init__(self, name, **mods):
        self.name = name
        self.__dict__.update(mods)
        self.kw = {"device": "cpu"} if name == "torch" else {}


NAMES = ("types", "server", "client", "informer", "controllers", "faults",
         "scheduler", "testing")
PKGS = {
    "jax": Pkg("jax", **dict(zip(NAMES, (
        jax_types, jax_server, jax_client, jax_informer, jax_controllers,
        jax_faults, jax_scheduler, jax_testing)))),
    "torch": Pkg("torch", **dict(zip(NAMES, (
        torch_types, torch_server, torch_client, torch_informer,
        torch_controllers, torch_faults, torch_scheduler, torch_testing)))),
}
P = PKGS["torch"]


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for pkg in PKGS.values():
        pkg.faults.install_injector(None)


def _always_fail_preempt_solve():
    F = torch_faults
    injector = F.FaultInjector(F.FaultProfile(
        name="preempt-solve", seed=0,
        points={F.FaultPoint.PREEMPT_SOLVE: F.PointConfig(rate=1.0)}))
    F.install_injector(injector)
    return injector


def _k3_fails(monkeypatch):
    err = KernelError("the victim search failed to launch")

    def broken(*args, **kwargs):
        raise err

    monkeypatch.setattr(port_ops_preemption, "preempt_batch_device", broken)
    return err


def _full_cluster(batch, extenders=None):
    """Two 2-CPU nodes full of priority-0 pods and one pending
    priority-100 pod, which only a preemption can place."""
    server = P.server.APIServer()
    client = P.client.Client(server)
    informers = P.informer.InformerFactory(server)
    sched = P.scheduler.new_scheduler(client, informers, batch=batch,
                                      device="cpu", extenders=extenders)
    mk = P.testing.make_pod
    for i in range(2):
        client.create_node(P.testing.make_node(f"n{i}").capacity(
            cpu="2", memory="8Gi", pods=10).obj())
        for j in range(2):
            client.create_pod(mk(f"low-{i}-{j}").node(f"n{i}").container(
                cpu="1", memory="128Mi").priority(0).obj())
    client.create_pod(mk("high").container(cpu="1", memory="128Mi")
                      .priority(100).obj())
    informers.start()
    informers.wait_for_cache_sync()
    return server, client, informers, sched


def _requeued_without_nomination(client, sched):
    high = client.get_pod("default", "high")
    counts = sched.queue.num_pending()
    return (not high.spec.node_name
            and not high.status.nominated_node_name
            and not sched.queue.all_nominated_pods_by_node()
            and counts["active"] == 0
            and counts["backoff"] + counts["unschedulable"] == 1
            and len(client.list_pods()[0]) == 5)


def _park_the_failed_wave(sched):
    """Solve the high pod's batch on the CPU and keep its failure parked
    for the deferred wave, as the committer does while a burst lasts."""
    flush = sched._flush_deferred_preemptions
    sched._flush_deferred_preemptions = lambda: None
    try:
        assert sched.schedule_batch(timeout=5) == 1
    finally:
        sched._flush_deferred_preemptions = flush
    assert len(sched._deferred_preempt) == 1


def _flush_on_the_card(sched, monkeypatch):
    """The parked wave runs in a batch completion on the committer, with
    the scheduler and its Preemptor named ``cuda``."""
    sched.device = torch.device("cuda")
    sched.preemptor.device = torch.device("cuda")
    monkeypatch.setattr(
        sched, "_complete_solve",
        lambda pending: sched._flush_deferred_preemptions())
    sched._pending_q.append({"solver_infos": []})
    sched._ensure_committer()
    deadline = time.time() + 10
    while sched._pending_q and time.time() < deadline:
        time.sleep(0.01)
    assert not sched._pending_q


@pytest.mark.parametrize("fault", ["injected", "kernel"])
def test_card_wave_requeues_an_injected_exhaustion_and_halts_on_k3(
        fault, monkeypatch):
    server, client, informers, sched = _full_cluster(batch=True)
    try:
        _park_the_failed_wave(sched)
        if fault == "injected":
            injector = _always_fail_preempt_solve()
        else:
            err = _k3_fails(monkeypatch)
            monkeypatch.setattr(threading, "excepthook", lambda args: None)
        _flush_on_the_card(sched, monkeypatch)
        pre = sched.preemptor
        assert pre.host_preemptions == 0
        if fault == "injected":
            # two fires: one retried in place, the second exhausting
            assert injector.fired_count(
                torch_faults.FaultPoint.PREEMPT_SOLVE) == 2
            assert pre.ladder.injected_retries == 1
            assert pre.injected_exhaustions == 1
            assert sched.card_fault is None and not sched._stop.is_set()
            assert sched._committer.is_alive()
            assert _requeued_without_nomination(client, sched)
        else:
            sched._committer.join(timeout=5)
            assert not sched._committer.is_alive()
            assert isinstance(sched.card_fault, CardFault)
            assert sched.card_fault.__cause__ is err and sched._stop.is_set()
            assert pre.injected_exhaustions == 0
        assert not [p for p in client.list_pods()[0]
                    if p.metadata.name.startswith("low")
                    and not p.spec.node_name]
    finally:
        sched._stop_committer()
        sched.stop()
        informers.stop()


@pytest.mark.parametrize("fault", ["injected", "kernel"])
def test_card_per_pod_search_requeues_an_injected_exhaustion_and_halts_on_k3(
        fault, monkeypatch):
    server, client, informers, sched = _full_cluster(batch=False)
    try:
        pi = sched.queue.pop(timeout=5)
        assert pi is not None and pi.pod.metadata.name == "high"
        pre = sched.preemptor
        pre.device = torch.device("cuda")
        if fault == "injected":
            _always_fail_preempt_solve()
            sched.attempt_schedule(pi)
            assert pre.injected_exhaustions == 1
            assert pre.host_preemptions == pre.device_preemptions == 0
            assert sched.card_fault is None and not sched._stop.is_set()
            assert _requeued_without_nomination(client, sched)
        else:
            err = _k3_fails(monkeypatch)
            with pytest.raises(CardFault) as raised:
                sched.attempt_schedule(pi)
            assert raised.value.__cause__ is err
            assert sched.card_fault is raised.value and sched._stop.is_set()
            assert pre.injected_exhaustions == 0
    finally:
        sched.stop()
        informers.stop()


def _closed_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_card_per_pod_search_logs_an_unreachable_preempt_extender(caplog):
    """A non-ignorable extender's preempt verb that cannot be reached is a
    failure of the extender, not of K3: on a scheduler named ``cuda`` the
    pod is requeued without a nomination and the scheduler runs on."""
    ext = torch_extender.HTTPExtender(torch_extender.ExtenderConfig(
        url_prefix=f"http://127.0.0.1:{_closed_port()}",
        preempt_verb="preempt", ignorable=False, http_timeout_seconds=2))
    server, client, informers, sched = _full_cluster(batch=False,
                                                     extenders=[ext])
    try:
        pi = sched.queue.pop(timeout=5)
        assert pi is not None and pi.pod.metadata.name == "high"
        pre = sched.preemptor
        pre.device = torch.device("cuda")
        with caplog.at_level(logging.ERROR):
            sched.attempt_schedule(pi)
        assert any("preemption for default/high failed" in r.getMessage()
                   for r in caplog.records)
        # the extender narrowed the host oracle's candidates: K3 never ran
        assert pre.host_preemptions == 1 and pre.device_preemptions == 0
        assert sched.card_fault is None and not sched._stop.is_set()
        assert _requeued_without_nomination(client, sched)
    finally:
        sched.stop()
        informers.stop()


def test_cpu_per_pod_search_still_logs_a_k3_fault(monkeypatch):
    """The CPU keeps its behaviour: the failure is logged, the pod is
    requeued and the scheduler runs on."""
    server, client, informers, sched = _full_cluster(batch=False)
    try:
        pi = sched.queue.pop(timeout=5)
        _k3_fails(monkeypatch)
        sched.attempt_schedule(pi)
        assert sched.card_fault is None and not sched._stop.is_set()
        assert _requeued_without_nomination(client, sched)
    finally:
        sched.stop()
        informers.stop()


# -- tests/test_preemption_wave.py:652 at profile seed 42 ---------------------


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


def _pdb_floor(server):
    w = server.watch("PodDisruptionBudget", since_rv=0)
    floor = min((ev.object.status.disruptions_allowed
                 for ev in w.pending() if ev.type != "DELETED"), default=0)
    w.stop()
    return floor


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


def _storm(pkg, seed):
    T = pkg.types
    injector = pkg.faults.FaultInjector(
        pkg.faults.load_profile("preemption-chaos", seed=seed))
    pkg.faults.install_injector(injector)
    server = pkg.server.APIServer()
    client = pkg.client.Client(server)
    informers = pkg.informer.InformerFactory(server)
    sched = pkg.scheduler.new_scheduler(client, informers, batch=True,
                                        max_batch=256, **pkg.kw)
    for i in range(16):
        client.create_node(pkg.testing.make_node(f"n{i}").capacity(
            cpu="4", memory="64Gi", pods=12).obj())
    dc = pkg.controllers.DisruptionController(client, informers)
    sched.preemptor.disruption = dc
    pdb = T.PodDisruptionBudget(
        selector=T.LabelSelector(match_labels={"app": "low"}),
        max_unavailable=60)
    pdb.metadata.name = "storm-budget"
    pdb.metadata.namespace = "default"
    client.create_pdb(pdb)
    informers.start()
    informers.wait_for_cache_sync()
    dc.start()
    sched.queue.run()
    mk = pkg.testing.make_pod
    try:
        low = [f"low-{i}" for i in range(64)]
        for nm in low:
            client.create_pod(mk(nm).container(cpu="1", memory="128Mi")
                              .labels(app="low").priority(0).obj())
        sched.start()
        assert _wait_named_bound(client, low, 60)
        sched.wait_for_inflight_binds(timeout=60)
        high = [f"high-{i}" for i in range(24)]
        # three bursts, each bound before the next: every burst needs a
        # victim search of its own, so at least three run whatever the
        # host's load merges into one wave (the third exhausts at seed 42)
        for burst in range(3):
            for i in range(8 * burst, 8 * burst + 8):
                client.create_pod(mk(f"noise-{i}").container(
                    cpu="1", memory="128Mi").labels(app="low")
                    .priority(0).obj())
                client.create_pod(mk(high[i]).container(
                    cpu="1", memory="128Mi").priority(100).obj())
            assert _wait_named_bound(client, high[:8 * burst + 8], 120), (
                f"{pkg.name}: the high band did not fully bind under "
                "preemption-chaos")
        sched.wait_for_inflight_binds(timeout=60)
        assert injector.fired_count(pkg.faults.FaultPoint.PREEMPT_SOLVE) >= 2
        assert _pdb_floor(server) >= 0
        doubles = {u: c for u, c in _bind_transitions_by_uid(server).items()
                   if c > 1}
        assert not doubles, f"{pkg.name}: double-bound incarnations {doubles}"
        assert getattr(sched, "card_fault", None) is None
        bound_high = sorted(p.metadata.name for p in client.list_pods()[0]
                            if p.metadata.name.startswith("high-")
                            and p.spec.node_name)
        return bound_high, sched.preemptor
    finally:
        sched.stop()
        dc.stop()
        informers.stop()


def test_preemption_chaos_storm_at_seed_42_binds_the_high_band_in_both():
    got, pre = _storm(PKGS["torch"], 42)
    want, _ = _storm(PKGS["jax"], 42)
    assert got == want == sorted(f"high-{i}" for i in range(24))
    # two fires within one victim search: the ladder's attempts spent
    assert pre.injected_exhaustions >= 1
