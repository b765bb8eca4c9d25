"""Drain planning through the victim search, the port against the JAX
package.

``Preemptor.plan_replacements`` runs the wave's victim search as a plan,
at wave priority ``_PLAN_PRIO`` (below every real priority): no victim
is eligible, every nomination folds in, and the search reduces to a fit
test plus the nomination carry. Held here on the CPU:

- K3's plain version at that priority, bit for bit against the JAX
  package's XLA wave kernel (with PDBs and nominations) and against the
  Pallas kernel in interpret mode;
- both packages' ``plan_replacements`` on the same seeded clusters: the
  same node per pod;
- ``NodeDrainer.drain_via_preemption`` end to end through both packages
  on the drain of ``tests/test_preemption_wave.py``: the same evictions
  and pods left running;
- the drain's error handling: a ``KernelError`` from the plan propagates
  out of the drain, ``LadderExhausted`` is retried paced.

The CUDA kernel cannot run here; chip_smoke.py replays every plan launch
it makes on the card through the plain version.
"""

import random
import time

import numpy as np
import pytest

from kubernetes_tpu.api.types import LabelSelector as JaxLabelSelector
from kubernetes_tpu.api.types import PodDisruptionBudget as JaxPDB
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.cache.cache import SchedulerCache as JaxCache
from kubernetes_tpu.cache.snapshot import Snapshot as JaxSnapshot
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.controllers import DisruptionController as JaxDC
from kubernetes_tpu.controllers import NodeDrainer as JaxDrainer
from kubernetes_tpu.ops.pallas_preempt import pallas_preempt_solve
from kubernetes_tpu.robustness.lifecycle import PodRespawner as JaxRespawner
from kubernetes_tpu.scheduler.generic import GenericScheduler as JaxGeneric
from kubernetes_tpu.scheduler.preemption import Preemptor as JaxPreemptor
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_scheduler
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.api.types import LabelSelector, PodDisruptionBudget
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.cache.cache import SchedulerCache
from kubernetes_tpu_torch.cache.snapshot import Snapshot
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.controllers import DisruptionController, NodeDrainer
from kubernetes_tpu_torch.ops import preempt_kernel
from kubernetes_tpu_torch.ops.kernel_build import KernelError
from kubernetes_tpu_torch.robustness.ladder import LadderExhausted
from kubernetes_tpu_torch.robustness.lifecycle import PodRespawner
from kubernetes_tpu_torch.scheduler.generic import GenericScheduler
from kubernetes_tpu_torch.scheduler.preemption import _PLAN_PRIO, Preemptor
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

from test_torch_preempt import _carry, _plain, _random_wave, _xla


# -- K3's plain version at the plan priority -------------------------------


def _plan_wave(seed, m, p):
    """A seeded wave whose pods all carry the plan priority and request
    0.5-3 CPUs, so some fit where the wave left 0-2.5 CPUs free and
    some fit nowhere."""
    w = _random_wave(seed, m=m, p=p)
    rng = np.random.default_rng(seed + 1000)
    b = w["pods_req"].shape[0]
    w["pods_req"][:, 0] = rng.choice([500, 1000, 2000, 3000], b)
    w["pods_req"][:, 1] = rng.choice([1, 2], b) << 20
    w["pods_prio"] = np.full_like(w["pods_prio"], _PLAN_PRIO)
    return w


@pytest.mark.parametrize("p", [0, 3], ids=["no_pdbs", "pdbs"])
@pytest.mark.parametrize("m", [0, 4], ids=["no_noms", "noms"])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_plain_at_plan_priority_matches_the_xla_wave_kernel(seed, m, p):
    """No victim is eligible and every nomination folds into the carry:
    chosen nodes, victim and violating masks, violation counts and the
    post-plan carry are bit-equal to the JAX package's XLA kernel."""
    w = _plan_wave(seed, m, p)
    chosen, vic, viol, nviol, state = _plain(w)
    x_chosen, x_vic, x_viol, x_nviol = _xla(w)
    np.testing.assert_array_equal(chosen, x_chosen)
    np.testing.assert_array_equal(vic, x_vic)
    np.testing.assert_array_equal(viol, x_viol)
    np.testing.assert_array_equal(nviol, x_nviol)
    np.testing.assert_array_equal(state, _carry(w, chosen))
    assert not vic.any() and not nviol.any()
    assert (chosen >= 0).any(), "the plan must place some pods"
    assert (chosen[-2:] == -1).all()  # the inactive tail


def test_plan_priority_folds_every_nomination_in():
    """At the plan priority a node a nomination fills answers no pod:
    the same wave without the nominations places onto it."""
    w = _plan_wave(3, m=0, p=0)
    # a nomination on every node, each taking all that is free
    n = w["alloc"].shape[0]
    w["nom_req"] = np.maximum(w["alloc"] - w["base"], 0).astype(np.int32)
    w["nom_prio"] = np.full(n, -100, np.int32)  # far below any real pod
    w["nom_node"] = np.arange(n, dtype=np.int32)
    chosen, *_ = _plain(w)
    x_chosen, *_ = _xla(w)
    np.testing.assert_array_equal(chosen, x_chosen)
    assert (chosen == -1).all()
    free = _plan_wave(3, m=0, p=0)
    assert (_plain(free)[0] >= 0).any()


@pytest.mark.parametrize("m", [0, 4], ids=["no_noms", "noms"])
@pytest.mark.parametrize("seed", [0, 17])
def test_plain_at_plan_priority_matches_the_pallas_kernel(seed, m):
    """Interpret-mode Pallas at the plan priority: chosen nodes, victim
    masks (all empty) and the post-plan carry."""
    w = _plan_wave(seed, m, 0)
    v = w["prio"].shape[1]
    chosen, vic, _, _, state = _plain(w)
    rows, inverse = np.unique(w["candidate"], axis=0, return_inverse=True)
    u_pad = 8 * -(-rows.shape[0] // 8)
    rows_p = np.zeros((u_pad, rows.shape[1]), bool)
    rows_p[: rows.shape[0]] = rows
    active_bits = np.zeros(w["active"].shape[0], dtype=np.int32)
    for vi in range(v):
        active_bits |= w["active"][:, vi].astype(np.int32) << vi
    packed, p_state = pallas_preempt_solve(
        w["alloc"], w["base"], w["prio"], w["start"], w["req"], active_bits,
        w["nom_req"], w["nom_prio"], w["nom_node"],
        w["pods_req"], w["pods_prio"], rows_p,
        inverse.reshape(-1).astype(np.int32), w["pods_active"],
        interpret=True,
    )
    packed = np.asarray(packed)
    bits = packed[1].astype(np.uint32) | (packed[2].astype(np.uint32) << 16)
    np.testing.assert_array_equal(chosen, packed[0])
    assert not vic.any() and not bits.any()
    np.testing.assert_array_equal(state, np.asarray(p_state))


# -- plan_replacements, both packages --------------------------------------


def _drain_cluster(mk_node, mk_pod, seed):
    """16 nodes of mixed size and load (some labelled, some tainted) and
    the residents of the node to drain (n0): pods of mixed size, some
    pinned by a nodeSelector, some too large to go anywhere."""
    rng = random.Random(seed)
    t0 = 1_000_000.0
    nodes, pods = [], []
    for i in range(16):
        w = mk_node(f"n{i}").capacity(
            cpu=str(rng.choice([4, 8, 16])), memory="32Gi", pods=12
        )
        if rng.random() < 0.3:
            w.label("disk", "ssd")
        if rng.random() < 0.15:
            w.taint("dedicated", "infra")
        nodes.append(w.obj())
        if i == 0:
            continue
        for j in range(rng.randrange(0, 4)):
            p = (
                mk_pod(f"load{i}-{j}").node(f"n{i}")
                .container(cpu=f"{rng.choice([1000, 2000, 3000])}m",
                           memory=f"{rng.choice([512, 4096])}Mi")
                .priority(rng.choice([0, 10])).obj()
            )
            p.status.start_time = t0 + rng.randrange(1000)
            pods.append(p)
    residents = []
    for j in range(10):
        w = (
            mk_pod(f"res-{j}").node("n0")
            .container(cpu=f"{rng.choice([500, 1500, 3000, 20000])}m",
                       memory=f"{rng.choice([256, 2048])}Mi")
            .priority(rng.choice([0, 5]))
        )
        if rng.random() < 0.3:
            w.node_selector(disk="ssd")
        p = w.obj()
        p.status.start_time = t0 + rng.randrange(1000)
        residents.append(p)
    return nodes, pods + residents, residents


def _planner(preemptor_cls, generic_cls, cache_cls, snap_cls, nodes, pods,
             **kw):
    cache = cache_cls()
    for nd in nodes:
        cache.add_node(nd)
    for p in pods:
        cache.add_pod(p)
    snapshot = snap_cls()
    cache.update_snapshot(snapshot)
    return preemptor_cls(generic_cls(cache, snapshot), None, None, **kw)


@pytest.mark.parametrize("seed", range(5))
def test_plan_replacements_matches_the_jax_package(seed):
    jn, jp, jres = _drain_cluster(jax_node, jax_pod, seed)
    tn, tp, tres = _drain_cluster(make_node, make_pod, seed)
    order = lambda ps: sorted(  # noqa: E731 - the drain's plan order
        ps, key=lambda p: (-p.spec.priority, p.status.start_time,
                           p.metadata.name)
    )
    jplan = _planner(
        JaxPreemptor, JaxGeneric, JaxCache, JaxSnapshot, jn, jp
    ).plan_replacements(order(jres), exclude_nodes=("n0",))
    preemptor = _planner(
        Preemptor, GenericScheduler, SchedulerCache, Snapshot, tn, tp,
        device="cpu",
    )
    tplan = preemptor.plan_replacements(order(tres), exclude_nodes=("n0",))
    assert tplan == jplan
    assert "n0" not in tplan
    assert any(tplan), "some residents must have a destination"
    assert "" in tplan, "the 20-CPU residents have none"
    # a plan books nothing against the wave's ledger
    assert preemptor.wave_solver_tier == ""


def test_plan_pack_is_cached_and_apart_from_the_wave_pack():
    """Re-planning against an unchanged cache reuses the plan's pack; the
    plan's tensor cache shares the wave cache's interners (one slot
    layout), and its pack is its own object (its own device tensors)."""
    tn, tp, tres = _drain_cluster(make_node, make_pod, 1)
    preemptor = _planner(
        Preemptor, GenericScheduler, SchedulerCache, Snapshot, tn, tp,
        device="cpu",
    )
    first = preemptor.plan_replacements(tres, exclude_nodes=("n0",))
    pack = preemptor._plan_pack
    assert preemptor.plan_replacements(tres, exclude_nodes=("n0",)) == first
    assert preemptor._plan_pack is pack
    assert preemptor._plan_nt_cache.dims is preemptor._tensor_cache.dims
    assert (
        preemptor._plan_nt_cache.topology
        is preemptor._tensor_cache.topology
    )
    assert preemptor._pack is None  # the wave's pack was never touched


# -- drain_via_preemption end to end, both packages -------------------------


def _strictly_fewer_drain(pkg):
    """tests/test_preemption_wave.py::
    test_drain_via_preemption_evicts_strictly_fewer on either package:
    6 residents of 1 CPU on n0, 3 CPUs of room elsewhere, a PDB of one
    disruption at a time. Returns the drainer's ledger."""
    (APIServer_, Client_, Informers_, DC, Drainer, Respawner, sched_fn,
     mk_node, mk_pod, lsel, pdb_cls, kw) = pkg
    server = APIServer_()
    client = Client_(server)
    informers = Informers_(server)
    sched = sched_fn(client, informers, batch=True, max_batch=256, **kw)
    client.create_node(
        mk_node("n0").capacity(cpu="8", memory="64Gi", pods=20).obj()
    )
    client.create_node(
        mk_node("r1").capacity(cpu="2100m", memory="16Gi", pods=10)
        .label("kubernetes.io/hostname", "r1").obj()
    )
    client.create_node(
        mk_node("r2").capacity(cpu="1", memory="16Gi", pods=10).obj()
    )
    dc = DC(client, informers)
    sched.preemptor.disruption = dc
    pdb = pdb_cls(
        selector=lsel(match_labels={"app": "drainable"}), max_unavailable=1,
    )
    pdb.metadata.name = "drain-budget"
    pdb.metadata.namespace = "default"
    client.create_pdb(pdb)
    for i in range(6):
        p = (
            mk_pod(f"res-{i}").node("n0")
            .container(cpu="1", memory="128Mi")
            .labels(app="drainable").priority(0).obj()
        )
        p.status.start_time = time.time() - 100
        client.create_pod(p)
    informers.start()
    informers.wait_for_cache_sync()
    dc.start()
    sched.queue.run()
    respawner = Respawner(
        client, should_respawn=lambda p: p.metadata.name.startswith("res-")
    )
    respawner.start()
    try:
        sched.start()
        client.create_pod(
            mk_pod("warm").container(cpu="100m", memory="64Mi")
            .node_selector(**{"kubernetes.io/hostname": "r1"}).obj()
        )
        deadline = time.time() + 30
        while not client.get_pod("default", "warm").spec.node_name:
            assert time.time() < deadline, "the warm pod did not bind"
            time.sleep(0.05)
        sched.wait_for_inflight_binds(timeout=30)
        drainer = Drainer(client, disruption=dc, preemptor=sched.preemptor)
        emptied = drainer.drain_via_preemption("n0", timeout=60)
        on_node = sum(
            1 for p in client.list_pods()[0]
            if p.spec.node_name == "n0"
            and p.metadata.deletion_timestamp is None
        )
        floor = 0
        w = server.watch("PodDisruptionBudget", since_rv=0)
        for ev in w.pending():
            if ev.type != "DELETED":
                floor = min(floor, ev.object.status.disruptions_allowed)
        w.stop()
        return dict(
            emptied=emptied, evictions=drainer.evictions,
            planned=drainer.preempt_planned,
            left_running=drainer.preempt_left_running, on_node=on_node,
            pdb_floor=floor,
        )
    finally:
        respawner.stop()
        sched.stop()
        dc.stop()
        informers.stop()


def test_drain_via_preemption_evicts_strictly_fewer():
    jax_ledger = _strictly_fewer_drain((
        JaxAPIServer, JaxClient, JaxInformers, JaxDC, JaxDrainer,
        JaxRespawner, jax_scheduler, jax_node, jax_pod, JaxLabelSelector,
        JaxPDB, {},
    ))
    ledger = _strictly_fewer_drain((
        APIServer, Client, InformerFactory, DisruptionController,
        NodeDrainer, PodRespawner, new_scheduler, make_node, make_pod,
        LabelSelector, PodDisruptionBudget, {"device": "cpu"},
    ))
    assert ledger == jax_ledger
    assert not ledger["emptied"]  # stragglers have no destination
    assert 0 < ledger["evictions"] < 6
    assert ledger["planned"] == ledger["evictions"]
    assert ledger["left_running"] >= 1
    assert ledger["on_node"] == 6 - ledger["evictions"]
    assert ledger["pdb_floor"] >= 0


# -- the drain's error handling ---------------------------------------------


def _drain_env():
    """A node to drain (two residents) and room elsewhere, planned by a
    CPU Preemptor over a live cache."""
    server = APIServer()
    client = Client(server)
    client.create_node(make_node("n0").capacity(cpu="8").obj())
    client.create_node(make_node("n1").capacity(cpu="8").obj())
    for i in range(2):
        client.create_pod(
            make_pod(f"res-{i}").node("n0").container(cpu="1").obj()
        )
    nodes, _ = client.list_nodes()
    pods, _ = client.list_pods()
    preemptor = _planner(
        Preemptor, GenericScheduler, SchedulerCache, Snapshot, nodes, pods,
        device="cpu",
    )
    return client, preemptor


def test_kernel_error_from_the_plan_propagates(monkeypatch):
    """A fault of the victim search is never retried behind the kernel's
    back: it raises out of drain_via_preemption, and no pod is evicted."""
    client, preemptor = _drain_env()

    def broken(*args):
        raise KernelError("the victim search failed to launch")

    monkeypatch.setattr(preempt_kernel, "preempt_solve", broken)
    drainer = NodeDrainer(client, poll=0.01, preemptor=preemptor)
    with pytest.raises(KernelError):
        drainer.drain_via_preemption("n0", timeout=5)
    assert drainer.evictions == 0
    assert {p.metadata.name for p in client.list_pods()[0]} == {
        "res-0", "res-1",
    }


def test_ladder_exhausted_is_retried_paced(monkeypatch):
    """The CPU ladder's breaker case: the drain sleeps a poll and plans
    again, then drains the node."""
    client, preemptor = _drain_env()
    calls = []
    run = preemptor.ladder.run

    def flaky(attempts, label="batch"):
        calls.append(label)
        if len(calls) <= 2:
            raise LadderExhausted("every solver tier failed")
        return run(attempts, label=label)

    monkeypatch.setattr(preemptor.ladder, "run", flaky)
    drainer = NodeDrainer(client, poll=0.01, preemptor=preemptor)
    assert drainer.drain_via_preemption("n0", timeout=10)
    assert len(calls) >= 3
    assert drainer.evictions == drainer.preempt_planned == 2
    assert not [
        p for p in client.list_pods()[0] if p.spec.node_name == "n0"
    ]


def test_a_failed_completion_on_the_card_stops_the_scheduler(monkeypatch):
    """On the card a batch whose completion fails (a K3 fault in the
    deferred wave, a failed download) is not requeued to meet the same
    fault again: the committer keeps the error, stops the scheduler and
    releases the batches queued behind it."""
    import threading

    import torch

    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, device="cpu")
    # the completion's fault policy reads only the device's type
    sched.device = torch.device("cuda")
    err = KernelError("the deferred wave's victim search failed")

    def broken(pending):
        raise err

    monkeypatch.setattr(sched, "_complete_solve", broken)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)
    sched._pending_q.extend([{"solver_infos": []}, {"solver_infos": []}])
    sched._ensure_committer()
    sched._committer.join(timeout=5)
    assert not sched._committer.is_alive()
    assert sched.card_fault is err
    assert sched._stop.is_set()
    assert not sched._pending_q
    sched._drain_pending()  # returns: nothing is left in flight
    informers.stop()
