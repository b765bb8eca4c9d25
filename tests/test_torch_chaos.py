"""The port's solver ladder under injected faults, against the JAX
package's, on the CPU.

The ladder's rule for the card (``robustness/ladder.py``): the ``cuda``
tier retries an injected solver fault (``FaultInjected``, which real
hardware never raises) in place under the RetryPolicy and then ends in
``LadderExhausted`` with that fault as its cause; a KernelError, a CUDA
runtime error and a SolveTimeout raise at once, with no retry. The unit
tests drive a ladder whose tier is named ``cuda`` on the CPU, and hold
the ``torch`` tier's answer to the same fault sequences against the
JAX package's ``xla`` tier.

Twins, each scenario through both packages (the JAX package on the CPU,
the port's batch scheduler on ``device="cpu"``), both held to the
reference's contract: ``tests/test_chaos.py`` (churn under device
faults, hangs, garbage results, bind conflicts and watch drops, with a
full breaker cycle; every device solve failing), ``tests/
test_fallback_guard.py`` (a plain and a CSI-PV burst with no fallback,
placed alike) and ``tests/test_lifecycle_chaos.py::
TestLifecycleChaosStorm`` (node flaps and a reclamation storm under the
``lifecycle-chaos`` profile, its solver faults included).
"""

import threading
import time

import pytest
import torch

import kubernetes_tpu.api.types as jax_types
import kubernetes_tpu.robustness.circuit as jax_circuit
import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu.robustness.ladder as jax_ladder
import kubernetes_tpu.robustness.lifecycle as jax_lifecycle
import kubernetes_tpu_torch.api.types as port_types
import kubernetes_tpu_torch.robustness.circuit as port_circuit
import kubernetes_tpu_torch.robustness.faults as port_faults
import kubernetes_tpu_torch.robustness.ladder as port_ladder
import kubernetes_tpu_torch.robustness.lifecycle as port_lifecycle
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.ops.greedy_kernel import KernelError
from kubernetes_tpu_torch.robustness.circuit import SolveTimeout
from kubernetes_tpu_torch.robustness.faults import FaultInjected
from kubernetes_tpu_torch.robustness.ladder import (
    LadderExhausted,
    RobustnessConfig,
    SolverLadder,
)
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.utils import flightrecorder as port_fr
from kubernetes_tpu_torch.utils import metrics as port_metrics

from test_torch_slice import _bind_transitions_by_uid

PKG = {
    "jax": dict(server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
                new=jax_new, node=jax_node, pod=jax_pod, types=jax_types,
                faults=jax_faults, ladder=jax_ladder, circuit=jax_circuit,
                lifecycle=jax_lifecycle, metrics=jax_metrics,
                device_tier=jax_ladder.TIER_XLA, kw={}),
    "torch": dict(server=APIServer, client=Client, informers=InformerFactory,
                  new=new_scheduler, node=make_node, pod=make_pod,
                  types=port_types, faults=port_faults, ladder=port_ladder,
                  circuit=port_circuit, lifecycle=port_lifecycle,
                  metrics=port_metrics, device_tier=port_ladder.TIER_TORCH,
                  kw={"device": "cpu"}),
}
BOTH = ("jax", "torch")


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for pkg in BOTH:
        PKG[pkg]["faults"].install_injector(None)


@pytest.fixture
def thread_crashes(monkeypatch):
    crashes = []
    monkeypatch.setattr(
        threading, "excepthook", lambda args: crashes.append(args)
    )
    return crashes


def _no_crash(thread_crashes):
    assert not thread_crashes, [str(c.exc_value) for c in thread_crashes]


# -- the card tier's answer to an injected fault -------------------------------


def _failing(*errors):
    """A solve thunk raising ``errors`` in turn, then answering "ok";
    ``calls`` counts its attempts."""
    calls = []

    def thunk():
        calls.append(1)
        if len(calls) <= len(errors):
            raise errors[len(calls) - 1]
        return "ok"

    return thunk, calls


def _ladder():
    return SolverLadder(RobustnessConfig(sleep=lambda _s: None))


def test_card_tier_retries_an_injected_fault_in_place():
    ladder = _ladder()
    thunk, calls = _failing(FaultInjected("device_solve"))
    before = port_metrics.solve_retries.value(tier="cuda")
    assert ladder.run([("cuda", thunk)]) == ("cuda", "ok")
    assert len(calls) == 2
    assert ladder.injected_retries == 1
    assert port_metrics.solve_retries.value(tier="cuda") == before + 1
    assert ladder.solves_by_tier["cuda"] == 1


def test_card_tier_exhausts_on_a_second_injected_fault():
    """Two injected faults spend the two attempts: LadderExhausted with
    the FaultInjected as its cause, and no CPU tier is ever tried."""
    ladder = _ladder()
    thunk, calls = _failing(FaultInjected("device_solve"),
                            FaultInjected("device_solve"))
    with pytest.raises(LadderExhausted) as exc:
        ladder.run([("cuda", thunk)])
    assert isinstance(exc.value.__cause__, FaultInjected)
    assert len(calls) == 2
    assert ladder.injected_retries == 1
    assert ladder.solves_by_tier["cuda"] == 0
    assert ladder.solves_by_tier["host_greedy"] == 0


@pytest.mark.parametrize("err", [
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    KernelError("the greedy kernel failed to launch"),
    SolveTimeout("cuda", 60.0),
], ids=["runtime_error", "kernel_error", "solve_timeout"])
def test_card_tier_raises_a_real_fault_at_once(err):
    """A real fault on the card is never retried and never steps down:
    it propagates from the first attempt (the batch scheduler then stops
    on it)."""
    ladder = _ladder()
    thunk, calls = _failing(err, err)
    before = port_metrics.solve_retries.value(tier="cuda")
    with pytest.raises(type(err)):
        ladder.run([("cuda", thunk), ("host_greedy", lambda: "cpu")])
    assert len(calls) == 1
    assert ladder.injected_retries == 0
    assert port_metrics.solve_retries.value(tier="cuda") == before
    assert ladder.solves_by_tier["host_greedy"] == 0


@pytest.mark.parametrize("faults", [1, 2, 3], ids=lambda k: f"{k}_faults")
def test_cpu_device_tier_answers_injected_faults_like_the_jax_package(faults):
    """On the CPU the port's ``torch`` tier retries and steps down to
    host greedy exactly as the JAX package's ``xla`` tier does."""
    out = {}
    for pkg in BOTH:
        P = PKG[pkg]
        ladder = P["ladder"].SolverLadder(
            P["ladder"].RobustnessConfig(sleep=lambda _s: None))
        fi = P["faults"].FaultInjected
        thunk, calls = _failing(*[fi("device_solve")] * faults)
        tier, res = ladder.run([(P["device_tier"], thunk),
                                ("host_greedy", lambda: "host")])
        out[pkg] = (tier == P["device_tier"], res, len(calls))
    assert out["torch"] == out["jax"]


def test_card_floor_requeues_the_batch_on_the_backoff_clock():
    """Where the CPU hands an exhausted batch to the sequential oracle (a
    first singleton, a gang, containment off), the card requeues its
    pods on the backoff clock for K1: no pod takes the sequential path.
    The batch scheduler runs on the CPU with its device named ``cuda``
    for the one call, which touches no tensor."""
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, device="cpu")
    client.create_node(make_node("n0").capacity(cpu="4", memory="8Gi").obj())
    for i in range(2):
        client.create_pod(make_pod(f"p{i}").container(cpu="100m").obj())
    informers.start()
    informers.wait_for_cache_sync()
    try:
        infos = [sched.queue.pop(timeout=5) for _ in range(2)]
        assert all(infos)
        sched.device = torch.device("cuda")
        sched._exhausted_sequential(
            infos, sched.queue.scheduling_cycle, port_fr.NULL_SPAN)
        counts = sched.queue.num_pending()
        assert (counts["backoff"], counts["unschedulable"]) == (2, 0)
        assert sched.pods_fallback == 0
        assert sched.ladder.solves_by_tier["sequential"] == 0
        assert not any(p.spec.node_name for p in client.list_pods()[0])
    finally:
        sched.device = torch.device("cpu")
        sched.stop()
        informers.stop()


# -- twins of tests/test_chaos.py ----------------------------------------------


def _chaos_cluster(pkg, num_nodes=64, max_batch=128):
    P = PKG[pkg]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](
        client, informers, batch=True, max_batch=max_batch,
        robustness_config=P["ladder"].RobustnessConfig(
            solve_timeout_seconds=5.0, failure_threshold=2,
            cooloff_seconds=0.3, probe_batches=1,
            retry=P["circuit"].RetryPolicy(
                max_attempts=3, backoff_seconds=0.01,
                max_backoff_seconds=0.05,
            ),
        ),
        **P["kw"],
    )
    for i in range(num_nodes):
        client.create_node(
            P["node"](f"node-{i}").capacity(cpu="32", memory="64Gi", pods=110)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    return server, client, informers, sched


def _wait_bound(client, names, timeout):
    deadline = time.time() + timeout
    outstanding = set(names)
    while time.time() < deadline and outstanding:
        outstanding -= {p.metadata.name for p in client.list_pods()[0]
                        if p.spec.node_name}
        if outstanding:
            time.sleep(0.1)
    return outstanding


def _install(pkg, name, points, seed=0):
    f = PKG[pkg]["faults"]
    inj = f.FaultInjector(f.FaultProfile(name, seed=seed, points={
        getattr(f.FaultPoint, k): f.PointConfig(**v) for k, v in points.items()
    }))
    f.install_injector(inj)
    return inj


def _churn_under_chaos(pkg):
    """tests/test_chaos.py:93: 1,000 pods of churn under 20% device
    faults, hangs past the watchdog, garbage results, a bind-conflict
    burst and watch drops; then a forced breaker cycle."""
    P = PKG[pkg]
    m = P["metrics"]
    tier = P["device_tier"]
    server, client, informers, sched = _chaos_cluster(pkg)
    _install(pkg, "chaos-e2e", {
        "DEVICE_SOLVE": dict(rate=0.2, max_fires=24),
        "DEVICE_SOLVE_HANG": dict(rate=0.08, max_fires=2, hang_seconds=8.0),
        "SOLVE_GARBAGE": dict(rate=0.1, max_fires=4),
        "BIND_CONFLICT": dict(rate=1.0, max_fires=2),
        "WATCH_DROP": dict(rate=0.02, max_fires=3),
    }, seed=1234)
    fp = P["faults"].FaultPoint
    before = {p: m.faults_injected.value(point=p)
              for p in (fp.DEVICE_SOLVE, fp.BIND_CONFLICT)}
    try:
        sched.start()
        names = [f"w1-{i}" for i in range(400)]
        for n in names:
            client.create_pod(
                P["pod"](n).container(cpu="250m", memory="512Mi").obj())
        assert not _wait_bound(client, names, 120), f"{pkg}: wave 1"
        for i in range(100):
            client.delete_pod("default", f"w1-{i}")
        names2 = [f"{w}-{i}" for w in ("w2", "w3") for i in range(300)]
        for n in names2:
            client.create_pod(
                P["pod"](n).container(cpu="250m", memory="512Mi").obj())
        assert not _wait_bound(client, names2, 120), f"{pkg}: churn waves"
        sched.wait_for_inflight_binds()
        unbound = [p.metadata.name for p in client.list_pods()[0]
                   if not p.spec.node_name]
        assert not unbound, f"{pkg}: unbound after chaos: {unbound[:10]}"
        for p, v in before.items():
            assert m.faults_injected.value(point=p) > v, (pkg, p)
        assert [line for line in m.solver_fallbacks.collect()
                if not line.startswith("#")]
        assert any(t != tier and n > 0
                   for t, n in sched.ladder.solves_by_tier.items()
                   ) or sched.pods_fallback > 0
        # heal, then one deterministic closed -> open -> half-open ->
        # closed cycle of the device tier's breaker
        P["faults"].install_injector(None)
        closed = P["circuit"].CLOSED
        breaker = sched.ladder.breakers[tier]
        deadline, i = time.time() + 20, 0
        while breaker.state != closed and time.time() < deadline:
            client.create_pod(P["pod"](f"heal-{i}").container(cpu="100m").obj())
            _wait_bound(client, [f"heal-{i}"], 10)
            i += 1
            time.sleep(0.2)
        assert breaker.state == closed
        edges = (("closed", "open"), ("open", "half_open"),
                 ("half_open", "closed"))
        t0 = {e: m.breaker_transitions.value(
            tier=tier, from_state=e[0], to_state=e[1]) for e in edges}
        _install(pkg, "force-cycle",
                 {"DEVICE_SOLVE": dict(rate=1.0, max_fires=6)})
        for i in range(2):
            client.create_pod(
                P["pod"](f"cycle-a{i}").container(cpu="100m").obj())
            assert not _wait_bound(client, [f"cycle-a{i}"], 30)
        deadline = time.time() + 10
        while (m.breaker_transitions.value(
                tier=tier, from_state="closed", to_state="open")
               <= t0[edges[0]] and time.time() < deadline):
            time.sleep(0.05)
        time.sleep(0.4)  # past the cool-off: the next batch probes
        client.create_pod(P["pod"]("cycle-probe").container(cpu="100m").obj())
        assert not _wait_bound(client, ["cycle-probe"], 30)
        deadline = time.time() + 10
        while breaker.state != closed and time.time() < deadline:
            time.sleep(0.05)
        for e in edges:
            assert m.breaker_transitions.value(
                tier=tier, from_state=e[0], to_state=e[1]) > t0[e], (pkg, e)
    finally:
        sched.stop()
        informers.stop()
    assert not sched.commit_degraded


def test_churn_binds_everything_under_chaos(thread_crashes):
    """Twin of TestChaosChurn's first test, through both packages: every
    pod binds, nothing crashes, and each package's device tier walks a
    full breaker cycle."""
    for pkg in BOTH:
        _churn_under_chaos(pkg)
    _no_crash(thread_crashes)


def _device_down(pkg):
    P = PKG[pkg]
    server, client, informers, sched = _chaos_cluster(pkg, 16, 64)
    _install(pkg, "device-down", {"DEVICE_SOLVE": dict(rate=1.0)})
    try:
        sched.start()
        names = [f"p{i}" for i in range(120)]
        for n in names:
            client.create_pod(
                P["pod"](n).container(cpu="100m", memory="128Mi").obj())
        assert not _wait_bound(client, names, 60)
        sched.wait_for_inflight_binds()
        assert sched.ladder.solves_by_tier["host_greedy"] > 0
        assert sched.ladder.solves_by_tier[P["device_tier"]] == 0
        return {p.metadata.name: p.spec.node_name
                for p in client.list_pods()[0]}
    finally:
        sched.stop()
        informers.stop()


def test_device_down_everything_still_binds(thread_crashes):
    """Twin of TestChaosChurn's second test: every device solve fails on
    the CPU, the host tiers carry the burst."""
    for pkg in BOTH:
        _device_down(pkg)
    _no_crash(thread_crashes)


# -- twins of tests/test_fallback_guard.py -------------------------------------


def _wait_all_bound(client, count, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if len([p for p in pods if p.spec.node_name]) >= count:
            return pods
        time.sleep(0.05)
    raise AssertionError("the burst did not bind")


def _guard_burst(pkg, csi):
    P = PKG[pkg]
    T = P["types"]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](client, informers, batch=True, max_batch=32, **P["kw"])
    try:
        for i in range(6):
            client.create_node(
                P["node"](f"n{i}").capacity(cpu="16", memory="32Gi").obj())
            if csi:
                server.create(T.CSINode(
                    metadata=T.ObjectMeta(name=f"n{i}", namespace=""),
                    drivers=[T.CSINodeDriver(
                        name="ebs.csi.aws.com", node_id=f"n{i}",
                        allocatable_count=8)],
                ))
        for i in range(24 if csi else 0):
            server.create(T.PersistentVolumeClaim(
                metadata=T.ObjectMeta(name=f"pvc-{i}", namespace="default"),
                volume_name=f"pv-{i}", requested_bytes=1 << 30,
            ))
            server.create(T.PersistentVolume(
                metadata=T.ObjectMeta(name=f"pv-{i}", namespace=""),
                capacity_bytes=1 << 30, claim_ref_namespace="default",
                claim_ref_name=f"pvc-{i}", csi_driver="ebs.csi.aws.com",
                csi_volume_handle=f"pv-{i}",
            ))
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        for i in range(24):
            pw = P["pod"](f"p{i}").container(cpu="250m", memory="256Mi")
            if csi:
                pw.pvc(f"pvc-{i}")
            client.create_pod(pw.obj())
        sched.start()
        _wait_all_bound(client, 24)
        sched.wait_for_inflight_binds()
        assert sched.pods_fallback == 0, f"{pkg}: a pod fell off the solver"
        assert sched.pods_solved_on_device >= 24
        if csi:
            assert sched.volume_reject_retries == 0
            used = [ni.volume_in_use.get(
                "attachable-volumes-csi-ebs.csi.aws.com", 0)
                for ni in sched.cache._nodes.values()]
            assert max(used) <= 8 and sum(used) == 24
        return {p.metadata.name: p.spec.node_name
                for p in client.list_pods()[0]}
    finally:
        sched.stop()
        informers.stop()


@pytest.mark.parametrize("csi", [False, True], ids=["basic", "csi_pv"])
def test_burst_rides_the_solver_with_no_fallback(csi):
    """Twins of tests/test_fallback_guard.py: the whole burst solves on
    the device tier with no fallback (the CSI-PV burst within its attach
    limits), and places as the JAX package places it."""
    assert _guard_burst("torch", csi) == _guard_burst("jax", csi)


# -- twin of TestLifecycleChaosStorm -------------------------------------------


def _storm(pkg):
    """tests/test_lifecycle_chaos.py:234's storm: 600 pods onto 48 nodes
    while the lifecycle-chaos profile (seed 42) flaps nodes, fires a
    reclamation storm and sprinkles solver faults; the driver runs until
    its chaos has landed (a flap and the storm) and the fleet is whole."""
    P = PKG[pkg]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](client, informers, batch=True, max_batch=128, **P["kw"])
    for i in range(48):
        client.create_node(
            P["node"](f"node-{i}").capacity(cpu="32", memory="64Gi", pods=110)
            .obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    f = P["faults"]
    inj = f.FaultInjector(f.load_profile("lifecycle-chaos", seed=42))
    f.install_injector(inj)
    drv = P["lifecycle"].ClusterLifecycleDriver(
        client, injector=inj, tick_interval=0.1, flap_down_seconds=0.5,
        storm_fraction=0.1, storm_down_seconds=1.0,
    )
    names = [f"w-{i}" for i in range(600)]

    def all_bound():
        pods, _ = client.list_pods()
        return bool(pods) and all(p.spec.node_name for p in pods)

    try:
        sched.start()
        drv.start()
        for n in names:
            client.create_pod(
                P["pod"](n).container(cpu="250m", memory="256Mi").obj())
        deadline = time.time() + 120
        while time.time() < deadline and not (
            all_bound() and drv.flaps > 0 and drv.storms == 1
            and drv.down_count() == 0
        ):
            time.sleep(0.1)
    finally:
        drv.stop()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not all_bound():
            time.sleep(0.2)
        sched.wait_for_inflight_binds()
        pods, _ = client.list_pods()
        unbound = [p.metadata.name for p in pods if not p.spec.node_name]
        assert not unbound, f"{pkg}: unbound after chaos: {unbound[:10]}"
        assert {p.metadata.name for p in pods} == set(names)
        assert drv.flaps > 0 and drv.storms == 1
        assert drv.nodes_reclaimed >= drv.flaps
        assert len(client.list_nodes()[0]) == 48
        doubles = {u: c for u, c in _bind_transitions_by_uid(server).items()
                   if c > 1}
        assert not doubles, f"{pkg}: double-bound incarnations: {doubles}"
        assert sched.membership_row_patches > 0
        return drv.flaps, drv.storms, inj.fired_count(f.FaultPoint.DEVICE_SOLVE)
    finally:
        sched.stop()
        informers.stop()


def test_storm_converges_under_lifecycle_chaos(thread_crashes):
    """Twin of TestLifecycleChaosStorm through both packages: every live
    pod bound, the fleet whole again, no incarnation bound twice, the
    churn carried as row patches; on the port the solver faults of the
    profile are retried on its device tier and never stop it."""
    for pkg in BOTH:
        _storm(pkg)
    _no_crash(thread_crashes)
