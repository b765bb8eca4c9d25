"""The port's containment plane against the JAX package's, on the CPU.

Twins of the seven tests of ``tests/test_containment.py``: the poison
bisection and its quarantine, the exhausted-ladder crash loop, the
release of a parked pod by a real spec update, the carry integrity audit
(detect and heal, and concluding under load), the device-loss rebuild,
and the poison-chaos 1k guard. Each scenario runs through both packages
-- the JAX package on the CPU, the port's batch scheduler on
``device="cpu"`` -- and both must meet the reference's contract. Where
the outcome does not depend on timing, the port's placements must equal
the JAX package's on the same seed: the bisection's healthy placements
(which also equal the port's own no-poison run), the released pod, the
waves around a corrupted carry and around a device loss.
"""

import json
import random
import threading
import time

import pytest

import kubernetes_tpu.robustness.circuit as jax_circuit
import kubernetes_tpu.robustness.containment as jax_containment
import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu.robustness.ladder as jax_ladder
import kubernetes_tpu_torch.robustness.circuit as port_circuit
import kubernetes_tpu_torch.robustness.containment as port_containment
import kubernetes_tpu_torch.robustness.faults as port_faults
import kubernetes_tpu_torch.robustness.ladder as port_ladder
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu.utils import flightrecorder as jax_fr
from kubernetes_tpu.utils import metrics as jax_metrics
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.utils import flightrecorder as port_fr
from kubernetes_tpu_torch.utils import metrics as port_metrics

PKG = {
    "jax": dict(server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
                new=jax_new, node=jax_node, pod=jax_pod, faults=jax_faults,
                containment=jax_containment, ladder=jax_ladder,
                circuit=jax_circuit, metrics=jax_metrics, fr=jax_fr, kw={}),
    "torch": dict(server=APIServer, client=Client, informers=InformerFactory,
                  new=new_scheduler, node=make_node, pod=make_pod,
                  faults=port_faults, containment=port_containment,
                  ladder=port_ladder, circuit=port_circuit,
                  metrics=port_metrics, fr=port_fr, kw={"device": "cpu"}),
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


def _injector(pkg, name, points=None, profile=None, seed=0):
    """Install a seeded injector into ``pkg``'s fault module and return
    it (poison stamps manifest only while one is installed)."""
    f = PKG[pkg]["faults"]
    prof = (
        f.load_profile(profile, seed=seed) if profile
        else f.FaultProfile(name, seed=seed, points={
            getattr(f.FaultPoint, k): f.PointConfig(**v)
            for k, v in (points or {}).items()
        })
    )
    inj = f.FaultInjector(prof)
    f.install_injector(inj)
    return inj


def _mk_cluster(pkg, num_nodes=16, max_batch=128, capacity_cpu="32",
                capacity_pods=110):
    """The reference's stack (tests/test_containment.py:_mk_cluster) for
    one package: fast breakers, one attempt per tier, strike budget 3
    with sub-second holds, a 0.1 s requeue clock."""
    P = PKG[pkg]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](
        client, informers, batch=True, max_batch=max_batch,
        robustness_config=P["ladder"].RobustnessConfig(
            solve_timeout_seconds=10.0, failure_threshold=3,
            cooloff_seconds=0.2, probe_batches=1,
            retry=P["circuit"].RetryPolicy(
                max_attempts=1, backoff_seconds=0.01,
                max_backoff_seconds=0.02,
            ),
        ),
        containment_config=P["containment"].ContainmentConfig(
            max_strikes=3, base_hold_seconds=0.1, max_hold_seconds=0.5,
        ),
        **P["kw"],
    )
    sched.queue._initial_backoff = 0.1
    sched.queue._max_backoff = 0.5
    for i in range(num_nodes):
        client.create_node(
            P["node"](f"node-{i}")
            .capacity(cpu=capacity_cpu, memory="64Gi", pods=capacity_pods)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    return server, client, informers, sched


def _wait(predicate, timeout, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def _bound_map(client):
    return {
        p.metadata.name: p.spec.node_name
        for p in client.list_pods()[0] if p.spec.node_name
    }


def _overcommitted_nodes(client):
    """Nodes whose bound pods' cpu requests exceed capacity."""
    cap = {
        n.metadata.name: n.status.allocatable.get("cpu", 0)
        for n in client.list_nodes()[0]
    }
    used = {}
    for p in client.list_pods()[0]:
        if p.spec.node_name:
            used[p.spec.node_name] = used.get(p.spec.node_name, 0) + sum(
                c.resources.requests.get("cpu", 0) for c in p.spec.containers
            )
    return [n for n, u in used.items() if cap.get(n) is not None and u > cap[n]]


def _no_crash(thread_crashes):
    assert not thread_crashes, [str(c.exc_value) for c in thread_crashes]


# -- bisection isolates exactly the stamped pods ------------------------------


def _poison_burst(pkg, trial, poison_names, with_poison):
    """tests/test_containment.py:148's run(): 60 pods of 750m on 12
    nodes of 16 CPU, created before the scheduler starts (one batch)."""
    P = PKG[pkg]
    server, client, informers, sched = _mk_cluster(
        pkg, num_nodes=12, capacity_cpu="16"
    )
    if with_poison:
        _injector(pkg, "poison-differential", seed=trial)
    try:
        for i in range(60):
            name = f"t{trial}-p{i}"
            if name in poison_names and not with_poison:
                continue
            pw = P["pod"](name).container(cpu="750m", memory="512Mi")
            if with_poison and name in poison_names:
                pw.annotation(P["faults"].POISON_ANNOTATION, "true")
            client.create_pod(pw.obj())
        sched.start()
        healthy = {f"t{trial}-p{i}" for i in range(60)} - poison_names
        assert _wait(lambda: healthy <= set(_bound_map(client)), 60), (
            f"{pkg}: healthy pods did not all bind"
        )
        if with_poison:
            assert _wait(
                lambda: sched.queue.quarantine_parked_count()
                == len(poison_names), 60,
            ), f"{pkg}: poison pods did not all park"
        sched.wait_for_inflight_binds()
        parked = {pi.pod.metadata.name for pi in sched.queue.quarantined_pods()}
        conditions = {
            name: [c.type for c in client.get_pod("default", name)
                   .status.conditions if c.status == "True"]
            for name in (poison_names if with_poison else ())
        }
        return _bound_map(client), parked, conditions, sched.bisections
    finally:
        sched.stop()
        informers.stop()
        P["faults"].install_injector(None)


def test_bisection_isolates_exactly_the_stamped_pods(thread_crashes):
    """Twin of TestPoisonBisectionDifferential: 1-3 poison pods at seeded
    offsets in a 60-pod burst park with the typed condition, and every
    healthy placement equals the port's no-poison run and the JAX
    package's poisoned run."""
    rng = random.Random(20260804)
    for trial in range(2):
        n_poison = rng.randint(1, 3)
        offsets = sorted(rng.sample(range(60), n_poison))
        poison_names = {f"t{trial}-p{i}" for i in offsets}
        got = _poison_burst("torch", trial, poison_names, True)
        oracle = _poison_burst("torch", trial, poison_names, False)[0]
        ref = _poison_burst("jax", trial, poison_names, True)
        placements, parked, conditions, bisections = got
        assert parked == poison_names == ref[1]
        assert not poison_names & set(placements)
        for name in poison_names:
            assert port_containment.QUARANTINE_CONDITION in conditions[name]
        assert placements == oracle
        assert placements == ref[0]
        assert bisections >= 1
    _no_crash(thread_crashes)


# -- the exhausted-ladder crash loop and the release of a parked pod ----------


def _lone_poison(pkg):
    P = PKG[pkg]
    m = P["metrics"]
    server, client, informers, sched = _mk_cluster(pkg, num_nodes=4)
    _injector(pkg, "lone-poison")
    crashloops_before = m.exhausted_crashloops.value()
    try:
        sched.start()
        client.create_pod(
            P["pod"]("poison-solo").container(cpu="100m")
            .annotation(P["faults"].POISON_ANNOTATION, "true").obj()
        )
        assert _wait(lambda: sched.queue.quarantine_parked_count() == 1, 60), (
            f"{pkg}: lone poison pod never parked"
        )
        assert m.exhausted_crashloops.value() > crashloops_before
        live = client.get_pod("default", "poison-solo")
        assert any(
            c.type == P["containment"].QUARANTINE_CONDITION
            and c.status == "True" for c in live.status.conditions
        )
        client.create_pod(P["pod"]("after").container(cpu="100m").obj())
        assert _wait(lambda: "after" in _bound_map(client), 30)
        sched.wait_for_inflight_binds()
        return (sched.quarantine.parks, sched.quarantine.isolations,
                sched.containment_config.max_strikes, _bound_map(client))
    finally:
        sched.stop()
        informers.stop()


def test_singleton_poison_trips_the_crash_loop_then_parks(thread_crashes):
    """Twin of TestExhaustedCrashloop's first test: the second identical
    exhaustion books a crash loop and strikes the lone poison pod into
    quarantine; it parks within the strike budget, and healthy traffic
    binds after it as in the JAX package."""
    got = {pkg: _lone_poison(pkg) for pkg in BOTH}
    for pkg in BOTH:
        parks, isolations, strikes, _ = got[pkg]
        assert parks == 1
        assert isolations <= strikes
    assert got["torch"][3] == got["jax"][3]
    _no_crash(thread_crashes)


def _release(pkg):
    P = PKG[pkg]
    server, client, informers, sched = _mk_cluster(pkg, num_nodes=4)
    _injector(pkg, "release")
    try:
        sched.start()
        client.create_pod(
            P["pod"]("cured").container(cpu="100m")
            .annotation(P["faults"].POISON_ANNOTATION, "true").obj()
        )
        assert _wait(lambda: sched.queue.quarantine_parked_count() == 1, 60)

        def fix(p):
            p.metadata.annotations = {
                k: v for k, v in p.metadata.annotations.items()
                if k != P["faults"].POISON_ANNOTATION
            }
            p.metadata.labels = {**p.metadata.labels, "fixed": "true"}

        server.guaranteed_update("Pod", "default", "cured", fix)
        assert _wait(lambda: "cured" in _bound_map(client), 30), (
            f"{pkg}: released pod did not bind"
        )
        assert sched.queue.quarantine_parked_count() == 0
        assert _wait(
            lambda: not any(
                c.type == P["containment"].QUARANTINE_CONDITION
                for c in client.get_pod("default", "cured").status.conditions
            ), 10,
        ), f"{pkg}: PodQuarantined condition outlived the release"
        assert P["metrics"].quarantine_parked.value() == 0
        return _bound_map(client)["cured"]
    finally:
        sched.stop()
        informers.stop()


def test_spec_update_releases_the_parked_pod():
    """Twin of TestExhaustedCrashloop's second test: a real spec update
    releases the parked pod, its condition is cleared, and it binds to
    the node the JAX package binds it to."""
    assert _release("torch") == _release("jax")


# -- the carry integrity audit -------------------------------------------------


def _corrupt_and_heal(pkg):
    P = PKG[pkg]
    m = P["metrics"]
    server, client, informers, sched = _mk_cluster(pkg, num_nodes=8,
                                                   max_batch=32)
    try:
        sched.start()
        names1 = [f"w1-{i}" for i in range(40)]
        for n in names1:
            client.create_pod(
                P["pod"](n).container(cpu="250m", memory="256Mi").obj())
        assert _wait(lambda: set(names1) <= set(_bound_map(client)), 60)
        sched.wait_for_inflight_binds()
        assert _wait(lambda: sched.audit_carry() in ("clean", "idle"), 10)
        uploads_before = sched.state_uploads
        inj = _injector(pkg, "corrupt", points={
            "CARRY_CORRUPT": dict(rate=1.0, max_fires=1)})
        client.create_pod(P["pod"]("trigger").container(cpu="100m").obj())
        assert _wait(lambda: "trigger" in _bound_map(client), 30)
        sched.wait_for_inflight_binds()
        assert _wait(
            lambda: inj.fired_count(P["faults"].FaultPoint.CARRY_CORRUPT)
            == 1, 10)
        mm_before = m.carry_audit_mismatches.value(array="req")
        assert _wait(lambda: sched.audit_carry() == "mismatch", 10), (
            f"{pkg}: the audit never detected the corrupted row"
        )
        assert m.carry_audit_mismatches.value(array="req") > mm_before
        assert sched.carry_audit_heals >= 1
        names2 = [f"w2-{i}" for i in range(40)]
        for n in names2:
            client.create_pod(
                P["pod"](n).container(cpu="250m", memory="256Mi").obj())
        assert _wait(lambda: set(names2) <= set(_bound_map(client)), 60)
        sched.wait_for_inflight_binds()
        assert sched.state_uploads > uploads_before, (
            f"{pkg}: the heal never took the counted-upload path"
        )
        assert _wait(lambda: sched.audit_carry() == "clean", 10)
        assert not _overcommitted_nodes(client)
        return _bound_map(client)
    finally:
        sched.stop()
        informers.stop()


def test_corruption_is_detected_and_healed(thread_crashes):
    """Twin of TestCarryIntegrityAudit: a corrupted resident row is seen
    by the audit's checksums, healed through a counted upload, and every
    wave around it places as the JAX package places it."""
    assert _corrupt_and_heal("torch") == _corrupt_and_heal("jax")
    _no_crash(thread_crashes)


def _audit_under_load(pkg):
    P = PKG[pkg]
    server, client, informers, sched = _mk_cluster(
        pkg, num_nodes=8, max_batch=16, capacity_pods=4000)
    sched.start()
    for i in range(20):
        client.create_pod(
            P["pod"](f"warm-{i}").container(cpu="100m", memory="64Mi").obj())
    assert _wait(lambda: all(f"warm-{i}" in _bound_map(client)
                             for i in range(20)), 60)
    sched.wait_for_inflight_binds()
    orig_complete = sched._complete_solve

    def slow_complete(p):
        time.sleep(0.2)
        return orig_complete(p)

    sched._complete_solve = slow_complete
    stop_feeding = threading.Event()

    def feeder():
        i = 0
        while not stop_feeding.is_set():
            try:
                client.create_pod(
                    P["pod"](f"load-{i}").container(cpu="10m").obj())
            except Exception:  # noqa: BLE001 - the feeder is best-effort
                pass
            i += 1
            time.sleep(0.02)

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        concluded = busy = 0
        deadline = time.time() + 30
        while time.time() < deadline and concluded < 3:
            if not sched._pending_exists():
                time.sleep(0.01)
                continue
            out = sched.audit_carry()
            if not sched._pending_exists():
                continue
            if out in ("clean", "mismatch"):
                concluded += 1
            elif out == "busy":
                busy += 1
            time.sleep(0.03)
        assert concluded >= 3, f"{pkg}: audit never concluded (busy={busy})"
        inj = _injector(pkg, "corrupt-under-load", points={
            "CARRY_CORRUPT": dict(rate=1.0, max_fires=1)})
        assert _wait(
            lambda: inj.fired_count(P["faults"].FaultPoint.CARRY_CORRUPT)
            == 1, 20), f"{pkg}: the corruption never fired"
        assert _wait(lambda: sched.audit_carry() == "mismatch", 20, 0.02), (
            f"{pkg}: the audit never saw the corruption under load"
        )
        assert sched.carry_audit_heals >= 1
    finally:
        stop_feeding.set()
        t.join(timeout=5)
        sched._complete_solve = orig_complete
    sched.wait_for_inflight_binds()
    assert _wait(lambda: sched.audit_carry() in ("clean", "idle"), 10)
    assert not _overcommitted_nodes(client)
    sched.stop()
    informers.stop()


def test_audit_concludes_under_load(thread_crashes):
    """Twin of TestAuditUnderLoad on the port: with the committer slowed
    so batches stay in flight, the audit concludes on the first
    unmirrored record's carry and sees a corruption stamped into the
    stream without the load ever pausing. (The feeder's timing leaves no
    output to compare; the JAX package's run is the reference test.)"""
    _audit_under_load("torch")
    _no_crash(thread_crashes)


# -- device loss ---------------------------------------------------------------


def _device_loss(pkg):
    P = PKG[pkg]
    m = P["metrics"]
    server, client, informers, sched = _mk_cluster(pkg, num_nodes=8,
                                                   max_batch=64)
    try:
        sched.start()
        names1 = [f"a-{i}" for i in range(30)]
        for n in names1:
            client.create_pod(
                P["pod"](n).container(cpu="100m", memory="128Mi").obj())
        assert _wait(lambda: set(names1) <= set(_bound_map(client)), 60)
        sched.wait_for_inflight_binds()
        lost_before = m.device_lost_events.value()
        rebuilds_before = m.device_rebuild_ms.count()
        uploads_before = sched.state_uploads
        _injector(pkg, "device-loss", points={
            "DEVICE_LOST": dict(rate=1.0, max_fires=1)})
        names2 = [f"b-{i}" for i in range(30)]
        for n in names2:
            client.create_pod(
                P["pod"](n).container(cpu="100m", memory="128Mi").obj())
        assert _wait(lambda: set(names2) <= set(_bound_map(client)), 60), (
            f"{pkg}: the post-loss wave did not bind"
        )
        sched.wait_for_inflight_binds()
        assert m.device_lost_events.value() == lost_before + 1
        assert m.device_rebuild_ms.count() == rebuilds_before + 1
        assert sched.state_uploads > uploads_before
        assert not _overcommitted_nodes(client)
        return _bound_map(client)
    finally:
        sched.stop()
        informers.stop()


def test_device_loss_rebuilds_and_everything_binds(thread_crashes):
    """Twin of TestDeviceLossRebuild: the loss drops every resident
    buffer, the next solve rebuilds from the host cache (metered once),
    and both waves place as the JAX package places them."""
    assert _device_loss("torch") == _device_loss("jax")
    _no_crash(thread_crashes)


# -- the poison-chaos 1k guard -------------------------------------------------


def _poison_chaos(pkg):
    P = PKG[pkg]
    fr = P["fr"]
    fp = P["faults"].FaultPoint
    fr.RECORDER.reset()
    server, client, informers, sched = _mk_cluster(pkg, num_nodes=48,
                                                   max_batch=256)
    inj = _injector(pkg, None, profile="poison-chaos", seed=7)
    names = [f"pc-{i}" for i in range(1000)]
    try:
        sched.start()
        for n in names:
            client.create_pod(
                P["pod"](n).container(cpu="500m", memory="256Mi").obj())

        def settled():
            counts = sched.queue.num_pending()
            fired = inj.fired_count(fp.POISON_POD)
            return (
                fired >= 1
                and counts.get("active", 0) == 0
                and counts.get("backoff", 0) == 0
                and counts.get("unschedulable", 0) == 0
                and counts.get("quarantined", 0) == 0
                and sched.queue.quarantine_parked_count() == fired
                and len(_bound_map(client)) == len(names) - fired
            )

        assert _wait(settled, 300, interval=0.2), (
            f"{pkg}: never settled: {sched.queue.num_pending()}"
        )
        stamped = {pi.pod.metadata.name
                   for pi in sched.queue.quarantined_pods()}
        sched.wait_for_inflight_binds()
        bound = _bound_map(client)
        assert set(names) - stamped <= set(bound)
        assert not stamped & set(bound), f"{pkg}: a poison pod bound"
        assert sched.pods_solved_on_device >= 0.9 * len(bound)
        assert (sched.quarantine.isolations
                <= len(stamped) * sched.containment_config.max_strikes)
        assert sched.quarantine.parks == len(stamped)
        assert not _overcommitted_nodes(client)
        # the flight recorder's dump alone reconstructs the containment
        marks = json.loads(fr.RECORDER.dump_json())["marks"]
        kinds = [m["kind"] for m in marks]
        assert kinds.count("bisect_start") == sched.bisections
        assert (kinds.count("bisect_done") + kinds.count("bisect_abort")
                == sched.bisections)
        quarantine_marks = [m for m in marks if m["kind"] == "quarantine"]
        assert len(quarantine_marks) == sched.quarantine.isolations
        assert {m["pod"] for m in quarantine_marks
                if m["disposition"] == "parked"} == {
            pi.pod.metadata.uid for pi in sched.queue.quarantined_pods()}
        assert kinds.count("bisect_isolated") <= len(quarantine_marks)
        assert sum(1 for m in marks if m["kind"] == "fault"
                   and m["point"] == fp.POISON_POD) == inj.fired_count(
                       fp.POISON_POD)
        return stamped
    finally:
        sched.stop()
        informers.stop()
        assert not sched.commit_degraded


def test_poison_chaos_1k_guard(thread_crashes):
    """Twin of TestPoisonChaosGuard: 1,000 pods under the poison-chaos
    profile at seed 7. Every healthy pod binds, every stamped pod parks
    within its strike budget, the flight recorder reconstructs every
    bisection and quarantine -- and the profile stamps the same pods in
    both packages (one draw per pod, in pop order)."""
    assert _poison_chaos("torch") == _poison_chaos("jax")
    _no_crash(thread_crashes)
