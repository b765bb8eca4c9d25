"""The port's fairness plane (kubernetes_tpu_torch/scheduler/tenancy.py,
kubernetes_tpu_torch/controllers/quota.py and the solve-order hook in
the batch scheduler) on the CPU, against the JAX package.

Exact everywhere: this is integer and host logic. ``fair_order`` gives
equal index arrays on seeded multi-tenant, multi-priority batches; the
share tracker gives equal shares after the same bind/unbind sequence;
the quota controller's ledger (each admission's verdict, each refund,
every quota's ``used``) is equal over a seeded churn replay; one
tenancy-armed batch scheduler per package solves a contended
multi-tenant burst in the same (fair) order and places it alike, with
an equal Jain index; the port's twin of the randomized churn under the
ha-chaos profile keeps its ledger equal to the apiserver's truth with no
overspend; and ``SchedulerApp`` arms the plane on ``device="cpu"``.
"""

import random
import time

import numpy as np
import pytest

import kubernetes_tpu.api.types as jax_types
import kubernetes_tpu.scheduler.tenancy as jax_ten
import kubernetes_tpu_torch.api.types as port_types
import kubernetes_tpu_torch.scheduler.tenancy as port_ten
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.controllers.quota import QuotaController as JaxQuota
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.config.types import (
    KubeSchedulerConfiguration,
    TenancyConfiguration,
)
from kubernetes_tpu_torch.controllers import QuotaController
from kubernetes_tpu_torch.controllers.quota import quota_pod_usage
from kubernetes_tpu_torch.robustness.faults import (
    FaultInjector,
    install_injector,
    load_profile,
)
from kubernetes_tpu_torch.scheduler.app import SchedulerApp
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

PKG = {
    "jax": dict(server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
                new=jax_new, node=jax_node, pod=jax_pod, types=jax_types,
                ten=jax_ten, quota=JaxQuota, kw={}),
    "torch": dict(server=APIServer, client=Client, informers=InformerFactory,
                  new=new_scheduler, node=make_node, pod=make_pod,
                  types=port_types, ten=port_ten, quota=QuotaController,
                  kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clean_injector():
    yield
    install_injector(None)


def _wait(pred, timeout=20.0, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _pod(pkg, ns, name, cpu_m, mem_mi, priority=0, uid=None):
    p = PKG[pkg]["pod"](name, ns).container(
        cpu=f"{cpu_m}m", memory=f"{mem_mi}Mi").priority(priority).obj()
    if uid is not None:
        p.metadata.uid = uid
    return p


def _quota(pkg, ns, **hard):
    t = PKG[pkg]["types"]
    return t.ResourceQuota(metadata=t.ObjectMeta(name="quota", namespace=ns),
                           hard=dict(hard))


# -- fair_order and the share tracker -----------------------------------------

def _tracker_and_batch(pkg, seed, tenants, n, prios):
    rng = np.random.default_rng(seed)
    tt = PKG[pkg]["ten"].TenantShareTracker()
    tt.set_capacity(64_000, 128 << 20)
    pre = [_pod(pkg, f"t{int(rng.integers(0, tenants))}", f"pre{i}",
                int(rng.integers(1, 40)) * 100, int(rng.integers(1, 64)) * 64,
                uid=f"pre-{seed}-{i}")
           for i in range(int(rng.integers(0, 12)))]
    tt.note_bound(pre)
    pods = [_pod(pkg, f"t{int(rng.integers(0, tenants))}", f"p{i}",
                 int(rng.integers(1, 20)) * 50, int(rng.integers(1, 32)) * 32,
                 priority=int(rng.choice(prios)), uid=f"p-{seed}-{i}")
            for i in range(n)]
    priorities = np.asarray([p.spec.priority for p in pods], dtype=np.int32)
    # pack_pod_batch's base order: priority descending, then arrival
    base = np.asarray(sorted(range(n), key=lambda i: (-priorities[i], i)),
                      dtype=np.int32)
    return tt, pods, priorities, base


@pytest.mark.parametrize("seed", range(6))
def test_fair_order_matches_jax(seed):
    tenants = [1, 2, 3, 7, 20, 64][seed]
    prios = [(0,), (0, 100), (0, 50, 100)][seed % 3]
    out = {}
    for pkg in PKG:
        tt, pods, priorities, base = _tracker_and_batch(
            pkg, seed, tenants, 160, prios)
        out[pkg] = (PKG[pkg]["ten"].fair_order(base, pods, priorities, tt),
                    base)
    got, base = out["torch"]
    assert np.array_equal(got, out["jax"][0])
    assert sorted(int(i) for i in got) == list(range(160))
    if tenants == 1:
        assert got is base  # the single-tenant fast path


def test_share_tracker_matches_jax_over_binds_and_unbinds():
    rng = random.Random(17)
    ops = []
    live = []
    for i in range(300):
        if live and rng.random() < 0.3:
            ops.append(("unbind", live.pop(rng.randrange(len(live)))))
        else:
            spec = (f"t{rng.randrange(9)}", f"p{i}", rng.randrange(1, 40) * 100,
                    rng.randrange(1, 64) * 64)
            live.append(spec)
            ops.append(("bind", spec))
        if rng.random() < 0.1 and live:
            ops.append(("bind", rng.choice(live)))  # a re-echoed bind
    seen = {}
    for pkg in PKG:
        tt = PKG[pkg]["ten"].TenantShareTracker()
        tt.set_capacity(128_000, 256 << 20)
        trail = []
        for op, (ns, name, cpu, mem) in ops:
            pod = _pod(pkg, ns, name, cpu, mem, uid=f"uid-{name}")
            (tt.note_bound if op == "bind" else tt.note_unbound)([pod])
            names = [f"t{k}" for k in range(9)]
            trail.append((tt.shares_for(names), tt.max_share(),
                          tt.share_spread(), tt.usage_and_caps(names)))
        seen[pkg] = trail
    assert seen["torch"] == seen["jax"]


# -- the quota ledger ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quota_ledger_matches_jax(seed):
    """A seeded sequence of admissions, refunds, deletes and quota raises
    driven straight into each package's controller (informers pumped
    after every write): every verdict, every refund and every quota's
    ``used`` equal after every step."""
    rng = random.Random(seed)
    namespaces = [f"t{k}" for k in range(4)]
    hard = {ns: dict(pods=rng.randint(2, 6), cpu=rng.randint(1, 4) * 1000)
            for ns in namespaces}
    script = []
    for i in range(160):
        r = rng.random()
        if r < 0.55:
            script.append(("admit", rng.choice(namespaces), f"p{i}",
                           rng.randint(1, 8) * 100))
        elif r < 0.75:
            script.append(("refund", None, None, None))
        elif r < 0.9:
            script.append(("delete", None, None, None))
        else:
            script.append(("raise", rng.choice(namespaces), None,
                           rng.randint(1, 3)))
    trails = {}
    for pkg in PKG:
        server = PKG[pkg]["server"]()
        client = PKG[pkg]["client"](server)
        informers = PKG[pkg]["informers"](server)
        qc = PKG[pkg]["quota"](client, informers)
        for ns in namespaces:
            client.create_resource_quota(_quota(pkg, ns, **hard[ns]))
        informers.pump()
        charged = []
        pick = random.Random(seed + 100)
        trail = []
        for op, ns, name, val in script:
            if op == "admit":
                pod = _pod(pkg, ns, name, val, 128, uid=f"uid-{name}")
                client.create_pod(pod)
                informers.pump()
                verdict = qc.try_admit(pod)
                if not verdict:
                    charged.append(pod)
                trail.append(("admit", verdict))
            elif op == "refund" and charged:
                pod = charged.pop(pick.randrange(len(charged)))
                trail.append(("refund", qc.refund(pod, reason="requeue")))
            elif op == "delete" and charged:
                pod = charged.pop(pick.randrange(len(charged)))
                client.delete_pod(pod.metadata.namespace, pod.metadata.name)
                informers.pump()
                trail.append(("delete", pod.metadata.name))
            elif op == "raise":
                client.update_resource_quota_status(
                    ns, "quota", lambda o, k=val: setattr(o, "hard", {
                        **o.hard, "pods": o.hard["pods"] + k}))
                informers.pump()
                trail.append(("raise", ns))
            trail.append(tuple(
                sorted(client.get("ResourceQuota", n, "quota").status.used
                       .items()) for n in namespaces))
        trail.append((qc.admissions_granted, qc.admissions_denied,
                      qc.refunds))
        trails[pkg] = trail
    assert trails["torch"] == trails["jax"]
    assert any(t == ("admit", "") for t in trails["torch"])
    assert any(t[0] == "admit" and t[1] for t in trails["torch"]
               if isinstance(t[0], str))


def test_randomized_churn_ledger_matches_the_apiserver_truth():
    """The port's twin of the randomized churn under the ha-chaos
    profile: at quiescence every quota's ``used`` equals the recount of
    bound pods, and no quota was ever overspent over the whole watch
    history."""
    rng = random.Random(1234)
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=64,
                          device="cpu")
    qc = port_ten.arm_tenancy(sched, client, informers)
    namespaces = [f"t{k}" for k in range(6)]
    for ns in namespaces:
        client.create_resource_quota(
            _quota("torch", ns, pods=rng.randint(3, 8), cpu=4000))
    for i in range(6):
        client.create_node(
            make_node(f"n{i}").capacity(cpu="16", memory="32Gi").obj())
    install_injector(FaultInjector(load_profile("ha-chaos", seed=77)))
    try:
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        qc.sync_all()
        qc.start()
        sched.start()
        created = []
        for round_i in range(5):
            for _ in range(rng.randint(5, 15)):
                ns = rng.choice(namespaces)
                name = f"p{len(created)}"
                client.create_pod(_pod("torch", ns, name,
                                       rng.randint(1, 4) * 100, 128))
                created.append((ns, name))
            time.sleep(0.3)
            for _ in range(rng.randint(0, 5)):
                ns, name = created.pop(rng.randrange(len(created)))
                try:
                    client.delete_pod(ns, name)
                except KeyError:
                    pass
            if round_i == 2:
                for ns in namespaces[:2]:
                    client.update_resource_quota_status(
                        ns, "quota", lambda o: setattr(o, "hard", {
                            **o.hard, "pods": o.hard["pods"] + 3}))
        install_injector(None)
        time.sleep(2.0)
        sched.wait_for_inflight_binds(timeout=30)

        def quiescent():
            # no pod in flight or on its way to a pop: nothing is
            # dispatched, nothing waits in the active or backoff queue
            # (a pod there is charged again at its pop), and the quota
            # controller holds no refund or resync still to write
            counts = sched.queue.num_pending()
            return (not sched._pending_exists()
                    and counts["active"] == 0 and counts["backoff"] == 0
                    and not qc._refund_retry and not qc._resync)

        assert _wait(quiescent, 20)
        time.sleep(1.0)
        assert quiescent()
        # every pod still pending holds no charge: it is parked by the
        # quota gate, or waits in the unschedulable queue after a
        # terminal bind failure (refunded at its requeue)
        parked = {pi.pod.metadata.uid for pi in sched.queue.quota_parked_infos()}
        waiting = {pi.pod.metadata.uid
                   for pi in sched.queue.unschedulable_q.values()}
        for p in client.list_pods()[0]:
            if not p.spec.node_name and p.metadata.deletion_timestamp is None:
                assert p.metadata.uid in parked | waiting, p.metadata.name
        for ns in namespaces:
            q = client.get("ResourceQuota", ns, "quota")
            recount = {}
            for p in client.list_pods()[0]:
                if (p.metadata.namespace == ns and p.spec.node_name
                        and p.metadata.deletion_timestamp is None):
                    for r, qty in quota_pod_usage(p).items():
                        recount[r] = recount.get(r, 0) + qty
            for r, hard in q.hard.items():
                assert q.status.used.get(r, 0) == recount.get(r, 0), (ns, r)
                assert q.status.used.get(r, 0) <= hard
        # no overspend at any point of the watch history
        hard_now = {ns: client.get("ResourceQuota", ns, "quota").hard
                    for ns in namespaces}
        w = server.watch("Pod", since_rv=0)
        bound, usage = {}, {}
        for ev in w.pending():
            pod = ev.object
            ns, uid = pod.metadata.namespace, pod.metadata.uid
            if ev.type != "DELETED" and pod.spec.node_name and uid not in bound:
                bound[uid] = quota_pod_usage(pod)
                for r, qty in bound[uid].items():
                    usage[(ns, r)] = usage.get((ns, r), 0) + qty
            elif ev.type == "DELETED" and uid in bound:
                for r, qty in bound.pop(uid).items():
                    usage[(ns, r)] -= qty
            for r, hard in hard_now.get(ns, {}).items():
                assert usage.get((ns, r), 0) <= hard
        w.stop()
    finally:
        install_injector(None)
        qc.stop()
        sched.stop()
        informers.stop()


# -- the solve-order hook in the batch scheduler ------------------------------

def _tenancy_burst(pkg):
    """One tenancy-armed batch scheduler on a cluster that fits about
    half of a four-tenant burst, one tenant already heavy: the batch is
    driven by hand once the queue holds every pod. Returns the
    placements, the solve order of each dispatch, and Jain's index over
    per-tenant binds."""
    P = PKG[pkg]
    server = P["server"]()
    client = P["client"](server)
    informers = P["informers"](server)
    sched = P["new"](client, informers, batch=True, max_batch=256, **P["kw"])
    P["ten"].arm_tenancy(sched, client, informers, quota=False)
    orders = []
    orig = sched._dispatch_solve

    def recording(*a, **kw):
        pending = orig(*a, **kw)
        if pending is not None:
            orders.append(np.asarray(pending["order"]).tolist())
        return pending

    sched._dispatch_solve = recording
    rng = random.Random(9)
    try:
        for i in range(12):
            client.create_node(P["node"](f"n{i}").capacity(
                cpu="4", memory="8Gi", pods=16).obj())
        for i in range(10):  # the heavy tenant's earlier usage
            p = _pod(pkg, "tenant-0", f"pre{i}", 1000, 512, uid=f"pre-{i}")
            p.spec.node_name = f"n{i}"
            client.create_pod(p)
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        pods = []
        for i in range(96):
            p = _pod(pkg, f"tenant-{i % 4 if i >= 24 else 0}", f"b{i}",
                     rng.choice((250, 500, 750)), rng.choice((256, 512)),
                     priority=rng.choice((0, 0, 0, 10)), uid=f"b-{i}")
            p.metadata.creation_timestamp = float(i)
            pods.append(p)
        client.create_pods_bulk(pods)
        assert _wait(lambda: sched.queue.active_count() == len(pods), 20)
        while sched.queue.active_count():
            sched.schedule_batch(timeout=0.05)
            sched.wait_for_inflight_binds(timeout=10)
        placed = {p.metadata.name: p.spec.node_name
                  for p in client.list_pods()[0]}
        counts = [sum(1 for p in client.list_pods()[0]
                      if p.spec.node_name and p.metadata.namespace == f"tenant-{t}"
                      and p.metadata.name.startswith("b")) for t in range(4)]
        jain = sum(counts) ** 2 / (4 * sum(c * c for c in counts))
        return placed, orders, jain, counts
    finally:
        sched.stop()
        informers.stop()


def test_tenancy_armed_burst_solves_in_fair_order_like_jax():
    want = _tenancy_burst("jax")
    got = _tenancy_burst("torch")
    placed, orders, jain, counts = got
    assert orders == want[1]
    assert placed == want[0]
    assert jain == want[2]
    assert counts == want[3]
    # the fair order moved the solve off FIFO, and the heavy tenant (24
    # of the 96 pods first, ten already bound) did not take the burst
    assert any(o != sorted(o) for o in orders)
    assert counts[0] < 24 + 18


def test_scheduler_app_arms_the_fairness_plane_on_the_cpu():
    """A ``tenancy:`` block on SchedulerApp: the quota gate parks what a
    namespace's quota cannot hold, a raise wakes it, and the DRF tracker
    folds the binds."""
    server = APIServer()
    cfg = KubeSchedulerConfiguration(tenancy=TenancyConfiguration(
        enabled=True))
    app = SchedulerApp(config=cfg, server=server, device="cpu")
    assert app.quota_controller is not None
    assert app.sched.tenant_shares is not None and app.sched.quota is not None
    client = app.client
    for i in range(4):
        client.create_node(make_node(f"n{i}").capacity(
            cpu="8", memory="16Gi", pods=20).obj())
    client.create_resource_quota(_quota("torch", "team", pods=5))
    app.start()
    try:
        client.create_pods_bulk([_pod("torch", "team", f"q{i}", 100, 128)
                                 for i in range(12)])
        bound = lambda: sum(1 for p in client.list_pods()[0]  # noqa: E731
                            if p.spec.node_name)
        assert _wait(lambda: bound() == 5
                     and app.sched.queue.quota_parked_count() == 7, 20)
        client.update_resource_quota_status(
            "team", "quota", lambda o: setattr(o, "hard", {"pods": 12}))
        assert _wait(lambda: bound() == 12, 20)
        assert app.sched.queue.quota_parked_count() == 0
        assert app.quota_controller.releases >= 7
        assert app.sched.tenant_shares.share("team") > 0
        assert app.sched.card_fault is None
    finally:
        app.stop()
