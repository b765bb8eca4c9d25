"""The port's control-plane resilience and its binary surface against the
JAX package, on the CPU.

Twins of the 23 cases of ``tests/test_resilience.py`` (410 Gone on a
truncated watch replay and the informer's relist through it; the
idempotent same-node rebind and the refused cross-node one; the
assumed-pod TTL sweep; the fast expiry of a deleted node's assumed
pods; the drift checker; startup recovery) and the 4 of
``tests/test_cli.py`` (the flags, feature gates, an unknown gate, and
``SchedulerApp`` booting, serving ``/healthz``, ``/metrics`` and the
``/debug`` endpoints and binding a pod -- the port on ``device="cpu"``);
then the ``leaderElection``, ``resilience`` and ``faultInjection``
configuration blocks (loaded values and validation errors) and the
exposition of the succession counters. Each scenario runs
through both packages on the same inputs and is held to the reference
test's assertions in both; what it returns (the reports and heal
counts, the metric deltas, the cache's pods and nodes, what the queue
pops) must be equal. Tolerance: exact.
"""

import dataclasses
import json
import time
import urllib.request

import pytest

import kubernetes_tpu.__main__ as jax_main
import kubernetes_tpu.api.types as jax_api
import kubernetes_tpu.apiserver.server as jax_server
import kubernetes_tpu.client.client as jax_client
import kubernetes_tpu.client.informer as jax_informer
import kubernetes_tpu.config.loader as jax_loader
import kubernetes_tpu.config.types as jax_types
import kubernetes_tpu.config.validation as jax_validation
import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu.scheduler.app as jax_app
import kubernetes_tpu.scheduler.resilience as jax_res
import kubernetes_tpu.scheduler.scheduler as jax_sched
import kubernetes_tpu.testing as jax_testing
import kubernetes_tpu.utils.metrics as jax_metrics
import kubernetes_tpu_torch.__main__ as port_main
import kubernetes_tpu_torch.api.types as port_api
import kubernetes_tpu_torch.apiserver.server as port_server
import kubernetes_tpu_torch.client.client as port_client
import kubernetes_tpu_torch.client.informer as port_informer
import kubernetes_tpu_torch.config.loader as port_loader
import kubernetes_tpu_torch.config.types as port_types
import kubernetes_tpu_torch.config.validation as port_validation
import kubernetes_tpu_torch.robustness.faults as port_faults
import kubernetes_tpu_torch.scheduler.app as port_app
import kubernetes_tpu_torch.scheduler.resilience as port_res
import kubernetes_tpu_torch.scheduler.scheduler as port_sched
import kubernetes_tpu_torch.testing as port_testing
import kubernetes_tpu_torch.utils.metrics as port_metrics

PKGS = {
    "jax": (jax_main, jax_api, jax_server, jax_client, jax_informer,
            jax_loader, jax_types, jax_faults, jax_app, jax_res, jax_sched,
            jax_testing, jax_metrics, jax_validation, {}),
    "torch": (port_main, port_api, port_server, port_client, port_informer,
              port_loader, port_types, port_faults, port_app, port_res,
              port_sched, port_testing, port_metrics, port_validation,
              {"device": "cpu"}),
}


class P:
    """One package's names; ``kw`` is what its entry points need to solve
    on the CPU."""

    def __init__(self, pkg):
        (self.main, self.api, self.server, client, informer, self.loader,
         self.types, self.faults, self.app, self.res, sched, testing,
         self.metrics, self.validation, self.kw) = PKGS[pkg]
        self.APIServer = self.server.APIServer
        self.Client = client.Client
        self.InformerFactory = informer.InformerFactory
        self.new_scheduler = sched.new_scheduler
        self.make_node = testing.make_node
        self.make_pod = testing.make_pod

    def binding(self, pod, node):
        return self.api.Binding(
            pod_namespace="default", pod_name=pod.metadata.name,
            pod_uid=pod.metadata.uid, target_node=node)

    def node_ref(self, name):
        return self.api.Node(metadata=self.api.ObjectMeta(name=name,
                                                          namespace=""))

    def injector(self, **points):
        fp = self.faults.FaultPoint
        return self.faults.FaultInjector(self.faults.FaultProfile(
            "t", seed=0, points={getattr(fp, k): self.faults.PointConfig(
                rate=1.0, max_fires=n) for k, n in points.items()}))


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for pkg in PKGS:
        P(pkg).faults.install_injector(None)


def both(scenario):
    """``scenario(P(pkg))`` through both packages: equal results."""
    got = {pkg: scenario(P(pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


def cache_view(sched):
    """The cache's pods (name, node, assumed) and nodes, sorted."""
    pods = sorted(
        (pod.metadata.name, pod.spec.node_name, assumed)
        for pod, assumed in sched.cache.pod_states_snapshot().values())
    return pods, sorted(sched.cache.known_node_names())


def popped(sched, timeout):
    pi = sched.queue.pop(timeout=timeout)
    return None if pi is None else pi.pod.metadata.name


def mk_sched(p, num_nodes=4, ttl=0.05):
    server = p.APIServer()
    client = p.Client(server)
    informers = p.InformerFactory(server)
    sched = p.new_scheduler(client, informers, batch=False,
                            cache_ttl_seconds=ttl, **p.kw)
    for i in range(num_nodes):
        client.create_node(p.make_node(f"n{i}").capacity(
            cpu="8", memory="16Gi", pods=30).obj())
    informers.pump()
    return server, client, informers, sched


def assume(p, client, sched, name, node, finish=True):
    pod = p.make_pod(name).container(cpu="100m").obj()
    client.create_pod(pod)
    assumed = pod.assumed_clone()
    assumed.spec.node_name = node
    sched.cache.assume_pod(assumed)
    if finish:
        sched.cache.finish_binding(assumed)
    return pod, assumed


# -- 410 Gone: a truncated watch replay signals ------------------------------


def test_truncated_replay_raises_gone():
    def scenario(p):
        server = p.APIServer(watch_history_limit=8)
        for i in range(30):
            server.create(p.make_pod(f"p{i}").obj())
        with pytest.raises(p.server.Gone):
            server.watch("Pod", since_rv=1)
        return server.current_rv()

    both(scenario)


def test_replay_within_window_still_works():
    def scenario(p):
        server = p.APIServer(watch_history_limit=8)
        for i in range(30):
            server.create(p.make_pod(f"p{i}").obj())
        rv = server.current_rv()
        server.create(p.make_pod("tail").obj())
        return [e.object.metadata.name
                for e in server.watch("Pod", since_rv=rv).pending()]

    assert both(scenario) == ["tail"]


def test_untruncated_history_never_gone():
    def scenario(p):
        server = p.APIServer()
        for i in range(10):
            server.create(p.make_pod(f"p{i}").obj())
        return len(server.watch("Pod", since_rv=0).pending())

    assert both(scenario) == 10


def test_injected_gone_fires_once():
    def scenario(p):
        server = p.APIServer()
        p.faults.install_injector(p.injector(WATCH_HISTORY_TRUNCATED=1))
        with pytest.raises(p.server.Gone):
            server.watch("Pod", since_rv=server.current_rv())
        # the point healed: the next open succeeds
        return len(server.watch("Pod", since_rv=server.current_rv())
                   .pending())

    assert both(scenario) == 0


def test_informer_relists_through_injected_gone():
    """A relist whose watch open meets 410 Gone lists again and converges:
    no event lost, watch_gone metered, the informer synced."""
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        pods_inf = p.InformerFactory(server).pods()
        pods_inf.pump()
        gone0 = p.metrics.watch_gone.value(kind="Pod")
        client.create_pod(p.make_pod("a").container(cpu="1m").obj())
        p.faults.install_injector(p.injector(WATCH_DROP=1,
                                             WATCH_HISTORY_TRUNCATED=1))
        pods_inf.pump()  # drop -> relist -> Gone -> list again
        p.faults.install_injector(None)
        client.create_pod(p.make_pod("b").container(cpu="1m").obj())
        pods_inf.pump()
        assert pods_inf.synced
        return (sorted(x.metadata.name for x in pods_inf.list()),
                p.metrics.watch_gone.value(kind="Pod") - gone0)

    names, gone = both(scenario)
    assert names == ["a", "b"] and gone > 0


# -- the idempotent same-node rebind ------------------------------------------


def test_same_node_rebind_is_silent_success():
    def scenario(p):
        server = p.APIServer()
        pod = p.make_pod("p").container(cpu="1m").obj()
        server.create(pod)
        bound = server.bind(p.binding(pod, "n1"))
        rv = bound.metadata.resource_version
        w = server.watch("Pod", since_rv=server.current_rv())
        again = server.bind(p.binding(pod, "n1"))  # a retried commit
        return (again.spec.node_name, again.metadata.resource_version == rv,
                w.pending())

    assert both(scenario) == ("n1", True, [])


def test_other_node_rebind_still_conflicts():
    def scenario(p):
        server = p.APIServer()
        pod = p.make_pod("p").container(cpu="1m").obj()
        server.create(pod)
        server.bind(p.binding(pod, "n1"))
        with pytest.raises(p.server.Conflict):
            server.bind(p.binding(pod, "n2"))
        return server.get("Pod", "default", "p").spec.node_name

    assert both(scenario) == "n1"


def test_bind_assumed_bulk_same_node_is_success():
    def scenario(p):
        server = p.APIServer()
        pod = p.make_pod("p").container(cpu="1m").obj()
        server.create(pod)
        assumed = pod.assumed_clone()
        assumed.spec.node_name = "n1"
        # the whole transaction replayed after a crash
        return [server.bind_assumed_bulk([assumed]),
                server.bind_assumed_bulk([assumed])]

    assert both(scenario) == [[], []]


# -- the assumed-pod TTL sweep -------------------------------------------------


def test_expired_assumed_pod_forgotten_and_requeued():
    """Assumed + finish_binding'd, the confirmation never arrives: past
    the TTL it is forgotten, requeued and metered."""
    def scenario(p):
        server, client, informers, sched = mk_sched(p, ttl=0.05)
        _, assumed = assume(p, client, sched, "stuck", "n0")
        before = p.metrics.assumed_pods_expired.value()
        rec = p.res.ControlPlaneReconciler(sched, client, sweep_interval=0.01)
        time.sleep(0.08)  # past the TTL
        expired = [x.metadata.name for x in rec.sweep_assumed_once()]
        assert sched.cache.get_pod(assumed) is None
        return (expired, p.metrics.assumed_pods_expired.value() - before,
                cache_view(sched), popped(sched, 1.0))

    assert both(scenario)[0] == ["stuck"]


def test_expired_but_actually_bound_pod_readopted():
    """The bind landed, its confirmation was lost: the expiry re-adopts
    from the apiserver's truth and requeues nothing."""
    def scenario(p):
        server, client, informers, sched = mk_sched(p, ttl=0.05)
        _, assumed = assume(p, client, sched, "landed", "n0")
        server.bind_assumed_bulk([assumed])
        rec = p.res.ControlPlaneReconciler(sched, client, sweep_interval=0.01)
        time.sleep(0.08)
        rec.sweep_assumed_once()
        assert not sched.cache.is_assumed_pod(assumed)
        return cache_view(sched), popped(sched, 0.1)

    view, pop = both(scenario)
    assert ("landed", "n0", False) in view[0] and pop is None


def test_unexpired_assumed_pod_untouched():
    def scenario(p):
        server, client, informers, sched = mk_sched(p, ttl=30.0)
        _, assumed = assume(p, client, sched, "inflight", "n0")
        rec = p.res.ControlPlaneReconciler(sched, client, sweep_interval=0.01)
        return (rec.sweep_assumed_once(), sched.cache.is_assumed_pod(assumed),
                cache_view(sched))

    expired, still, _ = both(scenario)
    assert expired == [] and still


# -- the fast expiry of a deleted node's assumed pods -------------------------


def test_node_delete_fast_expires_and_requeues():
    """A node deleted under an assumed pod: the next sweep expires it (the
    TTL is an hour) and meters the requeue."""
    def scenario(p):
        server, client, informers, sched = mk_sched(p, ttl=3600.0)
        _, assumed = assume(p, client, sched, "stranded", "n0")
        sched.cache.remove_node(p.node_ref("n0"))
        before = p.metrics.node_removed_requeues.value()
        rec = p.res.ControlPlaneReconciler(sched, client, sweep_interval=0.01)
        expired = [x.metadata.name for x in rec.sweep_assumed_once()]
        assert sched.cache.get_pod(assumed) is None
        return (expired, p.metrics.node_removed_requeues.value() - before,
                cache_view(sched), popped(sched, 1.0))

    expired, requeues, _, pop = both(scenario)
    assert expired == ["stranded"] and requeues == 1 and pop == "stranded"


def test_node_delete_before_finish_binding_expires_on_finish():
    """The bind is still in flight when the node dies: the expiry waits
    for finish_binding, then fires on the next sweep."""
    def scenario(p):
        server, client, informers, sched = mk_sched(p, ttl=3600.0)
        _, assumed = assume(p, client, sched, "midbind", "n1", finish=False)
        sched.cache.remove_node(p.node_ref("n1"))
        rec = p.res.ControlPlaneReconciler(sched, client, sweep_interval=0.01)
        first = rec.sweep_assumed_once()
        held = sched.cache.is_assumed_pod(assumed)
        sched.cache.finish_binding(assumed)
        return (first, held,
                [x.metadata.name for x in rec.sweep_assumed_once()])

    assert both(scenario) == ([], True, ["midbind"])


def test_bound_to_deleted_node_readopted_not_requeued():
    """The bind landed before the node died: re-adopted, no requeue."""
    def scenario(p):
        server, client, informers, sched = mk_sched(p, ttl=3600.0)
        _, assumed = assume(p, client, sched, "landed2", "n2")
        server.bind_assumed_bulk([assumed])
        sched.cache.remove_node(p.node_ref("n2"))
        before = p.metrics.node_removed_requeues.value()
        rec = p.res.ControlPlaneReconciler(sched, client, sweep_interval=0.01)
        rec.sweep_assumed_once()
        cached = sched.cache.get_pod(assumed)
        return (p.metrics.node_removed_requeues.value() - before,
                cached is not None and cached.spec.node_name,
                popped(sched, 0.1))

    assert both(scenario) == (0, "n2", None)


# -- the drift checker -----------------------------------------------------------


def _ghost(p, server, client):
    pod = p.make_pod("ghost").container(cpu="100m").obj()
    client.create_pod(pod)
    return pod, server.bind(p.binding(pod, "n1"))


def _report(r):
    return (r.pods_readopted, r.pods_evicted, r.pods_requeued, r.nodes_added,
            r.nodes_removed)


def test_heals_pod_missing_from_cache():
    def scenario(p):
        server, client, informers, sched = mk_sched(p)
        _, bound = _ghost(p, server, client)  # the cache never hears of it
        before = p.metrics.cache_drift.value(kind="pod", action="readopt")
        rec = p.res.ControlPlaneReconciler(sched, client)
        report = _report(rec.check_drift_once())
        assert sched.cache.get_pod(bound) is not None
        return (report,
                p.metrics.cache_drift.value(kind="pod", action="readopt")
                - before, rec.check_drift_once().total(), cache_view(sched))

    report, metered, again, _ = both(scenario)
    assert report[0] == 1 and metered == 1 and again == 0


def test_heals_phantom_pod_in_cache():
    """The cache holds as placed a pod the apiserver shows pending: evicted
    from the cache and given back to the queue."""
    def scenario(p):
        server, client, informers, sched = mk_sched(p)
        pod = p.make_pod("phantom").container(cpu="100m").obj()
        client.create_pod(pod)
        placed = pod.assumed_clone()
        placed.spec.node_name = "n2"
        sched.cache.add_pod(placed)
        report = _report(p.res.ControlPlaneReconciler(
            sched, client).check_drift_once())
        assert sched.cache.get_pod(placed) is None
        return report, cache_view(sched), popped(sched, 1.0)

    report, _, pop = both(scenario)
    assert report[1:3] == (1, 1) and pop == "phantom"


def test_heals_deleted_pod_still_in_cache():
    def scenario(p):
        server, client, informers, sched = mk_sched(p)
        placed = p.make_pod("gone").container(cpu="100m").obj().assumed_clone()
        placed.spec.node_name = "n0"
        sched.cache.add_pod(placed)  # never existed at the apiserver
        report = _report(p.res.ControlPlaneReconciler(
            sched, client).check_drift_once())
        return report, cache_view(sched)

    assert both(scenario)[0][1:3] == (1, 0)


def test_assumed_pods_never_healed():
    def scenario(p):
        server, client, informers, sched = mk_sched(p)
        _, assumed = assume(p, client, sched, "inflight", "n0", finish=False)
        report = _report(p.res.ControlPlaneReconciler(
            sched, client).check_drift_once())
        return report, sched.cache.is_assumed_pod(assumed), cache_view(sched)

    report, still, _ = both(scenario)
    assert report[1] == 0 and still


def test_heals_node_drift_both_directions():
    def scenario(p):
        server, client, informers, sched = mk_sched(p, num_nodes=3)
        sched.cache.remove_node(p.node_ref("n0"))
        client.delete_node("n2")  # no pump: the cache still holds n2
        report = _report(p.res.ControlPlaneReconciler(
            sched, client).check_drift_once())
        return report, cache_view(sched)[1]

    report, nodes = both(scenario)
    assert report[3:] == (1, 1) and nodes == ["n0", "n1"]


def test_sweeper_thread_heals_within_interval():
    """A divergence heals within one interval of the running sweeper."""
    def scenario(p):
        server, client, informers, sched = mk_sched(p)
        pod, _ = _ghost(p, server, client)
        before = p.metrics.cache_drift.value(kind="pod", action="readopt")
        rec = p.res.ControlPlaneReconciler(sched, client, sweep_interval=0.02,
                                           drift_interval=0.05)
        rec.start()
        try:
            deadline = time.time() + 2.0
            while sched.cache.get_pod(pod) is None and time.time() < deadline:
                time.sleep(0.01)
            healed = sched.cache.get_pod(pod) is not None
        finally:
            rec.stop()
        return (healed, p.metrics.cache_drift.value(kind="pod",
                                                    action="readopt") - before)

    assert both(scenario) == (True, 1)


# -- startup recovery ------------------------------------------------------------


def test_adopts_bound_and_requeues_pending():
    """A previous incarnation bound 3 pods and left 2 in flight: the
    relist adopts the 3, the recovery requeues the 2, all metered."""
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        for i in range(3):
            pod = p.make_pod(f"bound-{i}").container(cpu="100m").obj()
            client.create_pod(pod)
            server.bind(p.binding(pod, f"n{i}"))
        for i in range(2):
            client.create_pod(p.make_pod(f"inflight-{i}").container(
                cpu="100m").obj())
        for i in range(3):
            client.create_node(p.make_node(f"n{i}").capacity(
                cpu="8", memory="16Gi").obj())
        informers = p.InformerFactory(server)
        sched = p.new_scheduler(client, informers, batch=False, **p.kw)
        informers.pump()
        a0 = p.metrics.pods_adopted_on_restart.value()
        r0 = p.metrics.pods_requeued_on_restart.value()
        r = p.res.recover_on_startup(sched, client)
        return ((r.adopted, r.requeued, r.healed),
                p.metrics.pods_adopted_on_restart.value() - a0,
                p.metrics.pods_requeued_on_restart.value() - r0,
                cache_view(sched))

    report, adopted, requeued, view = both(scenario)
    assert report == (3, 2, 0) and (adopted, requeued) == (3, 2)
    assert len(view[0]) == 3


def test_heals_bound_pod_missed_by_sync():
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        pod = p.make_pod("missed").container(cpu="100m").obj()
        client.create_pod(pod)
        server.bind(p.binding(pod, "n0"))
        sched = p.new_scheduler(client, p.InformerFactory(server),
                                batch=False, **p.kw)
        r = p.res.recover_on_startup(sched, client)  # no informer pump
        return (r.adopted, r.requeued, r.healed), cache_view(sched)

    report, view = both(scenario)
    assert report == (1, 0, 1) and view[0] == [("missed", "n0", False)]


def test_foreign_scheduler_pods_not_requeued():
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        pod = p.make_pod("other").container(cpu="100m").obj()
        pod.spec.scheduler_name = "someone-elses-scheduler"
        client.create_pod(pod)
        informers = p.InformerFactory(server)
        sched = p.new_scheduler(client, informers, batch=False, **p.kw)
        informers.pump()
        r = p.res.recover_on_startup(sched, client)
        return r.adopted, r.requeued, r.healed

    assert both(scenario) == (0, 0, 0)


# -- the binary surface (tests/test_cli.py) ------------------------------------


def test_flags_parse():
    argv = ["--config", "cfg.yaml", "--healthz-bind-address",
            "127.0.0.1:10251", "--leader-elect", "--feature-gates",
            "TPUBatchSolver=true,EvenPodsSpread=false",
            "--percentage-of-nodes-to-score", "50", "-v"]

    def scenario(p):
        return vars(p.main.build_parser().parse_args(argv))

    args = both(scenario)
    assert args["config"] == "cfg.yaml" and args["leader_elect"] is True
    assert args["percentage_of_nodes_to_score"] == 50


def test_feature_gates_parse():
    def scenario(p):
        with pytest.raises(SystemExit):
            p.main.parse_feature_gates("A=maybe")
        return (p.main.parse_feature_gates("A=true, B=false"),
                p.main.parse_feature_gates(""))

    assert both(scenario) == ({"A": True, "B": False}, {})


def test_unknown_gate_rejected():
    def scenario(p):
        gates = p.loader.FeatureGate(p.loader.DEFAULT_FEATURE_GATES)
        with pytest.raises(ValueError, match="unknown feature gate") as e:
            gates.set_from_map({"NoSuchGate": True})
        return str(e.value), dict(p.loader.DEFAULT_FEATURE_GATES)

    both(scenario)


def test_app_boots_serves_and_binds():
    """``SchedulerApp`` boots, serves /healthz and /metrics, and schedules
    a pod through the in-process control plane."""
    def scenario(p):
        app = p.app.SchedulerApp(
            config=p.types.KubeSchedulerConfiguration(), **p.kw)
        try:
            host, port = app.start_serving()
            app.client.create_node(p.make_node("n").capacity(
                cpu="4", memory="8Gi").obj())
            app.start()
            app.client.create_pod(p.make_pod("p").container(cpu="1").obj())
            url = f"http://{host}:{port}"
            body = urllib.request.urlopen(f"{url}/healthz", timeout=5).read()
            deadline = time.time() + 30
            while (not app.client.get_pod("default", "p").spec.node_name
                   and time.time() < deadline):
                time.sleep(0.05)
            node = app.client.get_pod("default", "p").spec.node_name
            exposed = urllib.request.urlopen(
                f"{url}/metrics", timeout=5).read().decode()
            app.sched.wait_for_inflight_binds()
            comparer = json.loads(urllib.request.urlopen(
                f"{url}/debug/comparer", timeout=5).read())
            dumped = urllib.request.urlopen(
                f"{url}/debug/cache", timeout=5).read().decode()
        finally:
            app.stop()
        return (body, node,
                "scheduler_schedule_attempts_total" in exposed,
                app.recovery_report.adopted, app.recovery_report.requeued,
                comparer, "default/p" in dumped)

    got = both(scenario)
    assert got[:5] == (b"ok", "n", True, 0, 0) and got[6]
    assert not any(got[5].values())


# -- the configuration blocks and the counters' exposition -------------------


@pytest.mark.parametrize("raw, valid", [
    # the blocks as an operator writes them
    ({"leaderElection": {"leaderElect": True, "leaseDuration": "15s",
                        "renewDeadline": "10s", "retryPeriod": "2s",
                        "renewJitter": 0.2, "clockSkewTolerance": "500ms"},
     "resilience": {"sweeperEnabled": True, "sweepInterval": "1s",
                    "driftCheckInterval": "5s", "commitFencing": True},
     "faultInjection": {"enabled": True, "profile": "ha-chaos", "seed": 3,
                        "points": {"api_unavailable": {
                            "rate": 0.1, "maxFires": 4}}}}, True),
    # bench.py:206-211's leases: a renew deadline past the lease
    ({"leaderElection": {"leaderElect": True, "leaseDuration": 1.0,
                         "renewDeadline": 2.0, "retryPeriod": 0.1}}, False),
    # leader election with partitions, a zero sweep, unknown fault points
    ({"leaderElection": {"leaderElect": True, "renewJitter": 2.0},
      "partition": {"enabled": True},
      "resilience": {"sweepInterval": 0},
      "faultInjection": {"enabled": True, "profile": "no-such",
                         "points": {"no_such_point": {"rate": 2.0}}}},
     False),
])
def test_config_blocks_load_and_validate_alike(raw, valid):
    """The leaderElection, resilience and faultInjection blocks load into
    the same values and draw the same validation errors."""
    def scenario(p):
        cfg = p.loader.load_config_from_dict(raw)
        return ([dataclasses.asdict(getattr(cfg, k)) for k in (
            "leader_election", "resilience", "fault_injection")],
            p.validation.validate_config(cfg))

    blocks, errors = both(scenario)
    assert blocks[0]["leader_elect"] and (errors == []) == valid


def test_succession_counters_expose_alike():
    """The counters an operator reads across a failover or a restart are
    exposed under the same names, help and types."""
    names = ("scheduler_fencing_aborts_total",
             "scheduler_lease_renew_failures_total",
             "scheduler_pods_adopted_on_restart_total",
             "scheduler_cache_drift_total")

    def scenario(p):
        text = p.metrics.registry.expose()
        return [sorted(line for line in text.splitlines()
                       if line.startswith("#") and f" {n} " in line)
                for n in names]

    assert all(len(lines) == 2 for lines in both(scenario))
