"""The disruption controller and the storage wake-ups, on the CPU, in
both packages.

Twins of the 10 cases of ``tests/test_controllers.py``: the port's
``controllers/disruption.py`` (DisruptionsAllowed reconciled from the
pods and budgets, the event-driven loop, the shared ``can_disrupt``
gate with its refunds), preemption under a controller-kept budget
through the batch scheduler (``device="cpu"``), and a parked pod woken
by a PersistentVolume, against the JAX package's on the same inputs.
Each case returns what the reference test checks -- budgets, survivors,
queue counts, the blocked-eviction counter's step -- from each package;
the two must be equal (tolerance: exact) and hold the reference's
assertions.
"""

import importlib
import time
from types import SimpleNamespace

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        types=m("api.types"),
        APIServer=m("apiserver.server").APIServer,
        Client=m("client.client").Client,
        InformerFactory=m("client.informer").InformerFactory,
        DisruptionController=m("controllers").DisruptionController,
        new_scheduler=m("scheduler.scheduler").new_scheduler,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        metrics=m("utils.metrics"),
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


SIDES = [_side("torch"), _side("jax")]


def both(case):
    port, ref = (case(s) for s in SIDES)
    assert port == ref
    return port


def _pdb(s, name, match, min_available=None, max_unavailable=None):
    T = s.types
    pdb = T.PodDisruptionBudget(
        selector=T.LabelSelector(match_labels=match),
        min_available=min_available, max_unavailable=max_unavailable,
    )
    pdb.metadata.name = name
    pdb.metadata.namespace = "default"
    return pdb


def _env(s):
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    return server, client, informers, s.DisruptionController(client,
                                                             informers)


def _allowed(client):
    return {p.metadata.name: p.status.disruptions_allowed
            for p in client.list_pdbs()[0]}


# -- TestDisruptionController -------------------------------------------------


def _reconciled(s, pdb_kw, pods):
    _, client, informers, ctrl = _env(s)
    client.create_pdb(_pdb(s, "a", **pdb_kw))
    for name, labels, node in pods:
        w = s.make_pod(name).labels(**labels)
        client.create_pod((w.node(node) if node else w).obj())
    informers.pods().pump()
    informers.pdbs().pump()
    ctrl.sync_all()
    return _allowed(client)


def test_min_available():
    assert both(lambda s: _reconciled(
        s, dict(match={"app": "web"}, min_available=2),
        [(f"p{i}", {"app": "web"}, "n1") for i in range(3)])) == {"a": 1}


def test_max_unavailable():
    # expected 4, desired 3, healthy 4 -> 1 disruption allowed
    assert both(lambda s: _reconciled(
        s, dict(match={"app": "db"}, max_unavailable=1),
        [(f"p{i}", {"app": "db"}, "n1") for i in range(4)])) == {"a": 1}


def test_unbound_pods_not_healthy():
    assert both(lambda s: _reconciled(
        s, dict(match={"app": "web"}, min_available=1),
        [("bound", {"app": "web"}, "n"), ("pending", {"app": "web"}, "")],
    )) == {"a": 0}  # 1 healthy - 1


def _event_driven(s):
    _, client, informers, ctrl = _env(s)
    client.create_pdb(_pdb(s, "a", {"app": "web"}, min_available=1))
    informers.start()
    informers.wait_for_cache_sync()
    ctrl.start()
    try:
        for i in range(3):
            client.create_pod(
                s.make_pod(f"p{i}").labels(app="web").node("n1").obj())
        deadline = time.time() + 10
        while time.time() < deadline and _allowed(client)["a"] != 2:
            time.sleep(0.02)
        return _allowed(client)
    finally:
        ctrl.stop()
        informers.stop()


def test_event_driven_loop():
    assert both(_event_driven) == {"a": 2}


# -- TestPdbPreemptionEndToEnd ------------------------------------------------


def _wait(fn, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if fn():
            return True
        time.sleep(0.02)
    return False


def _controller_budget(s):
    """Two nodes, each full with one priority-0 pod; the protected one
    (a budget of 0 kept by the controller) is reprieved, the other
    evicted for a priority-100 pod."""
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    sched = s.new_scheduler(client, informers, batch=True, max_batch=16,
                            **s.kw)
    ctrl = s.DisruptionController(client, informers)
    try:
        for n in ("n0", "n1"):
            client.create_node(
                s.make_node(n).capacity(cpu="2", memory="4Gi").obj())
        client.create_pdb(_pdb(s, "guard", {"app": "protected"},
                               min_available=1))
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        for name, app in (("prot", "protected"), ("loose", "loose")):
            client.create_pod(s.make_pod(name).labels(app=app)
                              .container(cpu="2").priority(0).obj())
        sched.start()
        ctrl.start()
        _wait(lambda: sum(1 for p in client.list_pods()[0]
                          if p.spec.node_name) >= 2, 15)
        # the budget settles at 0 (1 healthy - 1 minAvailable)
        _wait(lambda: _allowed(client)["guard"] == 0, 10)
        client.create_pod(
            s.make_pod("high").container(cpu="2").priority(100).obj())
        bound = []

        def high_bound():
            try:
                node = client.get_pod("default", "high").spec.node_name
            except KeyError:
                return True
            bound.append(node)
            return bool(node)

        _wait(high_bound, 15)
    finally:
        sched.stop()
        ctrl.stop()
        informers.stop()
    return bool(bound and bound[-1]), sorted(
        p.metadata.name for p in client.list_pods()[0])


def test_preemption_respects_controller_maintained_budget():
    bound, names = both(_controller_budget)
    assert bound, "high-priority pod never bound"
    assert "prot" in names  # the protected pod survived
    assert "loose" not in names  # the loose one was evicted


# -- TestStorageWakeups -------------------------------------------------------


def _pv_wakes(s):
    """A pod parked on a missing PVC leaves the unschedulable queue when
    a PersistentVolume lands."""
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    sched = s.new_scheduler(client, informers, batch=True, max_batch=16,
                            **s.kw)
    try:
        client.create_node(
            s.make_node("n").capacity(cpu="4", memory="8Gi").obj())
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        client.create_pod(
            s.make_pod("p").container(cpu="1").pvc("missing-claim").obj())
        deadline = time.time() + 10
        while time.time() < deadline:
            sched.schedule_batch(timeout=0.2)
            if sched.queue.num_pending()["unschedulable"] == 1:
                break
        parked = sched.queue.num_pending()["unschedulable"]
        server.create(s.types.PersistentVolume(
            metadata=s.types.ObjectMeta(name="pv0", namespace="")))
        _wait(lambda: sched.queue.num_pending()["unschedulable"] == 0, 10)
        counts = sched.queue.num_pending()
    finally:
        sched.stop()
        informers.stop()
    return parked, counts["unschedulable"], \
        counts["active"] + counts["backoff"]


def test_pv_add_wakes_parked_pod():
    assert both(_pv_wakes) == (1, 0, 1)


# -- TestCanDisrupt: drains and taint evictions spend one budget -------------


def _no_pdb(s):
    _, client, informers, ctrl = _env(s)
    pod = s.make_pod("free").labels(app="x").node("n").obj()
    client.create_pod(pod)
    informers.pods().pump()
    return ctrl.can_disrupt(pod)


def test_no_matching_pdb_always_allows():
    assert both(_no_pdb)


def _grant_then_deny(s):
    _, client, informers, ctrl = _env(s)
    client.create_pdb(_pdb(s, "g", {"app": "web"}, min_available=2))
    pods = []
    for i in range(3):
        p = s.make_pod(f"p{i}").labels(app="web").node("n").obj()
        client.create_pod(p)
        pods.append(p)
    informers.pods().pump()
    informers.pdbs().pump()
    ctrl.sync_all()  # 3 healthy - 2 minAvailable = 1 allowed
    blocked0 = s.metrics.evictions_blocked_by_pdb.value()
    first, second = ctrl.can_disrupt(pods[0]), ctrl.can_disrupt(pods[1])
    return (first, second, _allowed(client)["g"],
            s.metrics.evictions_blocked_by_pdb.value() - blocked0)


def test_grant_consumes_budget_then_denies():
    # the single unit spent, then the budget exhausted and one block
    assert both(_grant_then_deny) == (True, False, 0, 1)


def _reopens(s):
    _, client, informers, ctrl = _env(s)
    client.create_pdb(_pdb(s, "g", {"app": "web"}, min_available=1))
    pods = []
    for i in range(2):
        p = s.make_pod(f"p{i}").labels(app="web").node("n").obj()
        client.create_pod(p)
        pods.append(p)
    informers.pods().pump()
    informers.pdbs().pump()
    ctrl.sync_all()
    answers = [ctrl.can_disrupt(pods[0]), ctrl.can_disrupt(pods[1])]
    # the evictee terminates; a replacement binds elsewhere
    client.delete_pod("default", "p0")
    client.create_pod(s.make_pod("p0r").labels(app="web").node("m").obj())
    informers.pods().pump()
    ctrl.sync_all()
    answers.append(ctrl.can_disrupt(pods[1]))
    return answers


def test_budget_reopens_after_evictee_terminates():
    assert both(_reopens) == [True, False, True]


def _refunds(s):
    """A pod under two budgets, only one with room: the deny refunds
    the unit already taken from the granting sibling."""
    _, client, informers, ctrl = _env(s)
    client.create_pdb(_pdb(s, "rich", {"app": "web"}, max_unavailable=2))
    client.create_pdb(_pdb(s, "poor", {"tier": "gold"}, min_available=2))
    p = s.make_pod("both").labels(app="web", tier="gold").node("n").obj()
    client.create_pod(p)
    client.create_pod(s.make_pod("web2").labels(app="web").node("n").obj())
    client.create_pod(
        s.make_pod("gold2").labels(tier="gold").node("n").obj())
    informers.pods().pump()
    informers.pdbs().pump()
    ctrl.sync_all()  # rich: allowed=2; poor: 2 healthy - 2 = 0
    return ctrl.can_disrupt(p), _allowed(client)


def test_deny_refunds_sibling_pdbs():
    assert both(_refunds) == (False, {"rich": 2, "poor": 0})
