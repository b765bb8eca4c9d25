"""The host preemption oracle, on the CPU, in both packages.

Twins of the 11 cases of ``tests/test_preemption.py``: the port's
``scheduler/preemption.py`` (``Preemptor.select_victims_on_node``, the
PDB split ``filter_pods_with_pdb_violation``, the pick rules of
``pick_one_node_for_preemption``) and preempt-then-schedule end to end,
against the JAX package's on the same objects. Each case builds its
inputs with each package's own constructors and requires the two to
answer alike -- victims by name and order, PDB violation counts, whether
the pod fits, the picked node, the pods that survive -- then holds the
port to the reference test's own checks. Tolerance: exact (every answer
is a name or an integer). The victim search on the card (K3) is held
against this oracle by ``chip_smoke.py``.
"""

import importlib
import time
from types import SimpleNamespace

import pytest

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    pre = m("scheduler.preemption")
    return SimpleNamespace(
        pkg=pkg,
        types=m("api.types"),
        APIServer=m("apiserver.server").APIServer,
        Client=m("client.client").Client,
        InformerFactory=m("client.informer").InformerFactory,
        new_snapshot=m("cache.snapshot").new_snapshot,
        SchedulerCache=m("cache.cache").SchedulerCache,
        CycleState=m("framework.interface").CycleState,
        FitError=m("framework.interface").FitError,
        Framework=m("framework.runtime").Framework,
        registry=m("plugins").new_in_tree_registry,
        GenericScheduler=m("scheduler.generic").GenericScheduler,
        default_plugins=m("scheduler.provider").default_plugins,
        Preemptor=pre.Preemptor,
        Victims=pre.Victims,
        filter_pods_with_pdb_violation=pre.filter_pods_with_pdb_violation,
        pick_one_node_for_preemption=pre.pick_one_node_for_preemption,
        new_scheduler=m("scheduler.scheduler").new_scheduler,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


SIDES = [_side("torch"), _side("jax")]


def both(case):
    """``case(side)`` in each package; the answers must be equal.
    Returns the port's."""
    port, ref = (case(s) for s in SIDES)
    assert port == ref
    return port


# -- TestSelectVictims --------------------------------------------------------


def _select(s, node_cpu, residents, preemptor_cpu, preemptor_prio):
    """The reference's in-memory env: a cache holding ``residents``
    (name, cpu, priority) on one node, the default plugins, a failed
    schedule of the preemptor, then ``select_victims_on_node``."""
    node = s.make_node("n").capacity(cpu=node_cpu, memory="4Gi").obj()
    pods = []
    for name, cpu, prio in residents:
        p = s.make_pod(name).node("n").container(cpu=cpu).obj()
        p.spec.priority = prio
        pods.append(p)
    cache = s.SchedulerCache()
    cache.add_node(node)
    for p in pods:
        cache.add_pod(p)
    snapshot = s.new_snapshot([], [])
    algorithm = s.GenericScheduler(cache, snapshot)
    fw = s.Framework(s.registry(), s.default_plugins(),
                     snapshot_provider=lambda: snapshot)
    pod = s.make_pod("preemptor").container(cpu=preemptor_cpu).obj()
    pod.spec.priority = preemptor_prio
    state = s.CycleState()
    with pytest.raises(s.FitError):
        algorithm.schedule(fw, state, pod)
    p = s.Preemptor(algorithm, None, None, **s.kw)
    ni = algorithm.snapshot.get_node_info("n")
    victims, violations, fits = p.select_victims_on_node(
        fw, state, pod, ni, [])
    return [v.name for v in victims], violations, fits


def test_evicts_lowest_priority_first():
    # removing low frees the cpu: mid is reprieved
    assert both(lambda s: _select(
        s, "2", [("low", "1", 0), ("mid", "1", 5)], "1", 10)) == (
        ["low"], 0, True)


def test_no_preemption_when_pod_too_big():
    assert not both(lambda s: _select(
        s, "2", [("low", "1", 0)], "64", 10))[2]


def test_equal_priority_not_preempted():
    assert not both(lambda s: _select(
        s, "1", [("peer", "1", 10)], "1", 10))[2]


# -- TestPDB ------------------------------------------------------------------


def _split(s, allowed, selector, labelled):
    pdb = s.types.PodDisruptionBudget(selector=s.types.LabelSelector(
        match_labels=selector))
    pdb.status.disruptions_allowed = allowed
    pods = ([s.make_pod(f"db{i}").labels(app="db").obj() for i in range(3)]
            if labelled else [s.make_pod("x").obj()])
    violating, non_violating = s.filter_pods_with_pdb_violation(pods, [pdb])
    return [p.name for p in violating], [p.name for p in non_violating]


def test_pdb_budget_splits_violating():
    violating, non_violating = both(lambda s: _split(s, 1, {"app": "db"},
                                                     True))
    assert len(non_violating) == 1  # the first one spends the budget
    assert len(violating) == 2


def test_unlabeled_pods_never_violate():
    assert not both(lambda s: _split(s, 0, None, False))[0]


# -- TestPickNode -------------------------------------------------------------


def _victims(s, *prios, violations=0):
    pods = []
    for i, pr in enumerate(sorted(prios, reverse=True)):
        p = s.make_pod(f"v{pr}-{i}").obj()
        p.spec.priority = pr
        p.status.start_time = 100.0 + i
        pods.append(p)
    return s.Victims(pods, violations)


@pytest.mark.parametrize("a,b", [
    ((5,), ()),                       # a node needing no victim wins
    ((1, {"violations": 1}), (5,)),   # fewest PDB violations
    ((10,), (5,)),                    # lowest highest priority
    ((5, 5), (5, 1)),                 # least priority sum
    ((5, 5, 5), (5, 5)),              # fewest victims
], ids=["free_lunch_wins", "min_pdb_violations", "min_highest_priority",
        "min_priority_sum", "min_victim_count"])
def test_pick_node(a, b):
    def victims(s, spec):
        kw = spec[-1] if spec and isinstance(spec[-1], dict) else {}
        prios = spec[:-1] if kw else spec
        return _victims(s, *prios, **kw) if prios else s.Victims([], 0)

    assert both(lambda s: s.pick_one_node_for_preemption(
        {"a": victims(s, a), "b": victims(s, b)})) == "b"


# -- TestEndToEnd -------------------------------------------------------------


def _preempt_then_schedule(s):
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    sched = s.new_scheduler(client, informers, **s.kw)
    try:
        client.create_node(
            s.make_node("n").capacity(cpu="2", memory="4Gi").obj())
        informers.start()
        informers.wait_for_cache_sync()
        for i in range(2):  # fill the node with two low-priority pods
            client.create_pod(s.make_pod(f"low{i}").container(cpu="1").obj())
        sched.start()
        deadline = time.time() + 10
        while time.time() < deadline:
            if all(p.spec.node_name for p in client.list_pods()[0]):
                break
            time.sleep(0.05)
        high = s.make_pod("high").container(cpu="1").obj()
        high.spec.priority = 100
        client.create_pod(high)
        bound = False
        deadline = time.time() + 10
        while time.time() < deadline:
            try:
                hp = client.get_pod("default", "high")
            except KeyError:
                break
            if hp.spec.node_name:
                bound = True
                break
            time.sleep(0.05)
    finally:
        sched.stop()
        informers.stop()
    alive = sorted(p.name for p in client.list_pods()[0])
    pre = sched.preemptor
    return (bound, sum(1 for n in alive if n.startswith("low")),
            pre.device_preemptions, pre.host_preemptions)


def test_preempt_then_schedule():
    """One victim deleted, the high pod bound on the freed room; the
    two packages' victim searches ran on the same route."""
    bound, low_alive, _, _ = both(_preempt_then_schedule)
    assert bound, "high-priority pod never bound after preemption"
    assert low_alive == 1  # exactly one victim deleted


# -- the device wave against the host oracle: pods with no start time --------


def _wave_and_oracle(s, fixed_now=None):
    """Four full nodes of ten priority-0 pods with no start time; one
    priority-100 pod that needs one victim. Returns the device search's
    answer (K3's plain version in the port, the XLA wave in the JAX
    package) and the host oracle's, each as (node, victims)."""
    mod = importlib.import_module(f"{ROOTS[s.pkg]}.scheduler.preemption")
    nodes = [s.make_node(f"n{i}").capacity(cpu="4", memory="8Gi", pods=20)
             .obj() for i in range(4)]
    residents = [s.make_pod(f"r{i}-{k}").node(f"n{i}").container(cpu="400m")
                 .obj() for i in range(4) for k in range(10)]
    cache = s.SchedulerCache()
    for n in nodes:
        cache.add_node(n)
    for p in residents:
        cache.add_pod(p)
    snapshot = s.new_snapshot([], [])
    algorithm = s.GenericScheduler(cache, snapshot)
    fw = s.Framework(s.registry(), s.default_plugins(),
                     snapshot_provider=lambda: snapshot)
    pod = s.make_pod("high").container(cpu="400m").obj()
    pod.spec.priority = 100
    state = s.CycleState()
    with pytest.raises(s.FitError) as exc:
        algorithm.schedule(fw, state, pod)
    pre = s.Preemptor(algorithm, None, None, **s.kw)
    assert pre.device_eligible(fw, pod)
    device = pre.find_preemption(fw, state, pod, exc.value)
    orig = mod.pod_start_time
    if fixed_now is not None:
        mod.pod_start_time = lambda p: (p.status.start_time
                                        if p.status.start_time is not None
                                        else fixed_now)
    try:
        host = pre._host_wave_answers(fw, [(pod, exc.value)], [])[0]
    finally:
        mod.pod_start_time = orig
    return ((device[0], [v.name for v in device[1]]),
            (host[0], [v.name for v in host[1]]))


def test_start_time_ties_split_the_wave_from_the_oracle_alike():
    """Shared with the JAX package (pinned, not repaired): a victim with
    no start time counts as "now" (GetPodStartTime). The device pack
    reads the clock once per wave, so every such victim ties and the
    lowest node index wins; the host oracle reads it at every call, so
    each later candidate looks later started and the last node wins.
    With the oracle's clock read once, the two answer alike."""
    device, host = both(_wave_and_oracle)
    assert device == ("n0", ["r0-9"])
    assert host[0] == "n3"
    device, host = both(lambda s: _wave_and_oracle(s, fixed_now=1e9))
    assert device == host == ("n0", ["r0-9"])
