"""The batch path against the sequential Filter/Score path, on the CPU,
in both packages.

Twins of the 2 cases of ``tests/test_score_parity.py``: the same
6-node cluster (every score family: ImageLocality, preferred
NodeAffinity, TaintToleration PreferNoSchedule, NodePreferAvoidPods,
SelectorSpread, soft and hard PodTopologySpread, required pod
anti-affinity, the resource scorers) and the same 22 pending pods go
through the port's batch scheduler (``device="cpu"``: the plain versions
of the kernels) and the port's sequential scheduler (every node scored,
ties kept first, as the device's lowest index keeps them), and through
both of the JAX package's. All four placements must be equal, pod for
pod, with no pod taking the sequential route inside the batch
scheduler. Tolerance: exact.

A third case pins a difference between the two paths that both packages
share: a pod that a batch fails runs the host preemption oracle on the
snapshot the batch was dispatched with, which does not yet hold the
batch's own placements. It can find room there that the batch has just
taken, and nominates the pod to a node with no victim, which the
sequential path (its snapshot current) never does. The nomination then
reserves room on that node for the filters of later pods.
"""

import importlib
import json
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
        new_scheduler=m("scheduler.scheduler").new_scheduler,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


SIDES = [_side("torch"), _side("jax")]


class _KeepFirstRng:
    """Reservoir sampling that never replaces: the sequential
    select_host keeps the first max, as the device's argmax keeps the
    lowest index."""

    def randrange(self, n):
        return 1 if n > 1 else 0

    def randint(self, a, b):
        return b

    def random(self):
        return 1.0

    def sample(self, population, k):
        return list(population)[:k]


AVOID_ANNOTATION = json.dumps({"preferAvoidPods": [{"podSignature": {
    "podController": {"kind": "ReplicaSet", "uid": "rs-avoided"}}}]})


def _build_cluster(s, client):
    """``tests/test_score_parity.py``'s cluster, as written."""
    for i in range(6):
        n = (
            s.make_node(f"n{i}")
            .labels(zone=f"z{i % 3}",
                    **{"failure-domain.beta.kubernetes.io/zone": f"z{i % 3}"})
            .capacity(cpu="16", memory="32Gi", pods=40)
        )
        if i in (0, 3):
            n = n.image("registry/app:v1", 500 * 1024 * 1024)
        if i == 1:
            n = n.taint("flaky", "true", effect="PreferNoSchedule")
        n = n.obj()
        if i == 2:
            n.metadata.annotations[
                "scheduler.alpha.kubernetes.io/preferAvoidPods"
            ] = AVOID_ANNOTATION
        client.create_node(n)
    svc = s.types.Service()
    svc.metadata.name = "websvc"
    svc.metadata.namespace = "default"
    svc.selector = {"app": "web"}
    client.create(svc)
    for i, (node, cpu) in enumerate(
        [("n0", "2"), ("n1", "4"), ("n2", "1"), ("n4", "6")]
    ):
        client.create_pod(
            s.make_pod(f"existing-{i}").node(node)
            .labels(app="web" if i % 2 == 0 else "db")
            .container(cpu=cpu, memory=f"{1 + i}Gi").obj()
        )


def _pending_pods(s):
    """``tests/test_score_parity.py``'s 22 pending pods, as written."""
    mk = s.make_pod
    specs = (
        [mk(f"plain-{i}").container(cpu="500m", memory="1Gi")
         for i in range(4)]
        + [mk(f"img-{i}").container(cpu="250m", memory="512Mi",
                                    image="registry/app:v1")
           for i in range(2)]
        + [mk(f"naff-{i}").container(cpu="250m", memory="512Mi")
           .preferred_node_affinity_in("zone", ["z1"], weight=10)
           for i in range(2)]
        + [mk(f"web-{i}").labels(app="web")
           .container(cpu="250m", memory="512Mi") for i in range(4)]
        + [mk(f"soft-{i}").labels(app="soft")
           .container(cpu="250m", memory="512Mi")
           .spread_constraint(1, "zone", when_unsatisfiable="ScheduleAnyway",
                              match_labels={"app": "soft"})
           for i in range(3)]
        + [mk(f"hard-{i}").labels(app="hard")
           .container(cpu="250m", memory="512Mi")
           .spread_constraint(1, "zone", match_labels={"app": "hard"})
           for i in range(3)]
        + [mk(f"anti-{i}").labels(app="db")
           .container(cpu="250m", memory="512Mi")
           .pod_affinity("zone", {"app": "db"}, anti=True)
           for i in range(3)]
        + [mk("avoided").container(cpu="250m", memory="512Mi")]
    )
    pods = [w.creation_timestamp(float(t)).obj() for t, w in enumerate(specs)]
    pods[-1].metadata.owner_references.append(s.types.OwnerReference(
        kind="ReplicaSet", name="rs", uid="rs-avoided", controller=True))
    return pods


def _run(s, build, pods, *, batch, max_batch=64):
    """One scheduler of ``s`` over ``build``'s cluster and ``pods``:
    the batch path (``schedule_batch`` by hand) or the sequential path
    (``schedule_one``, every node scored, ties kept first). Returns the
    placements, the nominations and the batch path's ``pods_fallback``."""
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    if batch:
        sched = s.new_scheduler(client, informers, batch=True,
                                max_batch=max_batch, async_binding=False,
                                rng=_KeepFirstRng(), **s.kw)
    else:
        sched = s.new_scheduler(client, informers, batch=False,
                                percentage_of_nodes_to_score=100,
                                rng=_KeepFirstRng(), async_binding=False,
                                **s.kw)
    try:
        build(s, client)
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        for p in pods:
            client.create_pod(p)
        deadline = time.time() + 10
        while (sched.queue.num_pending()["active"] < len(pods)
               and time.time() < deadline):
            time.sleep(0.01)
        if batch:
            while sched.schedule_batch(timeout=0.5):
                pass
        else:
            while sched.schedule_one(timeout=0.5):
                pass
        live = [p for p in client.list_pods()[0]
                if not p.metadata.name.startswith("existing-")]
        return (
            {p.metadata.name: p.spec.node_name for p in live},
            {p.metadata.name: p.status.nominated_node_name for p in live
             if p.status.nominated_node_name},
            getattr(sched, "pods_fallback", 0),
        )
    finally:
        sched.stop()
        informers.stop()


def _four(build, pods_of, **kw):
    """Batch and sequential runs of each package: (port batch, port
    sequential, JAX batch, JAX sequential)."""
    return [
        _run(s, build, pods_of(s), batch=batch, **kw)
        for s in SIDES for batch in (True, False)
    ]


def test_identical_placements_full_score_set():
    port_b, port_s, jax_b, jax_s = _four(_build_cluster, _pending_pods)
    assert port_b[2] == 0, "the batch path took the sequential route"
    assert port_b == jax_b and port_s == jax_s
    diffs = {n: (port_s[0][n], port_b[0][n]) for n in port_s[0]
             if port_s[0][n] != port_b[0][n]}
    assert not diffs, f"placement divergence: {diffs}"
    # everything binds but an anti-affinity pod squeezed out of the
    # zones that already host db pods, alike on both paths
    unbound = {n for n, node in port_s[0].items() if not node}
    assert all(n.startswith("anti-") for n in unbound), unbound
    assert len(unbound) <= 1


def test_avoided_pod_skips_annotated_node():
    placed = [_run(s, _build_cluster, _pending_pods(s), batch=True)[0]
              for s in SIDES]
    assert placed[0] == placed[1]
    assert placed[0]["avoided"] != "n2"


def _two_zones(s, client):
    for i in range(2):
        client.create_node(
            s.make_node(f"n{i}").labels(zone=f"z{i}")
            .capacity(cpu="3", memory="32Gi", pods=40).obj())


def _anti_then_plain(s):
    """Three db pods that each refuse a zone holding another db pod, in
    one batch, then a 2-CPU pod in the next batch."""
    pods = [
        s.make_pod(f"anti-{i}").labels(app="db")
        .container(cpu="1", memory="1Gi")
        .pod_affinity("zone", {"app": "db"}, anti=True)
        .creation_timestamp(float(i)).obj()
        for i in range(3)
    ]
    pods.append(s.make_pod("plain").container(cpu="2", memory="1Gi")
                .creation_timestamp(3.0).obj())
    return pods


def test_stale_snapshot_nomination_diverges_alike():
    """Shared with the JAX package (pinned, not repaired): anti-2 fails
    its batch, and the host oracle, on the batch's pre-placement
    snapshot, finds n0 empty of db pods and nominates anti-2 there with
    no victim. The sequential path nominates nothing. The nomination
    keeps 1 CPU of n0 for the filters, so the 2-CPU pod of the next batch
    goes to n1 where the sequential path, its tie kept first, puts it on
    n0."""
    port_b, port_s, jax_b, jax_s = _four(_two_zones, _anti_then_plain,
                                         max_batch=3)
    assert port_b == jax_b and port_s == jax_s
    assert port_s[:2] == (
        {"anti-0": "n0", "anti-1": "n1", "anti-2": "", "plain": "n0"}, {})
    assert port_b[:2] == (
        {"anti-0": "n0", "anti-1": "n1", "anti-2": "", "plain": "n1"},
        {"anti-2": "n0"})
    # the nominee's constraints send the next batch down the sequential
    # route (nominee_constrained), where the nomination is a filter input
    assert port_b[2] == 1
