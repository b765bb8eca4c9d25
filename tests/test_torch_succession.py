"""Scheduler succession in the port against the JAX package, on the CPU.

Twins of ``tests/test_ha_failover.py:91`` (two ``SchedulerApp``s under
leader election, the leader killed mid-burst, every commit of the
deposed-but-live leader fenced, the standby draining the backlog),
``tests/test_restart_resume.py:29`` (a replacement scheduler resuming
mid-burst) and ``tests/test_crash_recovery.py:70`` (a crash between
assume and bind, then a fresh incarnation's startup recovery), each run
through both packages (the port on ``device="cpu"``) and held to the
reference test's assertions in both; the crash's ``RecoveryReport``
equals the pod counts each run derives from its apiserver.

A deterministic fenced-commit differential: each package's batch
scheduler driven by hand (informers pumped, commits run inline, no
pipeline), the fence refusing one bulk commit; every solve's packed
pieces, handed state and answer, the fenced pods' place in the queue,
the placements and the final carry equal between the packages, and the
final carry equal to the host cache's pack.

Three repairs of the port are pinned against what the JAX package does
on the same sequence: a crashed incarnation sends no bind after its
crash (the JAX package lands a batch it had in flight); a stop while a
batch is in flight lets the batch land through the bind pool instead of
failing its completion (on the card a failed completion stops the
scheduler); a pod drained twice into one batch leaves no phantom
placement in the resident carry (in the JAX package it stays there until
its row next changes). And under the ``ha-chaos`` profile no
control-plane fault escapes a batch completion of two leader-elected
port stacks, so on the card none reaches the halt. Tolerance: exact.
"""

import threading
import time

import numpy as np
import pytest

import kubernetes_tpu.apiserver.server as jax_server
import kubernetes_tpu.client.client as jax_client
import kubernetes_tpu.client.informer as jax_informer
import kubernetes_tpu.config.types as jax_types
import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu.scheduler.app as jax_app
import kubernetes_tpu.scheduler.batch as jax_batch
import kubernetes_tpu.scheduler.resilience as jax_res
import kubernetes_tpu.scheduler.scheduler as jax_sched
import kubernetes_tpu.testing as jax_testing
import kubernetes_tpu.utils.metrics as jax_metrics
import kubernetes_tpu_torch.apiserver.server as port_server
import kubernetes_tpu_torch.client.client as port_client
import kubernetes_tpu_torch.client.informer as port_informer
import kubernetes_tpu_torch.config.types as port_types
import kubernetes_tpu_torch.robustness.faults as port_faults
import kubernetes_tpu_torch.scheduler.app as port_app
import kubernetes_tpu_torch.scheduler.batch as port_batch
import kubernetes_tpu_torch.scheduler.resilience as port_res
import kubernetes_tpu_torch.scheduler.scheduler as port_sched
import kubernetes_tpu_torch.testing as port_testing
import kubernetes_tpu_torch.utils.metrics as port_metrics

PKGS = {
    "jax": (jax_server, jax_client, jax_informer, jax_types, jax_faults,
            jax_app, jax_batch, jax_res, jax_sched, jax_testing, jax_metrics,
            {}),
    "torch": (port_server, port_client, port_informer, port_types,
              port_faults, port_app, port_batch, port_res, port_sched,
              port_testing, port_metrics, {"device": "cpu"}),
}


class P:
    def __init__(self, pkg):
        (server, client, informer, self.types, self.faults, app, self.batch,
         self.res, sched, testing, self.metrics, self.kw) = PKGS[pkg]
        self.pkg = pkg
        self.server = server
        self.APIServer = server.APIServer
        self.Client = client.Client
        self.InformerFactory = informer.InformerFactory
        self.SchedulerApp = app.SchedulerApp
        self.new_scheduler = sched.new_scheduler
        self.make_node = testing.make_node
        self.make_pod = testing.make_pod

    def point(self, name, **kw):
        fp = self.faults
        return fp.FaultInjector(fp.FaultProfile(
            name, seed=0, points={getattr(fp.FaultPoint, k):
                                  fp.PointConfig(**v) for k, v in kw.items()}))


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for pkg in PKGS:
        P(pkg).faults.install_injector(None)


def _wait(pred, timeout, step=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _bound_count(client, names):
    return sum(1 for p in client.list_pods()[0]
               if p.spec.node_name and p.metadata.name in names)


def _bind_transitions(server):
    """Per pod, its unbound -> bound transitions over the whole watch
    history."""
    w = server.watch("Pod", since_rv=0)
    node, out = {}, {}
    for ev in w.pending():
        name = ev.object.metadata.name
        if ev.type == "DELETED":
            node.pop(name, None)
            continue
        cur = ev.object.spec.node_name or ""
        if not node.get(name) and cur:
            out[name] = out.get(name, 0) + 1
        node[name] = cur
    w.stop()
    return out


def _per_node_max(client):
    per = {}
    for p in client.list_pods()[0]:
        assert p.spec.node_name, f"{p.metadata.name} unbound"
        per[p.spec.node_name] = per.get(p.spec.node_name, 0) + 1
    return max(per.values())


# -- the reference scenarios -----------------------------------------------------


def _ha_failover(p):
    """tests/test_ha_failover.py:91 through package ``p``."""
    def cfg():
        return p.types.KubeSchedulerConfiguration(
            leader_election=p.types.LeaderElectionConfiguration(
                leader_elect=True, lease_duration_seconds=0.5,
                renew_deadline_seconds=6.0, retry_period_seconds=0.05))

    server = p.APIServer()
    app1 = p.SchedulerApp(config=cfg(), server=server, **p.kw)
    client = app1.client
    for i in range(16):
        client.create_node(p.make_node(f"n{i}").capacity(
            cpu="32", memory="64Gi", pods=110).obj())
    app1.start()
    app2 = None
    try:
        assert _wait(lambda: app1.elector.is_leader, 10), "no initial leader"
        assert app1.sched.fencing_check is not None
        wave1 = [f"p{i}" for i in range(160)]
        for n in wave1:
            client.create_pod(p.make_pod(n).container(
                cpu="100m", memory="128Mi").obj())
        assert _wait(lambda: _bound_count(client, set(wave1)) >= 20, 90)
        fences0 = p.metrics.fencing_aborts.value()
        renew0 = p.metrics.lease_renew_failures.value()
        app1.elector.fault_injector = p.point(
            "leader-kill", LEASE_RENEW_FAIL=dict(rate=1.0))
        assert _wait(lambda: not app1.elector.holds_lease(), 15)
        assert p.metrics.lease_renew_failures.value() > renew0
        assert app1.elector.is_leader, "abdicated before the renew deadline"
        # the fencing window: the deposed-but-live leader is the only
        # live scheduler, and every commit of it is fenced
        wave2 = [f"q{i}" for i in range(64)]
        for n in wave2:
            client.create_pod(p.make_pod(n).container(
                cpu="100m", memory="128Mi").obj())
        assert _wait(lambda: p.metrics.fencing_aborts.value() > fences0, 20)
        assert _bound_count(client, set(wave2)) == 0
        app2 = p.SchedulerApp(config=cfg(), server=server, **p.kw)
        app2.start()
        assert _wait(lambda: app2.elector.is_leader, 20)
        names = set(wave1) | set(wave2)
        assert _wait(lambda: _bound_count(client, names) == 224, 120)
        assert _wait(lambda: not app1.elector.is_leader, 30)
        app1.sched.wait_for_inflight_binds()
        app2.sched.wait_for_inflight_binds()
        transitions = _bind_transitions(server)
        assert sorted(transitions) == sorted(names)
        assert set(transitions.values()) == {1}
        assert _per_node_max(client) <= 110
        for app in (app1, app2):
            if p.pkg == "torch":
                assert app.sched.card_fault is None
        return sorted(transitions.items())
    finally:
        if app2 is not None:
            app2.stop()
        app1.stop()


def test_leader_killed_mid_batch_standby_drains_with_fencing():
    got = {pkg: _ha_failover(P(pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"]


def _restart_resume(p):
    """tests/test_restart_resume.py:29 through package ``p``."""
    server = p.APIServer()
    client = p.Client(server)
    for i in range(6):
        client.create_node(p.make_node(f"n{i}").capacity(
            cpu="8", memory="16Gi", pods=30).obj())

    def bound():
        return sum(1 for x in client.list_pods()[0] if x.spec.node_name)

    informers1 = p.InformerFactory(server)
    sched1 = p.new_scheduler(client, informers1, batch=True, max_batch=16,
                             **p.kw)
    informers1.start()
    informers1.wait_for_cache_sync()
    sched1.queue.run()
    for i in range(24):
        client.create_pod(p.make_pod(f"p{i}").container(
            cpu="250m", memory="256Mi").obj())
    sched1.start()
    assert _wait(lambda: bound() >= 8, 30)
    sched1.stop()
    informers1.stop()
    for i in range(24, 36):
        client.create_pod(p.make_pod(f"p{i}").container(
            cpu="250m", memory="256Mi").obj())
    informers2 = p.InformerFactory(server)
    sched2 = p.new_scheduler(client, informers2, batch=True, max_batch=16,
                             **p.kw)
    informers2.start()
    informers2.wait_for_cache_sync()
    sched2.queue.run()
    sched2.start()
    try:
        assert _wait(lambda: bound() == 36, 60)
        sched2.wait_for_inflight_binds()
    finally:
        sched2.stop()
        informers2.stop()
    assert _per_node_max(client) <= 30
    assert sched2.cache.pod_count() == 36
    assert set(_bind_transitions(server).values()) == {1}
    return sched2.cache.pod_count(), len(_bind_transitions(server))


def test_replacement_scheduler_resumes_mid_burst():
    got = {pkg: _restart_resume(P(pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"] == (36, 36)


def _crash_recovery(p):
    """tests/test_crash_recovery.py:70 through package ``p``; returns the
    recovery report beside the counts it must equal, and the bulk binds
    the crashed incarnation sent after its crash."""
    server = p.APIServer()
    client = p.Client(server)
    for i in range(8):
        client.create_node(p.make_node(f"n{i}").capacity(
            cpu="16", memory="32Gi", pods=60).obj())
    informers1 = p.InformerFactory(server)
    sched1 = p.new_scheduler(client, informers1, batch=True, max_batch=16,
                             **p.kw)
    late = []
    bind_bulk = client.bind_assumed_bulk

    def sent(assumed, *a, **kw):
        if sched1.crashed:
            late.append(len(assumed))
        return bind_bulk(assumed, *a, **kw)

    client.bind_assumed_bulk = sent
    informers1.start()
    informers1.wait_for_cache_sync()
    sched1.start()
    wave1 = [f"w1-{i}" for i in range(20)]
    for n in wave1:
        client.create_pod(p.make_pod(n).container(
            cpu="100m", memory="128Mi").obj())
    assert _wait(lambda: _bound_count(client, set(wave1)) == 20, 90)
    p.faults.install_injector(p.point(
        "crash", CRASH_BETWEEN_ASSUME_AND_BIND=dict(rate=1.0, max_fires=1)))
    wave2 = [f"w2-{i}" for i in range(20)]
    for n in wave2:
        client.create_pod(p.make_pod(n).container(
            cpu="100m", memory="128Mi").obj())
    assert _wait(lambda: sched1.crashed, 60), "crash point never fired"
    time.sleep(0.5)  # let any non-crashed in-flight batches land
    stranded = 20 - _bound_count(client, set(wave2))
    assert stranded > 0, "crash stranded nothing; the scenario is vacuous"
    informers1.stop()
    client.bind_assumed_bulk = bind_bulk
    p.faults.install_injector(None)
    a0 = p.metrics.pods_adopted_on_restart.value()
    informers2 = p.InformerFactory(server)
    sched2 = p.new_scheduler(client, informers2, batch=True, max_batch=16,
                             **p.kw)
    informers2.start()
    informers2.wait_for_cache_sync()
    report = p.res.recover_on_startup(sched2, client)
    allnames = set(wave1) | set(wave2)
    bound_now = _bound_count(client, allnames)
    assert report.adopted == bound_now
    assert p.metrics.pods_adopted_on_restart.value() == a0 + bound_now
    assert sched2.cache.pod_count() == bound_now
    assert report.requeued == stranded
    sched2.start()
    try:
        assert _wait(lambda: _bound_count(client, allnames) == 40, 120)
        sched2.wait_for_inflight_binds()
    finally:
        sched2.stop()
        informers2.stop()
    transitions = _bind_transitions(server)
    assert sorted(transitions) == sorted(allnames)
    assert set(transitions.values()) == {1}
    assert _per_node_max(client) <= 60
    return ((report.adopted, report.requeued, report.healed),
            (bound_now, stranded, 0), late)


def test_crash_between_assume_and_bind_then_restart_recovers():
    """Both packages pass the reference's assertions and report exactly
    what their apiserver holds. The port's dead incarnation sends no bind
    after its crash, so the crash strands its whole batch and the next;
    the JAX package's lands what it still had in flight."""
    got = {pkg: _crash_recovery(P(pkg)) for pkg in PKGS}
    for pkg, (report, derived, _) in got.items():
        assert report == derived, pkg
    assert got["torch"][2] == []
    assert got["torch"][0][1] >= got["jax"][0][1]


# -- the fenced-commit differential ----------------------------------------------


class _Inline:
    """A bind pool that runs each commit on the caller's thread."""

    def submit(self, fn, *args):
        fn(*args)

    def shutdown(self, wait=True):
        pass


def _fenced_drive(p, seed, fenced, lag_only=False):
    """The batch scheduler of package ``p`` driven by hand over a seeded
    cluster; the fence refuses the ``fenced``-th bulk commit. Returns
    every solve's pieces, handed state and answer, each batch's outcome,
    the fenced pods' place in the queue, the placements and the final
    carry.

    ``lag_only`` empties the pending-delta ring after each batch: every
    batch here commits before the next snapshot, so none of them is host
    lag any more. The port's handshake drops such deltas itself; the JAX
    package reads the fenced batch's forgotten placements as lag and
    keeps them in its carry (the phantom) unless they are dropped."""
    rng = np.random.default_rng(seed)
    server = p.APIServer()
    client = p.Client(server)
    informers = p.InformerFactory(server)
    sched = p.new_scheduler(client, informers, batch=True, max_batch=16,
                            **p.kw)
    sched._bind_pool = _Inline()
    sched.batch_window = 0.0
    sched.queue._initial_backoff = sched.queue._max_backoff = 0.0
    for i in range(int(rng.integers(8, 17))):
        client.create_node(p.make_node(f"n{i:02d}").capacity(
            cpu=str(int(rng.choice([4, 8, 16]))),
            memory=f"{int(rng.choice([8, 16, 32]))}Gi", pods=110).obj())
    for i in range(int(rng.integers(48, 72))):
        client.create_pod(p.make_pod(f"p{i:02d}").container(
            cpu=f"{int(rng.integers(1, 10)) * 100}m",
            memory=f"{int(rng.integers(1, 9)) * 128}Mi").obj())
    informers.pump()
    commits = [0]

    def fence():
        commits[0] += 1
        return commits[0] != fenced

    sched.fencing_check = fence
    solves = []
    orig = p.batch.solve_packed

    def recording(pieces, alloc_in, valid_in, req_in, nzr_in, **kw):
        out = orig(pieces, alloc_in, valid_in, req_in, nzr_in, **kw)
        solves.append((
            [(name, np.asarray(a).copy()) for name, a in pieces],
            [None if t is None else np.asarray(t).copy()
             for t in (alloc_in, valid_in, req_in, nzr_in)],
            [np.asarray(t).copy() for t in out[:3]]))
        return out

    p.batch.solve_packed = recording
    fences0 = p.metrics.fencing_aborts.value()
    batches, fenced_queue = [], None
    try:
        for _ in range(40):
            pending = sum(1 for x in client.list_pods()[0]
                          if not x.spec.node_name)
            if not pending:
                break
            n = sched.schedule_batch(timeout=0.05, pipeline=False)
            informers.pump()
            if lag_only:
                sched._dev.pending_deltas.clear()
            bound = sorted((x.metadata.name, x.spec.node_name)
                           for x in client.list_pods()[0] if x.spec.node_name)
            batches.append((n, commits[0], len(bound),
                            sched.carry_divergences, sched.state_uploads))
            if commits[0] == fenced and fenced_queue is None:
                fenced_queue = dict(sched.queue.num_pending())
            if n == 0:
                sched.queue.move_all_to_active_or_backoff_queue("retry")
                sched.queue.flush_backoff_q_completed()
    finally:
        p.batch.solve_packed = orig
    placements = sorted((x.metadata.name, x.spec.node_name)
                        for x in client.list_pods()[0])
    assert all(node for _, node in placements), "a pod left unbound"
    assert p.metrics.fencing_aborts.value() - fences0 == 1
    assert set(_bind_transitions(server).values()) == {1}
    sched.cache.update_snapshot(sched.algorithm.snapshot)
    nt = sched.tensor_cache.update(sched.algorithm.snapshot)
    carry = (np.asarray(sched._dev.req_dev), np.asarray(sched._dev.nzr_dev))
    assert np.array_equal(carry[0], nt.requested)
    assert np.array_equal(carry[1], nt.non_zero_requested)
    return solves, batches, fenced_queue, placements, carry


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fenced_commit_matches_the_jax_package(seed):
    """The k-th bulk commit is fenced (k = 1, 2, 3 by seed): its pods are
    forgotten and requeued, the next dispatch finds their rows diverged
    from the carry and patches them, and everything binds once. Every
    solve, batch outcome, queue state and placement, and the final carry,
    equal the JAX package's with its ring holding host lag only (the JAX
    package alone reads the fenced placements as lag, so its next solve
    would still see them); the final carry equals the host pack."""
    jax = _fenced_drive(P("jax"), seed, seed + 1, lag_only=True)
    port = _fenced_drive(P("torch"), seed, seed + 1)
    assert len(port[0]) == len(jax[0]) > seed + 1
    for (pp, ph, po), (jp, jh, jo) in zip(port[0], jax[0]):
        assert [n for n, _ in pp] == [n for n, _ in jp]
        for (_, a), (_, b) in zip(pp, jp):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ph, jh):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        for a, b in zip(po, jo):
            np.testing.assert_array_equal(a, b)
    assert port[1:4] == jax[1:4]
    assert port[2]  # the fenced pods went back to a queue
    for a, b in zip(port[4], jax[4]):
        np.testing.assert_array_equal(a, b)


# -- a placement the commit forgot after the carry mirrored it --------------------


class _Held:
    """A bind pool that holds each commit's bind until ``run``."""

    def __init__(self):
        self.jobs = []

    def submit(self, fn, *args):
        self.jobs.append((fn, args))

    def run(self):
        jobs, self.jobs = self.jobs, []
        for fn, args in jobs:
            fn(*args)

    def shutdown(self, wait=True):
        pass


def _forgotten_drive(p, how, order, lag_only=False):
    """Package ``p``'s batch scheduler, driven by hand over 64 equal nodes:
    a batch of 16 pods is assumed and mirrored into the carry, then its
    commit forgets every placement (``how``: the bulk bind unavailable on
    every attempt, the commit fenced, or each bind a typed conflict). With
    ``order`` "after" the forgotten pods are placed again by the next
    dispatch; with "before" a second batch is dispatched while the first
    one's bind is still held, and the forget lands after it. ``lag_only``
    empties the pending-delta ring after each batch (as the port's
    handshake drops the delta of a commit its snapshot shows). Returns the
    pods the carry, the shadow and the host pack hold after the dispatch
    that places the forgotten pods again, the divergences and uploads
    counted, and every placement."""
    server = p.APIServer()
    client = p.Client(server)
    informers = p.InformerFactory(server)
    sched = p.new_scheduler(client, informers, batch=True, max_batch=16,
                            **p.kw)
    pool = _Inline() if order == "after" else _Held()
    sched._bind_pool = pool
    sched.batch_window = 0.0
    sched.queue._initial_backoff = sched.queue._max_backoff = 0.0
    sched.ladder.config.sleep = lambda s: None
    for i in range(64):
        client.create_node(p.make_node(f"n{i:02d}").capacity(
            cpu="8", memory="16Gi", pods=110).obj())
    informers.pump()
    failing = [True]
    bind = client.bind_assumed_bulk

    def refusing(assumed, *a, **kw):
        first = failing[0] and assumed[0].metadata.name.startswith("a")
        if first and how == "bind":
            raise p.faults.FaultInjected(p.faults.FaultPoint.API_UNAVAILABLE)
        if first and how == "conflict":
            return [(i, p.server.BindConflict("already-bound"))
                    for i in range(len(assumed))]
        return bind(assumed, *a, **kw)

    client.bind_assumed_bulk = refusing
    if how == "fence":
        sched.fencing_check = lambda: not failing[0]

    def wave(prefix):
        client.create_pods_bulk([p.make_pod(f"{prefix}{i:02d}").container(
            cpu="500m", memory="512Mi").obj() for i in range(16)])
        informers.pump()

    def step():
        n = sched.schedule_batch(timeout=0.05, pipeline=False)
        informers.pump()
        if lag_only:
            sched._dev.pending_deltas.clear()
        return n

    wave("a")
    assert step() == 16
    if order == "before":
        wave("b")
        assert step() == 16
        if how == "fence":
            sched.fencing_check = lambda: not failing[0] or bool(pool.jobs)
        pool.run()  # a's commit forgets its pods now, b's binds
        if how == "fence":
            sched.fencing_check = lambda: True
    failing[0] = False
    informers.pump()
    sched.queue.move_all_to_active_or_backoff_queue("retry")
    sched.queue.flush_backoff_q_completed()
    assert step() == 16, "the forgotten pods were not placed again"
    if order == "before":
        pool.run()
        informers.pump()
    sched.cache.update_snapshot(sched.algorithm.snapshot)
    nt = sched.tensor_cache.update(sched.algorithm.snapshot)
    held = (int(np.asarray(sched._dev.req_dev)[:, 3].sum()),
            int(np.asarray(sched._dev.req_shadow)[:, 3].sum()),
            int(nt.requested[:, 3].sum()))
    placements = sorted((x.metadata.name, x.spec.node_name)
                        for x in client.list_pods()[0])
    assert all(node for _, node in placements), "a pod left unbound"
    assert set(_bind_transitions(server).values()) == {1}
    return held, sched.carry_divergences, sched.state_uploads, placements


@pytest.mark.parametrize("how,order", [
    ("bind", "after"), ("fence", "after"), ("conflict", "after"),
    ("bind", "before"),
])
def test_a_forgotten_placement_leaves_no_phantom_in_the_carry(how, order):
    """A commit forgets placements the carry already mirrored. The port's
    carry and shadow equal the host pack after the dispatch that places
    the pods again, with one divergence counted and the rows patched (no
    upload), and it places them where the JAX package does with its ring
    holding host lag only. The JAX package as it stands reads the forget
    as lag when it lands before the next dispatch ("after"): its carry
    keeps the 16 forgotten pods, uncounted, and the pods are placed past
    the rows they hold. When a later batch was dispatched first
    ("before"), both packages count the divergence and place alike."""
    port = _forgotten_drive(P("torch"), how, order)
    ref = _forgotten_drive(P("jax"), how, order, lag_only=True)
    jax = _forgotten_drive(P("jax"), how, order)
    pods = 16 if order == "after" else 32
    assert port[0] == (pods, pods, pods)
    assert port[1:3] == (1, 1)
    assert port == ref
    if order == "after":
        assert jax[0] == (pods + 16, pods + 16, pods)
        assert jax[1:3] == (0, 1)
        assert jax[3] != port[3]
    else:
        assert jax == port


# -- the repairs, against the JAX package ------------------------------------------


def _stop_in_flight(p):
    """A stop lands while the committer holds a dispatched batch: what
    escapes the batch's completion, and how many of its pods bind."""
    server = p.APIServer()
    client = p.Client(server)
    informers = p.InformerFactory(server)
    sched = p.new_scheduler(client, informers, batch=True, max_batch=64,
                            **p.kw)
    for i in range(4):
        client.create_node(p.make_node(f"n{i}").capacity(
            cpu="32", memory="64Gi", pods=110).obj())
    informers.start()
    informers.wait_for_cache_sync()
    # one batch: every pod is queued before the loop pops
    client.create_pods_bulk([p.make_pod(f"p{i}").container(
        cpu="100m", memory="128Mi").obj() for i in range(20)])
    assert _wait(lambda: sched.queue.num_pending()["active"] == 20, 10)
    held, release = threading.Event(), threading.Event()
    escaped = []
    commit, complete = sched._commit_batch, sched._complete_solve

    def holding_commit(*a, **kw):
        held.set()
        release.wait(10)
        return commit(*a, **kw)

    def recording_complete(pend):
        try:
            return complete(pend)
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            escaped.append(repr(e))
            raise

    sched._commit_batch = holding_commit
    sched._complete_solve = recording_complete
    loop = sched.start()
    try:
        assert held.wait(30), "no batch reached its commit"
        sched.stop()
        release.set()
        loop.join(30)
        assert not loop.is_alive()
        # the JAX package's failed submit leaves its in-flight bind
        # counted, so its wait runs out
        landed = sched.wait_for_inflight_binds(timeout=2)
        return escaped, landed, sum(1 for x in client.list_pods()[0]
                                    if x.spec.node_name)
    finally:
        release.set()
        informers.stop()


def test_stop_lets_the_batch_in_flight_land():
    """An elector's abdication calls ``stop`` while the loop still drains:
    the port's batch lands through the bind pool (the loop shuts it down
    after the drain), where the JAX package's completion fails on the
    closed pool, requeues and leaves a bind counted in flight -- on the
    card that failure would stop the scheduler."""
    port = _stop_in_flight(P("torch"))
    jax = _stop_in_flight(P("jax"))
    assert port == ([], True, 20)
    assert jax[1:] == (False, 0)
    assert any("after shutdown" in e for e in jax[0])


def _drained_twice(p):
    """A pod drained twice into one batch (a status echo's re-add, ROADMAP
    Queue 3 item 2), solved on the resident carry, then one more batch:
    the pods the carry's shadow holds against the host cache's."""
    server = p.APIServer()
    client = p.Client(server)
    informers = p.InformerFactory(server)
    sched = p.new_scheduler(client, informers, batch=True, max_batch=16,
                            async_binding=False, **p.kw)
    sched.batch_window = 0.0
    for i in range(8):
        client.create_node(p.make_node(f"n{i}").capacity(
            cpu="4", memory="8Gi", pods=110).obj())
    informers.pump()

    def wave(prefix):
        for i in range(4):
            client.create_pod(p.make_pod(f"{prefix}{i}").container(
                cpu="100m", memory="128Mi").obj())
        informers.pump()

    def held():
        shadow = int(np.asarray(sched._dev.req_shadow)[:, 3].sum())
        return shadow, sched.cache.pod_count()

    wave("a")
    pop = sched.queue.pop_batch
    sched.queue.pop_batch = lambda *a, **kw: (lambda b: b + b[:1])(
        pop(*a, **kw))
    sched.schedule_batch(timeout=0.1, pipeline=False)
    sched.queue.pop_batch = pop
    informers.pump()
    after_dup = held()
    wave("b")
    sched.schedule_batch(timeout=0.1, pipeline=False)
    informers.pump()
    return after_dup, held(), sched.carry_divergences


def test_a_pod_drained_twice_leaves_no_phantom_in_the_carry():
    """The second copy's assume fails, so no host row changes, yet the
    carry holds its placement. The port re-checks that row at the next
    negotiation (one counted divergence, the carry back to the host);
    the JAX package keeps the phantom."""
    port = _drained_twice(P("torch"))
    jax = _drained_twice(P("jax"))
    assert port[0] == jax[0] == (5, 4)
    assert port[1:] == ((8, 8), 1)
    assert jax[1:] == ((9, 8), 0)


def test_ha_chaos_faults_never_escape_a_batch_completion(monkeypatch):
    """Two leader-elected port stacks under ha-chaos (API_UNAVAILABLE on
    lists, binds and lease updates; bind conflicts; truncated watches)
    with the electors isolated, the leader killed mid-burst: nothing
    escapes a batch completion (the card's halt is reached only by a
    fault of the card), and every pod binds exactly once."""
    escaped = []
    orig = port_batch.BatchScheduler._complete_solve

    def complete(self, pend):
        try:
            return orig(self, pend)
        except Exception as e:  # noqa: BLE001 - recorded for the assert
            escaped.append(repr(e))
            raise

    monkeypatch.setattr(port_batch.BatchScheduler, "_complete_solve",
                        complete)
    p = P("torch")
    cfg = p.types.KubeSchedulerConfiguration(
        leader_election=p.types.LeaderElectionConfiguration(
            leader_elect=True, lease_duration_seconds=0.5,
            renew_deadline_seconds=1.0, retry_period_seconds=0.05))
    server = p.APIServer()
    apps = [p.SchedulerApp(config=cfg, server=server, **p.kw)
            for _ in range(2)]
    client = apps[0].client
    for i in range(24):
        client.create_node(p.make_node(f"n{i}").capacity(
            cpu="8", memory="16Gi", pods=110).obj())
    apps[0].start()
    try:
        assert _wait(lambda: apps[0].elector.is_leader, 10)
        apps[1].start()
        for app in apps:
            app.elector.fault_injector = p.point("none")
        profile = p.faults.load_profile("ha-chaos", seed=0)
        profile.points[p.faults.FaultPoint.API_UNAVAILABLE] = (
            p.faults.PointConfig(rate=0.2, max_fires=40))
        p.faults.install_injector(p.faults.FaultInjector(profile))
        names = [f"c{j}" for j in range(400)]
        for lo in range(0, 400, 50):
            client.create_pods_bulk([p.make_pod(n).container(
                cpu="100m", memory="128Mi").obj() for n in names[lo:lo + 50]])
            if lo == 100:
                apps[0].elector.fault_injector = p.point(
                    "leader-kill", LEASE_RENEW_FAIL=dict(rate=1.0))
        assert _wait(lambda: apps[1].elector.is_leader, 20)
        p.faults.install_injector(None)
        assert _wait(lambda: _bound_count(client, set(names)) == 400, 60)
        for app in apps:
            app.sched.wait_for_inflight_binds()
    finally:
        p.faults.install_injector(None)
        for app in reversed(apps):
            app.stop()
    assert not escaped, escaped[:3]
    assert all(app.sched.card_fault is None for app in apps)
    assert set(_bind_transitions(server).values()) == {1}
