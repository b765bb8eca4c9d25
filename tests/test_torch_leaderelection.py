"""The port's leader election (kubernetes_tpu_torch/scheduler/
leaderelection.py) against the JAX package's, on the CPU.

The 13 cases of ``tests/test_leaderelection.py`` (the renew deadline,
``release``, two electors on one lease, clock-skew tolerance, jittered
renew, the ``holds_lease`` fencing probe), each run through both
packages' ``LeaderElector`` with the same clock and the same call
sequence, and held to the reference test's assertions in both. The
cases that run the elector's loop (``run``) drive it under a
discrete-event clock: each elector's loop runs on its own thread, but
only one at a time, woken in the order of the times its waits end, so
``is_leader`` over time and the final ``Lease`` record are exact and
compared between the packages. Two more cases: a whole failover (the
leader's renews killed, the standby seizing at expiry plus the skew
grace), and the fencing probe under ``api_unavailable`` at rate 1 (a
live leader's lease read has no fault point, so it is never fenced;
its renew, a compare-and-swap, fails and is metered). Tolerance: exact.
"""

import threading
import time

import pytest

import kubernetes_tpu.apiserver.server as jax_server
import kubernetes_tpu.client.client as jax_client
import kubernetes_tpu.config.types as jax_types
import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu.scheduler.leaderelection as jax_le
import kubernetes_tpu.utils.metrics as jax_metrics
import kubernetes_tpu_torch.apiserver.server as port_server
import kubernetes_tpu_torch.client.client as port_client
import kubernetes_tpu_torch.config.types as port_types
import kubernetes_tpu_torch.robustness.faults as port_faults
import kubernetes_tpu_torch.scheduler.leaderelection as port_le
import kubernetes_tpu_torch.utils.metrics as port_metrics

PKGS = {
    "jax": (jax_server, jax_client, jax_types, jax_faults, jax_le,
            jax_metrics),
    "torch": (port_server, port_client, port_types, port_faults, port_le,
              port_metrics),
}


class P:
    """One package's names."""

    def __init__(self, pkg):
        server, client, types, faults, le, metrics = PKGS[pkg]
        self.APIServer = server.APIServer
        self.Client = client.Client
        self.Config = types.LeaderElectionConfiguration
        self.faults = faults
        self.LeaderElector = le.LeaderElector
        self.metrics = metrics


@pytest.fixture(autouse=True)
def _clean_injectors():
    yield
    for pkg in PKGS:
        P(pkg).faults.install_injector(None)


def both(scenario):
    """Run ``scenario(P(pkg))`` for both packages; their traces must be
    equal."""
    got = {pkg: scenario(P(pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


def lease_record(server):
    lease = server.get("Lease", "kube-system", "kube-scheduler")
    return (lease.holder_identity, lease.lease_duration_seconds,
            lease.acquire_time, lease.renew_time, lease.lease_transitions)


def renew_killer(p, seed=0, rate=1.0, max_fires=None):
    """A targeted injector failing the elector's renew rounds."""
    return p.faults.FaultInjector(p.faults.FaultProfile(
        "kill-renew", seed=seed,
        points={p.faults.FaultPoint.LEASE_RENEW_FAIL: p.faults.PointConfig(
            rate=rate, max_fires=max_fires)},
    ))


def elector(p, client, name, cfg, events, clock):
    return p.LeaderElector(
        client, cfg, identity=name,
        on_started_leading=lambda: events.append(("lead", name)),
        on_stopped_leading=lambda: events.append(("stop", name)),
        clock=clock,
    )


# -- the discrete-event clock --------------------------------------------------


class _SimStop:
    """The elector's stop event under ``Sim``: ``wait(t)`` yields to the
    clock until ``t`` has passed (or the elector is stopped)."""

    def __init__(self, sim, name):
        self.sim = sim
        self.name = name
        self._set = False

    def is_set(self):
        return self._set

    def set(self):
        with self.sim.cv:
            self._set = True
            self.sim.cv.notify_all()

    def wait(self, timeout=None):
        self.sim.park(self.name, self.sim.now + timeout, self)
        return self._set


class Sim:
    """Runs electors' ``run`` loops one at a time on a simulated clock:
    each loop runs until it waits, then the loop whose wait ends first
    (ties: the order the electors were added) resumes at that time.
    ``hooks`` are (time, fn) pairs run when the clock reaches them; the
    trace holds (time, each elector's ``is_leader``) at every step."""

    def __init__(self):
        self.now = 0.0
        self.cv = threading.Condition()
        self.parked = {}  # name -> (wake time, order)
        self.turn = None
        self.order = {}
        self.electors = {}
        self.threads = {}

    def clock(self):
        return self.now

    def add(self, name, el):
        el._stop = _SimStop(self, name)
        self.order[name] = len(self.order)
        self.electors[name] = el

        def target():
            self.park(name, self.now, el._stop)
            try:
                el.run()
            finally:
                with self.cv:
                    self.threads.pop(name, None)
                    self.turn = None
                    self.cv.notify_all()

        self.threads[name] = t = threading.Thread(target=target, daemon=True)
        t.start()

    def park(self, name, wake, stop):
        with self.cv:
            self.parked[name] = (wake, self.order[name])
            if self.turn == name:
                self.turn = None
            self.cv.notify_all()
            while self.turn != name and not stop._set:
                self.cv.wait()
            self.parked.pop(name, None)

    def run(self, until, hooks=()):
        hooks = sorted(hooks, key=lambda h: h[0])
        trace = []
        while True:
            with self.cv:
                deadline = time.time() + 10
                while self.turn is not None or len(self.parked) < len(
                        self.threads):
                    assert time.time() < deadline, "an elector never waited"
                    self.cv.wait(0.05)
                if not self.parked:
                    break
                name, (wake, _) = min(self.parked.items(),
                                      key=lambda kv: kv[1])
                if wake > until:
                    break
                self.now = max(self.now, wake)
            while hooks and hooks[0][0] <= self.now:
                hooks.pop(0)[1]()
            trace.append((round(self.now, 9), tuple(
                (n, e.is_leader) for n, e in self.electors.items())))
            with self.cv:
                self.turn = name
                self.cv.notify_all()
        return trace

    def stop(self):
        for el in self.electors.values():
            el._stop.set()
        for t in list(self.threads.values()):
            t.join(timeout=5)


# -- TestRenewDeadline ---------------------------------------------------------


def test_renew_failures_past_deadline_abdicate():
    """The holder's renews fail (injected lease_renew_fail) once it leads;
    once the renew deadline passes it abdicates: on_stopped_leading
    fires, is_leader drops, its loop returns, the failures are
    metered."""
    def scenario(p):
        server = p.APIServer()
        cfg = p.Config(leader_elect=True, lease_duration_seconds=0.4,
                       renew_deadline_seconds=0.3, retry_period_seconds=0.03)
        sim, events = Sim(), []
        a = elector(p, p.Client(server), "a", cfg, events, sim.clock)
        before = p.metrics.lease_renew_failures.value()
        sim.add("a", a)

        def kill():
            assert a.is_leader
            a.fault_injector = renew_killer(p)

        trace = sim.run(until=3.0, hooks=[(0.1, kill)])
        sim.stop()
        assert not a.is_leader and "a" not in sim.threads
        assert ("stop", "a") in events and ("lead", "a") in events
        failures = p.metrics.lease_renew_failures.value() - before
        assert failures > 0
        return trace, sorted(events), failures, lease_record(server)

    trace = both(scenario)[0]
    assert any(dict(state)["a"] for _, state in trace)


def test_renew_failure_before_deadline_keeps_leading():
    """Transient renew failures inside the deadline never depose: the next
    successful round extends it."""
    def scenario(p):
        server = p.APIServer()
        cfg = p.Config(leader_elect=True, lease_duration_seconds=2.0,
                       renew_deadline_seconds=1.5, retry_period_seconds=0.03)
        sim, events = Sim(), []
        a = elector(p, p.Client(server), "a", cfg, events, sim.clock)
        a.fault_injector = renew_killer(p, seed=7, rate=0.5, max_fires=5)
        sim.add("a", a)
        trace = sim.run(until=0.6)
        assert a.is_leader, "transient renew failures must not depose"
        fired = a.fault_injector.fired_count(
            p.faults.FaultPoint.LEASE_RENEW_FAIL)
        sim.stop()
        return trace, fired, lease_record(server)

    trace, fired, _ = both(scenario)
    assert fired == 5
    first = next(i for i, (_, s) in enumerate(trace) if dict(s)["a"])
    assert all(dict(s)["a"] for _, s in trace[first:])


# -- TestRelease -----------------------------------------------------------------


def _cfg30(p):
    return p.Config(lease_duration_seconds=30.0, renew_deadline_seconds=10.0,
                    retry_period_seconds=0.05)


def test_release_clears_holder_identity():
    def scenario(p):
        server = p.APIServer()
        a = elector(p, p.Client(server), "a", _cfg30(p), [], lambda: 5.0)
        assert a._try_acquire_or_renew()
        held = lease_record(server)
        a.is_leader = True
        a.release()
        assert server.get(
            "Lease", "kube-system", "kube-scheduler").holder_identity == ""
        assert not a.is_leader
        return held, lease_record(server)

    both(scenario)


def test_release_when_not_leader_is_noop():
    """release() by a non-holder never clobbers someone else's live
    lease, even with a stale is_leader flag."""
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        a = elector(p, client, "a", _cfg30(p), [], lambda: 5.0)
        b = elector(p, client, "b", _cfg30(p), [], lambda: 5.0)
        steps = [a._try_acquire_or_renew()]
        a.is_leader = True
        b.release()  # never led
        steps.append(lease_record(server))
        b.is_leader = True
        a.release()
        steps.append(lease_record(server))
        steps.append(a._try_acquire_or_renew())  # the lease is free again
        a.is_leader = True
        b.release()
        steps.append(lease_record(server))
        assert steps[-1][0] == "a", "non-holder release clobbered the lease"
        return steps

    steps = both(scenario)
    assert steps[0] and steps[1][0] == "a" and steps[3]


# -- TestContention --------------------------------------------------------------


def test_two_electors_one_lease_single_winner():
    """Both candidates CAS against one lease record: one wins, the loser
    never flips is_leader, one acquisition in all."""
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        cfg = p.Config(leader_elect=True, lease_duration_seconds=0.6,
                       renew_deadline_seconds=0.5, retry_period_seconds=0.02)
        sim, events = Sim(), []
        a = elector(p, client, "a", cfg, events, sim.clock)
        b = elector(p, client, "b", cfg, events, sim.clock)
        sim.add("a", a)
        sim.add("b", b)
        trace = sim.run(until=1.0)
        sim.stop()
        for _, state in trace:
            assert not (dict(state)["a"] and dict(state)["b"])
        record = lease_record(server)
        assert record[0] in ("a", "b") and record[4] == 1
        return trace, record

    trace, record = both(scenario)
    assert any(dict(s)[record[0]] for _, s in trace)


def test_direct_cas_only_one_seizes():
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        cfg = p.Config(lease_duration_seconds=10.0, renew_deadline_seconds=5.0,
                       retry_period_seconds=0.05)
        a = elector(p, client, "a", cfg, [], lambda: 1.0)
        b = elector(p, client, "b", cfg, [], lambda: 1.0)
        # the holder renews fine against its own record
        return [a._try_acquire_or_renew(), b._try_acquire_or_renew(),
                a._try_acquire_or_renew(), lease_record(server)]

    assert both(scenario)[:3] == [True, False, True]


# -- TestClockSkewTolerance ----------------------------------------------------


def _skew_pair(p, tolerance):
    server = p.APIServer()
    client = p.Client(server)
    t_a, t_b = [0.0], [0.0]
    cfg_a = p.Config(lease_duration_seconds=10.0, renew_deadline_seconds=5.0,
                     retry_period_seconds=0.05)
    cfg_b = p.Config(lease_duration_seconds=10.0, renew_deadline_seconds=5.0,
                     retry_period_seconds=0.05,
                     clock_skew_tolerance_seconds=tolerance)
    a = elector(p, client, "a", cfg_a, [], lambda: t_a[0])
    b = elector(p, client, "b", cfg_b, [], lambda: t_b[0])
    return server, a, b, t_b


def test_challenger_grants_skew_grace():
    """A challenger whose clock runs ahead waits out lease_duration plus
    the tolerance before it seizes."""
    def scenario(p):
        server, a, b, t_b = _skew_pair(p, 1.0)
        out = [a._try_acquire_or_renew()]
        t_b[0] = 10.2  # past expiry by b's clock, inside the grace
        out.append(b._try_acquire_or_renew())
        t_b[0] = 11.2  # past expiry + tolerance: seize
        out.append(b._try_acquire_or_renew())
        return out, lease_record(server)

    assert both(scenario)[0] == [True, False, True]


def test_zero_tolerance_seizes_at_expiry():
    def scenario(p):
        server, a, b, t_b = _skew_pair(p, 0.0)
        out = [a._try_acquire_or_renew()]
        t_b[0] = 10.2
        out.append(b._try_acquire_or_renew())
        return out, lease_record(server)

    assert both(scenario)[0] == [True, True]


# -- TestJitter ------------------------------------------------------------------


def test_jitter_stretches_within_fraction():
    def scenario(p):
        cfg = p.Config(retry_period_seconds=1.0, renew_jitter_fraction=0.25)
        a = elector(p, p.Client(p.APIServer()), "a", cfg, [], time.monotonic)
        return [a._jittered(1.0) for _ in range(200)]

    samples = both(scenario)
    assert all(1.0 <= s <= 1.25 for s in samples)
    assert len(set(samples)) > 1, "jitter stream is constant"


def test_zero_jitter_is_exact():
    def scenario(p):
        cfg = p.Config(renew_jitter_fraction=0.0)
        a = elector(p, p.Client(p.APIServer()), "a", cfg, [], time.monotonic)
        return a._jittered(1.0)

    assert both(scenario) == 1.0


# -- TestFencingProbe ------------------------------------------------------------


def _cfg10(p):
    return p.Config(lease_duration_seconds=10.0, renew_deadline_seconds=5.0,
                    retry_period_seconds=0.05)


def test_holds_lease_tracks_ownership():
    """After the standby seizes the expired lease, the old holder's fresh
    read answers False although its is_leader is stale."""
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        t = [0.0]
        a = elector(p, client, "a", _cfg10(p), [], lambda: t[0])
        b = elector(p, client, "b", _cfg10(p), [], lambda: t[0])
        out = [a._try_acquire_or_renew()]
        a.is_leader = True
        out.append(a.holds_lease())
        t[0] = 10.5
        out.append(b._try_acquire_or_renew())
        b.is_leader = True
        out += [a.holds_lease(), b.holds_lease()]
        return out, lease_record(server)

    assert both(scenario)[0] == [True, True, True, False, True]


def test_holds_lease_false_on_expired_record():
    def scenario(p):
        server = p.APIServer()
        t = [0.0]
        a = elector(p, p.Client(server), "a", _cfg10(p), [], lambda: t[0])
        out = [a._try_acquire_or_renew()]
        a.is_leader = True
        t[0] = 10.5  # past expiry with no renew: can't prove ownership
        out.append(a.holds_lease())
        return out

    assert both(scenario) == [True, False]


def test_holds_lease_false_when_record_missing():
    def scenario(p):
        a = elector(p, p.Client(p.APIServer()), "a", _cfg10(p), [],
                    time.monotonic)
        a.is_leader = True  # believes it leads but no record exists
        return a.holds_lease()

    assert both(scenario) is False


# -- beyond the reference cases ------------------------------------------------


def test_failover_timeline_matches_jax():
    """A leader and a standby with a skew grace of 0.2 s; the leader's
    renews are killed at t = 1: it abdicates at its renew deadline, the
    standby seizes once the lease plus the grace have passed, and the
    record counts two acquisitions. ``is_leader`` over time, the events
    and the lease record equal the JAX package's."""
    def scenario(p):
        server = p.APIServer()
        client = p.Client(server)
        cfg = p.Config(leader_elect=True, lease_duration_seconds=1.0,
                       renew_deadline_seconds=0.8, retry_period_seconds=0.1,
                       clock_skew_tolerance_seconds=0.2)
        sim, events = Sim(), []
        a = elector(p, client, "a", cfg, events, sim.clock)
        b = elector(p, client, "b", cfg, events, sim.clock)
        sim.add("a", a)
        sim.add("b", b)

        def kill():
            a.fault_injector = renew_killer(p)

        trace = sim.run(until=4.0, hooks=[(1.0, kill)])
        sim.stop()
        record = lease_record(server)
        assert record[0] == "b" and record[4] == 2
        seized = next(t for t, s in trace if dict(s)["b"])
        lost = max(t for t, s in trace if dict(s)["a"])
        assert 1.0 < lost < seized
        return trace, sorted(events), record

    both(scenario)


def test_a_live_leader_is_never_fenced_by_an_unavailable_api():
    """Under api_unavailable at rate 1 the lease read of the fencing probe
    has no fault point, so a live leader still holds its lease (a commit
    is never fenced by an injected API fault); its renew, a
    compare-and-swap, fails and is metered."""
    def scenario(p):
        server = p.APIServer()
        t = [0.0]
        a = elector(p, p.Client(server), "a", _cfg10(p), [], lambda: t[0])
        out = [a._try_acquire_or_renew()]
        a.is_leader = True
        before = p.metrics.lease_renew_failures.value()
        p.faults.install_injector(p.faults.FaultInjector(p.faults.FaultProfile(
            "api-down", seed=0,
            points={p.faults.FaultPoint.API_UNAVAILABLE: p.faults.PointConfig(
                rate=1.0)})))
        t[0] = 2.0
        out += [a.holds_lease(), a._try_acquire_or_renew(),
                p.metrics.lease_renew_failures.value() - before]
        p.faults.install_injector(None)
        return out, lease_record(server)

    assert both(scenario)[0] == [True, True, False, 1]
