"""The band queue-jump, the adaptive window and the PriorityClass band,
on the CPU, in both packages.

Twins of the 14 cases of ``tests/test_queue_bands.py``. The queue cases
run the same pods through each package's ``PriorityQueue.pop_batch``
(bands on and off, a high-band arrival cutting the window, a shrink
applied mid-window, a grow that never stretches an armed deadline, the
wait split) and require the same pods in each batch and the reference's
bounds on the seconds waited in both. The PriorityClass cases build each
package's scheduler from the same configuration (``device="cpu"`` for
the port) and require the same armed threshold and the same stamped
priorities.

The priority-inversion e2e runs the port alone at the reference's full
size (2,500 bulk pods, 12 high, 30 nodes, max_batch 192) and holds it to
the reference's starvation bound; the reference file already runs the
JAX package at that size. Beside it, a shortened deterministic input
(300 bulk pods driven batch by batch at max_batch 64, 12 high pods
landing after the second batch) runs through both packages: the pods of
every batch, in order, and every placement must be equal. Tolerance:
exact for pods, names and placements; the seconds only against the
reference's own bounds.
"""

import importlib
import threading
import time
from types import SimpleNamespace

import pytest

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}
HIGH = 100


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    sched_mod = m("scheduler.scheduler")
    return SimpleNamespace(
        pkg=pkg,
        types=m("api.types"),
        APIServer=m("apiserver.server").APIServer,
        Client=m("client.client").Client,
        InformerFactory=m("client.informer").InformerFactory,
        PrioritySort=m("plugins.queuesort").PrioritySort,
        PriorityQueue=m("queue.scheduling_queue").PriorityQueue,
        load_config_from_dict=m("config.loader").load_config_from_dict,
        new_scheduler=sched_mod.new_scheduler,
        new_scheduler_from_config=sched_mod.new_scheduler_from_config,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        metrics=m("utils.metrics"),
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


SIDES = [_side("torch"), _side("jax")]
PORT = SIDES[0]


def _queue(s, band_threshold=None):
    sorter = s.PrioritySort()
    q = s.PriorityQueue(sorter.queue_sort_less,
                        sort_key_func=sorter.queue_sort_key)
    q.band_threshold = band_threshold
    return q


def _pod(s, name, priority=0):
    return s.make_pod(name).priority(priority).obj()


def _names(batch):
    return [pi.pod.metadata.name for pi in batch]


def both(case):
    """``case(side)`` -> (pods, seconds) in each package: the pods must
    be equal; returns [(pods, seconds) of the port, of JAX]."""
    out = [case(s) for s in SIDES]
    assert out[0][0] == out[1][0]
    return out


def _timed_pop(q, *args, **kw):
    t0 = time.perf_counter()
    batch = q.pop_batch(*args, **kw)
    return _names(batch), time.perf_counter() - t0


def _drain_with_arrival(q, pod, delay, **kw):
    """A drain on its own thread; ``pod`` lands ``delay`` seconds in."""
    out = {}

    def drain():
        t0 = time.perf_counter()
        out["batch"] = q.pop_batch(10, timeout=0.0, **kw)
        out["elapsed"] = time.perf_counter() - t0
        out["waited"] = q.last_pop_wait_seconds

    t = threading.Thread(target=drain)
    t.start()
    time.sleep(delay)
    q.add(pod)
    t.join(timeout=5.0)
    assert not t.is_alive(), "the drain still waited"
    return out


# -- TestBandAwareDrain -------------------------------------------------------


def test_high_band_pod_skips_window():
    def case(s):
        q = _queue(s, band_threshold=50)
        q.add(_pod(s, "hi-0", HIGH))
        return _timed_pop(q, 10, timeout=0.0, window=5.0)

    for names, elapsed in both(case):
        assert names == ["hi-0"]
        assert elapsed < 1.0, "high-band pod waited out the window"


def test_bulk_pods_still_wait_window():
    def case(s):
        q = _queue(s, band_threshold=50)
        q.add(_pod(s, "bulk-0", 0))
        return _timed_pop(q, 10, timeout=0.0, window=0.3)

    for names, elapsed in both(case):
        assert names == ["bulk-0"]
        assert elapsed >= 0.25, "bulk-only batch should use the window"


def test_high_band_arrival_cuts_window_short():
    def case(s):
        q = _queue(s, band_threshold=50)
        q.add(_pod(s, "bulk-0", 0))
        out = _drain_with_arrival(q, _pod(s, "hi-0", HIGH), 0.15,
                                  window=5.0)
        return sorted(_names(out["batch"])), out["elapsed"]

    for names, elapsed in both(case):
        assert names == ["bulk-0", "hi-0"]
        assert elapsed < 2.0


def test_bands_off_is_flat_drain():
    def case(s):
        q = _queue(s, band_threshold=None)
        q.add(_pod(s, "hi-0", HIGH))
        return _timed_pop(q, 10, timeout=0.0, window=0.3)

    for names, elapsed in both(case):
        assert names == ["hi-0"]
        assert elapsed >= 0.25  # without bands it waits the window


def test_band_wait_histogram_recorded():
    def case(s):
        w = s.metrics.queue_band_wait
        before = (w.count(band="high"), w.count(band="bulk"))
        q = _queue(s, band_threshold=50)
        q.add_many([_pod(s, "b-0", 0), _pod(s, "b-1", 0),
                    _pod(s, "h-0", HIGH)])
        names = _names(q.pop_batch(10, timeout=0.0, window=0.0))
        return (names, w.count(band="high") - before[0],
                w.count(band="bulk") - before[1]), 0.0

    (names, high, bulk), _ = both(case)[0]
    assert len(names) == 3 and (high, bulk) == (1, 2)


# -- TestAdaptiveWindow -------------------------------------------------------


def test_mid_window_shrink_applies_immediately():
    def case(s):
        q = _queue(s)
        q.add(_pod(s, "bulk-0", 0))
        window = {"value": 5.0}

        def shrink_then_add():
            window["value"] = 0.01  # the controller shrinks mid-window
            return _pod(s, "bulk-1", 0)  # and a wakeup re-reads it

        out = {}

        def drain():
            t0 = time.perf_counter()
            out["batch"] = q.pop_batch(10, timeout=0.0,
                                       window=lambda: window["value"])
            out["elapsed"] = time.perf_counter() - t0

        t = threading.Thread(target=drain)
        t.start()
        time.sleep(0.15)
        q.add(shrink_then_add())
        t.join(timeout=5.0)
        assert not t.is_alive(), "shrink did not apply mid-window"
        return sorted(_names(out["batch"])), out["elapsed"]

    for names, elapsed in both(case):
        assert names == ["bulk-0", "bulk-1"]
        assert elapsed < 2.0


def test_grow_never_extends_armed_deadline():
    def case(s):
        q = _queue(s)
        q.add(_pod(s, "bulk-0", 0))
        calls = {"n": 0}

        def window():
            calls["n"] += 1
            return 0.2 if calls["n"] == 1 else 10.0  # armed, then grown

        return _timed_pop(q, 10, timeout=0.0, window=window)

    for names, elapsed in both(case):
        assert names == ["bulk-0"]
        assert elapsed < 2.0, f"armed 0.2s stretched to {elapsed:.2f}s"


def test_shrink_is_monotone_once_applied():
    def case(s):
        q = _queue(s)
        q.add(_pod(s, "bulk-0", 0))
        seq = iter([2.0, 0.1, 10.0, 10.0, 10.0])
        last = [0.1]

        def window():
            last[0] = next(seq, last[0])
            return last[0]

        out = _drain_with_arrival(q, _pod(s, "bulk-1", 0), 0.05,
                                  window=window)
        return sorted(_names(out["batch"])), out["elapsed"]

    for _, elapsed in both(case):
        assert elapsed < 1.5


def test_pop_wait_split_stays_honest():
    def case(s):
        q = _queue(s, band_threshold=50)
        q.add_many([_pod(s, f"p-{i}", 0) for i in range(5)])
        q.pop_batch(10, timeout=0.0, window=0.0)
        prefilled = q.last_pop_wait_seconds
        names, elapsed = _timed_pop(q, 10, timeout=0.25, window=0.0)
        empty = (elapsed, q.last_pop_wait_seconds)
        q.add(_pod(s, "bulk-0", 0))
        out = _drain_with_arrival(q, _pod(s, "hi-0", HIGH), 0.2,
                                  window=5.0)
        return names, (prefilled, empty, out["waited"])

    for names, (prefilled, (elapsed, waited), band_cut) in both(case):
        assert names == []
        assert prefilled < 0.05  # a pre-filled queue waits for nothing
        # an empty queue: the whole timeout is wait, not drain work
        assert waited == pytest.approx(elapsed, abs=0.1)
        assert waited >= 0.15
        # a band cut keeps only the time actually waited
        assert 0.05 < band_cut < 2.0


# -- priority-inversion e2e ---------------------------------------------------


class _BindTimes:
    """Watch-driven name -> bind wall clock (perf_counter)."""

    def __init__(self, server):
        self._watch = server.watch("Pod", since_rv=server.current_rv())
        self.times = {}
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            for ev in self._watch.next_batch(timeout=0.2) or []:
                pod = ev.object
                if ev.type == "MODIFIED" and pod.spec.node_name:
                    self.times.setdefault(pod.metadata.name,
                                          time.perf_counter())

    def stop(self):
        self._stop = True
        self._watch.stop()
        self._thread.join(timeout=2)


def _stack(s, max_batch, nodes):
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    sched = s.new_scheduler(client, informers, batch=True,
                            max_batch=max_batch, **s.kw)
    sched.queue.band_threshold = 50
    for i in range(nodes):
        client.create_node(s.make_node(f"n{i}")
                           .capacity(cpu="64", memory="256Gi", pods=120)
                           .obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    return server, client, informers, sched


def _small_pod(s, name, priority=0):
    return (s.make_pod(name).priority(priority)
            .container(cpu="100m", memory="128Mi").obj())


def test_priority_inversion_e2e_high_band_bounded_behind_bulk():
    """The port at the reference's size: a 2,500-pod bulk backlog is
    mid-drain when 12 high-priority pods arrive; every high pod binds
    while a large part of the backlog still waits, within a fraction of
    the drain's span."""
    s = PORT
    server, client, informers, sched = _stack(s, 192, 30)
    try:
        sched.batch_window = 0.1  # a throughput window the band must cut
        sched.warmup()
        n_bulk, n_high = 2500, 12
        bulk = [_small_pod(s, f"bulk-{i}") for i in range(n_bulk)]
        binds = _BindTimes(server)
        for i in range(0, n_bulk, 256):
            client.create_pods_bulk(bulk[i:i + 256])
        sched.start()
        deadline = time.time() + 120
        while len(binds.times) < n_bulk // 10 and time.time() < deadline:
            time.sleep(0.01)
        assert len(binds.times) >= n_bulk // 10, "bulk drain never started"
        high = [_small_pod(s, f"hi-{i}", 100) for i in range(n_high)]
        t_high_created = time.perf_counter()
        client.create_pods_bulk(high)
        names = [f"hi-{i}" for i in range(n_high)]
        deadline = time.time() + 120
        while (sum(n in binds.times for n in names) < n_high
               and time.time() < deadline):
            time.sleep(0.01)
        high_times = [binds.times.get(n) for n in names]
        assert all(t is not None for t in high_times), (
            f"only {sum(t is not None for t in high_times)}/{n_high} "
            f"high-prio pods bound")
        t_high_done = max(high_times)
        bulk_done_at_high = sum(
            1 for i in range(n_bulk)
            if binds.times.get(f"bulk-{i}", float("inf")) <= t_high_done)
        deadline = time.time() + 180
        while (len(binds.times) < n_bulk + n_high
               and time.time() < deadline):
            time.sleep(0.05)
        assert len(binds.times) >= n_bulk + n_high, "backlog never drained"
        sched.wait_for_inflight_binds()
        binds.stop()
        bulk_t = [binds.times[f"bulk-{i}"] for i in range(n_bulk)]
        bulk_span = max(bulk_t) - min(bulk_t)
        high_worst = t_high_done - t_high_created
        assert bulk_done_at_high < int(n_bulk * 0.9), (
            f"high band finished only after {bulk_done_at_high}/{n_bulk} "
            f"bulk pods")
        assert high_worst < max(2.0, 0.5 * bulk_span), (
            f"high-band worst {high_worst:.2f}s vs drain {bulk_span:.2f}s")
        assert sched.pods_fallback == 0
    finally:
        sched.stop()
        informers.stop()


def _inversion_batches(s, n_bulk=300, n_high=12, after=2):
    """The shortened input: 300 bulk pods created, drained batch by
    batch by hand; 12 high pods land after ``after`` batches. Returns
    the pods of each batch in solve order and every placement."""
    _, client, informers, sched = _stack(s, 64, 4)
    try:
        for i in range(0, n_bulk, 100):
            client.create_pods_bulk([
                _small_pod(s, f"bulk-{j}")
                for j in range(i, min(n_bulk, i + 100))])
        deadline = time.time() + 10
        while (sched.queue.num_pending()["active"] < n_bulk
               and time.time() < deadline):
            time.sleep(0.01)
        batches = []
        orig = sched.queue.pop_batch

        def recording_pop(*a, **kw):
            got = orig(*a, **kw)
            if got:
                batches.append(_names(got))
            return got

        sched.queue.pop_batch = recording_pop
        for k in range(after):
            sched.schedule_batch(timeout=0.5)
        client.create_pods_bulk(
            [_small_pod(s, f"hi-{i}", 100) for i in range(n_high)])
        deadline = time.time() + 10
        while (sched.queue.num_pending()["active"]
               < n_bulk + n_high - 64 * after and time.time() < deadline):
            time.sleep(0.01)
        while sched.schedule_batch(timeout=0.5):
            pass
        sched.wait_for_inflight_binds()
        placed = {p.metadata.name: p.spec.node_name
                  for p in client.list_pods()[0]}
        return batches, placed
    finally:
        sched.stop()
        informers.stop()


def test_priority_inversion_shortened_matches_the_jax_package():
    port, ref = (_inversion_batches(s) for s in SIDES)
    assert port == ref
    batches, placed = port
    assert all(placed.values())
    # the high band jumps the backlog: all 12 in the first batch after
    # their arrival, ahead of every bulk pod still queued
    assert batches[2][:12] == [f"hi-{i}" for i in range(12)]


# -- TestPriorityClassBand ----------------------------------------------------


def _wired(s):
    server = s.APIServer()
    server.create(s.types.PriorityClass(
        metadata=s.types.ObjectMeta(name="critical"), value=90))
    cfg = s.load_config_from_dict({
        "tpuSolver": {"maxBatch": 128},
        "streaming": {"enabled": True, "bandPriorityClass": "critical"},
    })
    client = s.Client(server)
    informers = s.InformerFactory(server)
    sched = s.new_scheduler_from_config(client, informers, cfg, **s.kw)
    informers.start()
    informers.wait_for_cache_sync()
    return server, informers, sched


def _with_wired(case):
    def run(s):
        server, informers, sched = _wired(s)
        try:
            return case(s, server, sched)
        finally:
            sched.stop()
            informers.stop()

    port, ref = (run(s) for s in SIDES)
    assert port == ref
    return port


def _await(fn, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not fn():
        time.sleep(0.02)


def test_class_value_arms_threshold_at_sync():
    assert _with_wired(lambda s, server, sched:
                       sched.queue.band_threshold) == 90


def test_class_update_rearms_live_and_delete_disarms():
    def case(s, server, sched):
        def bump(obj):
            obj.value = 120

        server.guaranteed_update("PriorityClass", "default", "critical",
                                 bump)
        _await(lambda: sched.queue.band_threshold == 120)
        armed = sched.queue.band_threshold
        server.delete("PriorityClass", "default", "critical")
        _await(lambda: sched.queue.band_threshold is None)
        return armed, sched.queue.band_threshold

    assert _with_wired(case) == (120, None)


def test_classifier_stamps_class_resolved_priority():
    def case(s, server, sched):
        pod = s.make_pod("pc-1").container(cpu="100m", memory="128Mi").obj()
        pod.spec.priority_class_name = "critical"
        assert pod.spec.priority == 0  # only the class names it
        sched.classify_pod(pod)
        pod2 = s.make_pod("pc-2").priority(7).obj()
        pod2.spec.priority_class_name = "critical"
        sched.classify_pod(pod2)
        # an explicit numeric priority wins over the class
        return pod.__dict__["_band_priority"], pod2.__dict__["_band_priority"]

    assert _with_wired(case) == (90, 7)


def test_class_resolved_pod_cuts_window():
    """A pod whose only priority signal is its PriorityClass still cuts
    the band window: the stamped memo drives the drain check."""
    def case(s, server, sched):
        q = _queue(s, band_threshold=90)
        classy = s.make_pod("classy").obj()
        classy.spec.priority_class_name = "critical"
        sched.classify_pod(classy)
        q.add(_pod(s, "low-1", priority=0))
        q.add(classy)
        names, took = _timed_pop(q, 10, timeout=0.5, window=5.0)
        assert took < 2.0, "class-resolved pod failed to cut window"
        return sorted(names)

    assert _with_wired(case) == ["classy", "low-1"]
