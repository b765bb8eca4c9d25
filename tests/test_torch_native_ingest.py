"""The port's native ingest spine, on the CPU, against its own Python
fallbacks and against the JAX package's native module.

Twins of the 12 cases of ``tests/test_native_ingest.py``.
``kubernetes_tpu_torch.native`` builds its own copy of ``_hotpath.c``;
each randomized case runs the same seeded inputs through the port's C
entry point, the port's Python twin (``KTPU_NATIVE_INGEST=0``
semantics) and the JAX package's C entry point, and requires the same
outcome: admission memos and the non-plain remainder
(``ingest_stamp``), informer stores and deltas (``ingest_apply``,
``ingest_decode``), packed rows (``pack_gather``, ``pack_pod_batch``),
queue contents, drains and nominations (``queue_shape``, ``add_many``),
the malformed frame's error and prefix. Objects of the two packages are
compared by their names, node names and memo values. Tolerance: exact.

The tier-1 guard runs the port alone at the reference's size (1,000
pods at 500/s open loop on 16 nodes, the batch path with
``device="cpu"``): no native-to-Python fallback, the pack + pop +
classify share under 10% of wall-clock, and placements equal to the
port's sequential oracle. The reference file already runs the JAX
package at that size; beside it, a shortened deterministic burst (200
pods created in bulk, max_batch 64, driven batch by batch) runs through
both packages and must place alike.
"""

import importlib
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

import kubernetes_tpu.native as jax_native
import kubernetes_tpu_torch.native as native

if native.hotpath is None or jax_native.hotpath is None:  # pragma: no cover
    pytest.skip("a native module did not build", allow_module_level=True)

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}
MEMO_KEYS = (
    "_req_memo", "_nzr_memo", "_hot_memo", "_packrow", "_band_priority",
)


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    srv = m("apiserver.server")
    inf = m("client.informer")
    q = m("queue.scheduling_queue")
    nt = m("tensors.node_tensor")
    return SimpleNamespace(
        pkg=pkg,
        hotpath=m("native").hotpath,
        types=m("api.types"),
        APIServer=srv.APIServer, Binding=srv.Binding,
        WatchEvent=srv.WatchEvent,
        Client=m("client.client").Client,
        InformerFactory=inf.InformerFactory,
        apply_events_py=inf._apply_events_py,
        PrioritySort=m("plugins.queuesort").PrioritySort,
        PriorityQueue=q.PriorityQueue, queue_shape_py=q._queue_shape_py,
        adm=m("scheduler.admission"),
        new_scheduler=m("scheduler.scheduler").new_scheduler,
        ResourceDims=nt.ResourceDims, pack_gather_py=nt._pack_gather_py,
        pack_pod_batch=nt.pack_pod_batch, stamp_pack_row=nt.stamp_pack_row,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
        metrics=m("utils.metrics"),
        ArrivalEngine=m("streaming.arrivals").ArrivalEngine,
        kw={"device": "cpu"} if pkg == "torch" else {},
    )


PORT, JAX = _side("torch"), _side("jax")


def _rand_pod(s, rng, i, plain_bias=0.7):
    """A randomized pod: mostly plain, with every non-plain feature the
    fast-path gate must route to the full classifier."""
    b = (
        s.make_pod(f"r{i}").creation_timestamp(float(i))
        .container(cpu=f"{rng.choice([0, 100, 200, 500])}m",
                   memory=f"{rng.choice([0, 128, 256])}Mi")
    )
    if rng.random() < 0.3:
        b = b.container(cpu="50m", memory="64Mi")
    if rng.random() < 0.2:
        b = b.priority(rng.choice([0, 10, 100]))
    if rng.random() < 0.2:
        b = b.node_selector(zone=f"z{rng.randrange(3)}")
    if rng.random() >= plain_bias:
        feature = rng.randrange(6)
        if feature == 0:
            b = b.pvc(f"claim-{i}")
        elif feature == 1:
            b = b.node_affinity_in("zone", ["z1"])
        elif feature == 2:
            b = b.spread_constraint(1, "zone", "DoNotSchedule")
        elif feature == 3:
            b = b.labels(**{s.types.POD_GROUP_LABEL: "g1"})
        elif feature == 4:
            b = b.container(cpu="10m", host_port=8000 + i % 100)
        else:
            pod = b.obj()
            pod.spec.priority_class_name = "high-prio"
            return pod
    pod = b.obj()
    if rng.random() < 0.15:
        pod.spec.containers[0].resources.requests[
            "example.com/widget"] = rng.randrange(1, 4)
    return pod


def _pods(s, seed, n, **kw):
    rng = random.Random(seed)
    return [_rand_pod(s, rng, i, **kw) for i in range(n)]


def _memo(pod):
    return {k: pod.__dict__.get(k) for k in MEMO_KEYS}


# -- TestStampDifferential ----------------------------------------------------


def _stamp(s, pods, native_path):
    plain = s.adm.plain_admission(object())
    if native_path:
        rest = s.hotpath.ingest_stamp(pods, s.adm.ingest_stamp_cfg(plain))
    else:
        rest = s.adm.stamp_plain_pods(pods, plain)
    return (list(rest),
            [(_memo(p), p.__dict__.get("_admission") is plain)
             for p in pods])


def test_randomized_population_stamps_identically():
    port_c = _stamp(PORT, _pods(PORT, 1234, 300), True)
    port_py = _stamp(PORT, _pods(PORT, 1234, 300), False)
    jax_c = _stamp(JAX, _pods(JAX, 1234, 300), True)
    assert port_c == port_py == jax_c
    assert 0 < len(port_c[0]) < 300, "the population must mix"


def test_stamped_memos_match_the_real_helpers():
    """The C-built memos equal the lazy helpers' output, which the
    commit and accounting paths read."""
    from kubernetes_tpu_torch.api.types import pod_resource_requests
    from kubernetes_tpu_torch.cache.node_info import (
        non_zero_requests,
        pod_hot_info,
    )

    pods = _pods(PORT, 77, 50, plain_bias=1.1)
    plain = PORT.adm.plain_admission(object())
    assert not PORT.hotpath.ingest_stamp(
        pods, PORT.adm.ingest_stamp_cfg(plain))
    for pod in pods:
        fresh = PORT.make_pod("x").obj()
        fresh.spec = pod.spec  # same spec, no memos
        assert pod.__dict__["_req_memo"] == pod_resource_requests(fresh)
        assert pod.__dict__["_nzr_memo"] == non_zero_requests(fresh)
        assert pod.__dict__["_hot_memo"] == pod_hot_info(fresh)
    jax_pods = _pods(JAX, 77, 50, plain_bias=1.1)
    JAX.hotpath.ingest_stamp(jax_pods, JAX.adm.ingest_stamp_cfg(
        JAX.adm.plain_admission(object())))
    assert [_memo(p) for p in pods] == [_memo(p) for p in jax_pods]


# -- TestApplyDifferential ----------------------------------------------------


def _event_stream(s, seed, n_ops=400):
    """A real apiserver history (creates, binds, status updates,
    deletes) collected from the watch log."""
    rng = random.Random(seed)
    server = s.APIServer()
    client = s.Client(server)
    w = server.watch("Pod", since_rv=0)
    live = []
    for i in range(n_ops):
        op = rng.random()
        if op < 0.5 or not live:
            pod = s.make_pod(f"e{i}").container(cpu="100m").obj()
            client.create_pod(pod)
            live.append((pod.metadata.namespace, pod.metadata.name))
        elif op < 0.7:
            ns, name = rng.choice(live)
            try:
                server.bind(s.Binding(pod_namespace=ns, pod_name=name,
                                      target_node=f"n{rng.randrange(8)}"))
            except Exception:
                pass
        elif op < 0.85:
            ns, name = rng.choice(live)

            def mut(p):
                p.status.nominated_node_name = f"n{rng.randrange(8)}"

            try:
                server.update_pod_status(ns, name, mut)
            except KeyError:
                pass
        else:
            ns, name = live.pop(rng.randrange(len(live)))
            try:
                server.delete("Pod", ns, name)
            except KeyError:
                pass
    evs = w.pending()
    w.stop()
    return evs


def _copies(s, evs):
    return [s.WatchEvent(e.type, e.object, e.resource_version) for e in evs]


def _store_view(store):
    return {k: (v.metadata.name, v.spec.node_name,
                v.status.nominated_node_name) for k, v in store.items()}


def _delta_view(deltas):
    """Each delta with its pods as (name, node): uids and timestamps
    are per process."""
    def obj(o):
        if hasattr(o, "metadata"):
            return o.metadata.name, o.spec.node_name
        return o

    return [tuple(obj(o) for o in d) for d in deltas]


def test_randomized_stream_applies_identically():
    out = []
    for s in (PORT, JAX):
        evs = _event_stream(s, 5)
        assert len(evs) > 300
        s_native, s_twin = {}, {}
        d_native = s.hotpath.ingest_apply(s_native, evs)
        d_twin = s.apply_events_py(s_twin, _copies(s, evs))
        assert s_native == s_twin and d_native == d_twin
        # decode-once: a second consumer reuses the memoized records
        assert all(e.decoded is not None for e in evs)
        s_again = {}
        assert s.apply_events_py(s_again, evs) == d_native
        assert s_again == s_native
        out.append((_store_view(s_native), _delta_view(d_native)))
    assert out[0] == out[1]


def test_ingest_decode_memoizes_shared_records():
    keys = []
    for s in (PORT, JAX):
        evs = _event_stream(s, 8, n_ops=40)
        k = s.hotpath.ingest_decode(evs)
        assert k == [e.decoded for e in evs]
        assert all(kk == (e.object.metadata.namespace,
                          e.object.metadata.name)
                   for kk, e in zip(k, evs))
        assert s.hotpath.ingest_decode(evs) == k  # idempotent
        s_native, s_twin = {}, {}
        s.hotpath.ingest_apply(s_native, evs)
        s.apply_events_py(s_twin, evs)
        assert s_native == s_twin
        keys.append(k)
    assert keys[0] == keys[1]


def test_malformed_frame_raises_identically_with_same_prefix():
    prefixes = []
    for s in (PORT, JAX):
        good = _event_stream(s, 6, n_ops=20)
        frame = good[:10] + [s.WatchEvent("ADDED", object(), 10_000)] \
            + good[10:]
        s_native, s_twin = {}, {}
        with pytest.raises(AttributeError):
            s.hotpath.ingest_apply(s_native, frame)
        with pytest.raises(AttributeError):
            s.apply_events_py(s_twin, _copies(s, frame))
        s_prefix = {}
        s.apply_events_py(s_prefix, _copies(s, good[:10]))
        # both applied exactly the prefix before the malformed event
        assert s_native == s_twin == s_prefix
        prefixes.append(_store_view(s_native))
    assert prefixes[0] == prefixes[1]


def _replicated(s, monkeypatch, flag):
    monkeypatch.setenv("KTPU_NATIVE_INGEST", flag)
    server = s.APIServer()
    client = s.Client(server)
    rng = random.Random(9)
    inf = s.InformerFactory(server).pods()
    inf.pump()
    live = []
    for i in range(200):
        if rng.random() < 0.6 or not live:
            pod = s.make_pod(f"p{i}").container(cpu="100m").obj()
            client.create_pod(pod)
            live.append(pod.metadata.name)
        else:
            server.delete("Pod", "default", live.pop(rng.randrange(
                len(live))))
        if i % 37 == 0:
            inf.pump()
    inf.pump()
    return {k: v.spec.node_name for k, v in inf._store.items()}


def test_informer_stores_identical_under_env_toggle(monkeypatch):
    stores = [_replicated(s, monkeypatch, flag)
              for s in (PORT, JAX) for flag in ("1", "0")]
    assert stores[0] == stores[1] == stores[2] == stores[3]


# -- TestPackDifferential -----------------------------------------------------


def _dims(s):
    dims = s.ResourceDims()
    dims.volume_column("attachable-volumes-csi-x")
    return dims


def _pack_pods(s, seed, n=256):
    rng = random.Random(seed)
    pods = [_rand_pod(s, rng, i) for i in range(n)]
    for pod in pods:
        if rng.random() < 0.2:
            pod.__dict__["_volcount_memo"] = (
                ("attachable-volumes-csi-x", rng.randrange(1, 3)),)
    return pods


PACK_FIELDS = ("requests", "non_zero_requests", "priorities", "order",
               "unsatisfiable")


def test_pack_rows_identical(monkeypatch):
    batches = []
    for s in (PORT, JAX):
        for flag in ("1", "0"):
            monkeypatch.setenv("KTPU_NATIVE_INGEST", flag)
            batches.append(s.pack_pod_batch(_pack_pods(s, 21), _dims(s)))
    for b in batches[1:]:
        for f in PACK_FIELDS:
            assert np.array_equal(getattr(batches[0], f), getattr(b, f)), f


def test_out_of_range_row_overflows_on_both_paths(monkeypatch):
    """A request past int32 raises OverflowError on every path: silent
    wraparound would corrupt the fit inputs."""
    for s in (PORT, JAX):
        pod = s.make_pod("huge").container(cpu="100m", memory="4Ti").obj()
        for flag in ("1", "0"):
            monkeypatch.setenv("KTPU_NATIVE_INGEST", flag)
            with pytest.raises(OverflowError):
                s.pack_pod_batch([pod], s.ResourceDims())


def _gather(s, pods, fn):
    b = len(pods)
    idx = np.empty(b, dtype=np.int32)
    nzr = np.empty((b, 2), dtype=np.int32)
    prio = np.empty(b, dtype=np.int32)
    cache = {}
    keys = fn(pods, s.stamp_pack_row, cache, idx, nzr, prio)
    return list(keys), cache, idx, nzr, prio


def test_gather_twin_parity_and_memo_reuse():
    pods_a = _pack_pods(PORT, 33)
    pods_b = _pack_pods(PORT, 33)
    for pod in pods_b:  # pre-stamped: the memo hit path == the miss path
        PORT.stamp_pack_row(pod)
    pods_j = _pack_pods(JAX, 33)
    out = [_gather(PORT, pods_a, PORT.hotpath.pack_gather),
           _gather(PORT, pods_b, PORT.pack_gather_py),
           _gather(JAX, pods_j, JAX.hotpath.pack_gather)]
    for o in out[1:]:
        assert o[0] == out[0][0] and o[1] == out[0][1]
        for x, y in zip(o[2:], out[0][2:]):
            assert np.array_equal(x, y)
    # every pod carries the memo now
    assert all("_packrow" in p.__dict__ for p in pods_a)


# -- TestQueueDifferential ----------------------------------------------------


def _queue_pods(s, seed, n=200):
    rng = random.Random(seed)
    pods = []
    for i in range(n):
        pod = (s.make_pod(f"q{i % (n - 20)}")  # some duplicate keys
               .priority(rng.choice([0, 0, 0, 10, 100]))
               .container(cpu="100m").obj())
        if rng.random() < 0.1:
            pod.status.nominated_node_name = f"n{rng.randrange(4)}"
        pods.append(pod)
    return pods


def _bulk_add(s, monkeypatch, flag):
    monkeypatch.setenv("KTPU_NATIVE_INGEST", flag)
    ps = s.PrioritySort()
    t = [0.0]
    q = s.PriorityQueue(ps.queue_sort_less, now=lambda: t[0],
                        sort_key_func=ps.queue_sort_key)
    pods = _queue_pods(s, 55)
    q.add(pods[0])  # seed the side containers so removal semantics run
    popped = q.pop()
    q.add_unschedulable_if_not_present(popped, q.scheduling_cycle)
    q.add_many(pods)
    name_by_uid = {p.metadata.uid: p.metadata.name for p in pods}
    noms = {name_by_uid[uid]: node for uid, node in
            q.nominated_pods.nominated_pod_to_node.items()}
    pending = q.num_pending()
    return ([pi.pod.metadata.name for pi in q.pop_batch(10_000)], pending,
            noms)


def test_bulk_add_matches_per_pod_path(monkeypatch):
    out = [_bulk_add(s, monkeypatch, flag)
           for s in (PORT, JAX) for flag in ("1", "0")]
    assert out[0] == out[1] == out[2] == out[3]


def test_shape_twin_parity():
    shapes = [tuple(map(list, fn(_queue_pods(s, 66))))
              for s, fn in ((PORT, PORT.hotpath.queue_shape),
                            (PORT, PORT.queue_shape_py),
                            (JAX, JAX.hotpath.queue_shape))]
    assert shapes[0] == shapes[1] == shapes[2]


# -- tier-1 guard -------------------------------------------------------------

NUM_NODES = 16
NUM_PODS = 1000
GUARD_RATE = 500.0  # the open loop's offered rate, pods/s


class _KeepFirstRng:
    def randrange(self, n):
        return 1 if n > 1 else 0

    def randint(self, a, b):
        return b


def _fallback_total(s):
    return sum(s.metrics.ingest_native_fallbacks._values.values())


def _burst_pods(s, seed, n):
    rng = random.Random(seed)
    return [
        s.make_pod(f"b{i}").creation_timestamp(float(i))
        .container(cpu=f"{rng.choice([100, 200, 250])}m",
                   memory=f"{rng.choice([128, 256])}Mi").obj()
        for i in range(n)
    ]


def _stack(s, batch, max_batch=256):
    server = s.APIServer()
    client = s.Client(server)
    informers = s.InformerFactory(server)
    sched = s.new_scheduler(client, informers, batch=batch,
                            max_batch=max_batch, rng=_KeepFirstRng(),
                            **s.kw)
    for i in range(NUM_NODES):
        client.create_node(s.make_node(f"g{i}")
                           .capacity(cpu="64", memory="256Gi", pods=120)
                           .obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    return client, informers, sched


def _wait_all_bound(client, count, timeout=120.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if sum(1 for p in client.list_pods()[0] if p.spec.node_name) \
                >= count:
            return
        time.sleep(0.05)
    raise AssertionError("not every pod bound")


def _run_burst(s, *, batch, profile=False):
    client, informers, sched = _stack(s, batch)
    pods = _burst_pods(s, 42, NUM_PODS)
    try:
        if profile:
            sched.profile_stages = True
            sched.warmup()
            sched.batch_window = 0.05
        sched.start()
        t0 = time.perf_counter()
        if batch:
            offsets = np.arange(NUM_PODS, dtype=np.float64) / GUARD_RATE
            engine = s.ArrivalEngine(client, offsets, lambda i: pods[i])
            engine.start()
            engine.join(timeout=120)
        else:
            for lo in range(0, NUM_PODS, 256):
                client.create_pods_bulk(pods[lo:lo + 256])
        _wait_all_bound(client, NUM_PODS)
        sched.wait_for_inflight_binds()
        elapsed = time.perf_counter() - t0
        return ({p.metadata.name: p.spec.node_name
                 for p in client.list_pods()[0]}, sched, elapsed)
    finally:
        sched.stop()
        informers.stop()


def test_tier1_ingest_guard_no_fallbacks_low_pop_pack_share_oracle_parity():
    """The port at the reference's size: a steady 1k-pod open-loop
    burst never falls back from the native ingest plane, keeps pack +
    pop_batch + classify under 10% of wall-clock (best of 2, as the
    reference), and places every pod as the sequential oracle."""
    fallbacks_before = _fallback_total(PORT)
    want, _, _ = _run_burst(PORT, batch=False)
    assert all(want.values()), "oracle failed to place a fitting pod"
    share = None
    for _attempt in range(2):
        got, sched, elapsed = _run_burst(PORT, batch=True, profile=True)
        assert got == want
        assert sched.pods_fallback == 0
        assert sched.pods_solved_on_device == NUM_PODS
        assert _fallback_total(PORT) == fallbacks_before, (
            "native->Python ingest fallbacks during the burst")
        assert elapsed >= NUM_PODS / GUARD_RATE * 0.9, (
            f"trace replay finished impossibly fast ({elapsed:.2f}s)")
        stages = sched.stage_seconds
        ingest_s = sum(stages.get(k, 0.0)
                       for k in ("pack", "pop_batch", "classify"))
        share = min(share, ingest_s / elapsed) if share else (
            ingest_s / elapsed)
        if share < 0.10:
            break
    assert share < 0.10, f"pack+pop+classify share {share:.3f} >= 10%"


def _shortened(s, n=200):
    client, informers, sched = _stack(s, True, max_batch=64)
    try:
        client.create_pods_bulk(_burst_pods(s, 42, n))
        deadline = time.time() + 10
        while (sched.queue.num_pending()["active"] < n
               and time.time() < deadline):
            time.sleep(0.01)
        while sched.schedule_batch(timeout=0.5):
            pass
        sched.wait_for_inflight_binds()
        return ({p.metadata.name: p.spec.node_name
                 for p in client.list_pods()[0]}, sched.pods_fallback)
    finally:
        sched.stop()
        informers.stop()


def test_shortened_burst_places_as_the_jax_package():
    port, ref = _shortened(PORT), _shortened(JAX)
    assert port == ref
    assert all(port[0].values()) and port[1] == 0
