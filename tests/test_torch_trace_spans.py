"""The port's trace spans and counters on the CPU, and the benchmark's
readers of them.

One traced burst of spread pods runs through ``new_scheduler(batch=True,
device="cpu")`` with the flight recorder's Chrome trace armed, and a
collection is forced while its run loop is up. The cases read that
trace: the informer's ``ingest`` spans, the drains' ``pop_batch`` spans
with ``queue_depth`` (and its counter track), ``window_wait`` inside
``pop_wait``, ``drain_wait`` and the pack's sub-steps inside ``pack``,
the commit's inside ``commit``, each on its parent's thread and batch;
the ``gc`` span and ``scheduler_tpu_gc_pause_seconds_total``; the
``clock_sync`` pair; the always-on stage sums. An unarmed recorder
appends nothing. The card's device spans are put on the host clock by
``device_spans``, checked here with stand-in events (the CUDA ones exist
only on the card, where ``chip_smoke.py``'s ``burst`` and
``portbench/tests``' card cases check them). Each new reader of
``portbench/metrics`` is read against a hand-built ``Run``: its value,
and None where what it reads is absent, as on a commit without the span.
"""

import gc
import time

import pytest

from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod
from kubernetes_tpu_torch.utils import flightrecorder as fr
from kubernetes_tpu_torch.utils import gc_tuning, metrics
from portbench import harness, spec

ZONE = "topology.kubernetes.io/zone"
N_PODS = 192
CHUNK = 24
#: a child's bounds are sums of the parent's (perf_counter microseconds)
SLACK_US = 0.01


def _gc_total():
    return sum(metrics.gc_pause_seconds.value(generation=str(g))
               for g in range(3))


@pytest.fixture(scope="module")
def burst():
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(client, informers, batch=True, max_batch=32,
                          device="cpu")
    for i in range(12):
        client.create_node(
            make_node(f"node-{i}").capacity(cpu="32", memory="64Gi",
                                            pods=110)
            .label(ZONE, f"zone-{i % 3}").obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.start()
    fr.start_trace()
    stages0 = dict(sched.stage_seconds)
    try:
        for lo in range(0, N_PODS, CHUNK):
            client.create_pods_bulk([
                make_pod(f"sp-{i}").container(cpu="100m", memory="128Mi")
                .labels(app="spread")
                .spread_constraint(1, ZONE, match_labels={"app": "spread"})
                .obj()
                for i in range(lo, lo + CHUNK)])
            time.sleep(0.02)
        deadline = time.time() + 60
        while time.time() < deadline:
            pods, _ = client.list_pods()
            if len(pods) == N_PODS and all(p.spec.node_name for p in pods):
                break
            time.sleep(0.05)
        sched.wait_for_inflight_binds()
        gc0 = _gc_total()
        gc.collect()
        gc1 = _gc_total()
    finally:
        events = fr.stop_trace()
        stages1 = dict(sched.stage_seconds)
        sched.stop()
        informers.stop()
    pods, _ = client.list_pods()
    assert all(p.spec.node_name for p in pods) and len(pods) == N_PODS
    stages = {k: v - stages0.get(k, 0.0) for k, v in stages1.items()}
    return dict(events=events, stages=stages, gc=(gc0, gc1))


def _spans(events, name):
    return [e for e in events if e["ph"] == "X" and e["name"] == name]


@pytest.mark.parametrize("name,args", [
    ("ingest", {"kind": "Pod"}),
    ("pop_batch", {"queue_depth": None}),
    ("pop_wait", {}),
    ("window_wait", {}),
    ("pack", {}),
    ("drain_wait", {}),
    ("pack_spread_batch", {}),
    ("commit", {}),
    ("bind_bulk", {}),
    ("gc", {"generation": 2}),
])
def test_the_span_is_written(burst, name, args):
    spans = _spans(burst["events"], name)
    assert spans, f"no {name} span in the trace"
    match = [e for e in spans
             if all(k in e.get("args", {})
                    and (v is None or e["args"][k] == v)
                    for k, v in args.items())]
    assert match, f"no {name} span with {args}: {spans[:3]}"
    assert all(e["dur"] >= 0 for e in spans)


def test_the_queue_depth_is_a_counter_track_too(burst):
    samples = [e for e in burst["events"]
               if e["ph"] == "C" and e["name"] == "queue_depth"]
    assert samples
    assert all(e["args"]["queue_depth"] >= 0 for e in samples)
    depths = [e["args"]["queue_depth"]
              for e in _spans(burst["events"], "pop_batch")]
    assert all(isinstance(d, int) and d >= 0 for d in depths)


@pytest.mark.parametrize("child,parent", [
    ("window_wait", "pop_wait"),
    ("drain_wait", "pack"),
    ("nt.update", "pack"),
    ("pack_pod_batch", "pack"),
    ("static_mask", "pack"),
    ("pack_score_batch", "pack"),
    ("pack_spread_batch", "pack"),
    ("commit.gather", "commit"),
    ("commit.assume", "commit"),
])
def test_a_child_span_lies_inside_its_parent(burst, child, parent):
    events = burst["events"]
    parents = {}
    for e in _spans(events, parent):
        parents.setdefault(e["args"]["batch"], []).append(e)
    children = _spans(events, child)
    assert children, f"no {child} span"
    for c in children:
        outer = [p for p in parents.get(c["args"]["batch"], ())
                 if p["tid"] == c["tid"]
                 and p["ts"] - SLACK_US <= c["ts"]
                 and c["ts"] + c["dur"] <= p["ts"] + p["dur"] + SLACK_US]
        assert outer, f"{child} {c} lies in no {parent} of its batch"


@pytest.mark.parametrize("part,whole", [
    ("drain_wait", "pack"),
    ("window_wait", "pop_wait"),
])
def test_a_part_stage_sums_below_its_whole(burst, part, whole):
    stages = burst["stages"]
    assert stages.get(part, 0.0) > 0.0, f"no {part} time in the burst"
    assert stages[part] <= stages[whole]


def test_the_gc_counter_rises(burst):
    gc0, gc1 = burst["gc"]
    assert gc1 > gc0
    text = metrics.registry.expose()
    assert 'scheduler_tpu_gc_pause_seconds_total{generation="2"}' in text


def test_the_trace_is_bracketed_by_clock_sync(burst):
    syncs = [e for e in burst["events"] if e["name"] == "clock_sync"]
    assert [e["args"]["at"] for e in syncs] == ["start", "stop"]
    assert burst["events"][0] is syncs[0] and burst["events"][-1] is syncs[1]
    for e in syncs:
        assert e["ph"] == "M"
        assert e["args"]["perf_counter_ns"] > 0 and e["args"]["time_ns"] > 0
    assert syncs[1]["args"]["perf_counter_ns"] > syncs[0]["args"][
        "perf_counter_ns"]


def test_the_cpu_trace_has_no_device_track(burst):
    tracks = {e["args"]["name"] for e in burst["events"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "device" not in tracks and "committer" not in tracks
    assert not [e for e in burst["events"]
                if e["name"].startswith(("solve b=", "commit b="))]


def test_nothing_is_appended_while_unarmed():
    assert not fr.trace_active()
    span = fr.BatchSpan(1, 1, [])
    span.stage("pack", 0.001, t0=time.perf_counter(), args={"x": 1})
    with fr.substep("nt.update", span):
        pass
    fr.trace_span("ingest", time.perf_counter(), 0.001)
    fr.trace_counter("queue_depth", 3)
    fr.gc_pause("MainThread", time.perf_counter(), 0.001, 2, 0)
    assert fr.collect_launches() is None and fr.launch_begin() is None
    fr.device_spans([("K2", None, None)], "solve b=1", {"batch": 1})
    gc_tuning.PAUSE_HOOK.install()
    try:
        gc.collect()
    finally:
        gc_tuning.PAUSE_HOOK.remove()
    fr.start_trace()
    events = fr.stop_trace()
    assert [e["name"] for e in events] == ["clock_sync", "clock_sync"]
    assert fr.stop_trace() == []


def test_the_pause_hook_is_shared_and_removed():
    hook = gc_tuning.PAUSE_HOOK
    users = hook._users
    hook.install()
    hook.install()
    hook.remove()
    assert gc.callbacks.count(hook) == 1
    hook.remove()
    assert hook._users == users
    assert gc.callbacks.count(hook) == (1 if users else 0)


class _Event:
    """A stand-in CUDA timing event: a time on the card, in ms."""

    def __init__(self, ms):
        self.ms = ms
        self.synced = False

    def elapsed_time(self, other):
        return other.ms - self.ms

    def synchronize(self):
        self.synced = True


def test_device_spans_are_put_on_the_host_clock(monkeypatch):
    fr.start_trace()
    try:
        monkeypatch.setattr(fr, "_anchor", (0, _Event(1000.0), 50.0))
        end = _Event(1012.5)
        fr.device_spans([("K2", _Event(1004.0), end)], "solve b=64",
                        {"batch": 7, "tier": "cuda"})
    finally:
        events = fr.stop_trace()
    [span] = [e for e in events if e["ph"] == "X"]
    tracks = {e["tid"]: e["args"]["name"] for e in events
              if e["name"] == "thread_name"}
    assert tracks[span["tid"]] == "device" and span["name"] == "solve b=64"
    assert span["ts"] == pytest.approx((50.0 + 0.004) * 1e6)
    assert span["dur"] == pytest.approx(8.5e3)
    assert span["args"] == {"batch": 7, "tier": "cuda", "kernel": "K2"}
    assert end.synced


# -- the readers -----------------------------------------------------------

T0, T1 = 100.0, 110.0


def _run(spans=(), stages0=None, stages1=None, bound=1000):
    run = harness.Run(cell=None, seed=0, seconds=T1 - T0, trace=True)
    run.t0, run.t1 = T0, T1
    run.order = [f"m-{i}" for i in range(bound)]
    run.bound = {n: (T0 + 1.0, "node-0") for n in run.order}
    run.host_spans = list(spans)
    run.stages0 = dict(stages0 or {})
    run.stages1 = dict(stages1 or {})
    return run


def _x(name, t0, dur, **args):
    return {"ph": "X", "name": name, "pid": 1, "tid": 1, "ts": t0 * 1e6,
            "dur": dur * 1e6, "args": args}


#: (metric, a run it reads, the value it reads, a run without its source)
READINGS = [
    ("drain_wait_us_per_pod.burst",
     _run(stages0={"drain_wait": 1.0, "pack": 2.0},
          stages1={"drain_wait": 1.5, "pack": 3.0}),
     500.0, _run(stages0={"pack": 2.0}, stages1={"pack": 3.0})),
    ("window_wait_us_per_pod.burst",
     _run(stages1={"window_wait": 0.02, "pop_wait": 0.5}), 20.0,
     _run(stages1={"pop_wait": 0.5})),
    ("queue_depth_at_pop.burst",
     _run([_x("pop_batch", 101.0, 0.001, batch=1, queue_depth=10),
           _x("pop_batch", 102.0, 0.001, batch=2, queue_depth=20),
           _x("pop_batch", 99.0, 0.001, batch=0, queue_depth=999)]),
     15.0, _run([_x("pop_batch", 101.0, 0.001, batch=1)])),
    ("ingest_us_per_pod.burst",
     _run([_x("ingest", 101.0, 0.2, kind="Pod", events=256),
           _x("ingest", 109.9, 0.2, kind="Pod", events=256),
           _x("ingest", 103.0, 5.0, kind="Node", events=1)]),
     300.0, _run([_x("ingest", 103.0, 5.0, kind="Node", events=1)])),
    ("gc_pause_us_per_pod.burst",
     _run([_x("gc", 99.5, 1.0, generation=1, collected=0),
           _x("gc", 105.0, 0.25, generation=2, collected=3)]),
     750.0, _run([_x("pack", 101.0, 1.0, batch=1)])),
    ("k2_device_us_per_pod.burst",
     _run([_x("solve b=1024", 101.0, 0.008, batch=1, tier="cuda",
              kernel="K2"),
           _x("solve b=1024", 109.996, 0.008, batch=2, tier="cuda",
              kernel="K2"),
           _x("solve b=1024", 102.0, 0.5, batch=3, tier="cuda",
              kernel="K1")]),
     12.0, _run([_x("device_solve", 101.0, 0.008, batch=1)])),
]


@pytest.mark.parametrize("metric,run,want,absent", READINGS,
                         ids=[r[0] for r in READINGS])
def test_a_reader_reads_its_source(metric, run, want, absent):
    entry = next(m for m in spec.load_benchmark()["per_layer"]
                 if m["name"] == metric)
    assert entry["moves"] == "pods_per_s"
    assert entry["source"] == "program_span"
    read = spec.load_reader(metric)
    assert read(run) == pytest.approx(want)
    assert read(absent) is None
    if entry["unit"] == "us/pod":
        # per pod bound: no pod bound, no reading
        assert read(_run(bound=0, spans=run.host_spans,
                         stages0=run.stages0, stages1=run.stages1)) is None
