"""The flight-recorder spine of the port's batch scheduler, on the CPU,
held against the JAX package.

``utils/flightrecorder.py``, ``utils/metrics.py``, ``utils/quantiles.py``,
``scheduler/metrics_recorder.py`` and ``scheduler/debugger.py`` are
identical in both packages (apart from the port's trace spans, counters
and clock anchor, and its collector-pause counter, which
``tests/test_torch_trace_spans.py`` covers), so the cases of
``tests/test_flightrecorder.py``,
``tests/test_metrics_exposition.py`` and ``tests/test_ops_shell.py`` that
test only those modules (the span ring, the Chrome-trace export, the
P-squared sketch, label escaping, callback gauges, the registry, leader
election, the config loader) need no twin. What the port rewrote is the
span its batch scheduler emits per dispatch, the sequential routes'
``routed=`` tags and the build watch (``_JitCacheWatch``, which reads
``ops.assignment.kernel_build_counts`` in place of JAX's
``jit_cache_sizes``). These twins cover that:

- ``TestBatchSpanSpine``: a burst's linked spans in both packages (the
  port's solving tiers are ``robustness/ladder.py``'s ``DEVICE_TIERS``,
  ``cuda`` and ``torch``, not the reference's three), the build watch
  with ``kernel_build_counts`` patched beside JAX's ``jit_cache_sizes``,
  and the live pod-to-bind quantile gauges;
- ``TestChaosReconstruction``: the lifecycle-chaos burst reconstructed
  from the port's dump alone, as the reference's is from its own;
- ``TestTraceOverheadGuard``: the always-on spine under 1% of the port's
  hot stages, with the per-operation timers of ``tools/bench_hotpath.py``;
- ``TestMetricsEndpointE2E`` and ``TestSchedulerApp``: the scrape lint,
  healthz, metrics and the cache comparers through
  ``kubernetes_tpu_torch.scheduler.app.SchedulerApp(device="cpu")``.
"""

import json
import time
import urllib.request
from types import SimpleNamespace

import pytest

import kubernetes_tpu.robustness.circuit as jax_circuit
import kubernetes_tpu.robustness.faults as jax_faults
import kubernetes_tpu.robustness.ladder as jax_ladder
import kubernetes_tpu.robustness.lifecycle as jax_lifecycle
import kubernetes_tpu.scheduler.batch as jax_batch
import kubernetes_tpu.utils.flightrecorder as jax_fr
import kubernetes_tpu.utils.metrics as jax_metrics
import kubernetes_tpu_torch.robustness.circuit as port_circuit
import kubernetes_tpu_torch.robustness.faults as port_faults
import kubernetes_tpu_torch.robustness.ladder as port_ladder
import kubernetes_tpu_torch.robustness.lifecycle as port_lifecycle
import kubernetes_tpu_torch.scheduler.batch as port_batch
import kubernetes_tpu_torch.utils.flightrecorder as port_fr
import kubernetes_tpu_torch.utils.metrics as port_metrics
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.app import SchedulerApp
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

from test_metrics_exposition import _lint_exposition
from tools.bench_hotpath import _time_mark_ops, _time_span_ops

PKG = {
    "jax": SimpleNamespace(
        server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
        new=jax_new, node=jax_node, pod=jax_pod, fr=jax_fr,
        metrics=jax_metrics, faults=jax_faults, ladder=jax_ladder,
        circuit=jax_circuit, lifecycle=jax_lifecycle, batch=jax_batch,
        solving=(jax_ladder.TIER_PALLAS, jax_ladder.TIER_XLA,
                 jax_ladder.TIER_HOST_GREEDY),
        build_probe="kubernetes_tpu.ops.assignment.jit_cache_sizes",
        kw={},
    ),
    "torch": SimpleNamespace(
        server=APIServer, client=Client, informers=InformerFactory,
        new=new_scheduler, node=make_node, pod=make_pod, fr=port_fr,
        metrics=port_metrics, faults=port_faults, ladder=port_ladder,
        circuit=port_circuit, lifecycle=port_lifecycle, batch=port_batch,
        # the ladder's solving tiers on a card and on the CPU, and the
        # host tier below them
        solving=port_ladder.DEVICE_TIERS + (port_ladder.TIER_HOST_GREEDY,),
        build_probe="kubernetes_tpu_torch.ops.assignment.kernel_build_counts",
        kw={"device": "cpu"},
    ),
}
BOTH = ("jax", "torch")
HOT = ("pop_batch", "pack", "device_solve", "download", "commit")


@pytest.fixture(autouse=True)
def _clean():
    for pkg in BOTH:
        PKG[pkg].fr.RECORDER.reset()
    yield
    for pkg in BOTH:
        P = PKG[pkg]
        P.faults.install_injector(None)
        P.fr.stop_trace()
        P.fr.ENABLED = True


def _mk_cluster(pkg, num_nodes=48, max_batch=128, retry_attempts=1):
    P = PKG[pkg]
    server = P.server()
    client = P.client(server)
    informers = P.informers(server)
    sched = P.new(
        client, informers, batch=True, max_batch=max_batch,
        robustness_config=P.ladder.RobustnessConfig(
            solve_timeout_seconds=5.0,
            failure_threshold=2,
            cooloff_seconds=0.3,
            probe_batches=1,
            retry=P.circuit.RetryPolicy(
                max_attempts=retry_attempts, backoff_seconds=0.01,
                max_backoff_seconds=0.05,
            ),
        ),
        **P.kw,
    )
    for i in range(num_nodes):
        client.create_node(
            P.node(f"node-{i}").capacity(cpu="32", memory="64Gi", pods=110)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    return server, client, informers, sched


def _wait_all_bound(client, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if pods and all(p.spec.node_name for p in pods):
            return True
        time.sleep(0.1)
    return False


class TestBatchSpanSpine:
    def test_burst_produces_linked_spans(self):
        """Every pod of a clean burst links to exactly one solving span,
        each span carries its size, pad, carry decision and stages, and
        the first one uploaded -- in both packages."""
        got = {}
        for pkg in BOTH:
            P = PKG[pkg]
            server, client, informers, sched = _mk_cluster(
                pkg, num_nodes=16, max_batch=64, retry_attempts=3)
            sched.start()
            names = [f"sp-{i}" for i in range(150)]
            for n in names:
                client.create_pod(
                    P.pod(n).container(cpu="100m", memory="128Mi").obj())
            assert _wait_all_bound(client, 60)
            sched.wait_for_inflight_binds()
            sched.stop()
            informers.stop()
            d = P.fr.RECORDER.dump()
            solved = [s for s in d["spans"]
                      if s["tier"] in P.solving and s["routed"] is None]
            assert solved, "no device-tier spans recorded"
            placed_total = 0
            for s in solved:
                assert s["size"] > 0
                assert s["padded"] >= s["size"]
                assert s["carry"] in ("reuse", "delta", "upload")
                for stage in ("pack", "device_solve", "commit"):
                    assert stage in s["stages_ms"], stage
                assert s["t_end"] is not None
                placed_total += s["placed"]
            assert placed_total == len(names)
            uid_of = {p.metadata.name: p.metadata.uid
                      for p in client.list_pods()[0]}
            seen = {}
            for s in solved:
                for link in s["pods"]:
                    seen.setdefault(link["uid"], []).append(
                        (s["batch_id"], link["attempts"]))
            for n in names:
                assert uid_of[n] in seen, f"pod {n} not linked to a batch"
                assert len(seen[uid_of[n]]) == 1, n
                assert seen[uid_of[n]][0][1] >= 1
            assert solved[0]["carry"] == "upload"
            got[pkg] = dict(
                placed=placed_total, linked=len(seen),
                tiers={s["tier"] for s in solved},
                stages=set.intersection(*(set(s["stages_ms"])
                                          for s in solved)) & set(HOT),
            )
        assert got["torch"]["tiers"] == {port_ladder.TIER_TORCH}
        for key in ("placed", "linked", "stages"):
            assert got["torch"][key] == got["jax"][key], key

    def test_jit_watch_counts_and_marks_recompiles(self, monkeypatch):
        """The build watch books warmup-era builds without a mark and
        marks a build after ``seal()`` once: the port reads
        ``kernel_build_counts`` where JAX reads ``jit_cache_sizes``, and
        both book and mark alike."""
        got = {}
        for pkg in BOTH:
            P = PKG[pkg]
            sizes = {"solve_packed": 3}
            monkeypatch.setattr(
                P.build_probe, lambda mesh=None, _s=sizes: dict(_s))
            w = P.batch._JitCacheWatch()
            before = P.metrics.jit_compiles.value(signature="solve_packed")
            w.refresh()
            booked = [P.metrics.jit_compiles.value(signature="solve_packed")
                      - before]
            marks0 = [m for m in P.fr.RECORDER.dump()["marks"]
                      if m["kind"] == "jit_recompile"]
            assert not marks0
            w.seal()
            sizes["solve_packed"] = 5
            w.refresh()
            booked.append(P.metrics.jit_compiles.value(
                signature="solve_packed") - before)
            marks = [m for m in P.fr.RECORDER.dump()["marks"]
                     if m["kind"] == "jit_recompile"]
            assert booked == [3, 5]
            assert len(marks) == 1
            assert marks[0]["signature"] == "solve_packed"
            assert marks[0]["compiles"] == 2
            got[pkg] = (booked, [(m["signature"], m["compiles"],
                                  m["cache_size"]) for m in marks])
        assert got["torch"] == got["jax"]

    def test_jit_watch_reads_the_kernel_modules(self):
        """Unpatched, the port's watch reads each kernel module's
        ``builds``: a build after ``seal()`` is one mark, named after
        the module."""
        from kubernetes_tpu_torch.ops import greedy_kernel

        w = port_batch._JitCacheWatch()
        w.seal()
        before = port_metrics.jit_compiles.value(signature="greedy_kernel")
        greedy_kernel.builds += 1
        try:
            w.refresh()
        finally:
            greedy_kernel.builds -= 1
        marks = [m for m in port_fr.RECORDER.dump()["marks"]
                 if m["kind"] == "jit_recompile"]
        assert [m["signature"] for m in marks] == ["greedy_kernel"]
        assert port_metrics.jit_compiles.value(
            signature="greedy_kernel") == before + 1

    def test_live_quantile_gauges_track_bound_pods(self):
        for pkg in BOTH:
            P = PKG[pkg]
            P.metrics.pod_to_bind_sketch.reset()
            server, client, informers, sched = _mk_cluster(
                pkg, num_nodes=16, max_batch=64, retry_attempts=3)
            sched.start()
            for i in range(200):
                client.create_pod(P.pod(f"q-{i}").container(cpu="50m").obj())
            assert _wait_all_bound(client, 60)
            sched.wait_for_inflight_binds()
            sched.stop()
            informers.stop()
            assert P.metrics.pod_to_bind_sketch.count == 200
            p50 = P.metrics.pod_to_bind_quantile.value(q="0.5")
            p99 = P.metrics.pod_to_bind_quantile.value(q="0.99")
            assert 0.0 < p50 <= p99 < 60.0
            lines = P.metrics.pod_to_bind_quantile.collect()
            assert any('q="0.99"' in ln for ln in lines if "#" not in ln)


def _chaos_reconstruction(pkg):
    """The reference's lifecycle-chaos reconstruction in package ``pkg``:
    every assertion reads only the dump (after a JSON round trip) and
    the ledgers it is checked against. Returns what the twin compares."""
    P = PKG[pkg]
    FaultPoint = P.faults.FaultPoint
    server, client, informers, sched = _mk_cluster(
        pkg, num_nodes=32, max_batch=128, retry_attempts=1)
    profile = P.faults.load_profile("lifecycle-chaos", seed=3)
    profile.points[FaultPoint.DEVICE_SOLVE].rate = 0.5
    profile.points[FaultPoint.DEVICE_SOLVE].max_fires = 6
    inj = P.faults.FaultInjector(profile)
    P.faults.install_injector(inj)
    fallbacks_before = dict(P.metrics.solver_fallbacks._values)
    tiers_before = dict(sched.ladder.solves_by_tier)
    drv = P.lifecycle.ClusterLifecycleDriver(
        client, injector=inj, tick_interval=0.1, flap_down_seconds=0.4,
        storm_fraction=0.1, storm_down_seconds=0.8,
    )
    sched.start()
    drv.start()
    try:
        for i in range(300):
            client.create_pod(P.pod(f"lc-{i}").container(
                cpu="250m", memory="256Mi").obj())
        assert _wait_all_bound(client, 120), "burst did not bind"
    finally:
        drv.stop()
    assert _wait_all_bound(client, 60)
    sched.wait_for_inflight_binds()
    sched.stop()
    informers.stop()

    d = json.loads(P.fr.RECORDER.dump_json())
    span_tiers = {}
    for s in d["spans"]:
        if s["tier"] in P.solving:
            span_tiers[s["tier"]] = span_tiers.get(s["tier"], 0) + 1
    for tier in P.solving:
        expect = (sched.ladder.solves_by_tier.get(tier, 0)
                  - tiers_before.get(tier, 0))
        assert span_tiers.get(tier, 0) == expect, (
            f"tier {tier}: {span_tiers.get(tier, 0)} spans vs "
            f"{expect} ladder solves")
    assert sum(span_tiers.values()) > 0

    fb_marks = {}
    for m in d["marks"]:
        if m["kind"] == "fallback":
            key = (m["tier"], m["reason"])
            fb_marks[key] = fb_marks.get(key, 0) + 1
    assert fb_marks, "chaos produced no fallbacks; tune the profile"
    seen_keys = set(fb_marks)
    for key, count in P.metrics.solver_fallbacks._values.items():
        labels = dict(key)
        if count - fallbacks_before.get(key, 0.0):
            seen_keys.add((labels["tier"], labels["reason"]))
    for k in seen_keys:
        key = (("reason", k[1]), ("tier", k[0]))
        delta = (P.metrics.solver_fallbacks._values.get(key, 0.0)
                 - fallbacks_before.get(key, 0.0))
        assert fb_marks.get(k, 0) == delta, (
            f"fallback {k}: {fb_marks.get(k, 0)} marks vs {delta} metric")

    fault_marks = {}
    for m in d["marks"]:
        if m["kind"] == "fault":
            fault_marks[m["point"]] = fault_marks.get(m["point"], 0) + 1
    for point in FaultPoint.ALL:
        assert fault_marks.get(point, 0) == inj.fired_count(point), (
            f"fault {point}: {fault_marks.get(point, 0)} marks vs "
            f"ledger {inj.fired_count(point)}")
    assert fault_marks.get(FaultPoint.DEVICE_SOLVE, 0) > 0
    assert fault_marks.get(FaultPoint.NODE_FLAP, 0) > 0
    assert any(s["carry"] != "reuse" for s in d["spans"] if s["carry"])
    return dict(
        fault_points={p for p, n in fault_marks.items() if n},
        fallback_reasons={_port_name(r) for _t, r in fb_marks},
        solving_tiers={_port_name(t) for t, n in span_tiers.items() if n},
    )


#: the reference's tier names and their port counterparts
_TIER_NAMES = {"pallas": "cuda", "xla": "torch"}


def _port_name(name):
    """A tier, or a fallback reason led by one, under the port's names."""
    head, sep, tail = name.partition("_")
    if head in _TIER_NAMES:
        return _TIER_NAMES[head] + sep + tail
    return name


class TestChaosReconstruction:
    def test_lifecycle_chaos_reconstructs_from_dump(self):
        """The lifecycle-chaos burst (DEVICE_SOLVE at rate 0.5, six
        fires, one attempt per tier, nodes flapping) reconstructs from
        each package's dump alone: spans per solving tier equal the
        ladder's tally, fallback marks equal the metric, fault marks
        equal the injector's ledger. The same fault points fire and the
        same fallback reasons book, on the same solving tiers, in both
        packages (the reference's ``xla`` tier is the port's ``torch``)."""
        want = _chaos_reconstruction("jax")
        got = _chaos_reconstruction("torch")
        assert got["fault_points"] >= {
            port_faults.FaultPoint.DEVICE_SOLVE,
            port_faults.FaultPoint.NODE_FLAP,
        }
        assert got["fallback_reasons"] == want["fallback_reasons"]
        assert got["solving_tiers"] == want["solving_tiers"]


class TestTraceOverheadGuard:
    def test_always_on_spine_under_one_percent(self):
        """The recorder operations of a 1k-pod burst through the port's
        scheduler, costed at the per-operation rate measured on a fresh
        ``FlightRecorder``, stay under 1% of the burst's hot stages
        (pop, pack, solve, download, commit)."""
        server, client, informers, sched = _mk_cluster(
            "torch", num_nodes=64, max_batch=256, retry_attempts=3)
        spans_before = port_fr.RECORDER._next_id
        marks_before = len(port_fr.RECORDER.dump()["marks"])
        stage_before = dict(sched.stage_seconds)
        sched.start()
        for i in range(1000):
            client.create_pod(make_pod(f"ov-{i}").container(
                cpu="10m", memory="16Mi").obj())
        assert _wait_all_bound(client, 120)
        sched.wait_for_inflight_binds()
        sched.stop()
        informers.stop()
        after = sched.stage_seconds
        hot_s = sum(after.get(k, 0.0) - stage_before.get(k, 0.0)
                    for k in HOT)
        n_spans = port_fr.RECORDER._next_id - spans_before
        n_marks = len(port_fr.RECORDER.dump()["marks"]) - marks_before
        assert n_spans > 0 and hot_s > 0
        rec = port_fr.FlightRecorder()
        links = [(f"uid-{i}", 0.001, 1) for i in range(256)]
        span_us = min(_time_span_ops(rec, links, HOT, 1000) for _ in range(3))
        mark_us = min(_time_mark_ops(rec, 5000) for _ in range(3))
        self_s = (n_spans * span_us + max(n_marks, 0) * mark_us) / 1e6
        share = self_s / hot_s
        assert share < 0.01, (
            f"spine self-time {self_s * 1e3:.2f}ms is "
            f"{share * 100:.2f}% of {hot_s * 1e3:.0f}ms hot path")


def _wait_scheduled(client, names, timeout):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(client.get_pod("default", n).spec.node_name for n in names):
            return True
        time.sleep(0.05)
    return False


class TestMetricsEndpointE2E:
    def test_scrape_lints_clean_during_burst(self):
        """The port's ``SchedulerApp`` /metrics after a small burst lints
        clean with the reference's exposition lint, carries the families
        the reference's scrape requires, and serves the flight recorder's
        spans with the port's tiers."""
        app = SchedulerApp(device="cpu")
        host, port = app.start_serving()
        try:
            client = app.client
            for i in range(8):
                client.create_node(make_node(f"n{i}").capacity(
                    cpu="16", memory="32Gi").obj())
            app.start()
            names = [f"m-{i}" for i in range(60)]
            for n in names:
                client.create_pod(make_pod(n).container(cpu="100m").obj())
            assert _wait_scheduled(client, names, 30)
            app.sched.wait_for_inflight_binds()
            port_metrics.faults_injected.inc(
                point='evil "point"\\with\nnewline')
            base = f"http://{host}:{port}"
            body = urllib.request.urlopen(base + "/metrics").read().decode()
            _families, problems = _lint_exposition(body)
            assert not problems, problems[:10]
            for family in (
                "scheduler_tpu_state_uploads_total",
                "scheduler_pod_to_bind_quantile_seconds",
                "scheduler_tpu_bisections_total",
                "scheduler_tpu_bisect_subsolves_total",
                "scheduler_ladder_exhausted_crashloops_total",
                "scheduler_quarantine_pods_total",
                "scheduler_quarantine_parked",
                "scheduler_quarantine_releases_total",
                "scheduler_tpu_carry_audit_sweeps_total",
                "scheduler_tpu_carry_audit_mismatches_total",
                "scheduler_tpu_device_lost_total",
                "scheduler_tpu_device_rebuild_ms",
                "scheduler_quota_admissions_total",
                "scheduler_quota_refunds_total",
                "scheduler_quota_parked",
                "scheduler_quota_releases_total",
                "scheduler_tenant_dominant_share",
                "scheduler_hollow_acks_total",
                "scheduler_hollow_heartbeats_total",
                "scheduler_bind_acks_total",
                "scheduler_bind_ack_latency_seconds",
                "scheduler_bind_ack_timeouts_total",
                "scheduler_rebinds_total",
                "scheduler_bind_ack_pending",
                "scheduler_bind_ack_suspect_nodes_tainted_total",
                "scheduler_node_heartbeat_lapses_total",
                "scheduler_taint_evictions_total",
                "scheduler_speculative_launches_total",
                "scheduler_speculative_rewinds_total",
                "scheduler_tpu_carry_compressed",
                "scheduler_tpu_carry_compress_bytes_saved_total",
                "scheduler_tpu_carry_compress_disengages_total",
                "scheduler_tpu_jit_compiles_total",
            ):
                assert family in body, family
            assert 'q="0.99"' in body
            assert port_metrics.pod_to_bind_quantile.value(q="0.99") > 0.0
            doc = json.loads(urllib.request.urlopen(
                base + "/debug/flightrecorder").read().decode())
            assert isinstance(doc["spans"], list)
            assert isinstance(doc["marks"], list)
            assert any(s["tier"] in PKG["torch"].solving
                       for s in doc["spans"])
        finally:
            app.stop()


class TestSchedulerApp:
    def test_healthz_metrics_and_scheduling(self):
        app = SchedulerApp(device="cpu")
        host, port = app.start_serving()
        try:
            client = app.client
            client.create_node(
                make_node("n").capacity(cpu="8", memory="16Gi").obj())
            app.start()
            client.create_pod(make_pod("p").container(cpu="1").obj())
            assert _wait_scheduled(client, ["p"], 10)
            app.sched.wait_for_inflight_binds()
            base = f"http://{host}:{port}"
            assert urllib.request.urlopen(base + "/healthz").read() == b"ok"
            body = urllib.request.urlopen(base + "/metrics").read().decode()
            assert ('scheduler_schedule_attempts_total{result="scheduled"}'
                    in body)
            assert "scheduler_scheduler_cache_size" in body
            dump = urllib.request.urlopen(
                base + "/debug/cache").read().decode()
            assert "node n" in dump
        finally:
            app.stop()

    def test_cache_comparer_consistent(self):
        app = SchedulerApp(device="cpu")
        try:
            client = app.client
            client.create_node(
                make_node("n").capacity(cpu="4", memory="8Gi").obj())
            app.start()
            client.create_pod(make_pod("p").container(cpu="1").obj())
            assert _wait_scheduled(client, ["p"], 10)
            app.sched.wait_for_inflight_binds()
            time.sleep(0.3)  # let informer events settle into the cache
            result = app.debugger.comparer.compare()
            assert all(not v for v in result.values()), result
            assert not app.debugger.tensor_comparer.compare()
        finally:
            app.stop()
