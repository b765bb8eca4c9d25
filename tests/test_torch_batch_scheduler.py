"""The batch scheduler's routing, on the CPU, in both packages.

Twins of every case of ``tests/test_batch_scheduler.py``: each scenario
runs through the JAX package's ``new_scheduler(..., batch=True)`` and
through the port's (``device="cpu"``), each package is held to the
reference's assertions, and the values those assertions read are
compared across the packages. Where the reference's test reads a
placement, the placements compare pod for pod: the sequential path's
score ties are seeded alike in both packages (``rng=random.Random``).

- the burst on the device, an infeasible pod recorded unschedulable,
  fallback pods routed to the sequential path, the selector and taint
  static mask;
- an unknown extended resource, tolerate-everything, a fallback pod not
  jumping a high-priority solver pod;
- an existing pod's required anti-affinity, nominated capacity not
  stolen, a constrained batch with a nominee taking the host path;
- the event stream's resident carry against a fresh full pack;
- ``solver_supported``: the reference's eight cases (nine pods) as one
  parametrised test, each pod asked of both packages;
- the eager download. The port's ``_EagerDownload`` takes a torch
  tensor: the round trip downloads ``torch.arange(16, dtype=torch.int32)``
  and the error case hands it a tensor whose ``.cpu()`` raises (a failed
  copy off the card), beside the reference's object whose
  ``__array__`` raises.
"""

import random
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.types as jax_types
import kubernetes_tpu.cache.snapshot as jax_snapshot
import kubernetes_tpu.scheduler.batch as jax_batch
import kubernetes_tpu.tensors as jax_tensors
import kubernetes_tpu_torch.api.types as port_types
import kubernetes_tpu_torch.cache.snapshot as port_snapshot
import kubernetes_tpu_torch.scheduler.batch as port_batch
import kubernetes_tpu_torch.tensors as port_tensors
from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.scheduler.batch import _to_host
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

PKG = {
    "jax": SimpleNamespace(
        server=JaxAPIServer, client=JaxClient, informers=JaxInformers,
        new=jax_new, node=jax_node, pod=jax_pod, types=jax_types,
        batch=jax_batch, Snapshot=jax_snapshot.Snapshot,
        NodeTensorCache=jax_tensors.NodeTensorCache,
        host=np.asarray, kw={},
    ),
    "torch": SimpleNamespace(
        server=APIServer, client=Client, informers=InformerFactory,
        new=new_scheduler, node=make_node, pod=make_pod, types=port_types,
        batch=port_batch, Snapshot=port_snapshot.Snapshot,
        NodeTensorCache=port_tensors.NodeTensorCache,
        host=_to_host, kw={"device": "cpu"},
    ),
}
BOTH = ("jax", "torch")
SEED = 7


def _wait_all_bound(client, count, timeout=30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        bound = [p for p in pods if p.spec.node_name]
        if len(bound) >= count:
            return pods
        time.sleep(0.05)
    raise AssertionError(
        f"only {len([p for p in client.list_pods()[0] if p.spec.node_name])}"
        f"/{count} pods bound"
    )


def _stack(pkg, max_batch=64):
    P = PKG[pkg]
    server = P.server()
    client = P.client(server)
    informers = P.informers(server)
    sched = P.new(client, informers, batch=True, max_batch=max_batch,
                  rng=random.Random(SEED), **P.kw)
    return SimpleNamespace(P=P, server=server, client=client,
                           informers=informers, sched=sched)


def _both(scenario, max_batch=64):
    """Run ``scenario(stack)`` once per package, each on a fresh stack;
    returns {pkg: what the scenario returned}."""
    out = {}
    for pkg in BOTH:
        s = _stack(pkg, max_batch)
        try:
            out[pkg] = scenario(s)
        finally:
            s.sched.stop()
            s.informers.stop()
    return out


def _start(s):
    s.informers.start()
    s.informers.wait_for_cache_sync()
    s.sched.queue.run()


def _placed(client):
    return {p.metadata.name: p.spec.node_name for p in client.list_pods()[0]}


class TestBatchScheduling:
    def test_burst_scheduled_on_device(self):
        def scenario(s):
            for i in range(8):
                s.client.create_node(s.P.node(f"n{i}").capacity(
                    cpu="8", memory="16Gi", pods=30).obj())
            _start(s)
            for i in range(40):
                s.client.create_pod(s.P.pod(f"p{i}").container(
                    cpu="250m", memory="256Mi").obj())
            s.sched.start()
            pods = _wait_all_bound(s.client, 40)
            s.sched.wait_for_inflight_binds()
            assert s.sched.pods_solved_on_device >= 40
            assert s.sched.pods_fallback == 0
            per_node = {}
            for p in pods:
                per_node[p.spec.node_name] = per_node.get(
                    p.spec.node_name, 0) + 1
            assert all(v <= 30 for v in per_node.values())
            return (s.sched.pods_solved_on_device, s.sched.pods_fallback,
                    sum(per_node.values()))

        got = _both(scenario)
        assert got["torch"] == got["jax"]

    def test_infeasible_pod_recorded_unschedulable(self):
        def scenario(s):
            s.client.create_node(
                s.P.node("n").capacity(cpu="1", memory="1Gi").obj())
            _start(s)
            s.client.create_pod(
                s.P.pod("big").container(cpu="64", memory="1Ti").obj())
            s.client.create_pod(s.P.pod("ok").container(cpu="500m").obj())
            s.sched.start()
            _wait_all_bound(s.client, 1)
            s.sched.wait_for_inflight_binds()
            deadline = time.time() + 5
            big = None
            while time.time() < deadline:
                big = s.client.get_pod("default", "big")
                if any(c.type == "PodScheduled" and c.status == "False"
                       for c in big.status.conditions):
                    break
                time.sleep(0.05)
            assert big is not None
            assert not big.spec.node_name
            reasons = [c.reason for c in big.status.conditions
                       if c.type == "PodScheduled" and c.status == "False"]
            assert "Unschedulable" in reasons
            return _placed(s.client), "Unschedulable"

        got = _both(scenario)
        assert got["torch"] == got["jax"]

    def test_fallback_pods_routed_to_sequential_path(self):
        def scenario(s):
            for name, zone in [("a", "z1"), ("b", "z2")]:
                s.client.create_node(s.P.node(name).labels(zone=zone)
                                     .capacity(cpu="8", memory="16Gi",
                                               pods=20).obj())
            _start(s)
            for i in range(4):
                s.client.create_pod(
                    s.P.pod(f"s{i}").labels(app="s").container(cpu="100m")
                    .gce_pd(f"disk-{i}").obj())
            for i in range(4):
                s.client.create_pod(
                    s.P.pod(f"r{i}").container(cpu="100m").obj())
            s.sched.start()
            _wait_all_bound(s.client, 8)
            s.sched.wait_for_inflight_binds()
            assert s.sched.pods_fallback >= 4
            assert s.sched.pods_solved_on_device >= 4
            return s.sched.pods_fallback, s.sched.pods_solved_on_device

        got = _both(scenario)
        assert got["torch"] == got["jax"]

    def test_node_selector_respected_via_static_mask(self):
        def scenario(s):
            s.client.create_node(s.P.node("gpu").labels(pool="gpu")
                                 .capacity(cpu="8", memory="16Gi").obj())
            s.client.create_node(s.P.node("cpu").labels(pool="cpu")
                                 .capacity(cpu="64", memory="128Gi").obj())
            _start(s)
            for i in range(3):
                s.client.create_pod(s.P.pod(f"g{i}").container(cpu="1")
                                    .node_selector(pool="gpu").obj())
            s.sched.start()
            pods = _wait_all_bound(s.client, 3)
            for p in pods:
                assert p.spec.node_name == "gpu"
            return _placed(s.client)

        got = _both(scenario)
        assert got["torch"] == got["jax"]

    def test_tainted_node_avoided(self):
        def scenario(s):
            s.client.create_node(s.P.node("t").taint("dedicated", "infra")
                                 .capacity(cpu="64", memory="64Gi").obj())
            s.client.create_node(
                s.P.node("ok").capacity(cpu="2", memory="4Gi").obj())
            _start(s)
            for i in range(3):
                s.client.create_pod(
                    s.P.pod(f"p{i}").container(cpu="100m").obj())
            s.client.create_pod(
                s.P.pod("tolerant").container(cpu="100m")
                .toleration("dedicated", value="infra").obj())
            s.sched.start()
            pods = _wait_all_bound(s.client, 4)
            s.sched.wait_for_inflight_binds()
            for p in pods:
                if p.name != "tolerant":
                    assert p.spec.node_name == "ok"
            return {n: v for n, v in _placed(s.client).items()
                    if n != "tolerant"}

        got = _both(scenario)
        assert got["torch"] == got["jax"]


class TestRegressions:
    def test_unknown_extended_resource_is_unschedulable_not_crash(self):
        def scenario(s):
            s.client.create_node(
                s.P.node("n").capacity(cpu="8", memory="16Gi").obj())
            s.informers.start()
            s.informers.wait_for_cache_sync()
            s.client.create_pod(s.P.pod("gpu").container(
                cpu="1", **{"example_com__gpu": 2}).obj())
            s.client.create_pod(s.P.pod("ok").container(cpu="1").obj())
            s.sched.start()
            _wait_all_bound(s.client, 1)
            s.sched.wait_for_inflight_binds()
            assert not s.client.get_pod("default", "gpu").spec.node_name
            assert s.client.get_pod("default", "ok").spec.node_name == "n"
            return _placed(s.client)

        got = _both(scenario)
        assert got["torch"] == got["jax"]

    def test_tolerate_everything_admits_cordoned_node(self):
        def scenario(s):
            s.client.create_node(s.P.node("c").capacity(
                cpu="8", memory="16Gi").unschedulable().obj())
            s.informers.start()
            s.informers.wait_for_cache_sync()
            p = s.P.pod("t").container(cpu="1").obj()
            p.spec.tolerations.append(
                s.P.types.Toleration(key="", operator="Exists"))
            s.client.create_pod(p)
            s.sched.start()
            pods = _wait_all_bound(s.client, 1)
            s.sched.wait_for_inflight_binds()
            assert pods[0].spec.node_name == "c"
            return _placed(s.client)

        got = _both(scenario)
        assert got["torch"] == got["jax"]

    def test_fallback_does_not_jump_high_priority_solver_pod(self):
        def scenario(s):
            s.client.create_node(
                s.P.node("n").capacity(cpu="1", memory="4Gi").obj())
            s.informers.start()
            s.informers.wait_for_cache_sync()
            high = s.P.pod("high").container(cpu="1").obj()
            high.spec.priority = 100
            low = (
                s.P.pod("low").labels(app="low").container(cpu="1")
                .spread_constraint(1, "zone", match_labels={"app": "low"})
                .obj()
            )
            s.client.create_pod(high)
            s.client.create_pod(low)
            s.sched.start()
            _wait_all_bound(s.client, 1)
            s.sched.wait_for_inflight_binds()
            assert s.client.get_pod("default", "high").spec.node_name == "n"
            assert not s.client.get_pod("default", "low").spec.node_name
            return _placed(s.client)

        got = _both(scenario)
        assert got["torch"] == got["jax"]


class TestExistingAntiAffinityGate:
    def test_existing_required_anti_affinity_respected(self):
        """A pod with no affinity of its own honours the required
        anti-affinity of a pod already on a node."""

        def scenario(s):
            for name in ("a", "b"):
                s.client.create_node(s.P.node(name).labels(host=name)
                                     .capacity(cpu="8", memory="16Gi").obj())
            s.informers.start()
            s.informers.wait_for_cache_sync()
            s.client.create_pod(
                s.P.pod("guard").labels(app="guard").container(cpu="100m")
                .pod_affinity("host", {"app": "web"}, anti=True).obj())
            s.sched.start()
            _wait_all_bound(s.client, 1)
            s.sched.wait_for_inflight_binds()
            guard_node = s.client.get_pod("default", "guard").spec.node_name
            for i in range(4):
                s.client.create_pod(s.P.pod(f"web-{i}").labels(app="web")
                                    .container(cpu="100m").obj())
            pods = _wait_all_bound(s.client, 5)
            s.sched.wait_for_inflight_binds()
            for p in pods:
                if p.name.startswith("web"):
                    assert p.spec.node_name != guard_node, p.name
            return _placed(s.client)

        got = _both(scenario)
        assert got["torch"] == got["jax"]


class TestNominatedOverlay:
    def test_batch_does_not_steal_nominated_capacity(self):
        """Capacity freed by preemption stays reserved for the nominee."""

        def scenario(s):
            s.client.create_node(
                s.P.node("n").capacity(cpu="2", memory="8Gi").obj())
            s.informers.start()
            s.informers.wait_for_cache_sync()
            for i in range(2):
                s.client.create_pod(
                    s.P.pod(f"low{i}").container(cpu="1").obj())
            s.sched.start()
            _wait_all_bound(s.client, 2)
            s.sched.wait_for_inflight_binds()
            high = s.P.pod("high").container(cpu="2").obj()
            high.spec.priority = 100
            s.client.create_pod(high)
            deadline = time.time() + 15
            while time.time() < deadline:
                if s.client.get_pod("default", "high").spec.node_name:
                    break
                time.sleep(0.2)
                s.client.create_pod(
                    s.P.pod(f"opportunist-{time.monotonic_ns()}")
                    .container(cpu="1").obj())
            s.sched.stop()
            node = s.client.get_pod("default", "high").spec.node_name
            assert node == "n", "nominee starved by batch pods"
            return node

        got = _both(scenario)
        assert got["torch"] == got["jax"]


# the reference's TestSolverSupported cases, one pod each (its affinity
# case asks two pods), with the answer it asserts
SOLVER_SUPPORTED = {
    "plain_pod": (lambda mk: mk("p").container(cpu="1"), True),
    "required_affinity": (
        lambda mk: mk("p").pod_affinity("zone", {"a": "b"}), True),
    "required_anti_affinity": (
        lambda mk: mk("p").pod_affinity("zone", {"a": "b"}, anti=True), True),
    "preferred_affinity": (
        lambda mk: mk("p").preferred_pod_affinity("zone", {"a": "b"}), True),
    "hard_spread": (lambda mk: mk("p").spread_constraint(1, "zone"), True),
    "soft_spread": (
        lambda mk: mk("p").spread_constraint(
            1, "zone", when_unsatisfiable="ScheduleAnyway"), True),
    "hard_spread_plus_node_selector": (
        lambda mk: mk("p").spread_constraint(1, "zone")
        .node_selector(pool="x"), True),
    "soft_spread_plus_node_selector": (
        lambda mk: mk("p").spread_constraint(
            1, "zone", when_unsatisfiable="ScheduleAnyway")
        .node_selector(pool="x"), False),
    "node_selector": (lambda mk: mk("p").node_selector(pool="x"), True),
}


@pytest.mark.parametrize("case", sorted(SOLVER_SUPPORTED))
def test_solver_supported(case):
    build, want = SOLVER_SUPPORTED[case]
    got = {pkg: PKG[pkg].batch.solver_supported(build(PKG[pkg].pod).obj())
           for pkg in BOTH}
    assert got == {"jax": want, "torch": want}


class TestNomineeConstrainedFallback:
    def test_constrained_batch_with_nominee_takes_host_path(self):
        """A constrained batch (anti-affinity) under an active nomination
        routes to the host path, where the nominee's full filter
        semantics run."""

        def scenario(s):
            for i in range(3):
                s.client.create_node(s.P.node(f"n{i}").labels(zone=f"z{i}")
                                     .capacity(cpu="8", memory="16Gi").obj())
            _start(s)
            nominee = s.P.pod("nominee").container(cpu="1").priority(50).obj()
            s.sched.queue.update_nominated_pod_for_node(nominee, "n0")
            s.client.create_pod(
                s.P.pod("anti").labels(app="a")
                .container(cpu="100m", memory="128Mi")
                .pod_affinity("zone", {"app": "a"}, anti=True).obj())
            deadline = time.time() + 15
            while time.time() < deadline:
                s.sched.schedule_batch(timeout=0.2)
                if any(p.spec.node_name for p in s.client.list_pods()[0]):
                    break
            s.sched.wait_for_inflight_binds()
            assert any(p.spec.node_name for p in s.client.list_pods()[0])
            assert s.sched.nominee_constrained_fallbacks >= 1
            assert s.sched.pods_fallback >= 1
            return (_placed(s.client), s.sched.nominee_constrained_fallbacks,
                    s.sched.pods_fallback)

        got = _both(scenario, max_batch=16)
        assert got["torch"] == got["jax"]


class TestDeviceStateDifferential:
    def test_event_stream_device_state_matches_full_pack(self, monkeypatch):
        """After batches with interleaved node churn, bind failures and
        schema growth, the resident carry equals a fresh full pack of the
        host snapshot in both packages, and both drove the row scatter
        and counted a divergence."""

        def scenario(s):
            P, client, sched = s.P, s.client, s.sched
            rng = random.Random(20260803)
            for i in range(8):
                client.create_node(P.node(f"ds-n{i}").capacity(
                    cpu="64", memory="128Gi", pods=200).obj())
            _start(s)
            orig_bulk = client.bind_assumed_bulk
            calls = {"n": 0}

            def flaky_bulk(assumed):
                calls["n"] += 1
                if calls["n"] % 4 == 0 and assumed:
                    errs = orig_bulk(assumed[1:])
                    return [(0, RuntimeError("synthetic bind failure"))] + [
                        (i + 1, e) for i, e in errs
                    ]
                return orig_bulk(assumed)

            monkeypatch.setattr(client, "bind_assumed_bulk", flaky_bulk)

            def one_batch():
                deadline = time.time() + 10
                while time.time() < deadline:
                    if sched.schedule_batch(timeout=0.2):
                        break

            seq = 0
            for k in range(12):
                for _ in range(rng.randint(3, 8)):
                    seq += 1
                    client.create_pod(P.pod(f"ds-p{seq}").container(
                        cpu=f"{rng.choice([100, 250, 500])}m",
                        memory="128Mi").obj())
                if k % 3 == 2:
                    bound = [p for p in client.list_pods()[0]
                             if p.spec.node_name]
                    if bound:
                        victim = rng.choice(bound)
                        client.delete_pod(victim.metadata.namespace,
                                          victim.metadata.name)
                if k == 5:
                    client.create_node(P.node("ds-gpu").capacity(
                        cpu="8", memory="16Gi",
                        **{"example_com__gpu": 4}).obj())
                deadline = time.time() + 5
                while time.time() < deadline:
                    if sched.schedule_batch(timeout=0.2):
                        break
            monkeypatch.setattr(client, "bind_assumed_bulk", orig_bulk)
            for _ in range(10):
                sched.schedule_batch(timeout=0.1)
            sched.wait_for_inflight_binds(timeout=30)
            for _ in range(5):
                sched.schedule_batch(timeout=0.1)
            sched.wait_for_inflight_binds(timeout=30)
            client.create_pod(P.pod("ds-final").container(
                cpu="100m", memory="64Mi").obj())
            one_batch()
            sched.wait_for_inflight_binds(timeout=30)

            # phase A: allocatable growth rides the row scatter
            node = client.get_node("ds-n0")
            node.status.capacity["cpu"] += 1000
            node.status.allocatable["cpu"] += 1000
            client.update_node(node)
            deadline = time.time() + 10
            while time.time() < deadline:
                ni = sched.cache._nodes.get("ds-n0")
                if ni is not None and ni.allocatable.milli_cpu == 65000:
                    break
                time.sleep(0.02)
            uploads_before = sched.state_uploads
            delta_before = sched.delta_rows_uploaded
            client.create_pod(P.pod("ds-final2").container(
                cpu="100m", memory="64Mi").obj())
            one_batch()
            sched.wait_for_inflight_binds(timeout=30)
            assert sched.delta_rows_uploaded > delta_before
            assert sched.state_uploads == uploads_before

            # phase B: an external delete is a counted divergence
            bound = [p for p in client.list_pods()[0] if p.spec.node_name]
            victim = bound[0]
            vnode = victim.spec.node_name
            client.delete_pod(victim.metadata.namespace,
                              victim.metadata.name)
            deadline = time.time() + 10
            while time.time() < deadline:
                ni = sched.cache._nodes.get(vnode)
                if ni is not None and all(
                    p.metadata.uid != victim.metadata.uid for p in ni.pods
                ):
                    break
                time.sleep(0.02)
            div_before = sched.carry_divergences
            client.create_pod(P.pod("ds-final3").container(
                cpu="100m", memory="64Mi").obj())
            one_batch()
            sched.wait_for_inflight_binds(timeout=30)
            assert sched.carry_divergences > div_before

            ds = sched._dev
            assert ds.req_dev is not None, "device carry was dropped"
            dev_req = P.host(ds.req_dev)
            dev_nzr = P.host(ds.nzr_dev)
            names = sched.tensor_cache._names
            snap2 = P.Snapshot()
            sched.cache.update_snapshot(snap2)
            fresh = P.NodeTensorCache(
                sched.tensor_cache.dims, sched.tensor_cache.topology
            ).update(snap2)
            assert sorted(fresh.names) == sorted(names)
            for name in names:
                i, j = names.index(name), fresh.row(name)
                assert np.array_equal(dev_req[i], fresh.requested[j]), name
                assert np.array_equal(
                    dev_nzr[i], fresh.non_zero_requested[j]), name
            assert sched.delta_rows_uploaded > 0
            assert sched.carry_divergences > 0
            assert calls["n"] >= 4
            return sorted(names)

        got = _both(scenario, max_batch=32)
        assert got["torch"] == got["jax"]


class _FailedCopy(torch.Tensor):
    """A tensor whose copy to the host fails, as a lost card's would."""

    def cpu(self, *args, **kwargs):
        raise RuntimeError("serving link down")


class _Boom:
    def __array__(self, *a, **k):
        raise RuntimeError("serving link down")


class TestEagerDownload:
    def test_eager_download_result_roundtrip(self):
        import jax.numpy as jnp

        outs = {}
        for pkg, dev in (("jax", jnp.arange(16, dtype=jnp.int32)),
                         ("torch", torch.arange(16, dtype=torch.int32))):
            dl = PKG[pkg].batch._EagerDownload(dev)
            out = dl.result()
            assert isinstance(out, np.ndarray)
            assert out.tolist() == list(range(16))
            assert dl.result() is out  # idempotent
            outs[pkg] = out
        assert outs["torch"].dtype == outs["jax"].dtype == np.int32

    def test_eager_download_propagates_errors(self):
        failing = torch.arange(4, dtype=torch.int32).as_subclass(_FailedCopy)
        for pkg, dev in (("jax", _Boom()), ("torch", failing),
                         ("torch", _Boom())):
            dl = PKG[pkg].batch._EagerDownload(dev)
            with pytest.raises(RuntimeError, match="serving link down"):
                dl.result()

    def test_pipeline_binds_with_eager_downloads_forced(self, monkeypatch):
        """The dispatch -> commit flow with the eager path forced on in
        both packages."""

        def scenario(s):
            monkeypatch.setattr(s.P.batch, "_EAGER_DOWNLOAD_OK", True)
            for i in range(6):
                s.client.create_node(s.P.node(f"ed-n{i}").capacity(
                    cpu="8", memory="16Gi", pods=32).obj())
            s.informers.start()
            s.informers.wait_for_cache_sync()
            for i in range(40):
                s.client.create_pod(s.P.pod(f"ed-p{i}").container(
                    cpu="100m", memory="128Mi").obj())
            s.sched.queue.run()
            deadline = time.time() + 30
            done = 0
            while done < 40 and time.time() < deadline:
                done += s.sched.schedule_batch(timeout=0.5, pipeline=True)
            s.sched._drain_pending()
            s.sched.wait_for_inflight_binds(timeout=30)
            _wait_all_bound(s.client, 40)
            assert s.sched.pods_solved_on_device == 40
            assert s.sched.pods_fallback == 0
            return _placed(s.client)

        got = _both(scenario)
        assert got["torch"] == got["jax"]
