"""The port's batch scheduler on a node-sharded CPU mesh, against the JAX
package's scheduler on its virtual-device mesh and against the port on
one device -- the counterparts of tests/test_mesh_state_guard.py:

- a steady 1k-pod burst on a 2-shard mesh places exactly as the port's
  single-device run and as the JAX mesh run, with at most one full
  node-state upload and zero carry divergences;
- the randomized event-stream differential (external deletes, a bind
  failure, a node joining mid-stream) leaves every shard's resident
  ``req_state`` equal to a fresh pack of the settled snapshot, per node
  name, with membership riding the shard-local slot scatter;
- an injected device-solve fault steps the CPU mesh down to the
  ``host_greedy`` tier, whose placements keep the sharded carry exact;
- ``new_scheduler_from_config`` with ``meshDevices: 2`` builds the mesh.

Placements are compared pod for pod: the tolerance is zero.
"""

import random
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.scheduler.scheduler import new_scheduler as jax_new
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.ops.mesh import NodeMesh, ShardedRows
from kubernetes_tpu_torch.scheduler.scheduler import (
    new_scheduler,
    new_scheduler_from_config,
)
from kubernetes_tpu_torch.testing import make_node, make_pod

NUM_NODES = 16
NUM_PODS = 1000

STACKS = {
    "jax": (JaxAPIServer, JaxClient, JaxInformers, jax_new, jax_node, jax_pod),
    "torch": (APIServer, Client, InformerFactory, new_scheduler, make_node,
              make_pod),
}


class _KeepFirstRng:
    """The sequential path's tie-break keeps the first candidate, as the
    device argmax's lowest index does."""

    def randrange(self, n):
        return 1 if n > 1 else 0

    def randint(self, a, b):
        return b


def _wait_all_bound(client, count, timeout=180.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if sum(1 for p in pods if p.spec.node_name) >= count:
            return
        time.sleep(0.05)
    bound = sum(1 for p in client.list_pods()[0] if p.spec.node_name)
    raise AssertionError(f"only {bound}/{count} pods bound")


def _burst(stack, seed, **kw):
    """A seeded 1k-pod burst through one stack's entry points, after
    warmup; returns (placements, scheduler)."""
    Server, Cl, Informers, new, mk_node, mk_pod = STACKS[stack]
    rng = random.Random(seed)
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    sched = new(client, informers, batch=True, max_batch=256,
                rng=_KeepFirstRng(), **kw)
    for i in range(NUM_NODES):
        client.create_node(
            mk_node(f"m{i}").capacity(cpu="64", memory="256Gi", pods=120)
            .obj()
        )
    pods = [
        mk_pod(f"b{i}").creation_timestamp(float(i)).container(
            cpu=f"{rng.choice([100, 200, 250])}m",
            memory=f"{rng.choice([128, 256])}Mi",
        ).obj()
        for i in range(NUM_PODS)
    ]
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.warmup()
    try:
        for lo in range(0, NUM_PODS, 100):
            client.create_pods_bulk(pods[lo:lo + 100])
        sched.start()
        _wait_all_bound(client, NUM_PODS)
        sched.wait_for_inflight_binds()
        return {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }, sched
    finally:
        sched.stop()
        informers.stop()


def test_mesh_burst_places_like_one_device_and_the_jax_mesh():
    jmesh = Mesh(np.array(jax.devices()[:2]), axis_names=("nodes",))
    want_jax, _ = _burst("jax", 42, mesh=jmesh)
    want_one, _ = _burst("torch", 42, device="cpu")
    got, sched = _burst("torch", 42, mesh=NodeMesh(["cpu"] * 2))
    assert all(got.values())
    assert got == want_one
    assert got == want_jax
    assert sched.device == torch.device("cpu")
    assert sched.mesh_solver_tier == "torch"
    assert sched.pods_fallback == 0
    assert sched.pods_solved_on_device == NUM_PODS
    assert sched.batches_solved >= 2
    assert sched.state_uploads <= 1
    assert sched.state_reuses >= sched.batches_solved - 1
    assert sched.carry_divergences == 0
    assert sched.delta_rows_uploaded == 0
    assert not sched.carry_compress_enabled  # off on a mesh
    ds = sched._dev
    assert isinstance(ds.req_dev, ShardedRows)
    assert [s.shape[0] for s in ds.req_dev.shards] == [
        ds.req_dev.shape[0] // 2
    ] * 2
    tiers = sched.ladder.solves_by_tier
    assert tiers["torch"] > 0
    assert tiers["cuda"] == tiers["host_greedy"] == tiers["sequential"] == 0


def test_mesh_event_stream_differential_sharded_carry(monkeypatch):
    from kubernetes_tpu_torch.cache.snapshot import Snapshot
    from kubernetes_tpu_torch.tensors import NodeTensorCache

    rng = random.Random(20260803)
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler(
        client, informers, batch=True, max_batch=32,
        mesh=NodeMesh(["cpu"] * 2),
    )
    for i in range(8):
        client.create_node(
            make_node(f"dm-n{i}").capacity(cpu="64", memory="128Gi", pods=200)
            .obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()

    orig_bulk = client.bind_assumed_bulk
    calls = {"n": 0}

    def flaky_bulk(assumed):
        calls["n"] += 1
        if calls["n"] == 3 and assumed:
            errs = orig_bulk(assumed[1:])
            return [(0, RuntimeError("synthetic bind failure"))] + [
                (i + 1, e) for i, e in errs
            ]
        return orig_bulk(assumed)

    monkeypatch.setattr(client, "bind_assumed_bulk", flaky_bulk)
    seq = 0
    uploads_after_cold = None
    try:
        for k in range(8):
            for _ in range(rng.randint(3, 8)):
                seq += 1
                client.create_pod(
                    make_pod(f"dm-p{seq}").container(
                        cpu=f"{rng.choice([100, 250, 500])}m",
                        memory="128Mi",
                    ).obj()
                )
            if k == 3:
                bound = [p for p in client.list_pods()[0] if p.spec.node_name]
                if bound:
                    victim = rng.choice(bound)
                    client.delete_pod(
                        victim.metadata.namespace, victim.metadata.name
                    )
            if k == 5:
                client.create_node(
                    make_node("dm-cold")
                    .capacity(cpu="64", memory="128Gi", pods=200).obj()
                )
                deadline = time.time() + 10
                while time.time() < deadline:
                    if "dm-cold" in sched.cache._nodes:
                        break
                    time.sleep(0.02)
                uploads_after_cold = sched.state_uploads
            deadline = time.time() + 30
            while time.time() < deadline:
                if sched.schedule_batch(timeout=0.2):
                    break
        monkeypatch.setattr(client, "bind_assumed_bulk", orig_bulk)
        for _ in range(10):
            sched.schedule_batch(timeout=0.1)
        sched.wait_for_inflight_binds(timeout=60)
        client.create_pod(
            make_pod("dm-final").container(cpu="100m", memory="64Mi").obj()
        )
        deadline = time.time() + 30
        while time.time() < deadline:
            if sched.schedule_batch(timeout=0.2):
                break
        sched.wait_for_inflight_binds(timeout=60)

        ds = sched._dev
        assert isinstance(ds.req_dev, ShardedRows), "the carry was dropped"
        assert len(ds.req_dev.shards) == 2
        assert isinstance(ds.alloc_dev, ShardedRows)
        assert uploads_after_cold is not None
        assert sched.state_uploads == uploads_after_cold
        assert sched.membership_row_patches >= 1
        dev_req = ds.req_dev.numpy()
        dev_nzr = ds.nzr_dev.numpy()
        names = sched.tensor_cache._names
        snap2 = Snapshot()
        sched.cache.update_snapshot(snap2)
        fresh = NodeTensorCache(
            sched.tensor_cache.dims, sched.tensor_cache.topology
        ).update(snap2)
        assert sorted(n for n in names if n) == sorted(fresh.names)
        for name in names:
            if not name:
                continue
            i = names.index(name)
            j = fresh.row(name)
            np.testing.assert_array_equal(dev_req[i], fresh.requested[j])
            np.testing.assert_array_equal(
                dev_nzr[i], fresh.non_zero_requested[j]
            )
        assert calls["n"] >= 3
        assert sched.pods_fallback == 0
        assert sched.mesh_solver_tier == "torch"
        assert sched.audit_carry() == "clean"
    finally:
        sched.stop()
        informers.stop()


def test_device_fault_steps_a_cpu_mesh_down_to_host_greedy():
    """Every retry of the torch tier faults for the second batch: it
    lands on host_greedy, which keeps the sharded carry warm through
    apply_assignment_delta; the carry still equals the shadow (the audit
    is clean, an injected corruption is caught), and every pod places as
    on one device."""
    from kubernetes_tpu_torch.robustness.faults import (
        FaultInjector,
        FaultPoint,
        FaultProfile,
        PointConfig,
        install_injector,
    )

    def run(**kw):
        server = APIServer()
        client = Client(server)
        informers = InformerFactory(server)
        sched = new_scheduler(client, informers, batch=True, max_batch=64,
                              rng=_KeepFirstRng(), **kw)
        for i in range(6):
            client.create_node(
                make_node(f"f{i}").capacity(cpu="8", memory="16Gi", pods=50)
                .obj()
            )
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        rng = random.Random(3)
        total = 0
        try:
            for wave in range(3):
                if wave == 1 and "mesh" in kw:
                    install_injector(FaultInjector(FaultProfile(
                        name="mesh-fault", seed=0,
                        points={FaultPoint.DEVICE_SOLVE: PointConfig(
                            rate=1.0,
                            max_fires=sched.ladder.config.retry.max_attempts,
                        )},
                    )))
                pods = [
                    make_pod(f"w{wave}-{i}")
                    .creation_timestamp(float(total + i))
                    .container(cpu=f"{rng.choice([100, 250, 500])}m",
                               memory="256Mi").obj()
                    for i in range(40)
                ]
                total += len(pods)
                client.create_pods_bulk(pods)
                time.sleep(0.2)
                deadline = time.time() + 30
                while time.time() < deadline:
                    sched.schedule_batch(timeout=0.2)
                    if sum(1 for p in client.list_pods()[0]
                           if p.spec.node_name) >= total:
                        break
                install_injector(None)
            sched.wait_for_inflight_binds(timeout=60)
            placed = {
                p.metadata.name: p.spec.node_name
                for p in client.list_pods()[0]
            }
            return placed, sched
        finally:
            install_injector(None)
            sched.stop()
            informers.stop()

    want, _ = run(device="cpu")
    got, sched = run(mesh=NodeMesh(["cpu"] * 2))
    assert all(got.values())
    assert got == want
    tiers = sched.ladder.solves_by_tier
    assert tiers["host_greedy"] >= 1, tiers
    assert tiers["torch"] >= 2, tiers
    assert sched.pods_fallback == 0
    assert sched.state_uploads <= 1
    assert sched.carry_divergences == 0
    ds = sched._dev
    assert isinstance(ds.req_dev, ShardedRows)
    np.testing.assert_array_equal(ds.req_dev.numpy(), ds.req_shadow)
    np.testing.assert_array_equal(ds.nzr_dev.numpy(), ds.nzr_shadow)
    assert sched.audit_carry() == "clean"
    sched._corrupt_carry_row()
    assert sched.audit_carry() == "mismatch"
    assert ds.req_dev is None  # healed through the counted upload


def test_config_mesh_devices_builds_a_cpu_mesh():
    from kubernetes_tpu_torch.config.loader import load_config_from_dict

    cfg = load_config_from_dict(
        {"tpuSolver": {"enabled": True, "maxBatch": 64, "meshDevices": 2}}
    )
    server = APIServer()
    client = Client(server)
    informers = InformerFactory(server)
    sched = new_scheduler_from_config(client, informers, cfg, device="cpu")
    assert sched.mesh == NodeMesh(["cpu", "cpu"])
    assert sched.device == torch.device("cpu")
    assert sched.preemptor.device == torch.device("cpu")
    for i in range(10):
        client.create_node(
            make_node(f"c{i}").capacity(cpu="4", memory="8Gi", pods=20).obj()
        )
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    sched.start()
    try:
        client.create_pods_bulk([
            make_pod(f"c{i}").container(cpu="250m", memory="256Mi").obj()
            for i in range(100)
        ])
        _wait_all_bound(client, 100)
        assert sched.pods_fallback == 0
        assert sched.mesh_solver_tier == "torch"
    finally:
        sched.stop()
        informers.stop()


def test_config_mesh_devices_on_the_card_needs_that_many_cards():
    from kubernetes_tpu_torch.config.loader import load_config_from_dict

    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("64 cards are visible")
    cfg = load_config_from_dict({"tpuSolver": {"meshDevices": 64}})
    server = APIServer()
    with pytest.raises((ValueError, RuntimeError)):
        new_scheduler_from_config(Client(server), InformerFactory(server), cfg)


def test_mesh_and_device_must_agree():
    server = APIServer()
    with pytest.raises(ValueError, match="first device"):
        new_scheduler(
            Client(server), InformerFactory(server), batch=True,
            device="meta", mesh=NodeMesh(["cpu"] * 2),
        )
    with pytest.raises(TypeError):
        new_scheduler(
            Client(server), InformerFactory(server), batch=True,
            device="cpu", mesh=["cpu", "cpu"],
        )


def test_preempt_batch_device_defaults_to_the_card():
    """No device named and no card visible: the victim search raises
    instead of running on the CPU, like every entry point."""
    from kubernetes_tpu_torch.ops.preemption import preempt_batch_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is valid")
    z = np.zeros
    with pytest.raises(RuntimeError, match="CUDA"):
        preempt_batch_device(
            None, z((1, 4), np.int32), z(1, np.int32), z((1, 4), bool),
            z(1, np.int32), z((0, 4), np.int32), z(0, np.int32),
            z(0, np.int32),
        )
