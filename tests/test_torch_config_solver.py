"""The ``tpuSolver`` configuration in the port against the JAX package's,
on the CPU: twins of the cases of ``tests/test_config_solver.py`` that
reach code the port rewrote.

Not twinned: ``TestValidation`` and ``TestPolicyTranslation``'s unit
cases. ``config/validation.py``, ``config/policy.py``, ``config/loader.py``
and ``config/types.py`` are byte-identical in both packages apart from the
package name in their imports; only ``test_policy_profile_schedules_end_
to_end`` reaches the scheduler, and it is twinned here.

Each case feeds the same dict (or Policy file) to both packages' entry
points, ``new_scheduler_from_config`` (the port on ``device="cpu"``), and
holds both to the reference case's assertions, then compares:

- ``maxBatch``, ``batchWindow``, ``solverMode``: the knobs as built, and
  every placement (exact);
- ``meshDevices: k``: the JAX package's node-axis Mesh over k of the
  conftest's 8 CPU devices; the port's ``NodeMesh(["cpu"] * k)``
  (``scheduler/scheduler.py``'s ``new_scheduler_from_config``). Greedy
  placements exact. Preemption under the mesh: the preemptors' and the
  victims' placements, exact, with the waves driven by hand so both
  packages see the same batches;
- ``solverMode: sinkhorn``: the reference's assertions in both and the
  same pods bound. Placements are not compared here: the sinkhorn plan
  is held to 1e-6 of the JAX plan, not bit for bit (ROADMAP Queue 3 item
  5), and these 40 equal pods on 8 equal nodes are all near-ties;
  ``tests/test_torch_sinkhorn_sched.py`` compares the placements of a
  seeded burst without near-ties, on one device and on a 2-shard mesh;
- ``TestMeshKernelInSuite``: the port's mesh greedy solve on 8 CPU
  shards against its one-device solve and the JAX package's sharded
  ``greedy_assign_compact`` on 8 devices, bit for bit.
"""

import time

import numpy as np
import pytest
import torch

import kubernetes_tpu.apiserver.server as jax_server
import kubernetes_tpu.client.client as jax_client
import kubernetes_tpu.client.informer as jax_informer
import kubernetes_tpu.config.loader as jax_loader
import kubernetes_tpu.config.policy as jax_policy
import kubernetes_tpu.scheduler.scheduler as jax_sched
import kubernetes_tpu.testing as jax_testing
import kubernetes_tpu_torch.apiserver.server as port_server
import kubernetes_tpu_torch.client.client as port_client
import kubernetes_tpu_torch.client.informer as port_informer
import kubernetes_tpu_torch.config.loader as port_loader
import kubernetes_tpu_torch.config.policy as port_policy
import kubernetes_tpu_torch.scheduler.scheduler as port_sched
import kubernetes_tpu_torch.testing as port_testing
from kubernetes_tpu_torch.ops.mesh import NodeMesh

PKGS = {
    "jax": (jax_server, jax_client, jax_informer, jax_loader, jax_policy,
            jax_sched, jax_testing, {}),
    "torch": (port_server, port_client, port_informer, port_loader,
              port_policy, port_sched, port_testing, {"device": "cpu"}),
}


class P:
    def __init__(self, pkg):
        (self.server, self.client, self.informer, self.loader, self.policy,
         self.sched, self.testing, self.kw) = PKGS[pkg]
        self.pkg = pkg


def _wait_bound(client, count, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        pods, _ = client.list_pods()
        if sum(1 for p in pods if p.spec.node_name) >= count:
            return pods
        time.sleep(0.05)
    raise AssertionError("pods not bound in time")


def _placements(client):
    return sorted((p.metadata.name, p.spec.node_name)
                  for p in client.list_pods()[0])


def _run_burst(pkg, cfg_dict, nodes=8, pods=40):
    """``TestConfigDrivenScheduler._run_burst``
    (``tests/test_config_solver.py:158``) through package ``pkg``; every
    pod queued before the loop starts, so both packages see the same
    batches. Returns (scheduler, placements)."""
    p = P(pkg)
    cfg = p.loader.load_config_from_dict(cfg_dict)
    server = p.server.APIServer()
    client = p.client.Client(server)
    informers = p.informer.InformerFactory(server)
    sched = p.sched.new_scheduler_from_config(client, informers, cfg, **p.kw)
    for i in range(nodes):
        client.create_node(p.testing.make_node(f"n{i}").capacity(
            cpu="8", memory="16Gi", pods=30).obj())
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        client.create_pods_bulk([
            p.testing.make_pod(f"p{i}").container(
                cpu="250m", memory="256Mi").obj() for i in range(pods)])
        deadline = time.time() + 30
        while sched.queue.active_count() < pods and time.time() < deadline:
            time.sleep(0.01)
        sched.start()
        _wait_bound(client, pods)
        sched.wait_for_inflight_binds()
    finally:
        sched.stop()
        informers.stop()
    return sched, _placements(client)


def _both(cfg_dict, **kw):
    return {pkg: _run_burst(pkg, cfg_dict, **kw) for pkg in PKGS}


def test_policy_profile_schedules_end_to_end(tmp_path):
    """A legacy Policy file, loaded by each package, schedules through a
    batch scheduler: every pod binds where the JAX package binds it."""
    policy = tmp_path / "policy.yaml"
    policy.write_text(
        """
kind: Policy
predicates:
  - name: PodFitsResources
  - name: CheckNodeUnschedulable
priorities:
  - name: LeastRequestedPriority
    weight: 1
"""
    )
    got = {}
    for pkg in PKGS:
        p = P(pkg)
        profile = p.policy.load_policy(str(policy))
        server = p.server.APIServer()
        client = p.client.Client(server)
        informers = p.informer.InformerFactory(server)
        sched = p.sched.new_scheduler(client, informers, profiles=[profile],
                                      batch=True, max_batch=16, **p.kw)
        client.create_node(p.testing.make_node("n").capacity(
            cpu="4", memory="8Gi").obj())
        client.create_node(p.testing.make_node("m").capacity(
            cpu="2", memory="8Gi").obj())
        informers.start()
        informers.wait_for_cache_sync()
        sched.queue.run()
        client.create_pods_bulk([p.testing.make_pod(f"p{i}").container(
            cpu="1").obj() for i in range(5)])
        sched.start()
        try:
            _wait_bound(client, 5)
            sched.wait_for_inflight_binds()
        finally:
            sched.stop()
            informers.stop()
        got[pkg] = _placements(client)
    assert got["torch"] == got["jax"]


def test_yaml_solver_knobs():
    got = _both({"tpuSolver": {"maxBatch": 32, "solverMode": "greedy",
                               "batchWindow": "20ms"}})
    for sched, _ in got.values():
        assert sched.max_batch == 32
        assert abs(sched.batch_window - 0.02) < 1e-9
        assert sched.pods_solved_on_device >= 40
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][0].ladder.solves_by_tier["torch"] > 0


@pytest.mark.parametrize("mesh", [0, 8], ids=["one_device", "mesh"])
def test_yaml_sinkhorn_mode_end_to_end(mesh):
    """``solverMode: sinkhorn`` through the whole batch scheduler, on one
    device and under an 8-device mesh."""
    solver = {"maxBatch": 32, "solverMode": "sinkhorn"}
    if mesh:
        solver["meshDevices"] = mesh
    got = _both({"tpuSolver": solver})
    for pkg, (sched, placed) in got.items():
        assert sched.solver_mode == "sinkhorn"
        assert (sched.mesh is not None) == bool(mesh)
        assert sched.pods_solved_on_device >= 40
        assert sched.pods_fallback == 0
        assert all(node for _, node in placed)
    assert [n for n, _ in got["torch"][1]] == [n for n, _ in got["jax"][1]]
    if mesh:
        assert got["torch"][0].mesh == NodeMesh(["cpu"] * mesh)


def test_yaml_mesh_end_to_end():
    """``meshDevices: 8`` builds the node-axis mesh from the config and the
    whole pipeline schedules across it, placing as the JAX package's."""
    got = _both({"tpuSolver": {"meshDevices": 8}})
    for sched, _ in got.values():
        assert sched.mesh is not None
        assert sched.pods_solved_on_device >= 40
    port = got["torch"][0]
    assert port.mesh == NodeMesh(["cpu"] * 8)
    assert port.mesh_solver_tier == "torch"
    assert got["torch"][1] == got["jax"][1]


def _preempt_under_mesh(pkg):
    """``test_preemption_under_mesh`` (``tests/test_config_solver.py:
    222``), the waves driven by hand (informers pumped, zero backoff):
    the high-priority pods' placements and the fill pods evicted."""
    p = P(pkg)
    cfg = p.loader.load_config_from_dict({"tpuSolver": {"meshDevices": 8}})
    server = p.server.APIServer()
    client = p.client.Client(server)
    informers = p.informer.InformerFactory(server)
    sched = p.sched.new_scheduler_from_config(client, informers, cfg, **p.kw)
    sched.batch_window = 0.0
    sched.queue._initial_backoff = sched.queue._max_backoff = 0.0
    for i in range(16):
        client.create_node(p.testing.make_node(f"n{i}").capacity(
            cpu="8", memory="16Gi", pods=10).obj())
    informers.pump()

    def drive(rounds=40):
        for _ in range(rounds):
            sched.schedule_batch(timeout=0.05, pipeline=False)
            sched.wait_for_inflight_binds()
            informers.pump()
            sched.queue.move_all_to_active_or_backoff_queue("retry")
            sched.queue.flush_backoff_q_completed()
            hi = [x for x in client.list_pods()[0]
                  if x.metadata.name.startswith("hi")]
            if hi and all(x.spec.node_name for x in hi):
                return

    client.create_pods_bulk([p.testing.make_pod(f"fill{i}").container(
        cpu="3500m", memory="2Gi").priority(0).obj() for i in range(32)])
    informers.pump()
    drive(rounds=4)
    assert sum(1 for x in client.list_pods()[0] if x.spec.node_name) == 32
    client.create_pods_bulk([p.testing.make_pod(f"hi{i}").container(
        cpu="4", memory="1Gi").priority(100).obj() for i in range(8)])
    informers.pump()
    drive()
    sched.stop()
    informers.stop()
    pods = client.list_pods()[0]
    hi = sorted((x.metadata.name, x.spec.node_name) for x in pods
                if x.metadata.name.startswith("hi"))
    left = sorted(x.metadata.name for x in pods
                  if x.metadata.name.startswith("fill"))
    return hi, left, sched.preemptor.device_preemptions > 0


def test_preemption_under_mesh():
    """A saturated mesh-configured cluster, then a high-priority burst:
    the device victim search runs inside the mesh scheduler, every
    preemptor binds, and the preemptors and the fill pods left are the
    JAX package's."""
    port = _preempt_under_mesh("torch")
    jax = _preempt_under_mesh("jax")
    assert port == jax
    hi, left, device = port
    assert len(hi) == 8 and all(node for _, node in hi)
    assert device and len(left) < 32


def test_invalid_config_rejected_at_build():
    for pkg in PKGS:
        p = P(pkg)
        cfg = p.loader.load_config_from_dict({"tpuSolver": {"maxBatch": -1}})
        with pytest.raises(ValueError, match="maxBatch"):
            p.sched.new_scheduler_from_config(
                p.client.Client(p.server.APIServer()),
                p.informer.InformerFactory(p.server.APIServer()), cfg,
                **p.kw)


def test_mesh_solve_matches_one_device_and_the_jax_sharded_solve():
    """``TestMeshKernelInSuite``: 128 nodes, 32 pods; the port's mesh
    greedy solve on 8 CPU shards places as its one-device solve and as
    the JAX package's ``greedy_assign_compact`` sharded over 8 devices."""
    import jax
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as PS

    from kubernetes_tpu.cache.snapshot import new_snapshot
    from kubernetes_tpu.ops.assignment import GreedyConfig as JaxConfig
    from kubernetes_tpu.ops.assignment import greedy_assign_compact as jax_g
    from kubernetes_tpu.tensors import NodeTensorCache, pack_pod_batch
    from kubernetes_tpu_torch.ops import assignment as port_asg

    nodes = [jax_testing.make_node(f"n{i}").capacity(
        cpu=str(4 + i % 3), memory="8Gi").obj() for i in range(128)]
    nt = NodeTensorCache().update(new_snapshot([], nodes))
    pods = [jax_testing.make_pod(f"p{i}").container(
        cpu="500m", memory="256Mi").obj() for i in range(32)]
    batch = pack_pod_batch(pods, nt.dims)
    rows = np.ones((8, nt.capacity), dtype=bool)
    midx = np.zeros(32, dtype=np.int32)
    active = np.ones(32, dtype=bool)
    args = (nt.allocatable, nt.requested, nt.non_zero_requested, nt.valid,
            batch.requests, batch.non_zero_requests, rows, midx, active)

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("nodes",))
    rows_, rep = PS("nodes", None), PS()
    sh = tuple(NamedSharding(mesh, spec) for spec in (
        rows_, rows_, rows_, PS("nodes"), rep, rep, PS(None, "nodes"), rep,
        rep))
    want = np.asarray(jax_g(*jax.device_put(args, sh), config=JaxConfig())[0])

    cfg = port_asg.GreedyConfig()
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    one = port_asg.greedy_assign_compact(*t, config=cfg)[0].numpy()
    nm = NodeMesh(["cpu"] * 8)
    bounds = nm.bounds(nt.capacity)
    shards = [[t[j][lo:hi].clone() for lo, hi in bounds] for j in range(4)]
    got = port_asg._mesh_greedy(
        nm, *shards, [t[6][:, lo:hi] for lo, hi in bounds],
        [(t[4], t[5], t[7])], active, cfg,
    )[0].numpy()
    assert (want >= 0).all()
    np.testing.assert_array_equal(one, want)
    np.testing.assert_array_equal(got, want)
