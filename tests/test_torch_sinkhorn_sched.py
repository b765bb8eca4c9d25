"""The sinkhorn mode through the port's packed upload, its mesh and its
batch scheduler, against the JAX package's:

- ``solve_packed(mode="sinkhorn")`` on the cold, refresh and steady
  layouts with and without the int16 carry, and on a 2-shard mesh
  against the JAX mesh and one port device: placements, requested' and
  nzr' equal (the plan is not bit-exact, test_torch_sinkhorn.py says
  why; on these seeds no two candidate nodes lie closer than its
  last-bit difference);
- the batch scheduler's ``solverMode: sinkhorn``, alone and with
  ``meshDevices``, places as the JAX package's scheduler does, every
  batch on the ``torch`` tier with no fallback.
"""

import random
import time

import numpy as np
import pytest

from kubernetes_tpu.apiserver.server import APIServer as JaxAPIServer
from kubernetes_tpu.client.client import Client as JaxClient
from kubernetes_tpu.client.informer import InformerFactory as JaxInformers
from kubernetes_tpu.config.loader import load_config_from_dict as jax_load
from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu.scheduler.scheduler import (
    new_scheduler_from_config as jax_from_config,
)
from kubernetes_tpu.testing import make_node as jax_node
from kubernetes_tpu.testing import make_pod as jax_pod
from kubernetes_tpu_torch.apiserver.server import APIServer
from kubernetes_tpu_torch.client.client import Client
from kubernetes_tpu_torch.client.informer import InformerFactory
from kubernetes_tpu_torch.config.loader import load_config_from_dict
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.ops.mesh import NodeMesh, ShardedRows
from kubernetes_tpu_torch.scheduler import batch as torch_batch
from kubernetes_tpu_torch.scheduler.scheduler import new_scheduler_from_config
from kubernetes_tpu_torch.testing import make_node, make_pod

from test_torch_mesh import (
    _assert_equal,
    _jax_mesh,
    _layout_chain,
    _np,
    _resident,
)
from test_torch_mesh_sched import _KeepFirstRng
from test_torch_packed import _batch, _state


@pytest.mark.parametrize("compress", [False, True])
def test_solve_packed_sinkhorn_layouts_match_the_jax_package(compress):
    alloc, valid, req, nzr = _state(3)
    dt = np.int16 if compress else np.int32
    static = [("alloc", alloc), ("valid", valid.astype(np.int32))]
    carry = [("req_state", req.astype(dt)), ("nzr_state", nzr.astype(dt))]
    def both(pieces, j_in, t_in):
        want = jax_asg.solve_packed(
            pieces, *j_in, config=jax_asg.GreedyConfig(), mode="sinkhorn",
            compress=compress,
        )
        got = torch_asg.solve_packed(
            pieces, *t_in, config=torch_asg.GreedyConfig(), mode="sinkhorn",
            compress=compress, device="cpu",
        )
        _assert_equal(got, want)
        return want, got

    w, g = both(_batch(3) + static + carry, (None,) * 4, (None,) * 4)
    w, g = both(_batch(4) + carry, (w[3], w[4], None, None),
                (g[3], g[4], None, None))
    slots = torch_batch._delta_slot_pieces(75, 5, compress=compress)
    w, g = both(_batch(5) + slots, (w[3], w[4], w[1], w[2]),
                (g[3], g[4], g[1], g[2]))
    assert (_np(g[0]) >= 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_on_a_mesh_matches_the_jax_mesh_and_one_device(seed):
    jmesh = _jax_mesh(2)
    tmesh = NodeMesh(["cpu"] * 2)
    cfg_j, cfg_t = jax_asg.GreedyConfig(), torch_asg.GreedyConfig()
    w = g = s = None
    placed = 0
    for pieces, which in _layout_chain(seed):
        w = jax_asg.solve_packed(
            pieces, *_resident(w, which), config=cfg_j, mode="sinkhorn",
            mesh=jmesh,
        )
        g = torch_asg.solve_packed(
            pieces, *_resident(g, which), config=cfg_t, mode="sinkhorn",
            device="cpu", mesh=tmesh,
        )
        single = [
            (name, a.astype(np.int32) if name == "rows" else a)
            for name, a in pieces
        ]
        s = torch_asg.solve_packed(
            single, *_resident(s, which), config=cfg_t, mode="sinkhorn",
            device="cpu",
        )
        _assert_equal(g, w)
        _assert_equal(g, s)
        assert all(isinstance(x, ShardedRows) for x in g[1:])
        placed += int((_np(g[0]) >= 0).sum())
    assert placed > 0


# -- the scheduler ------------------------------------------------------------

STACKS = {
    "jax": (JaxAPIServer, JaxClient, JaxInformers, jax_load,
            jax_from_config, jax_node, jax_pod),
    "torch": (APIServer, Client, InformerFactory, load_config_from_dict,
              new_scheduler_from_config, make_node, make_pod),
}


def _yaml_burst(stack, solver, seed=7, nodes=12, pods=96):
    """A seeded burst through one stack's config entry point; returns
    (placements, scheduler)."""
    Server, Cl, Informers, load, from_config, mk_node, mk_pod = STACKS[stack]
    rng = random.Random(seed)
    server = Server()
    client = Cl(server)
    informers = Informers(server)
    cfg = load({"tpuSolver": solver})
    kw = {"device": "cpu"} if stack == "torch" else {}
    sched = from_config(client, informers, cfg, rng=_KeepFirstRng(), **kw)
    for i in range(nodes):
        client.create_node(
            mk_node(f"s{i}").capacity(
                cpu=str(rng.choice([8, 16, 32])), memory="64Gi", pods=40
            ).obj()
        )
    batch = [
        mk_pod(f"p{i}").creation_timestamp(float(i)).container(
            cpu=f"{rng.choice([100, 250, 500])}m",
            memory=f"{rng.choice([128, 256])}Mi",
        ).obj()
        for i in range(pods)
    ]
    informers.start()
    informers.wait_for_cache_sync()
    sched.queue.run()
    try:
        client.create_pods_bulk(batch)
        # every pod queued before the first pop: the batches (and so
        # each batch's prior) are the same in both stacks
        deadline = time.time() + 60
        while sched.queue.active_count() < pods and time.time() < deadline:
            time.sleep(0.01)
        sched.start()
        deadline = time.time() + 120
        while time.time() < deadline:
            if all(p.spec.node_name for p in client.list_pods()[0]):
                break
            time.sleep(0.05)
        sched.wait_for_inflight_binds()
        return {
            p.metadata.name: p.spec.node_name for p in client.list_pods()[0]
        }, sched
    finally:
        sched.stop()
        informers.stop()


@pytest.mark.parametrize(
    "solver",
    [{"maxBatch": 32, "solverMode": "sinkhorn"},
     {"maxBatch": 32, "solverMode": "sinkhorn", "meshDevices": 2}],
    ids=["one_device", "mesh"],
)
def test_yaml_sinkhorn_mode_places_as_the_jax_scheduler(solver):
    want, _ = _yaml_burst("jax", solver)
    got, sched = _yaml_burst("torch", solver)
    assert all(got.values())
    assert got == want
    assert sched.solver_mode == "sinkhorn"
    assert (sched.mesh is not None) == ("meshDevices" in solver)
    assert sched.pods_solved_on_device == len(got)
    assert sched.pods_fallback == 0
    assert set(k for k, v in sched.ladder.solves_by_tier.items() if v) == {
        "torch"
    }
