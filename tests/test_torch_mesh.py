"""The port's node-sharded mesh tier against the JAX package's, on the CPU.

- K4's plain version (``ops/shard_kernel.shard_candidate_plain``) against
  the Pallas shard-candidate kernel in interpret mode and against the jnp
  step the JAX mesh runs off the TPU, over seeded shards, both configs,
  R = 6, infeasible pods included; and the known disagreement of the
  Pallas body above 2^24 memKiB, where the port follows the int32 sum.
- K4's batch entry's plain version (``mesh_batch_plain``) against the JAX
  package's ``make_sharded_solver`` on 2- and 4-device virtual meshes, and
  the one-device batch route against the step route of a mesh over
  several devices, on one device.
- ``solve_packed(..., mesh=NodeMesh(["cpu"] * 2))`` against JAX
  ``solve_packed(..., mesh=Mesh(2 CPU devices))`` on the cold, refresh
  and steady layouts (delta slots and membership slots), against the
  port's own single-device solve, and on a ragged 3-shard split; a
  constrained batch on both meshes; ``make_sharded_solver`` of both
  packages; and the JAX sharded carry handed to a port mesh.

The JAX meshes are built from ``jax.devices()[:P]`` of the virtual CPU
devices tests/conftest.py sets up. Everything compared is int32 state
or a bit-exact float32 score: the tolerance is zero.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu.ops.pallas_solver import pallas_shard_candidate
from kubernetes_tpu.scheduler import batch as jax_batch
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.ops import shard_kernel
from kubernetes_tpu_torch.ops.mesh import NodeMesh, ShardedRows, solve_device
from kubernetes_tpu_torch.scheduler import batch as torch_batch

from test_torch_constrained import _layouts, _packed_problem
from test_torch_greedy import _random_problem, _summation_order_problem

CONFIGS = {
    "default": (1, 1, 0),
    "most_allocated": (0, 0, 1),
}


def _jax_mesh(p):
    devices = jax.devices()
    if len(devices) < p:
        pytest.skip(f"need {p} devices, have {len(devices)}")
    return Mesh(np.array(devices[:p]), axis_names=("nodes",))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _np(x):
    if isinstance(x, ShardedRows):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


# -- K4's plain version -------------------------------------------------------

def _jnp_step(alloc, req, nzr, valid, rows, pod_req, pod_nzr, m, cfg):
    """The JAX mesh's jnp step (assignment.py:642-657) for one shard."""
    feasible = (
        jax_asg._fits(jnp.asarray(alloc - req), jnp.asarray(pod_req))
        & jnp.asarray(rows[m]) & jnp.asarray(valid)
    )
    score = jax_asg._combined_score(
        jnp.asarray(alloc[:, :2]), jnp.asarray(nzr), jnp.asarray(pod_nzr),
        cfg,
    )
    masked = jnp.where(feasible, score, -jnp.inf)
    best = jnp.max(masked)
    idx = jnp.min(jnp.where(masked == best, jnp.arange(alloc.shape[0]),
                            1 << 30))
    return float(best), int(idx)


def _pallas(alloc, req, nzr, valid, rows, pod_req, pod_nzr, m, cfg):
    best, idx = pallas_shard_candidate(
        jnp.asarray(alloc.T), jnp.asarray(req.T), jnp.asarray(nzr.T),
        jnp.asarray(valid.astype(np.int32))[None, :],
        jnp.asarray(rows.astype(np.int32)), jnp.asarray(pod_req),
        jnp.asarray(pod_nzr), jnp.asarray(np.int32(m)), config=cfg,
        interpret=True,
    )
    return float(best), int(idx)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [1, 13])
def test_plain_candidate_matches_pallas_and_the_jnp_step(seed, config):
    """Three ragged shards of a 200-row state (memKiB sums below 2^24);
    pods 0 and 1 of every shard find nothing feasible (the all-False
    mask row, a CPU request no node holds) and must give (-inf, 0)."""
    w = CONFIGS[config]
    jcfg, tcfg = jax_asg.GreedyConfig(*w), torch_asg.GreedyConfig(*w)
    (alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx,
     _) = _random_problem(seed, n=200, b=12, r=6)
    midx = midx.copy()
    pod_req = pod_req.copy()
    midx[0] = rows.shape[0] - 1  # the all-False row
    pod_req[1, 0] = 1 << 30
    mesh = NodeMesh(["cpu"] * 3)
    infeasible = 0
    for lo, hi in mesh.bounds(200):
        shard = (alloc[lo:hi], req[lo:hi], nzr[lo:hi], valid[lo:hi],
                 rows[:, lo:hi])
        for k in range(pod_req.shape[0]):
            best, idx = shard_kernel.shard_candidate_plain(
                *(_t(a) for a in shard), _t(pod_req[k]), _t(pod_nzr[k]),
                _t(np.int32(midx[k])), tcfg,
            )
            assert best.dtype == torch.float32 and idx.dtype == torch.int32
            got = (float(best), int(idx))
            args = (*shard, pod_req[k], pod_nzr[k], int(midx[k]), jcfg)
            assert got == _jnp_step(*args), (lo, k)
            assert got == _pallas(*args), (lo, k)
            infeasible += got == (float("-inf"), 0)
    assert infeasible >= 6  # pods 0 and 1 on every shard


def test_memkib_above_2_24_follows_the_int32_sum():
    """K4 shares the Pallas body of K1, which casts each addend to
    float32 before it adds (ROADMAP Queue 3 item 0). Above 2^24 memKiB
    the JAX package's own kernel and its jnp step pick different nodes;
    the port follows the jnp step's int32 sum."""
    (alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx,
     _) = _summation_order_problem()
    jcfg, tcfg = jax_asg.GreedyConfig(), torch_asg.GreedyConfig()
    args = (alloc, req, nzr, valid, rows, pod_req[0], pod_nzr[0], 0, jcfg)
    best, idx = shard_kernel.shard_candidate_plain(
        *(_t(a) for a in (alloc, req, nzr, valid, rows, pod_req[0],
                          pod_nzr[0], midx)), tcfg,
    )
    assert (float(best), int(idx)) == _jnp_step(*args)
    assert int(idx) == 0
    assert _pallas(*args)[1] == 1


def test_shard_candidates_step_writes_every_shard():
    """ShardCandidates on the CPU: row t holds pod t's candidate per
    shard, the plain version's, and no kernel launches."""
    (alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx,
     _) = _random_problem(4, n=90, b=8, r=4)
    mesh = NodeMesh(["cpu"] * 2)
    shards = [
        [_t(a[lo:hi]) for a in (alloc, req, nzr, valid)] + [_t(rows[:, lo:hi])]
        for lo, hi in mesh.bounds(90)
    ]
    before = shard_kernel.launches
    cands = shard_kernel.ShardCandidates(
        *[list(c) for c in zip(*shards)], _t(pod_req), _t(pod_nzr), _t(midx),
    )
    for t in range(8):
        cands.step(t)
    for t in range(8):
        for k, sh in enumerate(shards):
            best, idx = shard_kernel.shard_candidate_plain(
                *sh, _t(pod_req[t]), _t(pod_nzr[t]), _t(midx[t:t + 1]),
            )
            assert float(cands.score[t, k]) == float(best)
            assert int(cands.index[t, k]) == int(idx)
    one = shard_kernel.shard_candidate(
        *[list(c) for c in zip(*shards)], _t(pod_req[3]), _t(pod_nzr[3]),
        _t(midx[3:4]),
    )
    assert torch.equal(one[0], cands.score[3])
    assert torch.equal(one[1], cands.index[3])
    assert shard_kernel.launches == before


def test_shard_candidates_write_into_given_columns():
    """With caller-given [B, C] outputs, shard k of a device lands in
    column col + k and no other column is written: how the mesh solve
    gathers every device's candidates in one buffer."""
    (alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx,
     _) = _random_problem(5, n=90, b=8, r=4)
    mesh = NodeMesh(["cpu"] * 2)
    shards = [list(c) for c in zip(*[
        [_t(a[lo:hi]) for a in (alloc, req, nzr, valid)] + [_t(rows[:, lo:hi])]
        for lo, hi in mesh.bounds(90)
    ])]
    pods = (_t(pod_req), _t(pod_nzr), _t(midx))
    own = shard_kernel.ShardCandidates(*shards, *pods)
    score = torch.full((8, 5), 7.0)
    index = torch.full((8, 5), 7, dtype=torch.int32)
    wide = shard_kernel.ShardCandidates(
        *shards, *pods, score=score, index=index, col=2,
    )
    assert wide.score is score and wide.index is index
    for t in range(8):
        own.step(t)
        wide.step(t)
    assert torch.equal(score[:, 2:4], own.score)
    assert torch.equal(index[:, 2:4], own.index)
    assert (score[:, [0, 1, 4]] == 7.0).all()
    assert (index[:, [0, 1, 4]] == 7).all()
    with pytest.raises(ValueError):
        shard_kernel.ShardCandidates(
            *shards, *pods, score=score, index=index, col=4,
        )


def test_shard_kernel_raises_off_the_card():
    args = [[torch.zeros((4, 4), dtype=torch.int32, device="meta")]] * 3 + [
        [torch.zeros(4, dtype=torch.bool, device="meta")],
        [torch.zeros((8, 4), dtype=torch.bool, device="meta")],
    ]
    pods = (torch.zeros((1, 4), dtype=torch.int32, device="meta"),
            torch.zeros((1, 2), dtype=torch.int32, device="meta"),
            torch.zeros(1, dtype=torch.int32, device="meta"))
    with pytest.raises(shard_kernel.KernelError):
        shard_kernel.ShardCandidates(*args, *pods)
    with pytest.raises(shard_kernel.KernelError):
        shard_kernel.shard_candidate(*args, pods[0][0], pods[1][0], pods[2])
    cpu = [[torch.zeros(a[0].shape, dtype=a[0].dtype)] for a in args]
    with pytest.raises(shard_kernel.KernelError):  # the kernel wants the card
        shard_kernel.shard_candidate_cuda(
            *cpu, *(torch.zeros(t.shape, dtype=t.dtype)
                    for t in (pods[0][0], pods[1][0], pods[2]))
        )


# -- K4's batch entry ---------------------------------------------------------

def _split(mesh, problem):
    """A problem's node arrays as one tensor per shard (fresh copies) and
    its mask rows' columns per shard."""
    alloc, req, nzr, valid, _, _, rows, _, _ = problem
    bounds = mesh.bounds(alloc.shape[0])
    cols = [[_t(a[lo:hi]).clone() for lo, hi in bounds]
            for a in (alloc, req, nzr, valid)]
    return cols, [_t(rows[:, lo:hi]) for lo, hi in bounds]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [3, 8])
def test_mesh_batch_plain_matches_the_jax_sharded_solver(p, config, seed):
    """A seeded batch (scalar dims, all-zero pods, invalid rows, mask
    rows, inactive padding) through mesh_batch_plain on P shards of one
    device and through the JAX package's node-sharded solver on P
    virtual devices: assignment, req' and nzr' bit-equal, and every
    active step's per-shard candidates are the shards' plain candidates
    at that step's state."""
    w = CONFIGS[config]
    problem = _random_problem(seed, n=192, b=48, r=6)
    alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx, active = problem
    jmesh = _jax_mesh(p)
    with jmesh:
        want = jax_asg.make_sharded_solver(jmesh, jax_asg.GreedyConfig(*w))(
            alloc, req, nzr, valid, pod_req, pod_nzr, rows[midx], active,
        )
    mesh = NodeMesh(["cpu"] * p)
    (a_s, q_s, z_s, v_s), r_s = _split(mesh, problem)
    cfg = torch_asg.GreedyConfig(*w)
    asg, score, index = shard_kernel.mesh_batch_plain(
        a_s, q_s, z_s, v_s, r_s, _t(pod_req), _t(pod_nzr), _t(midx),
        _t(active), cfg,
    )
    _assert_equal((asg, torch.cat(q_s), torch.cat(z_s)), want)
    assert (asg.numpy() >= 0).sum() > 0
    # replay: step t's candidates are the shards' candidates at the
    # state every earlier placement left
    (a_r, q_r, z_r, v_r), _ = _split(mesh, problem)
    offs = np.cumsum([0] + [a.shape[0] for a in a_r])
    for t in np.flatnonzero(active):
        for k in range(p):
            best, idx = shard_kernel.shard_candidate_plain(
                a_r[k], q_r[k], z_r[k], v_r[k], r_s[k], _t(pod_req[t]),
                _t(pod_nzr[t]), _t(midx[t:t + 1]), cfg,
            )
            assert float(score[t, k]) == float(best)
            assert int(index[t, k]) == int(idx)
        g = int(asg[t])
        if g >= 0:
            k = int(np.searchsorted(offs, g, side="right")) - 1
            q_r[k][g - offs[k]] += _t(pod_req[t])
            z_r[k][g - offs[k]] += _t(pod_nzr[t])


@pytest.mark.parametrize("p", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 5])
def test_one_device_batch_route_equals_the_step_route(p, seed):
    """On a one-device CPU mesh the batch route (ShardCandidates.batch)
    and the step route of a mesh over several devices (_mesh_step_loop)
    give the same assignment, req', nzr' and active steps' candidates."""
    mesh = NodeMesh(["cpu"] * p)
    problem = _random_problem(seed, n=200, b=40, r=6)
    alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx, active = problem
    (a_s, q_s, z_s, v_s), r_s = _split(mesh, problem)
    pods = [(_t(pod_req), _t(pod_nzr), _t(midx))]
    cfg = torch_asg.GreedyConfig()

    def work():
        return torch_asg._mesh_work(mesh, a_s, q_s, z_s, v_s, r_s, pods, cfg)

    batch, b_score, b_index = work()
    assert len(batch) == 1
    b_asg = batch[0].cands.batch(_t(active))
    steps, s_score, s_index = work()
    s_asg = torch_asg._mesh_step_loop(mesh, steps, s_score, s_index, active)
    n = alloc.shape[0]  # the working buffers' last row is scratch
    _assert_equal(
        (b_asg, batch[0].req[:n], batch[0].nzr[:n]),
        (s_asg, steps[0].req[:n], steps[0].nzr[:n]),
    )
    act = _t(active)
    assert torch.equal(b_score[act], s_score[act])
    assert torch.equal(b_index[act], s_index[act])
    assert (b_asg.numpy() >= 0).sum() > 0
    # the inputs are never written
    np.testing.assert_array_equal(torch.cat(q_s).numpy(), req)


def test_the_mesh_layout_picks_the_route(monkeypatch):
    """One device holding every shard takes the batch entry and never
    steps; a mesh whose shards sit on distinct devices steps and never
    takes the batch entry."""
    problem = _random_problem(2, n=96, b=16, r=4)
    alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx, active = problem
    mesh = NodeMesh(["cpu"] * 2)
    (a_s, q_s, z_s, v_s), r_s = _split(mesh, problem)
    pods = [(_t(pod_req), _t(pod_nzr), _t(midx))]
    calls = []
    real_batch = shard_kernel.ShardCandidates.batch
    real_step = shard_kernel.ShardCandidates.step

    def batch(self, act):
        calls.append("batch")
        return real_batch(self, act)

    def step(self, t):
        calls.append("step")
        return real_step(self, t)

    monkeypatch.setattr(shard_kernel.ShardCandidates, "batch", batch)
    monkeypatch.setattr(shard_kernel.ShardCandidates, "step", step)
    cfg = torch_asg.GreedyConfig()
    one = torch_asg._mesh_greedy(mesh, a_s, q_s, z_s, v_s, r_s, pods,
                                 active, cfg)
    assert calls == ["batch"]
    calls.clear()
    monkeypatch.setattr(
        NodeMesh, "groups",
        lambda self: [(d, [k]) for k, d in enumerate(self.devices)],
    )
    several = torch_asg._mesh_greedy(mesh, a_s, q_s, z_s, v_s, r_s,
                                     pods * 2, active, cfg)
    assert set(calls) == {"step"}
    assert len(calls) == 2 * int(active.sum())
    _assert_equal(one, several)


# -- the mesh and its sharded rows -------------------------------------------

def test_node_mesh_splits_rows_in_order():
    mesh = NodeMesh(["cpu"] * 3)
    assert mesh.bounds(5000) == [(0, 1667), (1667, 3334), (3334, 5000)]
    assert mesh.bounds(2) == [(0, 1), (1, 2), (2, 2)]
    assert NodeMesh(["cpu"] * 4).bounds(5632) == [
        (0, 1408), (1408, 2816), (2816, 4224), (4224, 5632)
    ]
    assert mesh.groups() == [(torch.device("cpu"), [0, 1, 2])]
    full = np.arange(20, dtype=np.int32).reshape(10, 2)
    sh = ShardedRows.split(mesh, full)
    assert sh.shape == (10, 2) and sh.dtype == torch.int32
    assert [s.shape[0] for s in sh.shards] == [4, 3, 3]
    full[0, 0] = 99  # no shard aliases the source
    assert int(sh.shards[0][0, 0]) == 0
    assert sh.locate(4) == (1, 0)
    np.testing.assert_array_equal(sh.numpy()[1:], full[1:])
    row_map = mesh.row_map(10, "cpu", [0, 1, 2])
    assert row_map.tolist() == list(range(10)) + [10]
    # shard 1 alone (rows 4-6): its rows first, the scratch row 3 elsewhere
    row_map = mesh.row_map(10, "cpu", [1])
    assert row_map.tolist() == [3] * 4 + [0, 1, 2] + [3] * 4
    with pytest.raises(ValueError):
        NodeMesh([])
    with pytest.raises(ValueError):
        ShardedRows(mesh, sh.shards[:2])


def test_two_names_of_one_device_are_one_mesh_device(monkeypatch):
    """The names "cuda" and "cuda:0" are one card (as "cpu" and "cpu:0"
    are the CPU): the mesh groups them together, and a scheduler given either
    name with a mesh on that card solves on the mesh's first device."""
    cpu_mesh = NodeMesh(["cpu", "cpu:0"])
    assert cpu_mesh.groups() == [(torch.device("cpu"), [0, 1])]
    assert solve_device("cpu:0", cpu_mesh) == torch.device("cpu")
    with pytest.raises(RuntimeError):  # off a mesh: the card, and none here
        solve_device(None, None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = NodeMesh(["cuda:0"] * 4)
    assert mesh.groups() == [(torch.device("cuda", 0), [0, 1, 2, 3])]
    assert NodeMesh(["cuda", "cuda:0"]).groups() == [
        (torch.device("cuda", 0), [0, 1])
    ]
    for name in (None, "cuda", "cuda:0", torch.device("cuda")):
        assert solve_device(name, mesh) == torch.device("cuda", 0)
    with pytest.raises(ValueError):
        solve_device("cuda:1", mesh)
    with pytest.raises(ValueError):
        solve_device("cpu", mesh)
    with pytest.raises(TypeError):
        solve_device("cuda", ["cuda:0"])


def test_shard_local_row_set_matches_the_jax_version():
    """Per-shard patches, gathered, equal the JAX package's
    shard_local_row_set on the whole state: padding (index >= N) and
    negative slots drop, and of two slots on one row the first wins."""
    rng = np.random.default_rng(5)
    state = rng.integers(0, 100, (11, 3)).astype(np.int32)
    idx = np.array([3, 11, -1, 7, 3, 10, 0, 50], np.int32)
    rows = rng.integers(100, 200, (8, 3)).astype(np.int32)
    want = jax_asg.shard_local_row_set(
        jnp.asarray(state), jnp.asarray(idx), jnp.asarray(rows)
    )
    mesh = NodeMesh(["cpu"] * 3)
    sharded = ShardedRows.split(mesh, state)
    got = ShardedRows(mesh, [
        torch_asg.shard_local_row_set(s, _t(idx), _t(rows), lo, hi)
        for s, (lo, hi) in zip(sharded.shards, sharded.bounds)
    ])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharded_audit_checksum_and_delta():
    """The carry audit's checksum over a sharded carry equals the host's
    wrapping pair; apply_assignment_delta lands each placed row on the
    shard that holds it, as on the whole state."""
    rng = np.random.default_rng(2)
    arr = rng.integers((1 << 31) - 5000, (1 << 31) - 1, (301, 4)).astype(
        np.int32
    )
    mesh = NodeMesh(["cpu"] * 3)
    dev = torch_batch._audit_checksum_dev(ShardedRows.split(mesh, arr))
    assert (int(dev[0]), int(dev[1])) == jax_batch._audit_checksum_host(arr)
    req = arr[:, :3].copy()
    nzr = arr[:, 3:].repeat(2, axis=1)
    asg = rng.integers(-1, 301, 40).astype(np.int32)
    pod_req = rng.integers(0, 50, (40, 3)).astype(np.int32)
    pod_nzr = rng.integers(0, 50, (40, 2)).astype(np.int32)
    want = torch_asg.apply_assignment_delta(
        _t(req), _t(nzr), asg, pod_req, pod_nzr
    )
    got = torch_asg.apply_assignment_delta(
        ShardedRows.split(mesh, req), ShardedRows.split(mesh, nzr), asg,
        pod_req, pod_nzr,
    )
    _assert_equal(got, want)


# -- solve_packed on a mesh ---------------------------------------------------

N, R, B, U = 76, 5, 64, 8  # 76 rows: two shards of 38, or 26/25/25


def _state(seed):
    rng = np.random.default_rng(seed)
    alloc = np.zeros((N, R), np.int32)
    alloc[:, 0] = rng.choice([2000, 4000, 8000], N)
    alloc[:, 1] = rng.choice([4, 8, 16], N) * 1024
    alloc[:, 3] = rng.choice([3, 40, 110], N)
    alloc[:, 4] = rng.choice([0, 4], N)
    valid = rng.random(N) > 0.1
    req = np.zeros_like(alloc)
    req[:, 0] = rng.integers(0, 2000, N)
    req[:, 1] = rng.integers(0, 4096, N)
    req[:, 3] = rng.integers(0, 3, N)
    nzr = np.stack([req[:, 0], req[:, 1] + 100], axis=1).astype(np.int32)
    return alloc, valid, req, nzr


def _batch(seed):
    rng = np.random.default_rng(seed + 100)
    pod_req = np.zeros((B, R), np.int32)
    pod_req[:, 0] = rng.choice([0, 100, 250, 500], B)
    pod_req[:, 1] = rng.choice([0, 64, 128], B)
    pod_req[:, 3] = 1
    pod_req[:, 4] = rng.choice([0, 0, 1], B)
    pod_nzr = np.maximum(pod_req[:, :2], [100, 200]).astype(np.int32)
    midx = rng.integers(0, U, B).astype(np.int32)
    active = (rng.random(B) > 0.1).astype(np.int32)
    rows = rng.random((U, N)) > 0.2
    rows[U - 1] = False
    return [
        ("req", pod_req), ("nzr", pod_nzr), ("midx", midx),
        ("active", active), ("rows", rows),
    ]


def _patch_slots(alloc, valid, req, nzr):
    """Steady slots that patch req/nzr rows on both shards and flip a
    membership row (a retired slot), with padding slots."""
    host_req = req.copy()
    host_req[[0, 37, 38, N - 1]] += 11
    host_nzr = nzr.copy()
    host_nzr[[0, 37, 38, N - 1]] += 3
    new_alloc = alloc.copy()
    new_alloc[[2, 40]] *= 2
    new_valid = valid.copy()
    new_valid[[2, 40]] = [False, True]
    return jax_batch._delta_slot_pieces(
        N, R, fix_rows=np.array([0, 37, 38, N - 1]),
        alloc_rows=np.array([2, 40]), node_requested=host_req,
        node_nzr=host_nzr, allocatable=new_alloc, valid=new_valid,
    )


def _layout_chain(seed):
    """(pieces, resident-from-step) for cold, refresh, steady, patched."""
    alloc, valid, req, nzr = _state(seed)
    static = [("alloc", alloc), ("valid", valid.astype(np.int32))]
    carry = [("req_state", req), ("nzr_state", nzr)]
    return [
        (_batch(seed) + static + carry, None),
        (_batch(seed + 1) + carry, "static"),
        (_batch(seed + 2) + jax_batch._delta_slot_pieces(N, R), "all"),
        (_batch(seed + 3) + _patch_slots(alloc, valid, req, nzr), "all"),
    ]


def _resident(prev, which):
    if which is None:
        return (None,) * 4
    if which == "static":
        return (prev[3], prev[4], None, None)
    return (prev[3], prev[4], prev[1], prev[2])


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_packed_on_a_mesh_matches_the_jax_mesh(seed):
    jmesh = _jax_mesh(2)
    tmesh = NodeMesh(["cpu"] * 2)
    cfg_j, cfg_t = jax_asg.GreedyConfig(), torch_asg.GreedyConfig()
    w = g = s = None
    placed = 0
    for pieces, which in _layout_chain(seed):
        w = jax_asg.solve_packed(
            pieces, *_resident(w, which), config=cfg_j, mesh=jmesh
        )
        g = torch_asg.solve_packed(
            pieces, *_resident(g, which), config=cfg_t, device="cpu",
            mesh=tmesh,
        )
        single = [
            (name, a.astype(np.int32) if name == "rows" else a)
            for name, a in pieces
        ]
        s = torch_asg.solve_packed(
            single, *_resident(s, which), config=cfg_t, device="cpu"
        )
        _assert_equal(g, w)
        _assert_equal(g, s)
        assert all(isinstance(x, ShardedRows) for x in g[1:])
        assert [x.shape[0] for x in g[1].shards] == [38, 38]
        placed += int((_np(g[0]) >= 0).sum())
    assert placed > 0


def test_one_group_per_shard_takes_the_cross_device_path(monkeypatch):
    """Each shard its own device group -- what a mesh over distinct
    cards gives -- on CPU devices: one upload, one unpack, one K4 step
    and one working carry per group, the candidates meeting on the first
    group's device and the winner's row bumped on its own group. Places
    as the one-group mesh and the single-device solve."""
    monkeypatch.setattr(
        NodeMesh, "groups",
        lambda self: [(d, [k]) for k, d in enumerate(self.devices)],
    )
    tmesh = NodeMesh(["cpu"] * 3)
    cfg = torch_asg.GreedyConfig()
    g = s = None
    placed = 0
    for pieces, which in _layout_chain(5):
        g = torch_asg.solve_packed(
            pieces, *_resident(g, which), config=cfg, mesh=tmesh,
        )
        single = [
            (name, a.astype(np.int32) if name == "rows" else a)
            for name, a in pieces
        ]
        s = torch_asg.solve_packed(
            single, *_resident(s, which), config=cfg, device="cpu"
        )
        _assert_equal(g, s)
        placed += int((_np(g[0]) >= 0).sum())
    assert placed > 0
    import __graft_entry__

    args = __graft_entry__._example_problem(n_nodes=96, batch=32, seed=2)
    got = torch_asg.make_sharded_solver(tmesh)(*args)
    want = torch_asg.greedy_assign(*(_t(a) for a in args), config=cfg)
    _assert_equal(got, want)


def test_solve_packed_on_a_ragged_mesh():
    """76 rows over 3 shards (26, 25, 25): the JAX mesh takes its GSPMD
    twin for a ragged split; both place the same, and as one device."""
    jmesh = _jax_mesh(3)
    tmesh = NodeMesh(["cpu"] * 3)
    cfg_j, cfg_t = jax_asg.GreedyConfig(0, 0, 1), torch_asg.GreedyConfig(0, 0, 1)
    w = g = None
    for pieces, which in _layout_chain(7):
        w = jax_asg.solve_packed(
            pieces, *_resident(w, which), config=cfg_j, mesh=jmesh
        )
        g = torch_asg.solve_packed(
            pieces, *_resident(g, which), config=cfg_t, device="cpu",
            mesh=tmesh,
        )
        _assert_equal(g, w)
        assert [x.shape[0] for x in g[1].shards] == [26, 25, 25]


@pytest.mark.parametrize("layout", ["cold", "refresh", "steady"])
def test_constrained_batch_on_a_mesh_matches_the_jax_mesh(layout):
    """A constrained batch (spread and scoring live, affinity absent) on
    a 2-shard mesh: the port gathers onto the first device and runs the
    constrained solve; the JAX mesh its GSPMD twin. Bit for bit, and as
    the port's single-device solve."""
    jmesh = _jax_mesh(2)
    tmesh = NodeMesh(["cpu"] * 2)
    common, fams, noops = _packed_problem(11)
    alloc, req_state, nzr_state, valid = common[:4]
    jp, static_in, carry_in = _layouts(
        common, fams, noops, jax_asg.ConstPiece
    )[layout]
    tp, _, _ = _layouts(common, fams, noops, torch_asg.ConstPiece)[layout]

    def resident(put):
        return (
            put(alloc) if static_in else None,
            put(valid) if static_in else None,
            put(req_state) if carry_in else None,
            put(nzr_state) if carry_in else None,
        )

    want = jax_asg.solve_packed(
        jp, *resident(jnp.asarray), config=jax_asg.GreedyConfig(),
        mode="constrained", mesh=jmesh,
    )
    got = torch_asg.solve_packed(
        tp, *resident(lambda a: ShardedRows.split(tmesh, a)),
        config=torch_asg.GreedyConfig(), mode="constrained", device="cpu",
        mesh=tmesh,
    )
    single = torch_asg.solve_packed(
        tp, *resident(_t), config=torch_asg.GreedyConfig(),
        mode="constrained", device="cpu",
    )
    _assert_equal(got, want)
    _assert_equal(got, single)
    assert (_np(got[0]) >= 0).sum() > 0


def test_make_sharded_solver_matches_the_jax_package():
    """The stateless sharded entry on __graft_entry__'s example problem
    (the arrays the multichip dryrun hands it): same assignments and
    carry, every pod placed, capacity booked across shards."""
    import __graft_entry__

    args = __graft_entry__._example_problem(n_nodes=256, batch=64, seed=1)
    jmesh = _jax_mesh(2)
    with jmesh:
        want = jax_asg.make_sharded_solver(jmesh)(*args)
    got = torch_asg.make_sharded_solver(NodeMesh(["cpu"] * 2))(*args)
    _assert_equal(got, want)
    assert (_np(got[0]) >= 0).sum() == 64
    assert int(_np(got[1])[:, 0].sum()) == int(args[4][:, 0].sum())


def test_jax_sharded_carry_feeds_the_same_mesh_solve():
    """The JAX mesh's sharded resident carry, as numpy, goes into a port
    NodeMesh through carry_from_numpy; the next steady solve of both
    packages is the same."""
    jmesh = _jax_mesh(2)
    tmesh = NodeMesh(["cpu"] * 2)
    chain = _layout_chain(3)
    jcfg = jax_asg.GreedyConfig(0, 0, 1)
    cold = jax_asg.solve_packed(chain[0][0], None, None, None, None,
                                config=jcfg, mesh=jmesh)
    assert len(cold[1].addressable_shards) == 2
    carry, tcfg = torch_asg.carry_from_numpy(
        cold[3], cold[4], cold[1], cold[2], jcfg, None, mesh=tmesh,
    )
    assert all(isinstance(x, ShardedRows) for x in carry)
    assert carry[1].dtype == torch.bool
    pieces = chain[2][0]
    want = jax_asg.solve_packed(pieces, cold[3], cold[4], cold[1], cold[2],
                                config=jcfg, mesh=jmesh)
    got = torch_asg.solve_packed(pieces, *carry, config=tcfg, mesh=tmesh)
    _assert_equal(got, want)


def test_solve_packed_mesh_refuses_the_int16_carry():
    with pytest.raises(ValueError, match="int16"):
        torch_asg.solve_packed(
            _layout_chain(0)[0][0], None, None, None, None, compress=True,
            mesh=NodeMesh(["cpu"] * 2),
        )
