"""The port's sinkhorn mode against the JAX package's.

- The plan (``ops/sinkhorn.sinkhorn_plan``) and the 1e4-scaled prior
  (``refine_scores``) against the JAX package's on seeded scores: max
  abs 1e-6 on the plan and 1e-2 on the prior. Not zero, because a
  ``logsumexp`` reduces in another order in torch than in XLA (which
  also fuses the exponentials into the reduction), so the two differ in
  the last bits of each reduction, carried over 50 iterations (ROADMAP
  Queue 3 item 7). The JAX package's three plan properties (capacities,
  no mass on infeasible cells, contention) hold on the port's plan.
- The commit scans are bit-equal: ``greedy_assign_scored`` against the
  JAX package's on one score matrix, and ``sinkhorn_commit`` fed the
  JAX package's own prior against the JAX commit scan (assignment,
  requested' and nzr'), at the default weights, most-allocated alone at
  weight 2 and odd weights. Every resource score is an integer-valued
  float32 below 2^24 and every weight an integer, so ``prior + w * s``
  rounds once whether or not XLA contracts it into an FMA: the port adds
  the exact product.
- ``sinkhorn_assign`` against the JAX package's on seeded heterogeneous
  and homogeneous loads: placements, requested' and nzr' equal. On these
  seeds no two candidate nodes lie closer than the plan's last-bit
  difference, so placement equality is the test (ROADMAP Queue 3 item 7
  says why that is not guaranteed).

The packed, mesh and scheduler paths of the mode are in
test_torch_sinkhorn_sched.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu.ops import sinkhorn as jax_sk
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.ops import greedy_kernel
from kubernetes_tpu_torch.ops import sinkhorn as torch_sk
from kubernetes_tpu_torch.ops.kernel_build import KernelError
from kubernetes_tpu_torch.scheduler.batch import BatchScheduler

from test_torch_greedy import _random_problem
from test_torch_mesh import _assert_equal, _t
from test_torch_packed import _batch

PLAN_TOL = 1e-6
PRIOR_TOL = 1e-2

CONFIGS = {
    "default": (1, 1, 0),
    "most_allocated_w2": (0, 0, 2),
    "odd_weights": (3, 5, 7),
}


def _homogeneous_problem(n=96, b=160, r=4, u=2):
    """Identical nodes and identical pods: the plan is near-uniform and
    the dynamic score breaks its ties with within-batch load feedback."""
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 32000
    alloc[:, 1] = 64 * 1024 * 1024
    alloc[:, 3] = 110
    requested = np.zeros_like(alloc)
    nzr = np.zeros((n, 2), np.int32)
    valid = np.ones(n, bool)
    valid[n - 8:] = False  # capacity padding
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = 100
    pod_req[:, 1] = 128 * 1024
    pod_req[:, 3] = 1
    pod_nzr = pod_req[:, :2].copy()
    rows = np.ones((u, n), bool)
    midx = np.zeros(b, np.int32)
    active = np.ones(b, bool)
    active[b - 16:] = False
    return alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active


def _churned_problem(seed, n=128, b=96, r=4):
    """A cluster part-full after churn (uneven per-node load, some nodes
    near their pod cap) and a batch of one pod shape on one mask row."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 32000
    alloc[:, 1] = 64 * 1024 * 1024
    alloc[:, 3] = 110
    pods = rng.integers(0, 110, n)
    pods[rng.random(n) < 0.1] = 109
    requested = np.zeros_like(alloc)
    requested[:, 0] = pods * 100
    requested[:, 1] = pods * 128 * 1024
    requested[:, 3] = pods
    nzr = requested[:, :2].copy()
    valid = np.ones(n, bool)
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = 100
    pod_req[:, 1] = 128 * 1024
    pod_req[:, 3] = 1
    pod_nzr = pod_req[:, :2].copy()
    rows = np.ones((1, n), bool)
    midx = np.zeros(b, np.int32)
    active = np.ones(b, bool)
    return alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active


PROBLEMS = {
    "random_0": lambda: _random_problem(0, n=128, b=96, r=4),
    "random_1_scalar": lambda: _random_problem(1, n=128, b=96),
    "churned_2": lambda: _churned_problem(2),
    "churned_3": lambda: _churned_problem(3),
    "homogeneous": _homogeneous_problem,
    "homogeneous_r6": lambda: _homogeneous_problem(r=6, u=3),
}


def _plan_inputs(seed, b=48, n=80):
    rng = np.random.default_rng(seed)
    score = (rng.integers(0, 201, (b, n))).astype(np.float32)
    feasible = rng.random((b, n)) > 0.3
    slots = rng.choice([0.0, 1.0, 2.0, 3.5, 110.0], n).astype(np.float32)
    active = rng.random(b) > 0.1
    return score, feasible, slots, active


# -- the plan -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_and_prior_within_tolerance_of_the_jax_plan(seed):
    score, feasible, slots, active = _plan_inputs(seed)
    j_in = [jnp.asarray(a) for a in (score, feasible, slots, active)]
    t_in = [_t(a) for a in (score, feasible, slots, active)]
    want = np.asarray(jax_sk.sinkhorn_plan(*j_in))
    got = torch_sk.sinkhorn_plan(*t_in).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= PLAN_TOL
    want_r = np.asarray(jax_sk.refine_scores(*j_in))
    got_r = torch_sk.refine_scores(*t_in).numpy()
    assert np.abs(got_r - want_r).max() <= PRIOR_TOL
    # inactive rows carry no mass
    assert got[~active].max() < 1e-6


def test_plan_respects_capacities():
    b, n = 6, 3
    plan = torch_sk.sinkhorn_plan(
        torch.zeros((b, n)), torch.ones((b, n), dtype=torch.bool),
        torch.tensor([1.0, 2.0, 3.0]), torch.ones(b, dtype=torch.bool),
    ).numpy()
    assert (plan.sum(axis=0) <= np.array([1.0, 2.0, 3.0]) + 0.05).all()
    assert np.allclose(plan.sum(axis=1), 1.0, atol=0.05)


def test_infeasible_cells_carry_no_mass():
    plan = torch_sk.sinkhorn_plan(
        torch.zeros((2, 2)), torch.tensor([[True, False], [True, True]]),
        torch.tensor([5.0, 5.0]), torch.ones(2, dtype=torch.bool),
    ).numpy()
    assert plan[0, 1] < 1e-6


def test_global_plan_beats_myopic_contention():
    """Node 0 scores higher for both pods but has one slot: the plan
    routes the pod that needs it less to node 1."""
    plan = torch_sk.sinkhorn_plan(
        torch.tensor([[10.0, 9.0], [10.0, 1.0]]),
        torch.ones((2, 2), dtype=torch.bool), torch.tensor([1.0, 1.0]),
        torch.ones(2, dtype=torch.bool), tau=2.0,
    ).numpy()
    assert plan[1, 0] > plan[0, 0]
    assert plan[0, 1] > plan[1, 1]


def test_fits_batch_equals_the_per_pod_fit():
    """The prior's batch fit, one dimension at a time, equals ``_fits``
    per pod: scalar dims, all-zero pods, over-committed rows."""
    alloc, requested, _, _, pod_req, *_ = _random_problem(5)
    free = _t(alloc) - _t(requested)
    got = torch_asg._fits_batch(free, _t(pod_req))
    want = torch.stack([torch_asg._fits(free, _t(p)) for p in pod_req])
    assert torch.equal(got, want)


# -- the commit scans -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_greedy_assign_scored_matches_the_jax_scan(seed):
    alloc, requested, _, valid, pod_req, _, rows, midx, active = (
        _random_problem(seed)
    )
    static = rows[midx]
    score = np.random.default_rng(seed).random(static.shape).astype(np.float32)
    args = (alloc, requested, valid, pod_req, static, active, score)
    want = jax_asg.greedy_assign_scored(*[jnp.asarray(a) for a in args])
    got = torch_asg.greedy_assign_scored(*[_t(a) for a in args])
    _assert_equal(got, want)
    assert (got[0].numpy() >= 0).any()


def test_scored_scan_commits_feasible_assignment():
    n, b, r = 4, 6, 4
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = 2000
    alloc[:, 3] = 10
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = 1000
    pod_req[:, 3] = 1
    static = torch.ones((b, n), dtype=torch.bool)
    active = torch.ones(b, dtype=torch.bool)
    score = torch_sk.refine_scores(
        torch.zeros((b, n)), static, torch.full((n,), 2.0), active
    )
    a, req_out = torch_asg.greedy_assign_scored(
        _t(alloc), torch.zeros((n, r), dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), _t(pod_req), static, active, score,
    )
    a = a.numpy()
    assert (a != torch_asg.NO_NODE).all()
    assert (req_out.numpy()[:, 0] <= 2000).all()
    assert np.bincount(a, minlength=n).max() <= 2


def _jax_sinkhorn(args, cfg):
    """The JAX package's ``sinkhorn_assign`` on one batch, compiled
    afresh with ``refine_scores`` wrapped to hand its output (the prior
    the commit scan ranks by) to the host: returns (assignment,
    requested', nzr', prior) as numpy."""
    inner = jax_asg.sinkhorn_assign.__wrapped__
    orig = jax_sk.refine_scores
    seen = []

    def record(*a, **k):
        out = orig(*a, **k)
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), out)
        return out

    jax_sk.refine_scores = record
    try:
        fn = jax.jit(lambda *a, config: inner(*a, config=config),
                     static_argnames=("config",))
        out = [np.asarray(x) for x in fn(*[jnp.asarray(a) for a in args],
                                         config=cfg)]
    finally:
        jax_sk.refine_scores = orig
    return (*out, seen[0])


@pytest.mark.parametrize("config", list(CONFIGS), ids=list(CONFIGS))
@pytest.mark.parametrize("problem", ["random_0", "churned_2", "homogeneous"])
def test_sinkhorn_commit_on_the_jax_prior_is_bit_equal(problem, config):
    args = PROBLEMS[problem]()
    w = CONFIGS[config]
    cfg_j, cfg_t = jax_asg.GreedyConfig(*w), torch_asg.GreedyConfig(*w)
    *want, prior = _jax_sinkhorn(args, cfg_j)
    got = torch_asg.sinkhorn_commit(*[_t(a) for a in args], _t(prior),
                                    config=cfg_t)
    _assert_equal(got, want)
    # the wrapper's CPU route is the same plain loop
    again = greedy_kernel.greedy_solve(*[_t(a) for a in args], config=cfg_t,
                                       prior=_t(prior))
    _assert_equal(again, got)
    assert (got[0].numpy() >= 0).sum() > 0


@pytest.mark.parametrize("problem", ["random_0", "churned_2"])
def test_sinkhorn_prior_within_tolerance_of_the_jax_prior(problem):
    args = PROBLEMS[problem]()
    want = _jax_sinkhorn(args, jax_asg.GreedyConfig())[3]
    got = torch_asg.sinkhorn_prior(*[_t(a) for a in args]).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= PRIOR_TOL


def test_prior_of_the_wrong_shape_dtype_or_device_raises():
    args = [_t(a) for a in _random_problem(0, n=32, b=16, r=4)]
    good = torch.zeros((16, 32))
    for bad in (torch.zeros((16, 31)), good.double(), good.to("meta")):
        with pytest.raises(KernelError):
            greedy_kernel.greedy_solve(*args, prior=bad)


# -- the whole mode -------------------------------------------------------------

@pytest.mark.parametrize("problem", list(PROBLEMS), ids=list(PROBLEMS))
def test_sinkhorn_assign_places_as_the_jax_package(problem):
    args = PROBLEMS[problem]()
    want = jax_asg.sinkhorn_assign(*[jnp.asarray(a) for a in args])
    got = torch_asg.sinkhorn_assign(*[_t(a) for a in args])
    _assert_equal(got, want)
    placed = got[0].numpy()
    assert (placed >= 0).sum() > 0
    # every placement fits: a bumped entry stays within allocatable
    alloc, requested = args[0], args[1]
    req_out = got[1].numpy()
    bumped = req_out != requested
    assert (req_out[bumped] <= alloc[bumped]).all()


def test_homogeneous_load_spreads():
    """The slot cap binds and the dynamic score breaks ties: identical
    pods over identical nodes spread rather than pile on node 0."""
    args = _homogeneous_problem()
    got = torch_asg.sinkhorn_assign(*[_t(a) for a in args])[0].numpy()
    counts = np.bincount(got[got >= 0], minlength=args[0].shape[0])
    assert counts.max() <= 3


def test_unknown_solve_modes_are_rejected():
    with pytest.raises(ValueError, match="unknown solve mode"):
        torch_asg.solve_packed(_batch(0), None, None, None, None,
                               mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="unknown solver_mode"):
        BatchScheduler(solver_mode="bogus", device="cpu")
