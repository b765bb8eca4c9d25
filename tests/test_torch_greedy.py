"""The port's greedy solve against the JAX package's.

The port's plain version (kubernetes_tpu_torch/ops/assignment.py
``greedy_assign_compact`` over ``_greedy_assign_impl``) runs on the CPU
against JAX ``greedy_assign_compact`` and against the Pallas kernel
``pallas_greedy_solve`` in interpret mode -- the same seeded numpy
inputs through each, compared bit for bit (assignments, requested',
nzr'): all state is int32 and the float32 score arithmetic is matched
op for op, so the tolerance is zero. The hand-written CUDA kernel cannot
run here; chip_smoke.py holds it against this plain version on the card.
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu.ops.pallas_solver import pallas_greedy_solve
from kubernetes_tpu_torch.device import resolve_device
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.ops import greedy_kernel

CONFIGS = {
    "default": (1, 1, 0),
    "most_allocated": (0, 0, 1),
    "all_three": (2, 1, 1),
    "none": (0, 0, 0),
}


def _configs(name):
    w = CONFIGS[name]
    return jax_asg.GreedyConfig(*w), torch_asg.GreedyConfig(*w)


def _random_problem(seed, n=192, b=256, r=6, u=8):
    """Scalar dims (r > 4), all-zero-request pods, over-committed dims,
    invalid rows, inactive padding and deduplicated mask rows."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = rng.choice([0, 2000, 4000, 8000], n)
    alloc[:, 1] = rng.choice([4, 8, 16, 64], n) * 1024 * 1024
    alloc[:, 2] = rng.choice([0, 1 << 20], n)
    alloc[:, 3] = rng.choice([3, 40, 110], n)
    if r > 4:
        alloc[:, 4:] = rng.choice([0, 2, 8], (n, r - 4))
    requested = np.zeros_like(alloc)
    requested[:, 0] = rng.integers(0, 2000, n)
    requested[:, 3] = rng.integers(0, 3, n)
    # over-committed rows: requested past allocatable on a fixed dim
    over = rng.random(n) < 0.05
    requested[over, 2] = alloc[over, 2] + 1
    nzr = np.zeros((n, 2), np.int32)
    nzr[:, 0] = requested[:, 0]
    nzr[:, 1] = rng.integers(0, 1 << 22, n)
    valid = rng.random(n) > 0.05
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = rng.choice([0, 100, 500, 1500], b)
    pod_req[:, 1] = rng.choice([0, 128, 512], b) * 1024
    pod_req[:, 3] = 1
    if r > 4:
        pod_req[:, 4:] = rng.choice([0, 0, 0, 1], (b, r - 4))
    zero = rng.random(b) < 0.1  # all-zero requests: the pods-dim check only
    pod_req[zero, :3] = 0
    pod_req[zero, 4:] = 0
    pod_nzr = np.maximum(pod_req[:, :2], [100, 200 * 1024]).astype(np.int32)
    rows = rng.random((u, n)) > 0.2
    rows[u - 1] = False  # the all-False row unsatisfiable pods point at
    midx = rng.integers(0, u, b).astype(np.int32)
    active = rng.random(b) > 0.1
    active[b - b // 8:] = False  # inactive padding tail
    return alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active


def _torch_args(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


def _assert_equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy()
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_example_problem_matches_jax():
    """__graft_entry__'s example problem (512 nodes x 64 pods), through
    the full-mask solve and the compact-mask solve of both packages."""
    args = __graft_entry__._example_problem(512, 64)
    jcfg, tcfg = _configs("default")
    want = jax_asg.greedy_assign(*args, config=jcfg)
    got = torch_asg.greedy_assign(*_torch_args(args), config=tcfg)
    _assert_equal(got, want)
    alloc, req, nzr, valid, pod_req, pod_nzr, static, active = args
    rows = np.ones((8, 512), bool)
    midx = np.zeros(64, np.int32)
    compact = (alloc, req, nzr, valid, pod_req, pod_nzr, rows, midx, active)
    _assert_equal(
        torch_asg.greedy_assign_compact(*_torch_args(compact), config=tcfg),
        jax_asg.greedy_assign_compact(*compact, config=jcfg),
    )


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 7, 21])
def test_random_batches_match_jax_compact(seed, config):
    args = _random_problem(seed)
    jcfg, tcfg = _configs(config)
    want = jax_asg.greedy_assign_compact(*args, config=jcfg)
    got = torch_asg.greedy_assign_compact(*_torch_args(args), config=tcfg)
    _assert_equal(got, want)
    assert (np.asarray(want[0]) >= 0).sum() > 0  # the case places pods


@pytest.mark.parametrize("config", ["default", "most_allocated"])
@pytest.mark.parametrize("seed", [3, 11])
def test_random_batches_match_pallas_interpret(seed, config):
    """The Pallas kernel's contract is the same function: interpret mode
    on the CPU (as tests/test_pallas_solver.py runs it) equals the port."""
    args = _random_problem(seed, n=128, b=128)
    jcfg, tcfg = _configs(config)
    want = pallas_greedy_solve(*args, config=jcfg, interpret=True)
    got = torch_asg.greedy_assign_compact(*_torch_args(args), config=tcfg)
    _assert_equal(got, want)


def test_wrapper_takes_the_plain_version_for_cpu_tensors():
    args = _random_problem(2, n=96, b=64, r=4)
    jcfg, tcfg = _configs("default")
    before = greedy_kernel.launches
    got = greedy_kernel.greedy_solve(*_torch_args(args), config=tcfg)
    _assert_equal(got, jax_asg.greedy_assign_compact(*args, config=jcfg))
    assert greedy_kernel.launches == before  # no kernel launched on the CPU


def _summation_order_problem():
    """Two 64Gi nodes (memKiB capacity 2^26). Node 0's memKiB total and
    the pod's are odd and above 2^24: summed in int32 then cast, node 0
    scores 107; each cast to float32 first, then summed, it scores 106.
    Node 1 scores 107 either way. The reference order ties 107/107 and
    the lowest index (node 0) wins; the cast-first order picks node 1."""
    alloc = np.array([[32000, 1 << 26, 0, 110]] * 2, np.int32)
    nzr = np.array([[23795, 27693749], [19410, 1 << 20]], np.int32)
    requested = np.zeros_like(alloc)
    requested[:, :2] = nzr
    valid = np.ones(2, bool)
    pod_req = np.array([[250, 586277, 0, 1]], np.int32)
    pod_nzr = pod_req[:, :2].copy()
    rows = np.ones((8, 2), bool)
    midx = np.zeros(1, np.int32)
    active = np.ones(1, bool)
    return alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active


def test_memkib_above_2_24_follows_the_int32_sum():
    """The port sums node total + pod request in int32 and then casts,
    as the reference scan and the host greedy tier do. The Pallas body
    casts each addend to float32 first (pallas_solver.py:87-93), and on
    this input it picks a different node: the JAX package's own kernel
    and scan disagree once memKiB sums pass 2^24 (ROADMAP Queue 3)."""
    args = _summation_order_problem()
    jcfg, tcfg = _configs("default")
    scan = jax_asg.greedy_assign_compact(*args, config=jcfg)
    got = torch_asg.greedy_assign_compact(*_torch_args(args), config=tcfg)
    _assert_equal(got, scan)
    assert int(np.asarray(scan[0])[0]) == 0
    pallas = pallas_greedy_solve(*args, config=jcfg, interpret=True)
    assert int(np.asarray(pallas[0])[0]) == 1


def test_large_memkib_random_batches_match_jax_compact():
    args = list(_random_problem(9, n=128, b=128, r=4))
    rng = np.random.default_rng(9)
    args[0][:, 1] = 1 << 26  # 64Gi nodes
    args[2][:, 1] = rng.integers(1 << 24, 1 << 25, 128) | 1
    args[4][:, 1] = rng.integers(1, 1 << 20, 128) | 1
    args[5][:, 1] = args[4][:, 1]
    jcfg, tcfg = _configs("default")
    _assert_equal(
        torch_asg.greedy_assign_compact(*_torch_args(args), config=tcfg),
        jax_asg.greedy_assign_compact(*args, config=jcfg),
    )


def test_kernel_wrapper_raises_off_the_card():
    """A CUDA-less run: the kernel wrapper refuses tensors that are not on
    the card, a non-CPU device has no plain fallback, and the default
    device (the card) raises instead of moving to the CPU."""
    args = _torch_args(_random_problem(1, n=64, b=16, r=4))
    with pytest.raises(greedy_kernel.KernelError):
        greedy_kernel.greedy_solve_cuda(*args)
    meta = [a.to("meta") for a in args]
    with pytest.raises(greedy_kernel.KernelError):
        greedy_kernel.greedy_solve(*meta)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device(None)
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_host_greedy_tier_matches_the_jax_package():
    """The numpy host-greedy tier (copied unchanged) replays the same
    placements as the JAX package's."""
    from kubernetes_tpu.robustness.ladder import (
        host_greedy_assign as jax_host,
    )
    from kubernetes_tpu_torch.robustness.ladder import host_greedy_assign

    args = _random_problem(4, n=96, b=96)
    jcfg, tcfg = _configs("all_three")
    want = jax_host(*args, config=jcfg)
    got = host_greedy_assign(*args, config=tcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _assert_equal(
        torch_asg.greedy_assign_compact(*_torch_args(args), config=tcfg),
        want,
    )


def test_ladder_never_steps_down_from_a_kernel_error():
    """A kernel that cannot build or launch fails loudly, and so does any
    other fault on the card's tier: the ladder re-raises it instead of
    solving on a CPU tier. Only a poison pod (the batch's fault) leaves
    the card's tier, for the containment bisection. On the CPU an
    ordinary device fault still steps down to the host greedy tier."""
    from kubernetes_tpu_torch.robustness.faults import PoisonError
    from kubernetes_tpu_torch.robustness.ladder import (
        LadderExhausted,
        RobustnessConfig,
        SolverLadder,
    )

    ladder = SolverLadder(RobustnessConfig(sleep=lambda _s: None))

    def broken_kernel():
        raise greedy_kernel.KernelError("nvcc failed")

    def device_fault():
        raise RuntimeError("transient device fault")

    def poison():
        raise PoisonError("pod-0")

    for tier in ("cuda", "torch"):
        with pytest.raises(greedy_kernel.KernelError):
            ladder.run([(tier, broken_kernel), ("host_greedy", lambda: 1)])
    with pytest.raises(RuntimeError, match="transient device fault"):
        ladder.run([("cuda", device_fault), ("host_greedy", lambda: 1)])
    assert ladder.solves_by_tier["host_greedy"] == 0
    assert "cuda" not in ladder.breakers
    with pytest.raises(LadderExhausted) as exc:
        ladder.run([("cuda", poison)])
    assert isinstance(exc.value.__cause__, PoisonError)
    tier, out = ladder.run([("torch", device_fault), ("host_greedy", lambda: 7)])
    assert (tier, out) == ("host_greedy", 7)
