"""The frozen yardsticks against what they were copied from."""

import numpy as np
import pytest
import torch

from portbench import roofline
from portbench.arrivals import poisson_trace


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_the_poisson_copy_gives_the_programs_offsets(seed):
    from kubernetes_tpu_torch.streaming.arrivals import poisson_trace as prog

    for rate, duration in ((4000.0, 20.0), (37.5, 3.0)):
        assert np.array_equal(poisson_trace(rate, duration, seed),
                              prog(rate, duration, seed))


def _random_problem(seed, n, b, r, u):
    """The per-kernel check's seeded K1 problem at the burst's shape."""
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, r), np.int32)
    alloc[:, 0] = rng.choice([0, 4000, 16000, 32000], n)
    alloc[:, 1] = rng.choice([8, 16, 64], n) * 1024 * 1024
    alloc[:, 2] = rng.choice([0, 1 << 20], n)
    alloc[:, 3] = rng.choice([3, 40, 110], n)
    requested = np.zeros_like(alloc)
    requested[:, 0] = rng.integers(0, 4000, n)
    requested[:, 1] = rng.integers(0, 1 << 22, n)
    requested[:, 3] = rng.integers(0, 3, n)
    over = rng.random(n) < 0.02
    requested[over, 2] = alloc[over, 2] + 1
    nzr = requested[:, :2].copy()
    nzr[:, 1] += rng.integers(0, 1 << 20, n).astype(np.int32)
    valid = rng.random(n) > 0.05
    valid[n - n // 10:] = False
    pod_req = np.zeros((b, r), np.int32)
    pod_req[:, 0] = rng.choice([0, 100, 250, 1000], b)
    pod_req[:, 1] = rng.choice([0, 128, 512, 2048], b) * 1024
    pod_req[:, 3] = 1
    zero = rng.random(b) < 0.05
    pod_req[zero, :3] = 0
    pod_nzr = np.maximum(pod_req[:, :2], [100, 200 * 1024]).astype(np.int32)
    rows = rng.random((u, n)) > 0.1
    rows[u - 1] = False
    midx = rng.integers(0, u, b).astype(np.int32)
    active = rng.random(b) > 0.02
    active[b - b // 16:] = False
    return [alloc, requested, nzr, valid, pod_req, pod_nzr, rows, midx, active]


def test_k1s_bound_at_the_burst_shape_is_the_kernel_tables():
    """K1 at B=4,096, N=5,632: 0.0213 ms, bound by operations."""
    from kubernetes_tpu_torch.ops.assignment import greedy_assign_compact

    host = _random_problem(0, n=5632, b=4096, r=4, u=8)
    asg, _, _ = greedy_assign_compact(*[torch.from_numpy(a) for a in host])
    alloc, requested, _, valid, pod_req, _, rows, midx, active = host
    rec = roofline.k1_launch(alloc, requested, valid, pod_req, rows, midx,
                             active, asg.numpy())
    assert rec["bound_by"] == "operations"
    assert round(rec["least_s"] * 1e3, 4) == 0.0213
    assert rec["bytes"] == roofline.kernel_bytes(5632, 4096, 4, 8)


def test_k2s_count_of_a_spread_batch():
    n, b = 4, 2
    alloc = np.tile(np.array([32000, 1 << 26, 0, 110], np.int32), (n, 1))
    common = [alloc, np.zeros_like(alloc), np.zeros((n, 2), np.int32),
              np.ones(n, bool), np.tile(np.array([100, 1024, 0, 1], np.int32),
                                        (b, 1)),
              np.tile(np.array([100, 1024], np.int32), (b, 1)),
              np.ones((1, n), bool), np.zeros(b, np.int32), np.ones(b, bool)]
    spread = [np.zeros((1, 2), np.int32), np.ones((1, 2), bool),
              np.array([[0, 0, 1, 1]], np.int32), np.zeros((b, 1), np.int32),
              np.ones((b, 1), np.int32), np.ones((b, 1), np.int32),
              np.ones((b, 1), np.int32)]
    affinity = [np.zeros(0, np.int32)] * 14
    affinity[3] = affinity[8] = np.full((b, 1), -1, np.int32)
    affinity[12] = np.zeros((b, 1), np.int32)
    scoring = [np.zeros(0, np.int32)] * 20
    scoring[7] = np.full(b, -1, np.int32)
    scoring[11] = np.full((b, 1), -1, np.int32)
    scoring[13] = np.full((1, n), -1, np.int32)
    rec = roofline.k2_launch(common, spread, affinity, scoring,
                             np.array([0, 2], np.int32))
    # pod 0: 4 tested, 4 fit, 4 feasible; pod 1: the first value is one
    # above the least, so 2 feasible. Per pair: fit 13, spread slot 7,
    # score 52 + 18; per slot 2 x 2 values.
    assert (rec["pairs_tested"], rec["pairs_fit"], rec["pairs_feasible"]) == (
        8, 8, 6)
    assert rec["ops"] == (4 * 13 + 4 * 7 + 4 * 70 + 4) + (
        4 * 13 + 4 * 7 + 2 * 70 + 4)
    affinity[3] = np.zeros((b, 1), np.int32)
    assert roofline.k2_launch(common, spread, affinity, scoring,
                              np.array([0, 2], np.int32)) is None


def test_a_share_pairs_the_captured_launches_in_order():
    from portbench.readers import roofline_share

    recs = [{"least_s": 1.0}, None, {"least_s": 2.0}]
    # the profiler also ran a launch after the capture stopped
    assert roofline_share(recs, [10.0, 5.0, 10.0, 7.0]) == 15.0
    assert roofline_share(recs, [10.0, 5.0]) is None
    assert roofline_share([None], [3.0]) is None
