"""The port's resource scorers (kubernetes_tpu_torch/ops/scores.py)
against the JAX package's (kubernetes_tpu/ops/scores.py): the same
seeded numpy inputs through both, compared bit for bit -- the scores are
float32 floors of exact integer sums, so the tolerance is zero.

Cases: random clusters, zero capacities, over-capacity requests, every
floor boundary of a small capacity, and memKiB sums above 2^24 (where
summing before the cast matters).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetes_tpu.ops import scores as jax_scores
from kubernetes_tpu_torch.ops import scores as torch_scores

SCORERS = (
    "least_allocated_score",
    "balanced_allocation_score",
    "most_allocated_score",
)


def _random_case(seed):
    rng = np.random.default_rng(seed)
    n, b = 96, 16
    caps = np.stack(
        [
            rng.choice([0, 1000, 2000, 3333, 32000], n),
            rng.choice([0, 1 << 20, 3 << 20, 64 << 20], n),
        ],
        axis=1,
    ).astype(np.int32)
    nzr = np.stack(
        [rng.integers(0, 40000, n), rng.integers(0, 80 << 20, n)], axis=1
    ).astype(np.int32)
    pod_nzr = np.stack(
        [rng.choice([0, 100, 250, 1000], b),
         rng.choice([0, 200 << 10, 512 << 10], b)],
        axis=1,
    ).astype(np.int32)
    return caps, nzr, pod_nzr


def _zero_caps_case():
    caps = np.array([[0, 0], [0, 1 << 20], [1000, 0], [1, 1]], np.int32)
    nzr = np.array([[0, 0], [5, 7], [999, 0], [0, 1]], np.int32)
    pod_nzr = np.array([[0, 0], [1, 1], [100, 200]], np.int32)
    return caps, nzr, pod_nzr


def _over_capacity_case():
    caps = np.array([[1000, 4096], [4000, 1 << 20], [250, 512]], np.int32)
    nzr = np.array([[900, 4000], [4000, 1 << 20], [250, 511]], np.int32)
    pod_nzr = np.array([[100, 96], [101, 97], [0, 1], [5000, 0]], np.int32)
    return caps, nzr, pod_nzr


def _floor_boundary_case():
    # cap 1000 / 3000: (cap - req) * 100 / cap crosses an integer every 10
    # (resp. 30) units -- walk every request so each boundary is hit
    # exactly and from both sides, in both dimensions
    req = np.arange(0, 3101, dtype=np.int32)
    caps = np.array([[1000, 3000], [3000, 1000], [7, 3]], np.int32)
    nzr = np.zeros((3, 2), np.int32)
    pod_nzr = np.stack([req, req[::-1]], axis=1).astype(np.int32)
    return caps, nzr, pod_nzr


def _large_mem_case():
    # memKiB sums above 2^24 (64Gi nodes are 2^26 KiB), odd values
    rng = np.random.default_rng(5)
    n, b = 64, 32
    caps = np.stack(
        [np.full(n, 32000), np.full(n, 1 << 26)], axis=1
    ).astype(np.int32)
    nzr = np.stack(
        [rng.integers(0, 32000, n), (rng.integers(1 << 24, 1 << 26, n) | 1)],
        axis=1,
    ).astype(np.int32)
    pod_nzr = np.stack(
        [rng.integers(1, 500, b), (rng.integers(1, 1 << 20, b) | 1)], axis=1
    ).astype(np.int32)
    return caps, nzr, pod_nzr


CASES = {
    "random0": lambda: _random_case(0),
    "random1": lambda: _random_case(1),
    "zero_caps": _zero_caps_case,
    "over_capacity": _over_capacity_case,
    "floor_boundaries": _floor_boundary_case,
    "large_mem": _large_mem_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("scorer", SCORERS)
def test_scorer_matches_jax(scorer, case):
    caps, nzr, pod_nzr = CASES[case]()
    want = np.asarray(
        getattr(jax_scores, scorer)(
            jnp.asarray(caps), jnp.asarray(nzr), jnp.asarray(pod_nzr)
        )
    )
    got = getattr(torch_scores, scorer)(
        torch.from_numpy(caps), torch.from_numpy(nzr),
        torch.from_numpy(pod_nzr),
    )
    assert got.dtype == torch.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_constants_match_jax():
    assert torch_scores.MAX_NODE_SCORE == jax_scores.MAX_NODE_SCORE
    assert torch_scores._EPS == jax_scores._EPS
