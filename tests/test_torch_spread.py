"""The port's ``greedy_assign_spread`` against the JAX package's.

``kubernetes_tpu_torch/ops/assignment.greedy_assign_spread`` is a plain
torch loop over the batch: the greedy step with hard topology-spread
filtering (the skew rule against the least count over a group's valid
values, -1 meaning ineligible) and the per-group count replay. The JAX
function is an XLA scan (``kubernetes_tpu/ops/assignment.py:207``).
Both run here on the same seeded numpy inputs on the CPU; the
assignment, requested', nzr' and group_counts' must be bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import assignment as jax_asg
from kubernetes_tpu_torch.ops import assignment as torch_asg
from kubernetes_tpu_torch.ops.assignment import GreedyConfig

NAMES = (
    "allocatable", "requested", "nzr", "valid", "pod_requests", "pod_nzr",
    "static_mask", "active", "group_counts", "value_valid", "node_value",
    "pod_groups", "pod_max_skew", "pod_self", "pod_match",
)


def _problem(seed, n=24, b=40, r=4, g=3, v=4, c=2, homogeneous=False,
             no_valid_group=False, skew=None, inactive_every=0):
    """A seeded spread batch: nodes with some invalid rows and some with
    no eligible value in a group, several constraint slots per pod with
    -1 pads, pods that match some groups only, initial counts near the
    skew limit."""
    rng = np.random.default_rng(seed)
    if homogeneous:
        alloc = np.tile(np.array([8000, 16 << 20, 0, 20][:r], np.int32), (n, 1))
    else:
        alloc = np.stack([
            rng.integers(2000, 16000, n), rng.integers(4 << 20, 32 << 20, n),
            np.zeros(n, np.int64), rng.integers(4, 30, n),
        ], axis=1)[:, :r].astype(np.int32)
    requested = np.zeros_like(alloc)
    if not homogeneous:
        requested[:, 0] = rng.integers(0, 2000, n)
        requested[:, 3] = rng.integers(0, 3, n)
    nzr = np.stack([np.maximum(requested[:, 0], 100),
                    np.maximum(requested[:, 1], 200 << 10)], 1).astype(np.int32)
    valid = rng.random(n) > 0.1
    pod_req = np.stack([
        rng.integers(100, 1500, b), rng.integers(128 << 10, 2 << 20, b),
        np.zeros(b, np.int64), np.ones(b, np.int64),
    ], axis=1)[:, :r].astype(np.int32)
    if homogeneous:
        pod_req[:] = pod_req[0]
    pod_nzr = np.stack([np.maximum(pod_req[:, 0], 100),
                        np.maximum(pod_req[:, 1], 200 << 10)], 1).astype(np.int32)
    static = rng.random((b, n)) > 0.15
    active = np.ones(b, bool)
    if inactive_every:
        active[::inactive_every] = False
    counts = rng.integers(0, 3, (g, v)).astype(np.int32)
    value_valid = rng.random((g, v)) > 0.2
    if no_valid_group:
        value_valid[g - 1] = False
    node_value = rng.integers(-1, v, (g, n)).astype(np.int32)
    node_value[0, : n // 4] = -1  # a block of nodes ineligible in group 0
    pod_groups = rng.integers(-1, g, (b, c)).astype(np.int32)
    pod_groups[::5, :] = -1  # pods with no constraint at all
    pod_max_skew = (
        np.full((b, c), skew, np.int32) if skew is not None
        else rng.integers(1, 3, (b, c)).astype(np.int32)
    )
    pod_self = rng.integers(0, 2, (b, c)).astype(np.int32)
    pod_match = (rng.random((b, g)) > 0.4).astype(np.int32)
    return dict(zip(NAMES, (
        alloc, requested, nzr, valid, pod_req, pod_nzr, static, active,
        counts, value_valid, node_value, pod_groups, pod_max_skew, pod_self,
        pod_match,
    )))


CASES = {
    "random": dict(seed=0),
    "skew_at_the_limit": dict(seed=1, skew=1),
    "group_with_no_valid_value": dict(seed=2, no_valid_group=True),
    "several_constraints": dict(seed=3, c=3, g=4),
    "inactive_pods": dict(seed=4, inactive_every=3),
    "ties_lowest_index": dict(seed=5, homogeneous=True, skew=1),
}


@pytest.mark.parametrize("config", [
    GreedyConfig(),
    GreedyConfig(least_allocated_weight=0, balanced_allocation_weight=0,
                 most_allocated_weight=2),
], ids=["default", "most_allocated"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_spread_scan_is_bit_equal_to_the_jax_scan(case, config):
    prob = _problem(**CASES[case])
    jcfg = jax_asg.GreedyConfig(
        least_allocated_weight=config.least_allocated_weight,
        balanced_allocation_weight=config.balanced_allocation_weight,
        most_allocated_weight=config.most_allocated_weight,
    )
    want = jax_asg.greedy_assign_spread(
        *[jnp.asarray(prob[k]) for k in NAMES], config=jcfg
    )
    got = torch_asg.greedy_assign_spread(
        *[torch.from_numpy(np.array(prob[k])) for k in NAMES], config=config
    )
    for name, g, w in zip(("assignment", "requested'", "nzr'", "counts'"),
                          got, want):
        w = np.asarray(w)
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    placed = got[0].numpy()
    assert (placed >= 0).any()
    if "inactive" in case:
        assert (placed[~prob["active"]] == -1).all()


def test_spread_replays_counts_within_the_batch():
    """Eight pods of one maxSkew=1 constraint over two zones of two
    nodes land 4/4 in one batch (the reference's own shape), and the
    count replay leaves 4 and 4."""
    n, b = 4, 8
    alloc = np.tile(np.array([16000, 32 << 20, 0, 110], np.int32), (n, 1))
    zero = np.zeros_like(alloc)
    prob = dict(zip(NAMES, (
        alloc, zero, zero[:, :2].copy(), np.ones(n, bool),
        np.tile(np.array([500, 512 << 10, 0, 1], np.int32), (b, 1)),
        np.tile(np.array([500, 512 << 10], np.int32), (b, 1)),
        np.ones((b, n), bool), np.ones(b, bool),
        np.zeros((1, 2), np.int32), np.ones((1, 2), bool),
        np.array([[0, 0, 1, 1]], np.int32),
        np.zeros((b, 1), np.int32), np.ones((b, 1), np.int32),
        np.ones((b, 1), np.int32), np.ones((b, 1), np.int32),
    )))
    asg, _, _, counts = torch_asg.greedy_assign_spread(
        *[torch.from_numpy(prob[k]) for k in NAMES]
    )
    want = jax_asg.greedy_assign_spread(*[jnp.asarray(prob[k]) for k in NAMES])
    np.testing.assert_array_equal(asg.numpy(), np.asarray(want[0]))
    zones = np.array([0, 0, 1, 1])[asg.numpy()]
    assert (np.bincount(zones) == [4, 4]).all()
    assert counts.numpy().tolist() == [[4, 4]]
