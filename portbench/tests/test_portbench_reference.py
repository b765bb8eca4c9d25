"""The frozen reference against the port's plain solve, and its control.

The reference is held to the port's plain PyTorch greedy solve (the
version the CUDA kernel K1 is bit-equal to) on seeded clusters, so that
an exact comparison on the card means what it says. Its float32 scalar
path is held to its array path bit for bit. The control, the reference
in bfloat16, must place differently."""

import numpy as np
import pytest
import torch

from portbench.reference.scheduler import (
    BF16, FLOAT32, Cluster, PodSpec, _score_one_f32, resource_scores,
)


def _random_cluster(rng, n):
    alloc = np.zeros((n, 4), np.int64)
    alloc[:, 0] = rng.choice([4000, 16000, 32000], n)
    alloc[:, 1] = rng.choice([8, 16, 64], n) * 1024 * 1024
    alloc[:, 3] = rng.choice([10, 40, 110], n)
    return alloc


def _random_pods(rng, b):
    cpus = rng.choice([0, 100, 250, 1000], b)
    mems = rng.choice([0, 128, 512, 2048], b) * 1024
    return [PodSpec(req=(int(c), int(m), 0, 1)) for c, m in zip(cpus, mems)]


@pytest.mark.parametrize("seed", [0, 1, 2, 2**33 + 5])
def test_scalar_score_is_the_array_score(seed):
    rng = np.random.default_rng(seed)
    cap = np.stack([rng.choice([0, 4000, 32000, 96000], 4000),
                    rng.choice([0, 8, 64, 512], 4000) * 1024 * 1024], 1)
    req = np.stack([rng.integers(0, 100000, 4000),
                    rng.integers(0, 1 << 29, 4000)], 1)
    vec = resource_scores(cap, req, FLOAT32)
    one = [_score_one_f32(*map(int, c), *map(int, r)) for c, r in zip(cap, req)]
    assert np.array_equal(vec, np.array(one, np.float32))


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_reference_places_as_the_ports_plain_solve(seed):
    from kubernetes_tpu_torch.ops.assignment import greedy_assign_compact

    rng = np.random.default_rng(seed)
    n, b = 96, 400
    alloc = _random_cluster(rng, n)
    pods = _random_pods(rng, b)
    ref = Cluster(alloc, {"zone": np.zeros(n, np.int64)})
    want = ref.place_all(pods)

    i32 = torch.int32
    req = torch.tensor([p.req for p in pods], dtype=i32)
    nzr = torch.tensor([p.nzr for p in pods], dtype=i32)
    got, _, _ = greedy_assign_compact(
        torch.tensor(alloc, dtype=i32), torch.zeros((n, 4), dtype=i32),
        torch.zeros((n, 2), dtype=i32), torch.ones(n, dtype=torch.bool),
        req, nzr, torch.ones((1, n), dtype=torch.bool),
        torch.zeros(b, dtype=i32), torch.ones(b, dtype=torch.bool))
    assert got.tolist() == want
    assert sum(1 for r in want if r < 0) < b


def test_the_bfloat16_control_places_differently():
    n = 200
    alloc = np.tile([32000, 64 * 1024 * 1024, 0, 110], (n, 1))
    pods = [PodSpec(req=(250, 512 * 1024, 0, 1))] * 800
    zones = {"zone": np.arange(n) % 10}
    f32 = Cluster(alloc, zones, FLOAT32).place_all(pods)
    bf16 = Cluster(alloc, zones, BF16).place_all(pods)
    assert sum(a != b for a, b in zip(f32, bf16)) > 0
