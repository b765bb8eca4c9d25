"""The port's resource ops against the sequential oracle plugins and
against the JAX package, on the CPU.

Twins of the 12 cases of ``tests/test_ops.py``: the fit mask, the
LeastAllocated and BalancedAllocation scores and the greedy solve of
``kubernetes_tpu_torch/ops`` (``fit_mask``, ``least_allocated_score``,
``balanced_allocation_score``, ``greedy_assign`` over
``ops/assignment.py`` and ``ops/scores.py``) on identical seeded
snapshots in both packages. Every case runs the JAX op and the port's op
on the same packed arrays and requires them equal, bit for bit
(tolerance zero: masks, assignments and int32 state are integers, the
scores float32 floors of exact sums); then it holds the port's answer
to the reference test's own checks against the port's
``plugins/noderesources`` (balanced within 1 of the oracle's float64
truncation, as the reference allows).
"""

import importlib
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

ROOTS = {"jax": "kubernetes_tpu", "torch": "kubernetes_tpu_torch"}


def _side(pkg):
    root = ROOTS[pkg]

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        pkg=pkg,
        new_snapshot=m("cache.snapshot").new_snapshot,
        CycleState=m("framework.interface").CycleState,
        ops=m("ops"),
        NO_NODE=m("ops.assignment").NO_NODE,
        noderesources=m("plugins.noderesources"),
        SNAPSHOT_STATE_KEY=m("scheduler.generic").SNAPSHOT_STATE_KEY,
        NodeTensorCache=m("tensors").NodeTensorCache,
        pack_pod_batch=m("tensors").pack_pod_batch,
        make_node=m("testing").make_node,
        make_pod=m("testing").make_pod,
    )


SIDES = {pkg: _side(pkg) for pkg in ROOTS}
PORT, JAX = SIDES["torch"], SIDES["jax"]


def _call(side, fn, *arrays, **kw):
    """One op of ``side`` on numpy inputs; numpy outputs."""
    conv = jnp.asarray if side.pkg == "jax" else torch.from_numpy
    out = fn(*(conv(np.ascontiguousarray(a)) for a in arrays), **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def _both(op, *arrays):
    """``op`` of each package on the same arrays: the two must agree
    exactly. Returns the port's answer."""
    got = _call(PORT, getattr(PORT.ops, op), *arrays)
    want = _call(JAX, getattr(JAX.ops, op), *arrays)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and np.array_equal(g, w), op
    return got


def _random_cluster(s, rng, num_nodes=12, num_existing=20):
    nodes = [
        s.make_node(f"n{i}")
        .capacity(
            cpu=str(rng.choice([2, 4, 8, 16])),
            memory=f"{rng.choice([4, 8, 16, 32])}Gi",
            pods=rng.choice([5, 10, 20]),
        )
        .obj()
        for i in range(num_nodes)
    ]
    pods = [
        s.make_pod(f"e{i}")
        .node(f"n{rng.randrange(num_nodes)}")
        .container(
            cpu=f"{rng.choice([100, 250, 500, 1000])}m",
            memory=f"{rng.choice([128, 256, 512, 1024])}Mi",
        )
        .obj()
        for i in range(num_existing)
    ]
    return pods, nodes


def _pending(s, rng, count):
    out = []
    for i in range(count):
        p = (
            s.make_pod(f"p{i}")
            .creation_timestamp(float(i))
            .container(
                cpu=f"{rng.choice([100, 250, 500, 1000, 2000])}m",
                memory=f"{rng.choice([128, 256, 512, 1024, 2048])}Mi",
            )
            .obj()
        )
        p.spec.priority = rng.choice([0, 0, 0, 5, 10])
        out.append(p)
    return out


def _packed(s, seed, pending):
    """The reference's seeded cluster and ``pending`` fresh pods, built
    and packed by ``s``'s own package."""
    rng = random.Random(seed)
    existing, nodes = _random_cluster(s, rng)
    snap = s.new_snapshot(existing, nodes)
    nt = s.NodeTensorCache().update(snap)
    pods = _pending(s, rng, pending)
    return snap, nt, pods, s.pack_pod_batch(pods, nt.dims)


def _same_pack(pending):
    """The packed cluster of both packages, which must be equal; the
    port's snapshot, tensor and batch."""
    port = _packed(PORT, 42, pending)
    ref = _packed(JAX, 42, pending)
    for a in ("allocatable", "requested", "non_zero_requested", "valid"):
        assert np.array_equal(getattr(port[1], a), getattr(ref[1], a)), a
    for a in ("requests", "non_zero_requests", "order"):
        assert np.array_equal(getattr(port[3], a), getattr(ref[3], a)), a
    assert list(port[1].names) == list(ref[1].names)
    return port


# -- TestFitMaskParity --------------------------------------------------------


def test_fit_mask_matches_sequential_fit():
    snap, nt, pending, batch = _same_pack(15)
    mask = _both("fit_mask", nt.allocatable, nt.requested, batch.requests,
                 nt.valid)
    plugin = PORT.noderesources.Fit()
    state = PORT.CycleState()
    for b, pod in enumerate(pending):
        plugin.pre_filter(state, pod)
        for ni in snap.list_node_infos():
            want = plugin.filter(state, pod, ni) is None
            assert bool(mask[b, nt.row(ni.node_name)]) == want, (
                pod.name, ni.node_name)


def test_zero_request_pod_fits_everywhere_with_pod_slots():
    masks = []
    for s in (PORT, JAX):
        nodes = [s.make_node("n").capacity(cpu="1", memory="1Gi", pods=1)
                 .obj()]
        nt = s.NodeTensorCache().update(s.new_snapshot([], nodes))
        batch = s.pack_pod_batch([s.make_pod("z").obj()], nt.dims)
        masks.append(_call(s, s.ops.fit_mask, nt.allocatable, nt.requested,
                           batch.requests, nt.valid))
    assert np.array_equal(masks[0], masks[1])
    assert masks[0][0, 0]
    assert not masks[0][0, 1:].any()  # padding rows never fit


# -- TestScoreParity ----------------------------------------------------------


def test_least_and_balanced_match_oracle():
    snap, nt, pending, batch = _same_pack(10)
    args = (nt.allocatable[:, :2], nt.non_zero_requested,
            batch.non_zero_requests)
    least = _both("least_allocated_score", *args)
    balanced = _both("balanced_allocation_score", *args)
    state = PORT.CycleState()
    state.write(PORT.SNAPSHOT_STATE_KEY, snap)
    lp = PORT.noderesources.LeastAllocated()
    bp = PORT.noderesources.BalancedAllocation()
    for b, pod in enumerate(pending):
        for ni in snap.list_node_infos():
            j = nt.row(ni.node_name)
            want, status = lp.score(state, pod, ni.node_name)
            assert status is None
            assert int(least[b, j]) == want, ("least", pod.name,
                                              ni.node_name)
            want, status = bp.score(state, pod, ni.node_name)
            assert status is None
            assert abs(int(balanced[b, j]) - want) <= 1, (
                "balanced", pod.name, ni.node_name)


# -- TestGreedyAssign ---------------------------------------------------------


def _solve(nt, batch, active=None):
    order = batch.order
    static = np.ones((batch.size, nt.capacity), dtype=bool)
    act = np.ones(batch.size, dtype=bool) if active is None else active
    return _both(
        "greedy_assign", nt.allocatable, nt.requested,
        nt.non_zero_requested, nt.valid, batch.requests[order],
        batch.non_zero_requests[order], static[order], act[order],
    )


def _tiny(s, cpu, memory, pods):
    nodes = [s.make_node("n").capacity(cpu=cpu, memory=memory, pods=10)
             .obj()]
    nt = s.NodeTensorCache().update(s.new_snapshot([], nodes))
    return nt, s.pack_pod_batch(pods(s), nt.dims)


def test_capacity_never_double_booked():
    def pods(s):
        return [s.make_pod(f"p{i}").creation_timestamp(float(i))
                .container(cpu="1", memory="1Gi").obj() for i in range(4)]

    nt, batch = _tiny(PORT, "2", "4Gi", pods)
    assignments, req_out, _ = _solve(nt, batch)
    assert (assignments == 0).sum() == 2
    assert (assignments == PORT.NO_NODE).sum() == 2
    assert req_out[0, 0] == 2000  # cpu fully booked, not over


def test_step_optimality_vs_oracle():
    """Each batched decision reaches the oracle's best total score given
    the same already-assigned prefix."""
    snap, nt, _, batch = _same_pack(20)
    assignments, _, _ = _solve(nt, batch)
    np_ = PORT.noderesources
    lp, bp, fit = np_.LeastAllocated(), np_.BalancedAllocation(), np_.Fit()
    for k, b in enumerate(batch.order):
        pod = batch.pods[b]
        choice = int(assignments[k])
        state = PORT.CycleState()
        state.write(PORT.SNAPSHOT_STATE_KEY, snap)
        fit.pre_filter(state, pod)
        feasible = [ni for ni in snap.list_node_infos()
                    if fit.filter(state, pod, ni) is None]
        if choice == PORT.NO_NODE:
            assert not feasible, pod.name
            continue
        chosen = nt.names[choice]
        assert chosen in {ni.node_name for ni in feasible}, pod.name

        def total(name):
            return (lp.score(state, pod, name)[0]
                    + bp.score(state, pod, name)[0])

        best = max(total(ni.node_name) for ni in feasible)
        assert total(chosen) >= best - 1, pod.name
        placed = pod.deepcopy()
        placed.spec.node_name = chosen
        snap.get_node_info(chosen).add_pod(placed)


def test_priority_order_wins_scarce_capacity():
    def pods(s):
        low = s.make_pod("low").creation_timestamp(0.0).container(cpu="1") \
            .obj()
        high = s.make_pod("high").creation_timestamp(1.0) \
            .container(cpu="1").obj()
        high.spec.priority = 100
        return [low, high]

    nt, batch = _tiny(PORT, "1", "1Gi", pods)
    assignments, _, _ = _solve(nt, batch)
    by_pod = {batch.pods[b].name: int(assignments[k])
              for k, b in enumerate(batch.order)}
    assert by_pod == {"high": 0, "low": PORT.NO_NODE}


def test_inactive_padding_rows_ignored():
    def pods(s):
        return [s.make_pod("p").container(cpu="1").obj(),
                s.make_pod("pad").container(cpu="1").obj()]

    nt, batch = _tiny(PORT, "4", "4Gi", pods)
    assignments, req_out, _ = _solve(nt, batch, np.array([True, False]))
    assert int(assignments[0]) == 0
    assert int(assignments[1]) == PORT.NO_NODE
    assert req_out[0, 0] == 1000  # the inactive pod booked nothing


# -- TestFitAdviceSemantics: the all-zero shortcut is per pod ----------------


@pytest.mark.parametrize("allocatable,requested,pod_req,want", [
    # over-committed cpu; the pod asks 0 cpu but some memory: rejected
    ([[1000, 1024, 0, 10]], [[1500, 0, 0, 1]], [0, 512, 0, 1], None),
    # an all-zero pod checks only the pod count
    ([[1000, 1024, 0, 10]], [[1500, 0, 0, 1]], [0, 0, 0, 1], 0),
    # ...and is rejected when the pod slots are full
    ([[1000, 1024, 0, 1]], [[0, 0, 0, 1]], [0, 0, 0, 1], None),
    # an over-committed scalar the pod does not ask for: still fits
    ([[1000, 1024, 0, 10, 4]], [[0, 0, 0, 1, 5]], [500, 0, 0, 1, 0], 0),
    # an over-committed scalar it does ask for: rejected
    ([[1000, 1024, 0, 10, 4]], [[0, 0, 0, 1, 4]], [500, 0, 0, 1, 1], None),
], ids=[
    "zero_request_dim_on_overcommitted_node_rejects",
    "all_zero_request_pod_only_checks_pod_count",
    "all_zero_request_pod_rejected_when_pod_slots_full",
    "unrequested_scalar_on_overcommitted_node_still_fits",
    "requested_scalar_on_overcommitted_node_rejects",
])
def test_fit_advice_semantics(allocatable, requested, pod_req, want):
    n = len(allocatable)
    out, _, _ = _both(
        "greedy_assign",
        np.array(allocatable, np.int32), np.array(requested, np.int32),
        np.zeros((n, 2), np.int32), np.ones(n, bool),
        np.array([pod_req], np.int32), np.zeros((1, 2), np.int32),
        np.ones((1, n), bool), np.ones(1, bool),
    )
    assert int(out[0]) == (PORT.NO_NODE if want is None else want)
